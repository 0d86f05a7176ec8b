"""The port's multi-device layer (halo2_tpu_torch.dist) against the JAX
reference, case for case with tests/test_dist.py: the port's shards are
8 CPU shards (`make_mesh(8, "cpu")`), the reference's the conftest's 8
virtual CPU devices.  NTTs go through the reference's own ShardedNTT and
must be equal word for word; the prefix product is held against the
reference's single-device `prefix_product`, the MSMs against its host MSM
(`host_msm`), as group elements (ShardedCachedMSM in both engine styles:
a StreamMSM a shard, or, sorted, a CachedMSM a shard on 4 shards).  The NTT and prefix product cases run on
both sides of `cuda_ops.on_ints` (python ints, then int64 limbs); the MSM
cases' points stay on the python-int side (the limbs side of the same
per-shard MSMs takes about 35 s a case here, and test_torch_msm*.py hold
it).  Also: the mesh never aliases a shard's memory, make_mesh refuses
more cards than are visible, and ProofConfig(mesh_devices=...) builds a
meshed engine, whose MSMs and transforms share one mesh."""

import functools
import random

import pytest
import torch

from halo2_tpu.curves import BN254_G1 as REF_G1, VESTA as REF_VESTA
from halo2_tpu.dist import make_mesh as ref_make_mesh
from halo2_tpu.dist.ntt import ShardedNTT as RefShardedNTT
from halo2_tpu.fields import BN254_FR as REF_FR, PASTA_FP as REF_FP
from halo2_tpu.msm.host_msm import host_msm as ref_host_msm
from halo2_tpu.poly.arith import prefix_product as ref_prefix_product
from halo2_tpu_torch.config import ProofConfig
from halo2_tpu_torch.curves import BN254_G1, VESTA
from halo2_tpu_torch.dist import (ROW_AXIS, Mesh, ShardedCachedMSM,
                                  ShardedNTT, all_gather, all_to_all,
                                  gather_rows, make_mesh, replicate,
                                  shard_columns, shard_rows,
                                  sharded_msm, sharded_prefix_product)
from halo2_tpu_torch.dist.multihost import global_mesh, hybrid_mesh
from halo2_tpu_torch.engine import GpuMsmEngine, PlonkEngineConfig
from halo2_tpu_torch.fields import BN254_FR, PASTA_FP, cuda_ops
from halo2_tpu_torch.msm.msm import CachedMSM, auto_c

from tests.test_curves_msm import py_mul

# The plain versions run many small tensor ops: one thread per worker
# is as fast and leaves the other cores to the other test workers.
torch.set_num_threads(1)

PATHS = ["ints", "limbs"]


@pytest.fixture(params=PATHS)
def path(request, monkeypatch):
    """Both sides of `cuda_ops.on_ints`: python ints, then int64 limbs."""
    if request.param == "limbs":
        monkeypatch.setattr(cuda_ops, "INT_ELEMS", 0)
        monkeypatch.setattr(cuda_ops, "INT_POINTS", 0)
    return request.param


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, "cpu")


def _pair(F, ref_F, vals):
    return F.encode_ints(vals, "cpu"), ref_F.encode_ints(vals)


@functools.lru_cache(maxsize=None)
def _ref_transform(field: str, log_n: int, seed: int, inverse: bool) -> tuple:
    """The reference ShardedNTT of REF_F.rand_ints(2^log_n, Random(seed))
    on its 8 virtual devices, once per module for every case and both
    plain paths that transform that input."""
    ref_F = {"fp": REF_FP, "fr": REF_FR}[field]
    dist = RefShardedNTT(ref_make_mesh(8), ref_F, log_n)
    a = ref_F.encode_ints(ref_F.rand_ints(1 << log_n, random.Random(seed)))
    return tuple(ref_F.decode_ints(dist.inverse(a) if inverse
                                   else dist.forward(a)))


def _points(ref_curve, n: int, seed: int, top: int):
    rng = random.Random(seed)
    g = (ref_curve.gen_x, ref_curve.gen_y)
    pts = [py_mul(ref_curve, g, rng.randrange(1, top)) for _ in range(n)]
    return pts, rng


def _affine(curve, pt):
    return curve.to_affine_ints(pt[None])


def test_sharded_ntt_matches_reference(mesh, path):
    log_n = 10
    a = PASTA_FP.encode_ints(REF_FP.rand_ints(1 << log_n, random.Random(3)),
                             "cpu")
    got = PASTA_FP.decode_ints(ShardedNTT(mesh, PASTA_FP, log_n).forward(a))
    assert tuple(got) == _ref_transform("fp", log_n, 3, False)


def test_sharded_ntt_roundtrip_and_inverse(mesh, path):
    log_n = 12
    coeffs = REF_FR.rand_ints(1 << log_n, random.Random(4))
    a = BN254_FR.encode_ints(coeffs, "cpu")
    dist = ShardedNTT(mesh, BN254_FR, log_n)
    assert BN254_FR.decode_ints(dist.inverse(dist.forward(a))) == coeffs
    assert tuple(BN254_FR.decode_ints(dist.inverse(a))) == \
        _ref_transform("fr", log_n, 4, True)


def test_sharded_msm_matches_reference(mesh):
    n = 64
    pts, rng = _points(REF_VESTA, n, 11, 500)
    pts[9] = None                       # identity point in the stream
    scalars = [rng.randrange(VESTA.Fr.p) for _ in range(n)]
    scalars[3] = 0
    got = sharded_msm(mesh, VESTA, VESTA.Fr.encode_ints(scalars, "cpu"),
                      VESTA.from_affine_ints(pts, "cpu"), c=4, block=8)
    assert _affine(VESTA, got) == [ref_host_msm(REF_VESTA, scalars, pts)]


def test_sharded_cached_msm_matches_reference(mesh):
    n = 32
    pts, rng = _points(REF_G1, n, 12, 300)
    scalars = [rng.randrange(BN254_G1.Fr.p) for _ in range(n)]
    engine = ShardedCachedMSM(mesh, BN254_G1,
                              BN254_G1.from_affine_ints(pts, "cpu"))
    got = engine(BN254_G1.Fr.encode_ints(scalars, "cpu"))
    assert _affine(BN254_G1, got) == [ref_host_msm(REF_G1, scalars, pts)]
    # fewer scalars than bases: the rest count as zero
    got = engine(BN254_G1.Fr.encode_ints(scalars[:20], "cpu"))
    assert _affine(BN254_G1, got) == [ref_host_msm(REF_G1, scalars[:20],
                                                   pts[:20])]


def test_sorted_sharded_cached_msm_matches_reference():
    """The sorted style on 4 CPU shards, the reference's design: one
    CachedMSM (window tables) a shard and the shard partials added, built
    by the engine from its style, c and block."""
    mesh = make_mesh(4, "cpu")
    n = 32
    pts, rng = _points(REF_VESTA, n, 13, 300)
    pts[5] = None                       # identity base
    scalars = [rng.randrange(VESTA.Fr.p) for _ in range(n)]
    bases = VESTA.from_affine_ints(pts, "cpu")
    engine = GpuMsmEngine(mesh=mesh, style="sorted", c=8, block=8)
    desc = engine.get_base_descriptor(VESTA, bases)
    assert isinstance(desc, ShardedCachedMSM)
    assert [(type(e), e.n, e.c) for e in desc.engines] == \
        [(CachedMSM, 8, 8)] * 4
    got = desc(VESTA.Fr.encode_ints(scalars, "cpu"))
    assert _affine(VESTA, got) == [ref_host_msm(REF_VESTA, scalars, pts)]
    got = desc(VESTA.Fr.encode_ints(scalars[:20], "cpu"))
    assert _affine(VESTA, got) == [ref_host_msm(REF_VESTA, scalars[:20],
                                                pts[:20])]
    # the window width defaults to auto_c of a shard's bases
    assert ShardedCachedMSM(mesh, VESTA, bases, style="sorted"
                            ).engines[0].c == auto_c(8)
    with pytest.raises(ValueError):
        ShardedCachedMSM(mesh, VESTA, bases, c=8)     # stream: no width
    with pytest.raises(ValueError):
        ShardedCachedMSM(mesh, VESTA, bases, style="bucket")


def test_sharded_prefix_product_matches_reference(mesh, path):
    vals = REF_FR.rand_ints(1 << 10, random.Random(5))
    a, ref_a = _pair(BN254_FR, REF_FR, vals)
    got = BN254_FR.decode_ints(sharded_prefix_product(mesh, BN254_FR, a))
    assert got == REF_FR.decode_ints(ref_prefix_product(REF_FR, ref_a))


def test_sharded_ntt_on_hybrid_mesh(path):
    """A 2 x 4 (hosts, rows) mesh shards over both axes jointly: equal to
    the reference's ShardedNTT of the same input (whose values do not
    depend on the mesh's shape; tests/test_dist.py holds the reference's
    hybrid mesh to its single-chip transform), and a round trip."""
    log_n = 10
    a = PASTA_FP.encode_ints(REF_FP.rand_ints(1 << log_n, random.Random(3)),
                             "cpu")
    hybrid = Mesh([torch.device("cpu")] * 8, ("hosts", ROW_AXIS), (2, 4))
    assert hybrid.shape == {"hosts": 2, ROW_AXIS: 4}
    dist = ShardedNTT(hybrid, PASTA_FP, log_n)
    out = dist.forward(a)
    assert tuple(PASTA_FP.decode_ints(out)) == _ref_transform(
        "fp", log_n, 3, False)
    assert torch.equal(dist.inverse(out), a)


def test_sharded_ntt_batched_columns_equal_column_loop(path):
    """(cols, n, 8) in one call, whole or as slabs, equals one call per
    column, and the single-device transform."""
    from halo2_tpu_torch.ntt import get_ntt
    F, log_n = BN254_FR, 9
    mesh = make_mesh(4, "cpu")
    rng = random.Random(21)
    a = torch.stack([F.encode_ints([rng.randrange(F.p)
                                    for _ in range(1 << log_n)], "cpu")
                     for _ in range(3)])
    dist = ShardedNTT(mesh, F, log_n)
    for inverse in (False, True):
        fn = dist.inverse if inverse else dist.forward
        got = fn(a)
        assert torch.equal(got, torch.stack([fn(col) for col in a]))
        single = get_ntt(F, log_n, "cpu")
        want = single.inverse(a) if inverse else single.forward(a)
        assert torch.equal(got, want)
        slabs = fn(shard_columns(mesh, a))
        assert torch.equal(gather_rows(mesh, slabs, dim=1), want)


def test_shards_never_alias():
    """On a mesh whose shards share a device, every slab and every
    exchanged chunk is a copy: writing one changes no other."""
    mesh = Mesh(["cpu"] * 4)
    a = torch.arange(64, dtype=torch.int32).reshape(16, 4)
    a0 = a.clone()
    slabs = shard_rows(mesh, a)
    copies = replicate(mesh, a)
    moved = all_to_all(mesh, slabs, 0, 1)
    gathered = all_gather(mesh, [s[0] for s in slabs])
    assert torch.equal(gather_rows(mesh, slabs), a)
    assert torch.equal(moved[1], torch.cat([s[1:2] for s in slabs], 1))
    assert torch.equal(gathered[2], torch.stack([s[0] for s in slabs]))
    outs = slabs + copies + moved + gathered
    before = [t.clone() for t in outs]
    for i, t in enumerate(outs):
        t.fill_(-1)
        assert torch.equal(a, a0)
        assert all(torch.equal(u, b)
                   for u, b in zip(outs[i + 1:], before[i + 1:]))


def test_make_mesh_never_shrinks():
    """More cards than are visible raise; nothing drops to fewer or to
    the CPU."""
    want = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="CUDA devices"):
        make_mesh(want, "cuda")
    with pytest.raises(ValueError, match="CUDA devices"):
        ProofConfig(k=5, mesh_devices=want).engine()
    assert make_mesh(3, "cpu").size == 3
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 4, ("hosts", ROW_AXIS), (3, 2))


def test_proof_config_builds_a_meshed_engine():
    cfg = ProofConfig(k=5, mesh_devices=4, device="cpu")
    engine = cfg.engine()
    assert engine.mesh.size == 4
    assert engine.msm_backend.mesh is engine.mesh
    assert engine is cfg.engine()
    assert ProofConfig(k=5, device="cpu").engine() is None


def test_set_msm_keeps_one_mesh():
    """The bundle's mesh defaults to the MSM engine's; a mesh that differs
    from the engine's raises instead of sharding only half the prover."""
    m = make_mesh(2, "cpu")
    assert PlonkEngineConfig.set_msm(GpuMsmEngine(mesh=m)).mesh is m
    assert PlonkEngineConfig.set_msm(GpuMsmEngine(mesh=m), mesh=m).mesh is m
    assert PlonkEngineConfig.set_msm(GpuMsmEngine()).mesh is None
    for engine, mesh in ((GpuMsmEngine(), m),
                         (GpuMsmEngine(mesh=m), make_mesh(2, "cpu"))):
        with pytest.raises(ValueError, match="mesh differs"):
            PlonkEngineConfig.set_msm(engine, mesh=mesh)


@pytest.mark.parametrize("make", [global_mesh, hybrid_mesh],
                         ids=["global", "hybrid"])
def test_multihost_mesh_defaults_to_a_card(make):
    """With no devices named, a multi-process mesh takes this process's
    card and raises without one: the CPU is had only by naming it."""
    if torch.cuda.is_available():
        return      # the default is the card (tests/test_torch_gpu.py)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
