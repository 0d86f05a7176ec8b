"""The port's MSMs against the JAX reference, with adversarial scalars: the
fixed-base stream MSM (kernel D's and kernel 8's plain versions, the lane
tree sum, the weighted bucket fold) against naive_msm, default_cached_msm
and msm_stream_unbaked; one segmented-scan level (kernel 9's plain
version) against _scan_level word for word; and the variable-base msm()
against naive_msm and msm_variable.  MSM results compare as affine points
(the projective form depends on the algorithm); the signed digits and the
scan levels compare word for word.  The plain versions of kernels D, 8 and
9 run on both sides of `cuda_ops.on_ints` (python ints for small CPU
batches, int64 limbs otherwise)."""

import numpy as np
import pytest
import torch

from halo2_tpu.curves import BN254_G1 as REF
from halo2_tpu.fields import PASTA_FP as REF_PASTA_FP
from halo2_tpu.msm.host_msm import host_msm
from halo2_tpu.msm import bucket_scan as ref_scan
from halo2_tpu.msm.bucket_scan import _signed_digits as ref_signed_digits
from halo2_tpu.msm.msm import default_cached_msm, naive_msm as ref_naive
from halo2_tpu.msm.stream_msm import (
    msm_stream_unbaked as ref_msm_stream_unbaked,
    pack_base_stream_table as ref_pack_base_stream_table)
from halo2_tpu_torch.compat.from_jax import limbs_from_jax
from halo2_tpu_torch.curves import BN254_G1 as C
from halo2_tpu_torch.engine import GpuMsmEngine
from halo2_tpu_torch.fields import PASTA_FP, cuda_ops
from halo2_tpu_torch.msm import StreamMSM, msm, naive_msm
from halo2_tpu_torch.msm.bucket_scan import (AFFINE, PACKED, PROJECTIVE,
                                             SENTINEL_KEY, _signed_digits,
                                             n_windows_for, pack_affine_rows,
                                             scan_level, scan_level_plain)
from halo2_tpu_torch.msm import stream_msm
from halo2_tpu_torch.msm.stream_msm import (N_BUCKETS, STREAM_C, lanes_for,
                                            msm_stream_unbaked,
                                            pack_base_stream_table,
                                            stream_bucket,
                                            stream_bucket_plain,
                                            stream_bucket_windows,
                                            stream_bucket_windows_plain,
                                            stream_keys, unbaked_lanes,
                                            window_keys)

# The plain versions run many small tensor ops: one thread per worker
# is as fast and leaves the other cores to the other test workers.
torch.set_num_threads(1)

P_ORDER = C.Fr.p


def plain_paths(monkeypatch):
    """Both sides of `cuda_ops.on_ints`: python ints, then int64 limbs."""
    yield "ints"
    monkeypatch.setattr(cuda_ops, "INT_ELEMS", 0)
    monkeypatch.setattr(cuda_ops, "INT_POINTS", 0)
    yield "limbs"


def _scalars(n: int, seed: int, kind: str) -> list:
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return [0] * n
    if kind == "equal":
        return [P_ORDER - 12345] * n
    if kind == "sparse":
        return [int(v) for v in rng.integers(0, 3, size=n)]
    if kind == "top":
        return [P_ORDER - 1 - int(v) for v in rng.integers(0, 4, size=n)]
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(r)) % P_ORDER
            for r in words]


@pytest.fixture(scope="module")
def bases():
    """2^10 reference points [k_i]G (a few identities), both layouts."""
    n = 1 << 10
    rng = np.random.default_rng(1)
    ks = [int(k) for k in rng.integers(1, 1 << 62, size=n)]
    ks[3] = ks[700] = 0
    pts = [host_msm(REF, [k], [(1, 2)]) for k in ks]
    ref_pts = REF.from_affine_ints(pts)
    ours = C.from_affine_ints(pts, "cpu")
    assert torch.equal(ours, limbs_from_jax(np.asarray(ref_pts)))
    return ref_pts, ours


@pytest.fixture(scope="module")
def desc_2_8(bases):
    return StreamMSM(C, bases[1][: 1 << 8])


@pytest.mark.parametrize("c", [STREAM_C, 4, 8])
@pytest.mark.parametrize("field", ["bn254", "pasta"])
def test_signed_digits_match_reference(field, c):
    """Word for word, for the stream width and both variable-base widths;
    Pasta Fp's 255 bits give a top window that starts at bit 256."""
    F, RF = (C.Fr, REF.Fr) if field == "bn254" else (PASTA_FP, REF_PASTA_FP)
    vals = [v % F.p for v in _scalars(64, 2, "random")] + \
        [F.p - 1 - i for i in range(8)] + [0, 1]
    ours_k, ours_s = _signed_digits(F, F.encode_ints(vals, "cpu"), c)
    ref_k, ref_s = ref_signed_digits(RF, RF.encode_ints(vals), c)
    assert torch.equal(ours_k, torch.from_numpy(np.array(ref_k)))
    assert torch.equal(ours_s, torch.from_numpy(np.array(ref_s)))
    assert ours_k.shape[0] == n_windows_for(F, c)


@pytest.mark.parametrize("kind", ["random", "zeros", "equal", "sparse",
                                  "top"])
def test_stream_msm_matches_naive_at_2_8(bases, desc_2_8, kind):
    ref_pts, _ = bases
    n = 1 << 8
    vals = _scalars(n, 4, kind)
    ours = desc_2_8(C.Fr.encode_ints(vals, "cpu"))
    theirs = ref_naive(REF, REF.Fr.encode_ints(vals), ref_pts[:n])
    assert C.to_affine_ints(ours[None]) == REF.to_affine_ints(theirs[None])


def test_stream_msm_matches_cached_msm_at_2_10(bases):
    ref_pts, pts = bases
    desc = StreamMSM(C, pts)
    ref_desc = default_cached_msm(REF, ref_pts)
    # fewer scalars than bases are zero-padded
    vals = _scalars(1000, 8, "random")
    theirs = ref_desc(REF.Fr.encode_ints(vals + [0] * 24))
    assert C.to_affine_ints(desc(C.Fr.encode_ints(vals, "cpu"))[None]) == \
        REF.to_affine_ints(theirs[None])


def test_kernel_d_plain_lanes_and_buckets(desc_2_8, monkeypatch):
    """The plain version of kernel D, called directly: bucket sums of lane
    j are the madds of that lane's stream rows into bucket key >> 1."""
    desc = desc_2_8
    n = 1 << 8
    assert desc.lanes == lanes_for(43 * n) == 256
    assert tuple(desc.table.shape) == (43, 18, 256)
    vals = _scalars(n, 9, "random")
    keys = stream_keys(C, C.Fr.encode_ints(vals, "cpu"), desc.lanes)
    nb = N_BUCKETS
    outs = [stream_bucket_plain(C, keys, desc.table)
            for _ in plain_paths(monkeypatch)]
    out = outs[0]
    assert torch.equal(out, outs[1])
    assert torch.equal(out, stream_bucket(C, keys, desc.table))
    assert out.shape == (256, nb, 3, 8)
    lane = 77
    acc = {}
    for s in range(keys.shape[0]):
        k = int(keys[s, lane])
        row = desc.table[s, :, lane]
        if int(row[16]) & 1:
            continue
        xy = C.Fq.decode_ints(row[:16].reshape(2, 8))
        if k & 1:
            xy[1] = (-xy[1]) % C.Fq.p
        acc.setdefault(k >> 1, []).append(tuple(xy))
    got = C.to_affine_ints(out[lane])
    for b in range(nb):
        terms = acc.get(b, [])
        assert got[b] == host_msm(REF, [1] * len(terms), terms)


def test_gpu_msm_engine_caches_descriptors(bases):
    """The engine's descriptors are StreamMSMs, reused per bases object,
    and the cache holds at most `max_descriptors` of them."""
    _, pts = bases
    engine = GpuMsmEngine(max_descriptors=1)
    tables = [pts[:16], pts[16:32]]
    d0 = engine.get_base_descriptor(C, tables[0])
    assert isinstance(d0, StreamMSM)
    assert engine.get_base_descriptor(C, tables[0]) is d0
    engine.get_base_descriptor(C, tables[1])
    assert len(engine._cache) == 1
    assert engine.get_base_descriptor(C, tables[0]) is not d0
    vals = _scalars(16, 13, "random")
    got = engine.msm_with_cached_base(C, C.Fr.encode_ints(vals, "cpu"), d0)
    assert C.to_affine_ints(got[None]) == \
        [host_msm(REF, vals, C.to_affine_ints(tables[0]))]


def test_unbaked_table_above_max_baked_rows(bases, monkeypatch):
    """A table of more than MAX_BAKED_ROWS rows is not baked: the
    descriptor takes the unbaked n-row table (kernel 8), with the same
    result as the baked one."""
    _, pts = bases
    monkeypatch.setattr(stream_msm, "MAX_BAKED_ROWS", 43 * 16)
    baked = StreamMSM(C, pts[:16])
    assert baked.baked and baked.lanes == 32
    unbaked = StreamMSM(C, pts[:17])
    assert not unbaked.baked
    assert tuple(unbaked.table.shape) == (1, 18, unbaked_lanes(17, 43))
    vals = _scalars(17, 12, "random")
    want = [host_msm(REF, vals, C.to_affine_ints(pts[:17]))]
    assert C.to_affine_ints(unbaked(C.Fr.encode_ints(vals, "cpu"))[None]) \
        == want
    assert C.to_affine_ints(baked(C.Fr.encode_ints(vals[:16], "cpu"))[None]) \
        == [host_msm(REF, vals[:16], C.to_affine_ints(pts[:16]))]


def test_small_variable_base_msm(bases):
    _, pts = bases
    vals = _scalars(20, 10, "random")
    s = C.Fr.encode_ints(vals, "cpu")
    want = [host_msm(REF, vals, C.to_affine_ints(pts[:20]))]
    assert C.to_affine_ints(msm(C, s, pts[:20])[None]) == want
    assert C.to_affine_ints(naive_msm(C, s, pts[:20])[None]) == want
    vals = _scalars(40, 11, "random")
    assert C.to_affine_ints(msm(C, C.Fr.encode_ints(vals, "cpu"),
                                pts[:40])[None]) == \
        [host_msm(REF, vals, C.to_affine_ints(pts[:40]))]


# ----------------------------------------------------------------------
# kernel 8 (unbaked stream) and kernel 9 (segmented scan), plain versions
# ----------------------------------------------------------------------

def test_msm_stream_unbaked_matches_reference(bases, monkeypatch):
    """msm_stream_unbaked (kernel 8's plain version, per-window folds and
    the Horner combine) against the reference's at n = 2^8, and kernel 8's
    plain version against a per-window run of kernel D's."""
    ref_pts, pts = bases
    n = 1 << 8
    lanes = unbaked_lanes(n, 43)
    table = pack_base_stream_table(C, pts[:n], lanes)
    ref_table = ref_pack_base_stream_table(REF, ref_pts[:n], lanes)
    assert table.shape == (n // lanes, 18, lanes)
    vals = _scalars(n, 14, "random")
    vals[:4] = [0, 1, P_ORDER - 1, P_ORDER - 2]
    ours = msm_stream_unbaked(C, C.Fr.encode_ints(vals, "cpu"), table)
    theirs = ref_msm_stream_unbaked(REF, REF.Fr.encode_ints(vals), ref_table,
                                    STREAM_C, lanes)
    assert C.to_affine_ints(ours[None]) == REF.to_affine_ints(theirs[None])
    keys = window_keys(C, C.Fr.encode_ints(vals, "cpu"), table.shape[0],
                       lanes)
    for path in plain_paths(monkeypatch):
        out = stream_bucket_windows_plain(C, keys, table)
        assert torch.equal(out, stream_bucket_windows(C, keys, table))
        assert out.shape == (43, lanes, N_BUCKETS, 3, 8)
        for w in (0, 21, 42):
            rows = keys[w * table.shape[0]:(w + 1) * table.shape[0]]
            assert torch.equal(out[w], stream_bucket_plain(C, rows, table)), \
                path


def _sorted_stream(kind: str, m: int, seed: int):
    """Sorted (keys, affine points or None) with the last lanes padded by
    SENTINEL_KEY identity elements."""
    rng = np.random.default_rng(seed)
    if kind == "one-bucket":
        keys = np.full(m, 5, np.int64)
    else:
        keys = np.sort(rng.integers(0, 12, size=m))
    keys[-16:] = SENTINEL_KEY
    ks = [int(k) for k in rng.integers(1, 1 << 40, size=m)]
    pts = [host_msm(REF, [k], [(1, 2)]) for k in ks]
    for i in list(range(3, m, 11)) + list(range(m - 16, m)):
        pts[i] = None
    return keys, pts


@pytest.mark.parametrize("mode", ["packed", "affine", "projective"])
@pytest.mark.parametrize("kind", ["one-bucket", "random"])
def test_scan_level_matches_reference(mode, kind, monkeypatch):
    """One segmented-scan level, word for word, on both plain paths: affine
    rows with packed signed keys (y negated on odd keys), plain affine rows,
    and projective points; one bucket owning every element, identity
    points, sentinel padding."""
    block, m = 8, 128
    keys, aff = _sorted_stream(kind, m, 21 if kind == "random" else 22)
    if mode == "packed":
        signs = np.random.default_rng(23).integers(0, 2, size=m)
        keys = np.where(keys == SENTINEL_KEY, keys, keys * 2 + signs)
    inf = np.array([p is None for p in aff])
    ref_keys = ref_scan.jnp.asarray(keys.astype(np.int32))
    ours_keys = torch.from_numpy(keys.astype(np.int32))
    ref_proj = REF.from_affine_ints(aff)
    ours_proj = C.from_affine_ints(aff, "cpu")
    if mode == "projective":
        ref_out = ref_scan._scan_level(REF, ref_keys, ref_proj,
                                       ref_scan.jnp.asarray(inf), block,
                                       False)
        data, flag = ours_proj, PROJECTIVE
    else:
        ref_xy = REF.batch_normalize(ref_proj)[:, :2, :].reshape(m, -1)
        ref_out = ref_scan._scan_level(REF, ref_keys, ref_xy,
                                       ref_scan.jnp.asarray(inf), block,
                                       True, mode == "packed")
        data = pack_affine_rows(C.batch_normalize(ours_proj),
                                torch.from_numpy(inf))
        flag = PACKED if mode == "packed" else AFFINE
    want = limbs_from_jax(np.asarray(ref_out[0]))
    for path in plain_paths(monkeypatch):
        ours_out = scan_level_plain(C, ours_keys, data, block, flag)
        assert torch.equal(ours_out[0], want), path
        assert torch.equal(ours_out[0], scan_level(C, ours_keys, data, block,
                                                   flag)[0]), path
        assert torch.equal(ours_out[1], torch.from_numpy(
            np.asarray(ref_out[1]).astype(np.int32))), path


@pytest.mark.parametrize("n", [33, 1 << 8, 1 << 10])
def test_variable_base_msm_matches_reference(bases, n):
    """msm() above 32 points (Pippenger on the segmented scan, c = 4 below
    2^12 points) against naive_msm and the reference's msm_variable, with
    one scalar set mixing zeros, p - 1 and repeats."""
    ref_pts, pts = bases
    vals = _scalars(n, 30 + n, "random")
    vals[:6] = [0, 0, P_ORDER - 1, 1, vals[7], vals[7]]
    s = C.Fr.encode_ints(vals, "cpu")
    got = C.to_affine_ints(msm(C, s, pts[:n])[None])
    assert got == C.to_affine_ints(naive_msm(C, s, pts[:n])[None])
    theirs = ref_scan.msm_variable(REF, REF.Fr.encode_ints(vals),
                                   ref_pts[:n], 4, 64)
    assert got == REF.to_affine_ints(theirs[None])


def test_variable_base_msm_vesta():
    """msm() over Vesta, whose 255-bit scalars give 65 windows at c = 4."""
    from halo2_tpu_torch.curves import VESTA
    vals = [v % VESTA.Fr.p for v in _scalars(40, 15, "random")]
    vals[:3] = [VESTA.Fr.p - 1, 0, 1]
    pts = VESTA.generator_mul(VESTA.Fr.encode_ints(
        [3 + 7 * i for i in range(40)], "cpu"))
    s = VESTA.Fr.encode_ints(vals, "cpu")
    assert VESTA.to_affine_ints(msm(VESTA, s, pts)[None]) == \
        [host_msm(VESTA, vals, VESTA.to_affine_ints(pts))]
