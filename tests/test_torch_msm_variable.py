"""The port's variable-base MSM against the JAX reference: one
segmented-scan level (kernel 9's plain version) against _scan_level word
for word, on both sides of `cuda_ops.on_ints` (python ints for small CPU
batches, int64 limbs otherwise), and msm() against host_msm, naive_msm
and the reference's msm_variable, with adversarial scalars.  MSM results
compare as affine points (the projective form depends on the algorithm).
Split from test_torch_msm.py so that test workers share the load."""

import numpy as np
import pytest
import torch

from halo2_tpu.curves import BN254_G1 as REF
from halo2_tpu.msm import bucket_scan as ref_scan
from halo2_tpu.msm.host_msm import host_msm
from halo2_tpu_torch.compat.from_jax import limbs_from_jax
from halo2_tpu_torch.curves import BN254_G1 as C
from halo2_tpu_torch.fields import cuda_ops
from halo2_tpu_torch.msm import msm, naive_msm
from halo2_tpu_torch.msm.bucket_scan import (AFFINE, PACKED, PROJECTIVE,
                                             SENTINEL_KEY, pack_affine_rows,
                                             scan_level, scan_level_plain)

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
# kernel 9 (segmented scan), plain version, and msm() above 32 points
# ----------------------------------------------------------------------

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


_REF_MSM = {}


@pytest.mark.parametrize("block", ["rule", 64])
def test_msm_variable_block_matches_reference(bases, block):
    """msm_variable at the block rule (block_for per level: on the CPU the
    python-int batch, then MIN_BLOCK; on the card one wave of lanes) and at
    one fixed block of 64 against the reference's msm_variable after
    normalisation, with the scalars of the n = 256 case above (its
    reference result is reused)."""
    from halo2_tpu_torch.msm import bucket_scan as bs
    ref_pts, pts = bases
    n = 256
    vals = _scalars(n, 30 + n, "random")
    vals[:6] = [0, 0, P_ORDER - 1, 1, vals[7], vals[7]]
    if n not in _REF_MSM:
        _REF_MSM[n] = REF.to_affine_ints(ref_scan.msm_variable(
            REF, REF.Fr.encode_ints(vals), ref_pts[:n], 4, 64)[None])
    m = bs.n_windows_for(C.Fr, 4) * n
    assert bs.block_for(m, "cuda") == bs.MIN_BLOCK
    assert bs.block_for(48 * bs.SCAN_LANES - 1, "cuda") == 48
    assert bs.block_for(48 * cuda_ops.INT_POINTS, "cpu") == 48
    assert bs.block_for(1 << 40, "cpu") == bs.MAX_BLOCK
    levels = []
    orig = bs.scan_level

    def counting(curve, keys, p, blk, mode):
        levels.append(blk)
        return orig(curve, keys, p, blk, mode)

    bs.scan_level = counting
    try:
        got = bs.msm_variable(C, C.Fr.encode_ints(vals, "cpu"), pts[:n], 4,
                              None if block == "rule" else block)
    finally:
        bs.scan_level = orig
    assert C.to_affine_ints(got[None]) == _REF_MSM[n]
    if block == "rule":
        assert levels[0] == bs.block_for(m, "cpu")
        assert bs.MIN_BLOCK in levels
    else:
        assert set(levels[:-1]) == {64}


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
