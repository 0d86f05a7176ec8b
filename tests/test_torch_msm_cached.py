"""The port's sorted fixed-base MSM against the JAX reference on the CPU:
`window_bases`, `CachedMSM` (baked, unbaked, and in window chunks) on
BN254 and Vesta, the sorted helpers of msm/bucket_scan.py, and the MSM
engine's `style` (GpuMsmEngine, HALO2_TPU_MSM_STYLE).

`CachedMSM` is held against the reference's `CachedMSM` on the shape the
reference's own test compiles (Vesta, n = 40, c = 8, block 16), and every
other case against the reference's `host_msm`, with the scalar sets of the
reference's adversarial test (all equal, zero, one, random) and fewer
scalars than bases.  Points compare after normalisation (the projective
words depend on the algorithm).  The reference-shape case runs on both
sides of `cuda_ops.on_ints` (python ints, then int64 limbs); the other
cases on the python-int side (and the limbs where a batch passes it),
since every piece they run is held on both sides here or in
test_torch_msm*.py.  The sharded
descriptor is in test_torch_dist.py, the sorted engine's KZG proof in
test_torch_e2e.py."""

import gc
import random

import numpy as np
import pytest
import torch

from halo2_tpu.curves import BN254_G1 as REF_BN254, VESTA as REF_VESTA
from halo2_tpu.msm import bucket_scan as ref_scan
from halo2_tpu.msm.host_msm import host_msm
from halo2_tpu.msm.msm import CachedMSM as RefCachedMSM
from halo2_tpu.msm.msm import window_bases as ref_window_bases
from halo2_tpu_torch.curves import BN254_G1, VESTA
from halo2_tpu_torch.engine import GpuMsmEngine, H2cEngine
from halo2_tpu_torch.fields import cuda_ops
from halo2_tpu_torch.msm import CachedMSM, StreamMSM
from halo2_tpu_torch.msm.bucket_scan import (msm_packed_rows,
                                             msm_unbaked_rows,
                                             packed_digits, shift_add,
                                             sort_perm, unpack_affine_rows)
from halo2_tpu_torch.msm.msm import default_cached_msm, window_bases

from tests.test_curves_msm import py_mul

# The plain versions run many small tensor ops: one thread per worker
# is as fast and leaves the other cores to the other test workers.
torch.set_num_threads(1)

CURVES = {"bn254": (BN254_G1, REF_BN254), "vesta": (VESTA, REF_VESTA)}
SCALAR_SETS = ("equal", "zero", "one", "random")


def plain_paths(monkeypatch):
    """Both sides of `cuda_ops.on_ints`: python ints, then int64 limbs."""
    yield "ints"
    monkeypatch.setattr(cuda_ops, "INT_ELEMS", 0)
    monkeypatch.setattr(cuda_ops, "INT_POINTS", 0)
    yield "limbs"


def _bases(ref_curve, n: int, seed: int) -> list:
    """n affine points [k]G with small k; the identity at index 3."""
    rng = random.Random(seed)
    g = (ref_curve.gen_x, ref_curve.gen_y)
    pts = [py_mul(ref_curve, g, rng.randrange(1, 500)) for _ in range(n)]
    pts[3] = None
    return pts


def _scalars(p: int, n: int, kind: str, seed: int) -> list:
    rng = random.Random(seed)
    if kind == "equal":
        return [rng.randrange(p)] * n
    if kind == "zero":
        return [0] * n
    if kind == "one":
        return [1] * n
    vals = [rng.randrange(p) for _ in range(n)]
    vals[:3] = [0, p - 1, 1]
    return vals


def _affine(curve, pt) -> list:
    return curve.to_affine_ints(pt[None])


def test_window_bases_match_reference():
    """[2^(c w)] P for every window, against the reference's table."""
    pts = _bases(REF_VESTA, 8, 1)
    got = window_bases(VESTA, VESTA.from_affine_ints(pts, "cpu"), 8)
    want = ref_window_bases(REF_VESTA, REF_VESTA.from_affine_ints(pts), 8)
    assert tuple(got.shape) == (33, 8, 3, 8)
    assert VESTA.to_affine_ints(got) == REF_VESTA.to_affine_ints(want)


def test_cached_msm_matches_reference_cached_msm(monkeypatch):
    """The reference's own CachedMSM shape (Vesta, n = 40, c = 8, block
    16, baked in one chunk), on both plain paths."""
    pts = _bases(REF_VESTA, 40, 21)
    vals = _scalars(VESTA.Fr.p, 40, "random", 22)
    ref = RefCachedMSM(REF_VESTA, REF_VESTA.from_affine_ints(pts), c=8,
                       block=16)
    want = REF_VESTA.to_affine_ints(ref(REF_VESTA.Fr.encode_ints(vals))[None])
    assert want == [host_msm(REF_VESTA, vals, pts)]
    for path in plain_paths(monkeypatch):
        ours = CachedMSM(VESTA, VESTA.from_affine_ints(pts, "cpu"), c=8,
                         block=16)
        assert ours.baked and len(ours.bounds) == 1, path
        assert tuple(ours.wbases.shape) == (33 * 40, 18), path
        assert _affine(VESTA, ours(VESTA.Fr.encode_ints(vals, "cpu"))) == \
            want, path


# (mode, CachedMSM keywords for n = 16, window width): the baked table in
# one chunk, the baked table in chunks of 16 windows (forced by max_rows),
# and the unbaked table (forced by max_baked_rows) in chunks of 22 windows
# that shift_add combines
MODES = {"baked": (dict(), 8), "chunked": (dict(max_rows=16 * 16), 8),
         "unbaked": (dict(max_rows=22 * 16, max_baked_rows=1), 4)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("curve", list(CURVES))
def test_cached_msm_modes_match_host_msm(curve, mode):
    C, REF = CURVES[curve]
    kw, c = MODES[mode]
    n = 16
    pts = _bases(REF, n, 31)
    desc = CachedMSM(C, C.from_affine_ints(pts, "cpu"), c=c, block=8, **kw)
    assert desc.baked == (mode != "unbaked")
    chunks = {"baked": 1, "unbaked": 3,
              "chunked": -(-desc.n_windows // 16)}[mode]
    assert len(desc.bounds) == chunks
    for i, kind in enumerate(SCALAR_SETS):
        vals = _scalars(C.Fr.p, n, kind, 40 + i)
        got = desc(C.Fr.encode_ints(vals, "cpu"))
        assert _affine(C, got) == [host_msm(REF, vals, pts)], kind
    # fewer scalars than bases: the first bases of every window
    vals = _scalars(C.Fr.p, 11, "random", 45)
    got = desc(C.Fr.encode_ints(vals, "cpu"))
    assert _affine(C, got) == [host_msm(REF, vals, pts[:11])]
    with pytest.raises(ValueError):
        desc(C.Fr.encode_ints([1] * (n + 1), "cpu"))


def test_sorted_helpers_match_reference():
    """packed_digits and shift_add word for word against the reference's;
    msm_packed_rows (a subset of baked windows) and msm_unbaked_rows (a
    chunk of unbaked windows) against host_msm on the windows' digits;
    sort_perm is stable; unpack_affine_rows splits a row."""
    n = 16
    pts = _bases(REF_VESTA, n, 61)
    vals = _scalars(VESTA.Fr.p, n, "random", 62)
    s = VESTA.Fr.encode_ints(vals, "cpu")
    packed = packed_digits(VESTA, s, 8)
    assert torch.equal(packed, torch.from_numpy(np.array(
        ref_scan.packed_digits(REF_VESTA, REF_VESTA.Fr.encode_ints(vals),
                               8))))
    # the windows' digits d_w: scalar = sum_w d_w 2^(8 w)
    digits = [((k >> 1) * (-1 if k & 1 else 1)) for k in
              packed.reshape(-1).tolist()]
    digits = torch.tensor(digits).reshape(packed.shape).tolist()
    p = VESTA.Fr.p
    assert [sum(d[i] << (8 * w) for w, d in enumerate(digits)) % p
            for i in range(n)] == vals

    desc = CachedMSM(VESTA, VESTA.from_affine_ints(pts, "cpu"), c=8,
                     block=8)
    rows = desc.wbases.reshape(33, n, 18)
    got = msm_packed_rows(VESTA, packed[5:8], rows[5:8].reshape(-1, 18), 8,
                          4)
    part = [sum(digits[w][i] << (8 * w) for w in range(5, 8)) % p
            for i in range(n)]
    assert _affine(VESTA, got) == [host_msm(REF_VESTA, part, pts)]
    got = msm_unbaked_rows(VESTA, packed[5:8], rows[0], 8, 4)
    part = [sum(digits[w][i] << (8 * (w - 5)) for w in range(5, 8)) % p
            for i in range(n)]
    assert _affine(VESTA, got) == [host_msm(REF_VESTA, part, pts)]

    xy, inf = unpack_affine_rows(rows[0])
    assert inf.tolist() == [pt is None for pt in pts]
    assert tuple(xy.shape) == (n, 16)

    keys = torch.tensor([5, 1, 5, 0, 1, 5], dtype=torch.int32)
    keys_s, perm = sort_perm(keys)
    assert keys_s.tolist() == [0, 1, 1, 5, 5, 5]
    assert perm.tolist() == [3, 1, 4, 0, 2, 5]

    acc = VESTA.from_affine_ints(pts[1:2], "cpu")[0]
    add = VESTA.from_affine_ints(pts[2:3], "cpu")[0]
    ref_acc, ref_add = (REF_VESTA.from_affine_ints(pts[i:i + 1])[0]
                        for i in (1, 2))
    want = ref_scan.shift_add(REF_VESTA, ref_acc, 1, ref_add)
    assert _affine(VESTA, shift_add(VESTA, acc, 1, add)) == \
        REF_VESTA.to_affine_ints(want[None])


def test_engine_style(monkeypatch):
    """GpuMsmEngine's style: "stream" by default, HALO2_TPU_MSM_STYLE
    read when no style is given, "sorted" builds a CachedMSM of the
    engine's c and block, an unknown style or a window width for the
    stream style raises; default_cached_msm on CPU bases is a CachedMSM;
    H2cEngine passes coefficients through."""
    pts = BN254_G1.from_affine_ints(_bases(REF_BN254, 8, 71), "cpu")
    monkeypatch.delenv("HALO2_TPU_MSM_STYLE", raising=False)
    assert GpuMsmEngine().style == "stream"
    assert isinstance(GpuMsmEngine().get_base_descriptor(BN254_G1, pts),
                      StreamMSM)
    monkeypatch.setenv("HALO2_TPU_MSM_STYLE", "sorted")
    engine = GpuMsmEngine(c=5, block=8)
    desc = engine.get_base_descriptor(BN254_G1, pts)
    assert isinstance(desc, CachedMSM) and (desc.c, desc.block) == (5, 8)
    assert GpuMsmEngine(style="stream").style == "stream"
    monkeypatch.setenv("HALO2_TPU_MSM_STYLE", "bucket")
    with pytest.raises(ValueError):
        GpuMsmEngine()
    with pytest.raises(ValueError):
        GpuMsmEngine(style="stream", c=8)
    assert isinstance(default_cached_msm(BN254_G1, pts), CachedMSM)
    coeffs = BN254_G1.Fr.encode_ints([1, 2], "cpu")
    assert H2cEngine().get_coeffs_descriptor(coeffs) is coeffs


def test_sorted_engine_descriptor_cache_no_stale_id_hit():
    """The reference's stale-id test under the sorted style: the cache
    pins its bases, so a recycled id() can never serve a stale window
    table, and new bases get a descriptor of their own."""
    n = 16
    rng = random.Random(5)
    g = (REF_VESTA.gen_x, REF_VESTA.gen_y)

    def mk(seed):
        r = random.Random(seed)
        return VESTA.from_affine_ints(
            [py_mul(REF_VESTA, g, r.randrange(1, 500)) for _ in range(n)],
            "cpu")

    vals = [rng.randrange(VESTA.Fr.p) for _ in range(n)]
    scalars = VESTA.Fr.encode_ints(vals, "cpu")
    engine = GpuMsmEngine(style="sorted", c=8, block=8)
    b1 = mk(1)
    d1 = engine.get_base_descriptor(VESTA, b1)
    assert isinstance(d1, CachedMSM)
    assert engine.get_base_descriptor(VESTA, b1) is d1
    assert any(entry[0] is b1 for entry in engine._cache.values())
    r1 = engine.msm_with_cached_base(VESTA, scalars, d1)
    del b1, d1
    gc.collect()
    b2 = mk(2)
    r2 = engine.get_base_descriptor(VESTA, b2)(scalars)
    want = [host_msm(REF_VESTA, vals, VESTA.to_affine_ints(b2))]
    assert _affine(VESTA, r2) == want
    assert _affine(VESTA, r1) != want
