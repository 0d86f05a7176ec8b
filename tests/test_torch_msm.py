"""The port's fixed-base MSM (kernel D's plain version, the lane tree sum
and the weighted bucket fold) against the JAX reference's naive_msm and
default_cached_msm, with adversarial scalars.  Results compare as affine
points (the projective form depends on the algorithm); the signed digits
compare word for word."""

import numpy as np
import pytest
import torch

from halo2_tpu.curves import BN254_G1 as REF
from halo2_tpu.msm.host_msm import host_msm
from halo2_tpu.msm.bucket_scan import _signed_digits as ref_signed_digits
from halo2_tpu.msm.msm import default_cached_msm, naive_msm as ref_naive
from halo2_tpu_torch.compat.from_jax import limbs_from_jax
from halo2_tpu_torch.curves import BN254_G1 as C
from halo2_tpu_torch.engine import GpuMsmEngine
from halo2_tpu_torch.msm import StreamMSM, msm, naive_msm
from halo2_tpu_torch.msm.bucket_scan import _signed_digits, n_windows_for
from halo2_tpu_torch.msm import stream_msm
from halo2_tpu_torch.msm.stream_msm import (N_BUCKETS, STREAM_C, lanes_for,
                                            stream_bucket,
                                            stream_bucket_plain, stream_keys)

# The plain versions run many small tensor ops: one thread per worker
# is as fast and leaves the other cores to the other test workers.
torch.set_num_threads(1)

P_ORDER = C.Fr.p


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


def test_signed_digits_match_reference():
    vals = _scalars(64, 2, "random") + _scalars(8, 3, "top") + [0, 1]
    ours_k, ours_s = _signed_digits(C.Fr, C.Fr.encode_ints(vals, "cpu"),
                                    STREAM_C)
    ref_k, ref_s = ref_signed_digits(REF.Fr, REF.Fr.encode_ints(vals),
                                     STREAM_C)
    assert torch.equal(ours_k, torch.from_numpy(np.array(ref_k)))
    assert torch.equal(ours_s, torch.from_numpy(np.array(ref_s)))
    assert ours_k.shape[0] == n_windows_for(C.Fr, STREAM_C) == 43


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


def test_kernel_d_plain_lanes_and_buckets(desc_2_8):
    """The plain version of kernel D, called directly: bucket sums of lane
    j are the madds of that lane's stream rows into bucket key >> 1."""
    desc = desc_2_8
    n = 1 << 8
    assert desc.lanes == lanes_for(43 * n) == 256
    assert tuple(desc.table.shape) == (43, 18, 256)
    vals = _scalars(n, 9, "random")
    keys = stream_keys(C, C.Fr.encode_ints(vals, "cpu"), desc.lanes)
    nb = N_BUCKETS
    out = stream_bucket_plain(C, keys, desc.table)
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


def test_unbaked_table_raises(bases, monkeypatch):
    """A table of more than MAX_BAKED_ROWS rows needs the per-window stream
    kernel, which is not ported: the descriptor raises."""
    _, pts = bases
    monkeypatch.setattr(stream_msm, "MAX_BAKED_ROWS", 43 * 16)
    assert StreamMSM(C, pts[:16]).lanes == 32
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StreamMSM(C, pts[:17])


def test_small_variable_base_msm(bases):
    _, pts = bases
    vals = _scalars(20, 10, "random")
    s = C.Fr.encode_ints(vals, "cpu")
    want = [host_msm(REF, vals, C.to_affine_ints(pts[:20]))]
    assert C.to_affine_ints(msm(C, s, pts[:20])[None]) == want
    assert C.to_affine_ints(naive_msm(C, s, pts[:20])[None]) == want
    with pytest.raises(NotImplementedError):
        msm(C, C.Fr.encode_ints(_scalars(40, 11, "random"), "cpu"), pts[:40])
