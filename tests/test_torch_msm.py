"""The port's fixed-base MSMs against the JAX reference, with adversarial
scalars: the stream MSM (the ordering pass's and kernel D's and kernel 8's
plain versions, the key sums of the partial sums, the weighted bucket
fold) against naive_msm, default_cached_msm and msm_stream_unbaked, and
the signed digits word for word.  MSM results compare as affine points
(the projective form depends on the algorithm).  The plain versions of
kernels D and 8 run on both sides of `cuda_ops.on_ints` (python ints for
small CPU batches, int64 limbs otherwise).  The ordering pass and the
baked MSM against the reference are in test_torch_msm_order.py; the
variable-base MSM and kernel 9 in test_torch_msm_variable.py."""

import numpy as np
import pytest
import torch

from halo2_tpu.curves import BN254_G1 as REF
from halo2_tpu.fields import PASTA_FP as REF_PASTA_FP
from halo2_tpu.msm.host_msm import host_msm
from halo2_tpu.msm.bucket_scan import _signed_digits as ref_signed_digits
from halo2_tpu.msm.msm import default_cached_msm, naive_msm as ref_naive
from halo2_tpu.msm.stream_msm import (
    msm_stream_unbaked as ref_msm_stream_unbaked,
    pack_base_stream_table as ref_pack_base_stream_table)
from halo2_tpu_torch.compat.from_jax import limbs_from_jax
from halo2_tpu_torch.curves import BN254_G1 as C
from halo2_tpu_torch.engine import GpuMsmEngine
from halo2_tpu_torch.fields import PASTA_FP, cuda_ops
from halo2_tpu_torch.msm import StreamMSM
from halo2_tpu_torch.msm.bucket_scan import _signed_digits, n_windows_for
from halo2_tpu_torch.msm import stream_msm
from halo2_tpu_torch.msm.stream_msm import (NB, STREAM_C, accumulate_plain,
                                            msm_order, msm_stream_unbaked,
                                            pack_base_stream_table,
                                            key_sums, pieces_for,
                                            reset_stream_counters, slots_for,
                                            stream_bucket, stream_buckets,
                                            stream_bucket_windows,
                                            stream_counters, stream_keys)

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
    if kind == "16-bit":
        return [int(v) for v in rng.integers(0, 1 << 16, size=n)]
    if kind == "one-bucket":
        return [1] * n
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
    """The plain version of kernel D, called directly on the ordering
    pass's split: the piece sums of a bucket, added up, are the madds of
    that bucket's table rows (y negated on a negative digit); slots past NS
    hold the identity; `key_sums` adds each bucket's pieces."""
    desc = desc_2_8
    n = 1 << 8
    assert desc.baked and tuple(desc.table.shape) == (43 * n, 18)
    vals = _scalars(n, 9, "random")
    keys = stream_keys(C, C.Fr.encode_ints(vals, "cpu"))
    assert keys.shape == (43, n)
    pieces = 400
    slots = slots_for(pieces, NB)
    order, info = msm_order(keys, False, pieces)
    total, step, ns = (int(v) for v in info[:3])
    assert total == int((keys >> 1).ne(0).sum()) and ns <= slots
    assert step == -(-total // pieces)
    outs = [accumulate_plain(C, order, desc.table, info, NB, slots)
            for _ in plain_paths(monkeypatch)]
    partials = outs[0]
    assert torch.equal(partials, outs[1])
    assert torch.equal(partials, stream_bucket(C, order, desc.table, info,
                                               slots))
    assert partials.shape == (slots, 3, 8)
    assert C.is_identity(partials[ns:]).all()
    seg_base = [int(v) for v in info[5 + NB:]]
    sums = C.to_affine_ints(key_sums(C, partials, info, NB))
    flat = keys.reshape(-1)
    for bucket in (0, 7, 31):
        terms = []
        for e in torch.nonzero((flat >> 1) == bucket + 1).reshape(-1):
            row = desc.table[int(e)]
            if int(row[16]) & 1:
                continue
            xy = C.Fq.decode_ints(row[:16].reshape(2, 8))
            if int(flat[e]) & 1:
                xy[1] = (-xy[1]) % C.Fq.p
            terms.append(tuple(xy))
        parts = [p for p in C.to_affine_ints(
            partials[seg_base[bucket]:seg_base[bucket + 1]]) if p is not None]
        want = host_msm(REF, [1] * len(terms), terms)
        assert host_msm(REF, [1] * len(parts), parts) == want
        assert sums[bucket] == want


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
    assert baked.baked and tuple(baked.table.shape) == (43 * 16, 18)
    unbaked = StreamMSM(C, pts[:17])
    assert not unbaked.baked
    assert tuple(unbaked.table.shape) == (17, 18)
    vals = _scalars(17, 12, "random")
    want = [host_msm(REF, vals, C.to_affine_ints(pts[:17]))]
    assert C.to_affine_ints(unbaked(C.Fr.encode_ints(vals, "cpu"))[None]) \
        == want
    assert C.to_affine_ints(baked(C.Fr.encode_ints(vals[:16], "cpu"))[None]) \
        == [host_msm(REF, vals[:16], C.to_affine_ints(pts[:16]))]


# ----------------------------------------------------------------------
# kernel 8 (unbaked stream), plain version
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "16-bit", "zeros", "equal",
                                  "one-bucket"])
def test_msm_stream_unbaked_matches_reference(bases, monkeypatch, kind):
    """msm_stream_unbaked (the ordering pass and kernel 8's plain versions,
    the key sums, per-window folds and the Horner combine) against the
    reference's at n = 2^8; each window's bucket sums against a one-window
    pass of kernel D's plain version over the same table; and (random)
    kernel 8's plain version on both sides of `on_ints`."""
    ref_pts, pts = bases
    n = 1 << 8
    lanes = 32
    table = pack_base_stream_table(C, pts[:n])
    ref_table = ref_pack_base_stream_table(REF, ref_pts[:n], lanes)
    assert table.shape == (n, 18)
    vals = _scalars(n, 14, kind)
    if kind == "random":
        vals[:4] = [0, 1, P_ORDER - 1, P_ORDER - 2]
    reset_stream_counters()
    ours = msm_stream_unbaked(C, C.Fr.encode_ints(vals, "cpu"), table)
    theirs = ref_msm_stream_unbaked(REF, REF.Fr.encode_ints(vals), ref_table,
                                    STREAM_C, lanes)
    assert C.to_affine_ints(ours[None]) == REF.to_affine_ints(theirs[None])
    keys = stream_keys(C, C.Fr.encode_ints(vals, "cpu"))
    assert stream_counters() == dict(
        streamed=keys.numel(), added=int((keys >> 1).ne(0).sum()))
    sums = stream_buckets(C, keys, table, True).reshape(43, NB, 3, 8)
    for w in (0, 2, 42):
        one = stream_buckets(C, keys[w:w + 1], table, False)
        assert C.to_affine_ints(sums[w]) == C.to_affine_ints(one)
    if kind != "random":
        return
    nkeys = NB * keys.shape[0]
    pieces = pieces_for(C, keys.numel(), nkeys, "cpu")
    slots = slots_for(pieces, nkeys)
    order, info = msm_order(keys, True, pieces)
    outs = [accumulate_plain(C, order, table, info, nkeys, slots)
            for _ in plain_paths(monkeypatch)]
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], stream_bucket_windows(C, order, table, info,
                                                      nkeys, slots))
