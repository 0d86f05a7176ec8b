"""The ordering pass and the accumulate pass of the fixed-base MSM
(halo2_tpu_torch/msm/stream_msm.py, kernels D and 8 of csrc/msm.cu) on the
CPU, and the baked MSM against the JAX reference.

- The ordering pass's plain version against a numpy stable argsort of the
  bucket keys with the zero digits removed, with the split it reports.
- The accumulate pass's plain version, per bucket, against `host_msm` of
  that bucket's table rows; `key_sums` adds each bucket's pieces.
- `msm_stream_baked` against the reference's (halo2_tpu.msm.stream_msm on
  the CPU) for random, 16-bit, zero, equal and one-bucket scalars on
  BN254 and Vesta.  The unbaked MSM against the reference is in
  test_torch_msm.py (BN254) and test_torch_msm_unbaked.py (Vesta).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from halo2_tpu.curves import BN254_G1 as REF_BN, VESTA as REF_VESTA
from halo2_tpu.msm import stream_msm as ref_sm
from halo2_tpu_torch.curves import BN254_G1, VESTA
from halo2_tpu_torch.msm import stream_msm as sm
from halo2_tpu_torch.msm.host_msm import host_msm

# The plain versions run many small tensor ops: one thread per worker
# is as fast and leaves the other cores to the other test workers.
torch.set_num_threads(1)

KINDS = ["random", "16-bit", "zeros", "equal", "one-bucket"]
REF_LANES = 32          # the reference's stream layout


def scalars(p: int, n: int, seed: int, kind: str) -> list:
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return [0] * n
    if kind == "equal":
        return [p - 12345] * n
    if kind == "16-bit":
        return [int(v) for v in rng.integers(0, 1 << 16, size=n)]
    if kind == "one-bucket":
        return [1] * n
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    vals[:3] = [0, 1, p - 1]
    return vals


def points(G, n: int, seed: int) -> list:
    """n affine points [k]G as ints, two of them the identity (None)."""
    rng = np.random.default_rng(seed)
    pts = [host_msm(G, [int(k)], [(G.gen_x, G.gen_y)])
           for k in rng.integers(1, 1 << 62, size=n)]
    pts[3] = pts[n - 2] = None
    return pts


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("per_window", [False, True],
                         ids=["baked", "unbaked"])
def test_order_plain_matches_numpy_argsort(per_window, kind):
    """Order = row * 2 + sign of the nonzero elements, stable-sorted by key
    (bucket - 1, or window * 32 + bucket - 1), rows w n + i (baked) or i
    (unbaked); info = [T, P, NS, 0] + key starts + piece starts."""
    n, pieces = 96, 40
    C = BN254_G1
    vals = scalars(C.Fr.p, n, 5, kind)
    keys = sm.stream_keys(C, C.Fr.encode_ints(vals, "cpu"))
    W = keys.shape[0]
    order, info = sm.msm_order_plain(keys, per_window, pieces)
    k = keys.numpy().astype(np.int64)
    b = (k >> 1).reshape(-1)
    w, i = np.divmod(np.arange(W * n), n)
    key = np.where(per_window, w * 32 + b - 1, b - 1)
    row = i if per_window else w * n + i
    live = b != 0
    perm = np.argsort(key[live], kind="stable")
    want = (row * 2 + (k.reshape(-1) & 1))[live][perm]
    total = int(live.sum())
    assert np.array_equal(order[:total].numpy(), want)
    nkeys = 32 * W if per_window else 32
    counts = np.bincount(key[live], minlength=nkeys)
    step = max(1, -(-total // pieces))
    segs = -(-counts // step)
    head = [total, step, int(segs.sum()), 0]
    starts = np.concatenate([[0], np.cumsum(counts)])
    seg_base = np.concatenate([[0], np.cumsum(segs)])
    assert info.tolist() == head + starts.tolist() + seg_base.tolist()


@pytest.mark.parametrize("per_window", [False, True],
                         ids=["baked", "unbaked"])
def test_accumulate_plain_per_bucket_matches_host_msm(per_window):
    """Each bucket's pieces, added up, and its `key_sums` entry equal
    host_msm over that bucket's rows (y negated on a negative digit)."""
    C, n = BN254_G1, 32
    pts = points(C, n, 7)
    ours = C.from_affine_ints(pts, "cpu")
    table = sm.pack_base_stream_table(C, ours) if per_window else \
        sm.bake_stream_table(C, ours)
    vals = scalars(C.Fr.p, n, 8, "random")
    keys = sm.stream_keys(C, C.Fr.encode_ints(vals, "cpu"))
    nkeys = sm.n_keys(keys, per_window)
    pieces = 24
    slots = sm.slots_for(pieces, nkeys)
    order, info = sm.msm_order(keys, per_window, pieces)
    partials = sm.accumulate_plain(C, order, table, info, nkeys, slots)
    sums = C.to_affine_ints(sm.key_sums(C, partials, info, nkeys))
    seg_base = [int(v) for v in info[5 + nkeys:]]
    flat = keys.reshape(-1)
    W = keys.shape[0]
    for key in (0, 5, 31) + ((32 * 7 + 3, 32 * (W - 1) + 1)
                             if per_window else ()):
        terms = []
        for e in range(W * n):
            w, i = divmod(e, n)
            bucket = int(flat[e]) >> 1
            if bucket == 0 or (w * 32 if per_window else 0) + bucket - 1 \
                    != key:
                continue
            row = table[i if per_window else e]
            if int(row[16]) & 1:
                continue
            x, y = C.Fq.decode_ints(row[:16].reshape(2, 8))
            terms.append((x, (-y) % C.Fq.p if int(flat[e]) & 1 else y))
        want = host_msm(C, [1] * len(terms), terms)
        piece = partials[seg_base[key]:seg_base[key + 1]]
        parts = [p for p in C.to_affine_ints(piece) if p is not None] \
            if piece.shape[0] else []
        assert host_msm(C, [1] * len(parts), parts) == want
        assert sums[key] == want


@functools.lru_cache(maxsize=None)
def baked_pair(curve: str):
    """A port baked table and the reference's over the same 64 points, and
    the reference MSM jitted once per curve."""
    C, R = (BN254_G1, REF_BN) if curve == "bn254" else (VESTA, REF_VESTA)
    pts = points(C, 64, 11)
    ours = sm.bake_stream_table(C, C.from_affine_ints(pts, "cpu"))
    theirs = ref_sm.bake_stream_table(R, R.from_affine_ints(pts), 6,
                                      REF_LANES)
    run = jax.jit(lambda s, t: ref_sm.msm_stream_baked(R, s, t, 6,
                                                       REF_LANES))
    return C, R, pts, ours, theirs, run


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("curve", ["bn254", "vesta"])
def test_msm_stream_baked_matches_reference(curve, kind):
    C, R, pts, ours, theirs, run = baked_pair(curve)
    vals = scalars(C.Fr.p, len(pts), 12, kind)
    sm.reset_stream_counters()
    got = sm.msm_stream_baked(C, C.Fr.encode_ints(vals, "cpu"), ours)
    want = run(R.Fr.encode_ints(vals), theirs)
    assert C.to_affine_ints(got[None]) == R.to_affine_ints(want[None])
    assert C.to_affine_ints(got[None]) == [host_msm(C, vals, pts)]
    keys = sm.stream_keys(C, C.Fr.encode_ints(vals, "cpu"))
    assert sm.stream_counters() == dict(
        streamed=keys.numel(), added=int((keys >> 1).ne(0).sum()))
