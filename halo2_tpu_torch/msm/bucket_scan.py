"""Bucket machinery of the MSMs (port of the JAX reference's
msm/bucket_scan.py): signed-digit windows, the weighted bucket fold, the
Horner combine over windows, and the sorted MSMs on kernel 9
(csrc/scan.cu), the segmented scan over a key-sorted stream: the
variable-base `msm_variable`, and the pieces of the sorted fixed-base
`msm.CachedMSM` (`msm_windowed_cached` and `msm_packed_rows` on a baked
window table, `msm_unbaked_rows` and `shift_add` on an unbaked one).

Variable-base pipeline (the reference's `best_multiexp`):

  digits --torch.sort (stable)--> one run of elements per bucket key
         --segmented scan (kernel 9)--> per-lane final partial sums
         --recursive scan over the lane sums--> per-key bucket sums
         --tails: the run pieces that end inside a lane, re-summed
         --weighted fold per window, Horner over windows

A lane owns `block` consecutive sorted elements.  A run that ends on a lane
boundary surfaces as that lane's final; the piece of a run that ends inside
a lane (its "tail", at most `block` elements) is gathered and summed by one
more scan, so no accumulator trace is ever stored.  The sort and the
gathers stay outside the kernel, as `lax.sort` and `jnp.take` are outside
the Pallas kernel in the reference.

Affine stream elements are 18-word rows (x words, y words, infinity flag,
pad), the stream MSM's row format; on the card a row gather moves 72 whole
bytes, so the TPU's tile padding (`pad_width`) has no counterpart.

Each level's `block` is chosen for the device (`block_for`): as many lanes
as one wave of kernel 9 holds on the card (as many as the plain version
runs on python ints on the CPU), and no fewer than MIN_BLOCK elements a
lane, since shorter lanes mean more levels and more tails calls.  The block
changes the order of the additions, so the projective words of a bucket sum,
but not the group element.  The Horner combine over windows is one launch of
kernel B's chain (`horner_windows`).
"""

from __future__ import annotations

import torch

from .._build import I32, I64, P, Kernel, stream_of
from ..curves.cuda_ec import (check_words, ec_add_plain, ec_double_plain,
                              ec_madd_plain)
from ..curves.curve import Curve
from ..fields import cuda_ops
from ..fields.cuda_ops import NWORDS, SUB, binop_plain

ROW_WORDS = 2 * NWORDS + 2        # x words, y words, infinity flag, pad
SENTINEL_KEY = 1 << 30            # pads a stream: sorts after every bucket
PROJECTIVE, AFFINE, PACKED = 0, 1, 2   # scan modes (csrc/scan.cu)
# A level's lanes: one wave of kernel 9 on the H100 (132 SMs, 3 resident
# blocks of 128 threads each); its lanes' blocks: MIN_BLOCK to MAX_BLOCK.
# MIN_BLOCK: of blocks 8, 16, 32 and 64, a whole variable-base MSM of
# 8,192 Vesta points ran fastest at 32 or 64 (within the host's noise) and
# slowest at 8 (chip_smoke.py, PERF.md): shorter lanes add levels whose
# host work costs more than the card saves; 32 fills more of the card.
SCAN_LANES = 132 * 3 * 128
MIN_BLOCK, MAX_BLOCK = 32, 64

_scan_kernel = Kernel("h2_scan_level", [I32, I32, P, P, P, P, I32, I64, P])
# curve, per-window sums, nw, c, out, n, stream
_horner_kernel = Kernel("h2_ec_horner", [I32, P, I32, I32, P, I64, P])


# ----------------------------------------------------------------------
# digits, folds and sums
# ----------------------------------------------------------------------

def n_windows_for(Fr, c: int) -> int:
    """Windows of the signed-digit decomposition: c * nw >= bits + 2, so the
    top balanced digit absorbs the final carry."""
    return -(-(Fr.p.bit_length() + 2) // c)


def _signed_digits(Fr, scalars_mont, c: int):
    """Balanced base-2^c digits: scalar = sum_w d_w 2^(c w) with d_w in
    [-2^(c-1), 2^(c-1)].  Returns (keys, signs), both (nw, n): keys = |d_w|
    int32, signs bool."""
    assert 2 <= c <= 16
    w = Fr.from_mont(scalars_mont).to(torch.int64) & 0xFFFFFFFF
    n = w.shape[0]
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(n, 16)
    # two zero guard limbs: the top window of a 255-bit field starts at bit
    # 256 and reads limbs 16 and 17
    limbs = torch.cat([limbs, torch.zeros_like(limbs[:, :2])], dim=1)
    nw = n_windows_for(Fr, c)
    off = torch.arange(nw, device=w.device) * c
    li, sh = off // 16, off % 16
    raw = ((limbs[:, li] | (limbs[:, li + 1] << 16)) >> sh) & ((1 << c) - 1)
    half, full = 1 << (c - 1), 1 << c
    ds = []
    carry = torch.zeros(n, dtype=torch.int64, device=w.device)
    for i in range(nw):
        d = raw[:, i] + carry
        over = d >= half
        ds.append(torch.where(over, d - full, d))
        carry = over.to(torch.int64)
    ds = torch.stack(ds)
    return ds.abs().to(torch.int32), ds < 0


def point_tree_sum(curve: Curve, pts, dim: int = 0):
    """Sum points along `dim` via log-depth pairwise adds (kernel B)."""
    pts = pts.movedim(dim, 0)
    while pts.shape[0] > 1:
        n = pts.shape[0]
        if n % 2:
            pts = torch.cat([pts, curve.identity(
                (1,) + tuple(pts.shape[1:-2]), pts.device)], dim=0)
            n += 1
        pts = curve.add(pts[: n // 2], pts[n // 2:])
    return pts[0]


def point_prefix_sum(curve: Curve, pts):
    """Inclusive prefix sums along dim 0 (Hillis-Steele: log2 levels of
    kernel B over contiguous slices)."""
    d = 1
    while d < pts.shape[0]:
        pts = torch.cat([pts[:d], curve.add(pts[d:], pts[:-d])])
        d *= 2
    return pts


def weighted_bucket_fold(curve: Curve, buckets):
    """sum_{j >= 1} j B_j for buckets (nb, ..., 3, 8), batched over the
    middle dims.  Small spaces: two suffix sums (W(x) = suffix(suffix(x))[0]
    = sum (i+1) x_i); large spaces split j - 1 = Q h + l on an (H, Q) grid:
    Q (W(R) - S(R)) + W(C)."""
    dev = buckets.device

    def suffix(arr):
        k = arr.shape[0]
        ident = curve.identity((1,), dev)
        d = 1
        while True:
            shifted = torch.cat([arr[d:], ident.expand((min(d, k),) +
                                                       tuple(arr.shape[1:]))],
                                dim=0)[:k]
            arr = curve.add(arr, shifted)
            d *= 2
            if d >= k:
                return arr

    def W(arr):
        return suffix(suffix(arr))[0]

    b = buckets[1:]
    m = b.shape[0]
    if m <= 256:
        return W(b)
    qbits = m.bit_length() // 2
    Q = 1 << qbits
    H = -(-m // Q)
    if H * Q != m:
        b = torch.cat([b, curve.identity((H * Q - m,) + tuple(b.shape[1:-2]),
                                         dev)], dim=0)
    grid = b.reshape((H, Q) + tuple(b.shape[1:]))
    R = point_tree_sum(curve, grid, 1)
    C = point_tree_sum(curve, grid, 0)
    SR = point_tree_sum(curve, R, 0)
    acc = curve.add(W(R), curve.neg(SR))
    for _ in range(qbits):
        acc = curve.double(acc)
    return curve.add(acc, W(C))


def horner_windows_plain(curve: Curve, per_window, c: int):
    """Plain version of the Horner chain: sum_w per_window[w] 2^(c w) for
    (nw, ..., 3, 8), high window first, from the identity: c doublings and
    one add per window (kernel B's plain versions)."""
    acc = curve.identity(tuple(per_window.shape[1:-2]), per_window.device)
    for w in range(per_window.shape[0] - 1, -1, -1):
        for _ in range(c):
            acc = ec_double_plain(curve, acc)
        acc = ec_add_plain(curve, acc, per_window[w])
    return acc


def horner_windows(curve: Curve, per_window, c: int):
    """sum_w per_window[w] 2^(c w) for (nw, ..., 3, 8): on the card one
    launch of kernel B's Horner chain (csrc/ec.cu), the same doublings and
    adds in the same order as `horner_windows_plain`."""
    if per_window.device.type == "cpu":
        return horner_windows_plain(curve, per_window, c)
    check_words(per_window)
    nw = per_window.shape[0]
    per_window = per_window.contiguous()
    out = torch.empty(per_window.shape[1:], dtype=torch.int32,
                      device=per_window.device)
    _horner_kernel.launch(curve.kernel_id, per_window.data_ptr(), nw, c,
                          out.data_ptr(), out.numel() // (3 * NWORDS),
                          stream_of(out))
    return out


# ----------------------------------------------------------------------
# kernel 9: one segmented-scan level
# ----------------------------------------------------------------------

def pack_affine_rows(aff_xy, inf):
    """(n, 2, 8) affine words + (n,) bool -> (n, 18) int32 rows
    [x words | y words | infinity flag | pad]."""
    n = aff_xy.shape[0]
    flag = inf.to(torch.int32).reshape(n, 1)
    return torch.cat([aff_xy.reshape(n, 2 * NWORDS), flag,
                      torch.zeros_like(flag)], dim=1)


def affine_rows(curve: Curve, points):
    """(m, 3, 8) projective points -> (m, 18) affine rows: one batched
    normalisation and the packing."""
    return pack_affine_rows(curve.batch_normalize(points),
                            curve.is_identity(points))


def scan_level_plain(curve: Curve, keys, pts, block: int, mode: int):
    """Plain version of kernel 9.  keys (M,) int32 non-decreasing, M a
    multiple of block; pts (M, 18) affine rows (AFFINE / PACKED) or (M, 3, 8)
    projective points.  In PACKED mode a key is 2 * bucket + sign and y is
    negated on odd keys.  Returns (finals (M / block, 3, 8), lane_keys
    (M / block,)): the running sum of each lane's last run piece, and its
    (bucket) key."""
    M = keys.shape[0]
    nb = M // block
    dev = keys.device
    F = curve.Fq
    k = keys.reshape(nb, block).to(torch.int64)
    neg = None
    if mode == PACKED:
        neg = (k & 1).bool()
        k = k >> 1
    one = F.ones((nb,), dev)
    zero = torch.zeros_like(one)
    acc = curve.identity((nb,), dev)
    seg = torch.full((nb,), -2, dtype=torch.int64, device=dev)
    if mode == PROJECTIVE:
        stream = pts.reshape(nb, block, 3, NWORDS)
    else:
        stream = pts.reshape(nb, block, ROW_WORDS)
    for t in range(block):
        fresh = (k[:, t] != seg)[:, None, None]
        if mode == PROJECTIVE:
            p = stream[:, t]
            acc = torch.where(fresh, p, ec_add_plain(curve, acc, p))
        else:
            rows = stream[:, t]
            x, y = rows[:, :NWORDS], rows[:, NWORDS:2 * NWORDS]
            inf = (rows[:, 2 * NWORDS] & 1) != 0
            if neg is not None:
                y = torch.where(neg[:, t, None],
                                binop_plain(F, SUB, zero, y), y)
            i2 = inf[:, None]
            started = torch.stack([torch.where(i2, zero, x),
                                   torch.where(i2, one, y),
                                   torch.where(i2, zero, one)], dim=-2)
            added = ec_madd_plain(curve, acc, torch.stack([x, y], dim=-2),
                                  inf)
            acc = torch.where(fresh, started, added)
        seg = k[:, t]
    return acc, seg.to(torch.int32)


def scan_level(curve: Curve, keys, pts, block: int, mode: int):
    """One segmented-scan level (kernel 9 on CUDA tensors); see
    `scan_level_plain` for the contract."""
    if keys.device.type == "cpu":
        return scan_level_plain(curve, keys, pts, block, mode)
    M = keys.shape[0]
    nb = M // block
    width = (3, NWORDS) if mode == PROJECTIVE else (ROW_WORDS,)
    if keys.device.type != "cuda" or pts.device != keys.device:
        raise ValueError(f"scan on unsupported devices {keys.device}, "
                         f"{pts.device}")
    if keys.dtype != torch.int32 or pts.dtype != torch.int32 or \
            nb * block != M or tuple(pts.shape) != (M,) + width:
        raise ValueError(f"scan needs int32 keys (M,) with M a multiple of "
                         f"{block} and points (M, {width}), got "
                         f"{keys.dtype} {tuple(keys.shape)}, {pts.dtype} "
                         f"{tuple(pts.shape)}")
    keys = keys.contiguous()
    pts = pts.contiguous()
    finals = torch.empty((nb, 3, NWORDS), dtype=torch.int32,
                         device=keys.device)
    lane_keys = torch.empty((nb,), dtype=torch.int32, device=keys.device)
    _scan_kernel.launch(curve.kernel_id, mode, keys.data_ptr(),
                        pts.data_ptr(), finals.data_ptr(),
                        lane_keys.data_ptr(), block, nb, stream_of(finals))
    return finals, lane_keys


def block_for(m: int, device) -> int:
    """The block of a scan level over m elements on `device`: lanes enough
    to fill one wave of kernel 9 on the card (SCAN_LANES) or the plain
    version's python-int batch on the CPU (cuda_ops.INT_POINTS), within
    [MIN_BLOCK, MAX_BLOCK]."""
    lanes = SCAN_LANES if torch.device(device).type == "cuda" else \
        max(1, cuda_ops.INT_POINTS)
    return max(MIN_BLOCK, min(MAX_BLOCK, -(-m // lanes)))


# ----------------------------------------------------------------------
# bucket reduction: sorted (key, point) stream -> per-key sums
# ----------------------------------------------------------------------

def _pieces(curve: Curve, keys, pts, inf, block: int, n_keys: int,
            affine: bool, packed: bool, whole: bool):
    """For each key k < n_keys, the sum of a piece of its run: the trailing
    elements that do not end on a lane boundary (whole=False, the tails), or
    the whole run (whole=True, for a stream of at most `block` elements).
    Each key's piece fills one gathered lane of `block` elements, summed by
    one scan level.  Returns (n_keys, 3, 8)."""
    M = keys.shape[0]
    dev = keys.device
    seg_keys = ((keys >> 1) if packed else keys).to(torch.int64)
    s = torch.searchsorted(seg_keys, torch.arange(n_keys + 1, device=dev))
    start, end = s[:-1], s[1:]
    if whole:
        a, take = start, end - start
    else:
        lane_start = torch.div(end - 1, block, rounding_mode="floor") * block
        a = torch.maximum(start, lane_start)
        take = torch.where((end > start) & (end % block != 0), end - a, 0)
    cols = torch.arange(block, device=dev)
    valid = (cols[None, :] < take[:, None]).reshape(-1)
    pos = (a[:, None] + cols[None, :]).clamp(0, M - 1).reshape(-1)
    lane_keys = torch.arange(n_keys, dtype=torch.int32,
                             device=dev).repeat_interleave(block)
    if affine:
        rows = pts[pos].clone()
        rows[:, 2 * NWORDS] = (~valid | inf[pos]).to(torch.int32)
        if packed:
            return scan_level(curve, lane_keys * 2 + (keys[pos] & 1), rows,
                              block, PACKED)[0]
        return scan_level(curve, lane_keys, rows, block, AFFINE)[0]
    g = torch.where((~valid | inf[pos])[:, None, None],
                    curve.identity((1,), dev), pts[pos])
    return scan_level(curve, lane_keys, g, block, PROJECTIVE)[0]


def bucket_sums(curve: Curve, keys, rows, n_keys: int, block: int = None,
                packed: bool = False):
    """Sum points grouped by key.  keys (M,) int32 sorted non-decreasing:
    bucket ids in [0, n_keys), or (packed) 2 * bucket + sign with the
    negation applied in the scan.  rows (M, 18) affine rows.  block: every
    level's, or None for `block_for` per level.  Returns (n_keys, 3, 8)
    projective bucket sums."""
    dev = keys.device
    total = curve.identity((n_keys,), dev)
    pts = rows
    inf = (rows[:, 2 * NWORDS] & 1) != 0
    affine = True
    while keys.shape[0] > (blk := block or block_for(keys.shape[0], dev)):
        pad = (-keys.shape[0]) % blk
        if pad:
            keys = torch.cat([keys, keys.new_full((pad,), SENTINEL_KEY)])
            fill = pack_affine_rows(curve.Fq.zeros((pad, 2), dev),
                                    torch.ones(pad, dtype=torch.bool,
                                               device=dev)) \
                if affine else curve.identity((pad,), dev)
            pts = torch.cat([pts, fill])
            inf = torch.cat([inf, inf.new_ones(pad)])
        tails = _pieces(curve, keys, pts, inf, blk, n_keys, affine, packed,
                        whole=False)
        total = curve.add(total, tails)
        mode = (PACKED if packed else AFFINE) if affine else PROJECTIVE
        pts, keys = scan_level(curve, keys, pts, blk, mode)
        inf = curve.is_identity(pts) | (keys >= n_keys) | (keys < 0)
        affine = packed = False
    rest = _pieces(curve, keys, pts, inf, keys.shape[0], n_keys, affine,
                   packed, whole=True)
    return curve.add(total, rest)


# ----------------------------------------------------------------------
# the sorted MSMs: one stable sort by bucket key, a gather of the rows,
# the segmented scan, the weighted fold
# ----------------------------------------------------------------------

def unpack_affine_rows(rows):
    """(M, 18) rows -> ((M, 16) x and y words, (M,) infinity mask)."""
    return rows[:, :2 * NWORDS], (rows[:, 2 * NWORDS] & 1) != 0


def sort_perm(keys):
    """(keys sorted, permutation) of (M,) keys by one stable sort, as the
    reference's `lax.sort`; the permutation is an int64 gather index."""
    keys_s, perm = torch.sort(keys.to(torch.int64), stable=True)
    return keys_s.to(keys.dtype), perm


def packed_digits(curve: Curve, scalars_mont, c: int):
    """(n, 8) scalars -> (nw, n) int32 keys |d| * 2 + sign of the balanced
    base-2^c digits: the sign rides in the key's low bit through the sort
    and kernel 9 negates y on odd keys."""
    keys, signs = _signed_digits(curve.Fr, scalars_mont, c)
    return keys * 2 + signs.to(torch.int32)


def msm_packed_rows(curve: Curve, packed_keys, rows, c: int,
                    block: int = None):
    """One sort and one segmented scan over (key, row) pairs that share one
    space of 2^(c-1)+1 buckets, then the weighted fold.  packed_keys: any
    shape, M keys in all; rows (M, 18) affine rows of a baked table, the
    window factor 2^(c w) already in them, so any subset of windows reduces
    on its own and the partial results add (`CachedMSM`'s window chunks)."""
    keys_s, perm = sort_perm(packed_keys.reshape(-1))
    buckets = bucket_sums(curve, keys_s, rows[perm], (1 << (c - 1)) + 1,
                          block, packed=True)
    return weighted_bucket_fold(curve, buckets)


def msm_windowed_cached(curve: Curve, scalars_mont, rows, c: int = 13,
                        block: int = None):
    """Fixed-base MSM of (n, 8) scalars against a baked table of
    (nw n_max, 18) rows, row w n_max + i = [2^(c w)] P_i (n <= n_max: the
    first n bases of every window)."""
    n = scalars_mont.shape[0]
    nw = n_windows_for(curve.Fr, c)
    n_max = rows.shape[0] // nw
    if n != n_max:
        rows = rows.reshape(nw, n_max, ROW_WORDS)[:, :n].reshape(
            -1, ROW_WORDS)
    return msm_packed_rows(curve, packed_digits(curve, scalars_mont, c),
                           rows, c, block)


def msm_unbaked_rows(curve: Curve, packed_keys, base_rows, c: int,
                     block: int = None):
    """MSM of wc consecutive windows against unbaked rows: packed_keys
    (wc, n) |d| * 2 + sign, base_rows (n, 18) (the window factor not
    applied).  Each window's bucket space is tagged into one key stream,
    one sort and one scan reduce them all (the gather reads row
    perm % n), then a weighted fold per window and the Horner combine with
    c doublings per window (kernel B's chain).  Returns
    sum_{i < wc} fold_i 2^(c i); the caller scales a chunk by 2^(c w0)."""
    wc, n = packed_keys.shape
    nb = (1 << (c - 1)) + 1
    window = torch.arange(wc, dtype=torch.int32,
                          device=packed_keys.device)[:, None]
    keys = ((packed_keys >> 1) + window * nb) * 2 + (packed_keys & 1)
    keys_s, perm = sort_perm(keys.reshape(-1))
    buckets = bucket_sums(curve, keys_s, base_rows[perm % n], wc * nb,
                          block, packed=True)
    per_window = weighted_bucket_fold(
        curve, buckets.reshape(wc, nb, 3, NWORDS).transpose(0, 1))
    return horner_windows(curve, per_window, c)


def shift_add(curve: Curve, acc, k_doublings: int, part):
    """acc 2^k_doublings + part, the chunk combine of an unbaked
    `CachedMSM`: one launch of kernel B's Horner chain over (part, acc),
    whose first k doublings are of the identity."""
    return horner_windows(curve, torch.stack([part, acc]), k_doublings)


def msm_variable(curve: Curve, scalars_mont, points, c: int = 8,
                 block: int = None):
    """Variable-base MSM (the general `best_multiexp`): the points packed
    as affine rows once, then `msm_unbaked_rows` over every window (block:
    every scan level's, or None for `block_for`)."""
    return msm_unbaked_rows(curve, packed_digits(curve, scalars_mont, c),
                            affine_rows(curve, points), c, block)
