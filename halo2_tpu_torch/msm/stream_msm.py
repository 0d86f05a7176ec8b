"""Fixed-base MSM over a table of affine rows, around the ordering pass and
kernels D and 8 (csrc/msm.cu).

Port of the JAX reference's msm/stream_msm.py.  Rows are affine points
packed as 18 words (8 x words, 8 y words, infinity flag, pad), row-major.
Two tables:

- BAKED (nw n <= MAX_BAKED_ROWS, k <= 18): row w n + i holds [2^(c w)] P_i,
  so every window shares one space of 32 nonzero buckets (kernel D).
- UNBAKED (k >= 19): the n bases once (75 MB at k = 20 instead of a 3.2 GB
  baked table); the key space is (window, bucket), and a Horner combine with
  STREAM_C doublings per window ends the MSM (kernel 8).

An MSM runs four steps:

1. signed digits: keys (nw, n) int32 |d| * 2 + sign;
2. the ordering pass (`msm_order`): a counting sort of the elements by
   bucket key, zero digits dropped (bucket 0 has weight 0), and the split of
   every key's run into pieces of at most P = ceil(T / pieces) elements (T
   nonzero elements, `pieces` threads wanted);
3. the accumulate pass (kernel D or 8, `stream_bucket` /
   `stream_bucket_windows`): each piece's sum by mixed adds, one projective
   partial sum per piece, a key's pieces side by side;
4. the bucket sums (`key_sums`): a prefix sum over the partial sums
   (kernel B) read at each key's first and last piece, then the weighted
   bucket fold (per window and Horner when unbaked).

The result is an exact group element, so it does not depend on the table,
the split or `pieces`; the contract is
`StreamMSM(points)(s) == naive_msm(s, points)`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._build import I32, P, Kernel, library, stream_of
from ..curves.cuda_ec import ec_madd_plain
from ..curves.curve import Curve
from ..fields.cuda_ops import NWORDS, SUB, binop_plain
from .bucket_scan import (ROW_WORDS, affine_rows, horner_windows,
                          n_windows_for, packed_digits, point_prefix_sum,
                          weighted_bucket_fold)

STREAM_C = 6                       # window width: 43 windows, 33 buckets
N_BUCKETS = (1 << (STREAM_C - 1)) + 1
NB = N_BUCKETS - 1                 # nonzero buckets per window
ORDER_CHUNK = 8192                 # keys per warp of the ordering pass (msm.cu)
TARGET_STEPS = 64                  # elements per piece for small MSMs
KEY_SUMS_TILE = 64                 # slots per row of key_sums' prefix tile
MAX_PIECES = 1 << 16               # pieces of a large MSM off the card
MAX_BAKED_ROWS = 1 << 24           # nw * n; k = 18 at c = 6 is 11.3M rows
BAKE_CHUNK_ROWS = 1 << 22          # table rows made per normalization

_order_kernel = Kernel("h2_msm_order", [I32, P, I32, I32, P, P, P, I32, P])
_bucket_kernel = Kernel("h2_stream_bucket", [I32, P, P, P, I32, P, I32, P])
_windows_kernel = Kernel("h2_stream_bucket_windows",
                         [I32, P, P, P, I32, P, I32, P])


@functools.lru_cache(maxsize=None)
def occupancy(curve_id: int, per_window: bool) -> dict:
    """The accumulate pass as the card runs it: resident blocks per SM,
    registers and local (spill) bytes per thread, threads and shared bytes
    per block (`h2_stream_occupancy`)."""
    out = (ctypes.c_int * 5)()
    fn = library().h2_stream_occupancy
    fn.argtypes = [I32, I32, P]
    fn.restype = ctypes.c_int
    if fn(int(per_window), curve_id, ctypes.addressof(out)) != 0:
        raise RuntimeError("h2_stream_occupancy failed")
    return dict(blocks_per_sm=out[0], registers=out[1], local_bytes=out[2],
                threads=out[3], shared_bytes=out[4])


def pieces_for(curve: Curve, elements: int, nkeys: int, device) -> int:
    """Pieces wanted from the split of `elements` (window, base) pairs over
    nkeys keys: about TARGET_STEPS elements each for small MSMs; for large
    ones on the card, one wave of resident threads less nkeys, since the
    split adds at most one piece per key (MAX_PIECES off the card)."""
    cap = MAX_PIECES
    if torch.device(device).type == "cuda":
        occ = occupancy(curve.kernel_id, False)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        cap = occ["blocks_per_sm"] * occ["threads"] * sms - nkeys
    return max(32, min(cap, -(-elements // TARGET_STEPS)))


def bake_stream_table(curve: Curve, points):
    """Rows w n + i = [2^(c w)] P_i for every window w (c = STREAM_C),
    affine and packed, built a group of windows at a time to bound the
    projective and normalization transient.  Returns (nw n, 18)."""
    c = STREAM_C
    n = points.shape[0]
    nw = n_windows_for(curve.Fr, c)
    wc = max(1, min(nw, BAKE_CHUNK_ROWS // max(n, 1)))
    out = []
    cur = points
    for w0 in range(0, nw, wc):
        group = []
        for w in range(w0, min(w0 + wc, nw)):
            group.append(cur)
            if w < nw - 1:
                for _ in range(c):
                    cur = curve.double(cur)
        pts = torch.cat(group, dim=0)
        out.append(affine_rows(curve, pts))
    return torch.cat(out, dim=0)


def pack_base_stream_table(curve: Curve, points):
    """The unbaked table: the n bases once, affine and packed (window factor
    not applied).  Returns (n, 18)."""
    return affine_rows(curve, points)


def stream_keys(curve: Curve, scalars_mont):
    """(n, 8) scalars -> (nw, n) int32 keys |d| * 2 + sign of the balanced
    base-2^c digits."""
    return packed_digits(curve, scalars_mont, STREAM_C).contiguous()


# ----------------------------------------------------------------------
# the ordering pass
# ----------------------------------------------------------------------

def n_keys(keys, per_window: bool) -> int:
    """Keys of the bucket space: 32 per window (kernel 8) or 32 (kernel
    D)."""
    return NB * keys.shape[0] if per_window else NB


def msm_order_plain(keys, per_window: bool, pieces: int):
    """Plain version of the ordering pass.  keys (W, n) int32 |d| * 2 +
    sign.  Returns (order (W n,) int32, info int32): order's first T entries
    are row * 2 + sign of the nonzero elements, stable by key (bucket - 1,
    or window * 32 + bucket - 1 when per_window) and then by element (w, i);
    row = i when per_window, else w n + i.  info = [T, P, NS, 0] +
    key_start (nkeys + 1) + seg_base (nkeys + 1): key k's run starts at
    key_start[k] and is cut into ceil(count / P) pieces from seg_base[k] on,
    P = max(1, ceil(T / pieces)), NS pieces in all."""
    W, n = keys.shape
    dev = keys.device
    k = keys.reshape(-1).to(torch.int64)
    b = k >> 1
    w = torch.arange(W, device=dev).repeat_interleave(n)
    i = torch.arange(n, device=dev).repeat(W)
    key = (w * NB + b - 1) if per_window else (b - 1)
    row = i if per_window else w * n + i
    live = b != 0
    key, packed = key[live], (row * 2 + (k & 1))[live]
    nkeys = n_keys(keys, per_window)
    perm = torch.sort(key, stable=True)[1]
    order = torch.zeros(W * n, dtype=torch.int32, device=dev)
    order[:packed.shape[0]] = packed[perm].to(torch.int32)
    counts = torch.bincount(key, minlength=nkeys)
    zero = counts.new_zeros(1)
    key_start = torch.cat([zero, torch.cumsum(counts, 0)])
    total = int(key_start[-1])
    step = max(1, -(-total // pieces))
    seg_base = torch.cat([zero, torch.cumsum(-(-counts // step), 0)])
    head = torch.tensor([total, step, int(seg_base[-1]), 0], device=dev)
    return order, torch.cat([head, key_start, seg_base]).to(torch.int32)


def msm_order(keys, per_window: bool, pieces: int):
    """The ordering pass (`h2_msm_order` on CUDA tensors); see
    `msm_order_plain` for the contract.  Past T the order is not written on
    the card."""
    if keys.device.type == "cpu":
        return msm_order_plain(keys, per_window, pieces)
    if keys.device.type != "cuda" or keys.dtype != torch.int32 or \
            keys.dim() != 2 or not keys.is_contiguous():
        raise ValueError(f"ordering pass needs contiguous (W, n) int32 keys "
                         f"on a CUDA device, got {keys.dtype} "
                         f"{tuple(keys.shape)} on {keys.device}")
    W, n = keys.shape
    nkeys = n_keys(keys, per_window)
    chunks = W * -(-n // ORDER_CHUNK)
    hist = torch.empty(NB * chunks, dtype=torch.int32, device=keys.device)
    order = torch.empty(W * n, dtype=torch.int32, device=keys.device)
    info = torch.empty(6 + 2 * nkeys, dtype=torch.int32, device=keys.device)
    _order_kernel.launch(int(per_window), keys.data_ptr(), W, n,
                         hist.data_ptr(), order.data_ptr(), info.data_ptr(),
                         pieces, stream_of(info))
    return order, info


# ----------------------------------------------------------------------
# the accumulate pass: kernels D and 8
# ----------------------------------------------------------------------

def slots_for(pieces: int, nkeys: int) -> int:
    """Partial sums an accumulate pass writes: NS <= pieces + nkeys."""
    return pieces + nkeys


def accumulate_plain(curve: Curve, order, table, info, nkeys: int,
                     slots: int):
    """Plain version of kernels D and 8: piece g < NS of the split in info
    sums its run of the ordered list by mixed adds from the identity, in
    order (y negated on an odd entry).  table (R, 18) rows.  Returns
    (slots, 3, 8) partial sums: piece g's sum, the identity past NS."""
    dev = order.device
    step, ns = int(info[1]), int(info[2])
    key_start = info[4:5 + nkeys].to(torch.int64)
    seg_base = info[5 + nkeys:].to(torch.int64)
    g = torch.arange(ns, device=dev)
    key = torch.searchsorted(seg_base, g, right=True) - 1
    begin = key_start[key] + (g - seg_base[key]) * step
    end = torch.minimum(begin + step, key_start[key + 1])
    acc = curve.identity((ns,), dev)
    zero = curve.Fq.zeros((ns,), dev)
    for j in range(step if ns else 0):
        q = begin + j
        live = q < end
        v = order[torch.where(live, q, begin)].to(torch.int64)
        rows = table[v >> 1]
        x, y = rows[:, :NWORDS], rows[:, NWORDS:2 * NWORDS]
        y = torch.where((v & 1).bool()[:, None],
                        binop_plain(curve.Fq, SUB, zero, y), y)
        inf = ((rows[:, 2 * NWORDS] & 1) != 0) | ~live
        acc = ec_madd_plain(curve, acc, torch.stack([x, y], dim=1), inf)
    partials = curve.identity((slots,), dev)
    partials[:ns] = acc
    return partials


def _accumulate(kernel, curve: Curve, order, table, info, nkeys: int,
                slots: int):
    if order.device.type == "cpu":
        return accumulate_plain(curve, order, table, info, nkeys, slots)
    if order.device.type != "cuda" or table.device != order.device or \
            info.device != order.device:
        raise ValueError(f"accumulate pass on unsupported devices "
                         f"{order.device}, {table.device}, {info.device}")
    if table.dtype != torch.int32 or table.dim() != 2 or \
            table.shape[1] != ROW_WORDS or not table.is_contiguous() or \
            info.shape != (6 + 2 * nkeys,):
        raise ValueError(f"accumulate pass needs a contiguous int32 table "
                         f"(R, 18) and info of {6 + 2 * nkeys} words, got "
                         f"{tuple(table.shape)}, {tuple(info.shape)}")
    partials = torch.empty((slots, 3, NWORDS), dtype=torch.int32,
                           device=order.device)
    kernel.launch(curve.kernel_id, order.data_ptr(), table.data_ptr(),
                  info.data_ptr(), nkeys, partials.data_ptr(), slots,
                  stream_of(partials))
    return partials


def stream_bucket(curve: Curve, order, table, info, slots: int):
    """Kernel D (baked table, 32 keys) on CUDA tensors; see
    `accumulate_plain`."""
    return _accumulate(_bucket_kernel, curve, order, table, info, NB, slots)


def stream_bucket_windows(curve: Curve, order, table, info, nkeys: int,
                          slots: int):
    """Kernel 8 (unbaked table, 32 keys per window) on CUDA tensors; see
    `accumulate_plain`."""
    return _accumulate(_windows_kernel, curve, order, table, info, nkeys,
                       slots)


# ----------------------------------------------------------------------
# the MSMs
# ----------------------------------------------------------------------

def key_sums(curve: Curve, partials, info, nkeys: int):
    """Per-key sums (nkeys, 3, 8) of an accumulate pass's partial sums,
    key k's pieces being slots [seg_base[k], seg_base[k + 1]): E[end] -
    E[start], E the exclusive prefix sum over the slots.  Slot s = r B + c
    of a (B, rows) tile (B = KEY_SUMS_TILE): E[s] = (rows before r) + (the
    row's slots before c), from a prefix down each column (log2 B levels
    over all slots) and one over the row totals (log2(rows) small levels),
    all on contiguous slices: about 40 launches.  Fixed shapes and no host
    read of the split, so it runs behind the kernels."""
    B = KEY_SUMS_TILE
    slots = partials.shape[0]
    rows = slots // B + 1                  # rows B > slots: E[slots] exists
    dev = partials.device
    tile = torch.cat([partials, curve.identity((rows * B - slots,), dev)])
    tile = point_prefix_sum(curve, tile.reshape(rows, B, 3, NWORDS).transpose(
        0, 1).contiguous())                 # [c, r]: slots r B .. r B + c
    ident = curve.identity((1,), dev)
    before_row = torch.cat([ident, point_prefix_sum(curve, tile[-1])])
    s = info[5 + nkeys:].to(torch.int64)
    r, c = s // B, s % B
    in_row = torch.where((c == 0)[:, None, None], ident,
                         tile[(c - 1).clamp(min=0), r])
    e = curve.add(before_row[r], in_row)
    return curve.add(e[1:], curve.neg(e[:-1]))


def stream_buckets(curve: Curve, keys, table, per_window: bool):
    """Bucket sums (nkeys, 3, 8) of keys against a table: the ordering pass,
    kernel D or 8, and the per-key sums of its partial sums.  Adds the
    elements to the stream counters."""
    W, n = keys.shape
    nkeys = n_keys(keys, per_window)
    pieces = pieces_for(curve, W * n, nkeys, keys.device)
    slots = slots_for(pieces, nkeys)
    order, info = msm_order(keys, per_window, pieces)
    if per_window:
        partials = stream_bucket_windows(curve, order, table, info, nkeys,
                                         slots)
    else:
        partials = stream_bucket(curve, order, table, info, slots)
    _TOTALS["streamed"] += W * n
    added = _TOTALS["added"]
    added[info.device] = added.get(info.device, 0) + info[0].to(torch.int64)
    return key_sums(curve, partials, info, nkeys)


def with_bucket_0(curve: Curve, sums):
    """(..., 32, 3, 8) nonzero bucket sums -> (..., 33, 3, 8) with the
    identity for bucket 0 (weight 0) in front."""
    ident = curve.identity(tuple(sums.shape[:-3]) + (1,), sums.device)
    return torch.cat([ident, sums], dim=-3)


def msm_stream_baked(curve: Curve, scalars_mont, table):
    """Fixed-base MSM against a baked table."""
    sums = stream_buckets(curve, stream_keys(curve, scalars_mont), table,
                          False)
    return weighted_bucket_fold(curve, with_bucket_0(curve, sums))


def msm_stream_unbaked(curve: Curve, scalars_mont, table):
    """Fixed-base MSM against an unbaked table: per-window bucket sums, a
    weighted fold per window and a Horner combine over windows."""
    keys = stream_keys(curve, scalars_mont)
    sums = stream_buckets(curve, keys, table, True)
    per_window = weighted_bucket_fold(curve, with_bucket_0(
        curve, sums.reshape(keys.shape[0], NB, 3, NWORDS)).transpose(0, 1))
    return horner_windows(curve, per_window, STREAM_C)


# (window, base) elements of every fixed-base MSM since
# reset_stream_counters(): streamed, and added (nonzero digit) per device, a
# count held on that device until read.
_TOTALS = dict(streamed=0, added={})


def stream_counters() -> dict:
    """Elements streamed and added by every fixed-base MSM since the last
    reset_stream_counters()."""
    return dict(streamed=_TOTALS["streamed"],
                added=sum(int(t) for t in _TOTALS["added"].values()))


def reset_stream_counters():
    _TOTALS["streamed"] = 0
    _TOTALS["added"].clear()


def auto_c_stream(n: int) -> int:
    """The stream MSM's window width for n bases: STREAM_C at every n, the
    width kernels D and 8 are built for (32 nonzero buckets a window).  The
    reference's narrower width below 2^10 bases and its environment
    override have no counterpart."""
    return STREAM_C


class StreamMSM:
    """Fixed-base MSM descriptor: the table of `points` (n, 3, 8), built
    once (baked while nw n <= MAX_BAKED_ROWS, else unbaked); calling it
    with (m <= n, 8) scalars returns one projective point (3, 8)."""

    def __init__(self, curve: Curve, points):
        self.curve = curve
        self.n = n = points.shape[0]
        nw = n_windows_for(curve.Fr, STREAM_C)
        self.baked = nw * n <= MAX_BAKED_ROWS
        if self.baked:
            self.table = bake_stream_table(curve, points)
        else:
            self.table = pack_base_stream_table(curve, points)

    @property
    def wbases(self):
        """The table (rows, 18)."""
        return self.table

    def __call__(self, scalars_mont):
        m = scalars_mont.shape[0]
        if m > self.n:
            raise ValueError(f"{m} scalars for {self.n} bases")
        if m != self.n:
            scalars_mont = torch.cat([scalars_mont, scalars_mont.new_zeros(
                (self.n - m, NWORDS))], dim=0)
        run = msm_stream_baked if self.baked else msm_stream_unbaked
        return run(self.curve, scalars_mont, self.table)
