"""Fixed-base MSM over a stream table, around kernels D and 8 (csrc/msm.cu).

Port of the JAX reference's msm/stream_msm.py.  Rows are affine points
packed as 18 words (8 x words, 8 y words, infinity flag, pad) and laid out
(S, 18, lanes) so that lane j streams rows j, j + lanes, ... .  Two tables:

- BAKED (nw n <= MAX_BAKED_ROWS, k <= 18): [2^(c w)] P_i for every window w
  and base i, all windows sharing one bucket space.  Kernel D accumulates
  every lane's private buckets; the cross-lane tree sum and the weighted
  bucket fold run here over kernel B.
- UNBAKED (k >= 19): the n bases once (75 MB at k = 20 instead of a 3.2 GB
  baked table).  Kernel 8 walks the table once per window against that
  window's digits, into per-window buckets; then a tree sum over lanes, a
  weighted fold per window and a Horner combine with STREAM_C doublings
  per window.

The result is an exact group element, so it does not depend on the table,
the window width or `lanes`; the contract is
`StreamMSM(points)(s) == naive_msm(s, points)`.
"""

from __future__ import annotations

import torch

from .._build import I32, P, Kernel, stream_of
from ..curves.cuda_ec import ec_madd_plain
from ..curves.curve import Curve
from ..fields.cuda_ops import NWORDS, SUB, binop_plain
from .bucket_scan import (ROW_WORDS, _signed_digits, horner_windows,
                          n_windows_for, pack_affine_rows,
                          weighted_bucket_fold)
from .msm import point_tree_sum

STREAM_C = 6                       # window width: 43 windows, 33 buckets
N_BUCKETS = (1 << (STREAM_C - 1)) + 1
MAX_LANES = 1 << 16                # ~2 resident waves of threads on 132 SMs
TARGET_STEPS = 64                  # stream rows per lane when lanes < max
MAX_BAKED_ROWS = 1 << 24           # nw * n; k = 18 at c = 6 is 11.3M rows
BAKE_CHUNK_ROWS = 1 << 22          # table rows made per normalization

_bucket_kernel = Kernel("h2_stream_bucket", [I32, P, P, P, I32, I32, I32, P])
_windows_kernel = Kernel("h2_stream_bucket_windows",
                         [I32, P, P, P, I32, I32, I32, I32, P])


def lanes_for(rows: int) -> int:
    """Lanes for a stream of `rows`: enough lanes to fill the card at
    k = 18 (MAX_LANES), fewer for short streams so each lane still walks
    about TARGET_STEPS rows."""
    want = max(32, -(-rows // TARGET_STEPS))
    return min(MAX_LANES, 1 << (want - 1).bit_length())


def unbaked_lanes(n: int, nw: int) -> int:
    """Lanes of an unbaked table: nw windows x lanes threads near one wave
    (MAX_LANES; 43 x 1,024 at k = 20), fewer for short tables so each lane
    still walks about TARGET_STEPS rows."""
    cap = 1 << ((MAX_LANES // nw).bit_length() - 1)
    want = max(32, -(-n // TARGET_STEPS))
    return min(cap, 1 << (want - 1).bit_length())


def _pad_rows(rows, lanes: int):
    """Pad (S, 18) rows to a multiple of lanes with identity rows."""
    pad = (-rows.shape[0]) % lanes
    if pad:
        extra = torch.zeros((pad, ROW_WORDS), dtype=torch.int32,
                            device=rows.device)
        extra[:, 2 * NWORDS] = 1
        rows = torch.cat([rows, extra], dim=0)
    return rows


def to_stream_layout(rows, lanes: int):
    """(S * lanes, 18) -> (S, 18, lanes)."""
    return rows.reshape(-1, lanes, ROW_WORDS).transpose(1, 2).contiguous()


def bake_stream_table(curve: Curve, points, lanes: int):
    """[2^(c w)] P_i for every window w (c = STREAM_C), affine, packed and
    laid out for streaming.  Built a group of windows at a time to bound
    the projective and normalization transient.  Returns (S, 18, lanes)."""
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
        out.append(pack_affine_rows(curve.batch_normalize(pts),
                                    curve.is_identity(pts)))
    return to_stream_layout(_pad_rows(torch.cat(out, dim=0), lanes), lanes)


def pack_base_stream_table(curve: Curve, points, lanes: int):
    """The unbaked table: the n bases once, affine, packed and laid out for
    streaming (window factor not applied).  Returns (S, 18, lanes)."""
    rows = pack_affine_rows(curve.batch_normalize(points),
                            curve.is_identity(points))
    return to_stream_layout(_pad_rows(rows, lanes), lanes)


def stream_keys(curve: Curve, scalars_mont, lanes: int):
    """(n, 8) scalars -> (S, lanes) int32 keys |d| * 2 + sign in the table's
    element order w * n + i; padding keys are 0 (bucket 0, weight 0)."""
    keys, signs = _signed_digits(curve.Fr, scalars_mont, STREAM_C)  # (nw, n)
    packed = (keys * 2 + signs.to(torch.int32)).reshape(-1)
    pad = (-packed.shape[0]) % lanes
    if pad:
        packed = torch.cat([packed, packed.new_zeros(pad)])
    return packed.reshape(-1, lanes).contiguous()


def window_keys(curve: Curve, scalars_mont, steps: int, lanes: int):
    """(n, 8) scalars -> (nw * steps, lanes) int32 window-aligned keys
    |d| * 2 + sign for an unbaked (steps, 18, lanes) table: window w in key
    rows [w steps, (w + 1) steps); padding keys are 0 (bucket 0, weight
    0)."""
    keys, signs = _signed_digits(curve.Fr, scalars_mont, STREAM_C)  # (nw, n)
    packed = keys * 2 + signs.to(torch.int32)
    pad = steps * lanes - packed.shape[1]
    if pad:
        packed = torch.cat([packed, packed.new_zeros((packed.shape[0], pad))],
                           dim=1)
    return packed.reshape(-1, lanes).contiguous()


# ----------------------------------------------------------------------
# kernels D and 8
# ----------------------------------------------------------------------

def _bucket_walk_plain(curve: Curve, keys_w, table_t):
    """The plain walk of kernels D and 8: keys (W, S, lanes) against one
    table (S, 18, lanes) -> (W, lanes, nb, 3, 8) bucket sums, all W windows
    and lanes at once (one plain mixed add per step)."""
    nb = N_BUCKETS
    dev = keys_w.device
    nw, steps, lanes = keys_w.shape
    acc = curve.identity((nw * lanes, nb), dev)
    slot = torch.arange(nw * lanes, device=dev)
    for s in range(steps):
        k = keys_w[:, s].reshape(-1).to(torch.int64)
        rows = table_t[s].T.repeat(nw, 1)                  # (nw lanes, 18)
        xy = rows[:, :2 * NWORDS].reshape(-1, 2, NWORDS)
        neg = (k & 1).bool()
        y = torch.where(neg[:, None], binop_plain(
            curve.Fq, SUB, torch.zeros_like(xy[:, 1]), xy[:, 1]), xy[:, 1])
        inf = (rows[:, 2 * NWORDS] & 1) != 0
        b = k >> 1
        acc[slot, b] = ec_madd_plain(curve, acc[slot, b],
                                     torch.stack([xy[:, 0], y], dim=1), inf)
    return acc.reshape(nw, lanes, nb, 3, NWORDS)


def _check_stream(keys_t, table_t, windows: int):
    steps, lanes = table_t.shape[0], table_t.shape[2]
    if keys_t.device.type != "cuda" or table_t.device != keys_t.device:
        raise ValueError(f"stream MSM on unsupported devices {keys_t.device}"
                         f", {table_t.device}")
    if keys_t.dtype != torch.int32 or table_t.dtype != torch.int32 or \
            tuple(keys_t.shape) != (windows * steps, lanes) or \
            table_t.shape[1] != ROW_WORDS or \
            not keys_t.is_contiguous() or not table_t.is_contiguous():
        raise ValueError(f"stream MSM needs contiguous int32 keys "
                         f"({windows} S, lanes) and table (S, 18, lanes), "
                         f"got {tuple(keys_t.shape)} {tuple(table_t.shape)}")


def stream_bucket_plain(curve: Curve, keys_t, table_t):
    """Plain version of kernel D: (S, lanes) keys, (S, 18, lanes) baked
    table -> (lanes, nb, 3, 8) per-lane bucket sums."""
    return _bucket_walk_plain(curve, keys_t[None], table_t)[0]


def stream_bucket(curve: Curve, keys_t, table_t):
    """Per-lane bucket accumulation over a baked table (kernel D on CUDA
    tensors)."""
    if keys_t.device.type == "cpu":
        return stream_bucket_plain(curve, keys_t, table_t)
    _check_stream(keys_t, table_t, 1)
    steps, lanes = keys_t.shape
    out = torch.empty((lanes, N_BUCKETS, 3, NWORDS), dtype=torch.int32,
                      device=keys_t.device)
    _bucket_kernel.launch(curve.kernel_id, keys_t.data_ptr(),
                          table_t.data_ptr(), out.data_ptr(), steps, lanes,
                          N_BUCKETS, stream_of(out))
    return out


def stream_bucket_windows_plain(curve: Curve, keys_t, table_t):
    """Plain version of kernel 8: window-aligned keys (nw S, lanes) against
    the unbaked table (S, 18, lanes) -> (nw, lanes, nb, 3, 8)."""
    steps, lanes = table_t.shape[0], table_t.shape[2]
    return _bucket_walk_plain(curve, keys_t.reshape(-1, steps, lanes),
                              table_t)


def stream_bucket_windows(curve: Curve, keys_t, table_t):
    """Per-window, per-lane bucket accumulation over an unbaked table
    (kernel 8 on CUDA tensors): (nw, lanes, nb, 3, 8)."""
    if keys_t.device.type == "cpu":
        return stream_bucket_windows_plain(curve, keys_t, table_t)
    steps, lanes = table_t.shape[0], table_t.shape[2]
    nw = keys_t.shape[0] // max(steps, 1)
    _check_stream(keys_t, table_t, nw)
    out = torch.empty((nw, lanes, N_BUCKETS, 3, NWORDS), dtype=torch.int32,
                      device=keys_t.device)
    _windows_kernel.launch(curve.kernel_id, keys_t.data_ptr(),
                           table_t.data_ptr(), out.data_ptr(), nw, steps,
                           lanes, N_BUCKETS, stream_of(out))
    return out


def stream_bucket_sums(curve: Curve, keys_t, table_t):
    """Per-lane buckets, then the cross-lane tree sum: (nb, 3, 8)."""
    return point_tree_sum(curve, stream_bucket(curve, keys_t, table_t), dim=0)


def msm_stream_baked(curve: Curve, scalars_mont, table_t):
    """Fixed-base MSM against a baked stream table."""
    lanes = table_t.shape[2]
    keys_t = stream_keys(curve, scalars_mont, lanes)
    return weighted_bucket_fold(curve,
                                stream_bucket_sums(curve, keys_t, table_t))


def msm_stream_unbaked(curve: Curve, scalars_mont, table_t):
    """Fixed-base MSM against an unbaked stream table: per-window buckets
    (kernel 8), a tree sum over lanes, a weighted fold per window and a
    Horner combine over windows."""
    steps, lanes = table_t.shape[0], table_t.shape[2]
    keys_t = window_keys(curve, scalars_mont, steps, lanes)
    sums = point_tree_sum(curve, stream_bucket_windows(curve, keys_t,
                                                       table_t), dim=1)
    per_window = weighted_bucket_fold(curve, sums.transpose(0, 1))
    return horner_windows(curve, per_window, STREAM_C)


class StreamMSM:
    """Fixed-base MSM descriptor: the stream table of `points` (n, 3, 8),
    built once (baked while nw n <= MAX_BAKED_ROWS, else unbaked); calling
    it with (m <= n, 8) scalars returns one projective point (3, 8)."""

    def __init__(self, curve: Curve, points):
        self.curve = curve
        self.n = n = points.shape[0]
        nw = n_windows_for(curve.Fr, STREAM_C)
        self.baked = nw * n <= MAX_BAKED_ROWS
        if self.baked:
            self.lanes = lanes_for(nw * n)
            self.table = bake_stream_table(curve, points, self.lanes)
        else:
            self.lanes = unbaked_lanes(n, nw)
            self.table = pack_base_stream_table(curve, points, self.lanes)

    def __call__(self, scalars_mont):
        m = scalars_mont.shape[0]
        if m > self.n:
            raise ValueError(f"{m} scalars for {self.n} bases")
        if m != self.n:
            scalars_mont = torch.cat([scalars_mont, scalars_mont.new_zeros(
                (self.n - m, NWORDS))], dim=0)
        run = msm_stream_baked if self.baked else msm_stream_unbaked
        return run(self.curve, scalars_mont, self.table)
