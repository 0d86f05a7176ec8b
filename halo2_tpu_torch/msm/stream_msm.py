"""Fixed-base MSM over a baked window table, around kernel D (csrc/msm.cu).

Port of halo2_tpu/msm/stream_msm.py, baked path.  The table holds
[2^(c w)] P_i for every window w and base i, in affine form, packed as
18-word rows (8 x words, 8 y words, infinity flag, pad) and laid out
(S, 18, lanes) so that lane j streams rows j, j + lanes, ... .  Kernel D
accumulates every lane's private buckets; the cross-lane tree sum and the
weighted bucket fold run here over kernel B.

The result is an exact group element, so it does not depend on the window
width or on `lanes`; the contract is
`StreamMSM(points)(s) == naive_msm(s, points)`.
"""

from __future__ import annotations

import torch

from .._build import I32, P, Kernel, stream_of
from ..curves.cuda_ec import madd_limbs
from ..curves.curve import Curve
from ..fields.cuda_ops import NWORDS, limbs_for, to_limbs, to_words
from .bucket_scan import _signed_digits, n_windows_for, weighted_bucket_fold
from .msm import point_tree_sum

NROWS_PK = 2 * NWORDS + 2          # x words, y words, infinity flag, pad
STREAM_C = 6                       # window width: 43 windows, 33 buckets
N_BUCKETS = (1 << (STREAM_C - 1)) + 1
MAX_LANES = 1 << 16                # ~2 resident waves of threads on 132 SMs
TARGET_STEPS = 64                  # stream rows per lane when lanes < max
MAX_BAKED_ROWS = 1 << 24           # nw * n; k = 18 at c = 6 is 11.3M rows
BAKE_CHUNK_ROWS = 1 << 22          # table rows made per normalization
UNBAKED_TODO = ("unbaked stream table (nw * n > 2^24, k >= 19) needs the "
                "per-window stream kernel, ROADMAP Queue 2 item 8")

_bucket_kernel = Kernel("h2_stream_bucket", [P, P, P, I32, I32, I32, P])


def lanes_for(rows: int) -> int:
    """Lanes for a stream of `rows`: enough lanes to fill the card at
    k = 18 (MAX_LANES), fewer for short streams so each lane still walks
    about TARGET_STEPS rows."""
    want = max(32, -(-rows // TARGET_STEPS))
    return min(MAX_LANES, 1 << (want - 1).bit_length())


def pack_stream_rows(aff_xy, inf):
    """(m, 2, 8) affine words + (m,) bool -> (m, 18) int32 rows."""
    m = aff_xy.shape[0]
    flag = inf.to(torch.int32).reshape(m, 1)
    return torch.cat([aff_xy.reshape(m, 2 * NWORDS), flag,
                      torch.zeros_like(flag)], dim=1)


def _pad_rows(rows, lanes: int):
    """Pad (S, 18) rows to a multiple of lanes with identity rows."""
    pad = (-rows.shape[0]) % lanes
    if pad:
        extra = torch.zeros((pad, NROWS_PK), dtype=torch.int32,
                            device=rows.device)
        extra[:, 2 * NWORDS] = 1
        rows = torch.cat([rows, extra], dim=0)
    return rows


def to_stream_layout(rows, lanes: int):
    """(S * lanes, 18) -> (S, 18, lanes)."""
    return rows.reshape(-1, lanes, NROWS_PK).transpose(1, 2).contiguous()


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
        out.append(pack_stream_rows(curve.batch_normalize(pts),
                                    curve.is_identity(pts)))
    return to_stream_layout(_pad_rows(torch.cat(out, dim=0), lanes), lanes)


def stream_keys(curve: Curve, scalars_mont, lanes: int):
    """(n, 8) scalars -> (S, lanes) int32 keys |d| * 2 + sign in the table's
    element order w * n + i; padding keys are 0 (bucket 0, weight 0)."""
    keys, signs = _signed_digits(curve.Fr, scalars_mont, STREAM_C)  # (nw, n)
    packed = (keys * 2 + signs.to(torch.int32)).reshape(-1)
    pad = (-packed.shape[0]) % lanes
    if pad:
        packed = torch.cat([packed, packed.new_zeros(pad)])
    return packed.reshape(-1, lanes).contiguous()


# ----------------------------------------------------------------------
# kernel D
# ----------------------------------------------------------------------

def stream_bucket_plain(curve: Curve, keys_t, table_t):
    """Plain version of kernel D: (S, lanes) keys, (S, 18, lanes) table ->
    (lanes, nb, 3, 8) per-lane bucket sums, in int64 limbs."""
    nb = N_BUCKETS
    dev = keys_t.device
    L = limbs_for(curve.Fq, dev)
    steps, lanes = keys_t.shape
    ident = to_limbs(curve.identity((), dev))
    acc = ident.expand(lanes, nb, 3, 16).clone()
    lane = torch.arange(lanes, device=dev)
    zero = torch.zeros((lanes, 16), dtype=torch.int64, device=dev)
    for s in range(steps):
        k = keys_t[s].to(torch.int64)
        rows = table_t[s]
        x = to_limbs(rows[:NWORDS].T)
        y = to_limbs(rows[NWORDS:2 * NWORDS].T)
        inf = (rows[2 * NWORDS] & 1) != 0
        y = torch.where((k & 1).bool()[:, None], L.sub(zero, y), y)
        b = k >> 1
        acc[lane, b] = madd_limbs(L, acc[lane, b], torch.stack([x, y], -2),
                                  inf)
    return to_words(acc)


def stream_bucket(curve: Curve, keys_t, table_t):
    """Per-lane bucket accumulation (kernel D on CUDA tensors)."""
    nb = N_BUCKETS
    if keys_t.device.type == "cpu":
        return stream_bucket_plain(curve, keys_t, table_t)
    steps, lanes = keys_t.shape
    if keys_t.device.type != "cuda" or table_t.device != keys_t.device:
        raise ValueError(f"stream MSM on unsupported devices {keys_t.device}"
                         f", {table_t.device}")
    if keys_t.dtype != torch.int32 or table_t.dtype != torch.int32 or \
            tuple(table_t.shape) != (steps, NROWS_PK, lanes) or \
            not keys_t.is_contiguous() or not table_t.is_contiguous():
        raise ValueError(f"stream MSM needs contiguous int32 keys (S, lanes) "
                         f"and table (S, 18, lanes), got "
                         f"{tuple(keys_t.shape)} {tuple(table_t.shape)}")
    out = torch.empty((lanes, nb, 3, NWORDS), dtype=torch.int32,
                      device=keys_t.device)
    _bucket_kernel.launch(keys_t.data_ptr(), table_t.data_ptr(),
                          out.data_ptr(), steps, lanes, nb, stream_of(out))
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


class StreamMSM:
    """Fixed-base MSM descriptor: the baked table of `points` (n, 3, 8),
    built once; calling it with (m <= n, 8) scalars returns one projective
    point (3, 8).  Tables above MAX_BAKED_ROWS rows are not baked: they
    raise NotImplementedError."""

    def __init__(self, curve: Curve, points):
        self.curve = curve
        self.n = n = points.shape[0]
        nw = n_windows_for(curve.Fr, STREAM_C)
        if nw * n > MAX_BAKED_ROWS:
            raise NotImplementedError(UNBAKED_TODO)
        self.lanes = lanes_for(nw * n)
        self.table = bake_stream_table(curve, points, self.lanes)

    def __call__(self, scalars_mont):
        m = scalars_mont.shape[0]
        if m > self.n:
            raise ValueError(f"{m} scalars for {self.n} bases")
        if m != self.n:
            scalars_mont = torch.cat([scalars_mont, scalars_mont.new_zeros(
                (self.n - m, NWORDS))], dim=0)
        return msm_stream_baked(self.curve, scalars_mont, self.table)
