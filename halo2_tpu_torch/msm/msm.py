"""MSM entry points (port of the JAX reference's msm/msm.py): the naive
reference MSM, the `best_multiexp` dispatch, and the sorted fixed-base MSM
`CachedMSM`.  Variable-base MSMs above 32 points run Pippenger's method on
the segmented-scan kernel (`bucket_scan.msm_variable`); fixed-base
commitments go through a descriptor of the engine (engine.py): the stream
MSM (`stream_msm.StreamMSM`, kernels D and 8) by default, or `CachedMSM`,
a stable sort by bucket and the segmented scan (kernel 9) over window
tables of affine rows, with `style="sorted"`."""

from __future__ import annotations

import torch

from ..curves.curve import Curve
from ..fields.cuda_ops import NWORDS
from .bucket_scan import (ROW_WORDS, affine_rows, msm_packed_rows,
                          msm_unbaked_rows, msm_variable, msm_windowed_cached,
                          n_windows_for, packed_digits, point_tree_sum,
                          shift_add)


def naive_msm(curve: Curve, scalars_mont, points):
    """Per-point scalar multiplication plus a tree sum; the reference
    result for tests (256 doublings and adds per point)."""
    return point_tree_sum(curve, curve.scalar_mul(points, scalars_mont))


def pippenger_msm(curve: Curve, scalars_mont, points, c: int = 8,
                  block: int = None):
    """Variable-base MSM via the windowed bucket method: (n, 8) scalars and
    (n, 3, 8) points -> one projective point (3, 8)."""
    return msm_variable(curve, scalars_mont, points, c, block)


def auto_c(n: int) -> int:
    """The reference's window width for an n-point sorted MSM (chosen on
    its TPU, c = 13 at k = 18); `CachedMSM` takes it, and the port's bench
    keeps it in the roofline's window count so that its numbers compare
    with the reference's."""
    return max(4, min(13, int(n).bit_length() - 4))


def window_bases(curve: Curve, points, c: int = 13):
    """[2^(c w)] P_i for every window w of the signed digits: c doublings a
    window on kernel B.  points (n, 3, 8) -> (nw, n, 3, 8) projective."""
    out = [points]
    for _ in range(n_windows_for(curve.Fr, c) - 1):
        cur = out[-1]
        for _ in range(c):
            cur = curve.double(cur)
        out.append(cur)
    return torch.stack(out)


class CachedMSM:
    """Fixed-base MSM descriptor on the sorted pipeline: its bases are kept
    as affine rows on their device, and every call is one stable sort by
    bucket, a gather, the segmented scan (kernel 9) and the weighted fold
    per window chunk.  Two tables, picked by size:

    - BAKED (nw n <= max_baked_rows, k <= 18 at c = 13): row w n + i holds
      [2^(c w)] P_i (`window_bases`), so all windows share one space of
      2^(c-1)+1 buckets and each chunk is one `msm_packed_rows`;
    - UNBAKED (larger): the n bases once; each chunk of windows tags its own
      bucket spaces (`msm_unbaked_rows`) and the chunks combine high to low
      by `shift_add`.

    Windows go in chunks of max_rows // n (baked) or min(max_rows, 2^22)
    // n (unbaked, which shares the card with a large prover's state), which
    bound the sort and gather transient.  Calling it with (m <= n, 8)
    scalars returns one projective point (3, 8)."""

    def __init__(self, curve: Curve, points, c: int | None = None,
                 block: int | None = None, max_rows: int = 1 << 23,
                 max_baked_rows: int = 1 << 23):
        self.curve = curve
        self.n = n = points.shape[0]
        self.c = c = auto_c(n) if c is None else c
        self.block = block
        self.n_windows = nw = n_windows_for(curve.Fr, c)
        self.baked = nw * n <= max_baked_rows
        rows = max_rows if self.baked else min(max_rows, 1 << 22)
        wc = self.window_chunk = max(1, min(nw, rows // max(n, 1)))
        self.bounds = [(w0, min(w0 + wc, nw)) for w0 in range(0, nw, wc)]
        if self.baked:
            wb = window_bases(curve, points, c)
            self.wchunks = [
                affine_rows(curve, wb[w0:w1].reshape(-1, 3, NWORDS))
                for w0, w1 in self.bounds]
        else:
            self.rows = affine_rows(curve, points)

    @property
    def wbases(self):
        """The first window chunk's rows (baked) or the base rows
        (unbaked)."""
        return self.wchunks[0] if self.baked else self.rows

    def __call__(self, scalars_mont):
        curve, c, block = self.curve, self.c, self.block
        m = scalars_mont.shape[0]
        if m > self.n:
            raise ValueError(f"{m} scalars for {self.n} bases")
        if self.baked and len(self.bounds) == 1:
            return msm_windowed_cached(curve, scalars_mont, self.wchunks[0],
                                       c, block)
        packed = packed_digits(curve, scalars_mont, c)
        acc = None
        if not self.baked:
            rows = self.rows[:m]
            prev_w0 = None
            for w0, w1 in reversed(self.bounds):
                part = msm_unbaked_rows(curve, packed[w0:w1], rows, c, block)
                acc = part if acc is None else shift_add(
                    curve, acc, c * (prev_w0 - w0), part)
                prev_w0 = w0
            return acc
        for (w0, w1), rows in zip(self.bounds, self.wchunks):
            if m != self.n:
                rows = rows.reshape(w1 - w0, self.n, ROW_WORDS)[:, :m]
            part = msm_packed_rows(curve, packed[w0:w1],
                                   rows.reshape(-1, ROW_WORDS), c, block)
            acc = part if acc is None else curve.add(acc, part)
        return acc


def default_cached_msm(curve: Curve, bases):
    """The fixed-base descriptor without an engine: `StreamMSM` (kernels D
    and 8) for bases on a CUDA device, `CachedMSM` on the CPU, as the
    reference picks its stream MSM on its accelerator and the sorted one on
    the CPU."""
    if bases.device.type == "cuda":
        from .stream_msm import StreamMSM
        return StreamMSM(curve, bases)
    return CachedMSM(curve, bases)


def msm(curve: Curve, scalars_mont, points, c: int | None = None,
        block: int | None = None):
    """The `best_multiexp` dispatch with the reference's window rule: naive
    up to 32 points, else Pippenger with window c (by default 8 from 2^12
    points, 4 below) and scan block `block` (None: `block_for` per
    level)."""
    n = int(scalars_mont.shape[0])
    if n == 0:
        return curve.identity((), points.device)
    if n <= 32:
        return naive_msm(curve, scalars_mont, points)
    if c is None:
        c = 8 if n >= 1 << 12 else 4
    return pippenger_msm(curve, scalars_mont, points, c, block)
