"""MSM entry points (port of the JAX reference's msm/msm.py): the naive
reference MSM and the `best_multiexp` dispatch.  Variable-base MSMs above
32 points run Pippenger's method on the segmented-scan kernel
(`bucket_scan.msm_variable`); fixed-base commitments go through
`stream_msm.StreamMSM` instead."""

from __future__ import annotations

from ..curves.curve import Curve
from .bucket_scan import msm_variable, point_tree_sum


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
    """The reference's window width for an n-point variable-base MSM
    (chosen on its TPU, c = 13 at k = 18); the port's bench keeps it in the
    roofline's window count so that its numbers compare with the
    reference's."""
    return max(4, min(13, int(n).bit_length() - 4))


def msm(curve: Curve, scalars_mont, points):
    """The `best_multiexp` dispatch with the reference's window rule: naive
    up to 32 points, else Pippenger with c = 8 from 2^12 points, c = 4
    below."""
    n = int(scalars_mont.shape[0])
    if n == 0:
        return curve.identity((), points.device)
    if n <= 32:
        return naive_msm(curve, scalars_mont, points)
    return pippenger_msm(curve, scalars_mont, points, 8 if n >= 1 << 12 else 4)
