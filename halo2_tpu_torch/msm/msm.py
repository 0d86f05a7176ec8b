"""MSM entry points (port of the parts of halo2_tpu/msm/msm.py on the KZG
main path): the tree sum, the naive reference MSM and the small-n branch of
the `best_multiexp` dispatch.  Fixed-base commitments go through
`stream_msm.StreamMSM` instead."""

from __future__ import annotations

import torch

from ..curves.curve import Curve

VARIABLE_BASE_TODO = ("variable-base MSM with n > 32 (the sorted segmented-"
                      "scan kernel, ROADMAP Queue 2 item 9) is not ported")


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


def naive_msm(curve: Curve, scalars_mont, points):
    """Per-point scalar multiplication plus a tree sum; the reference
    result for tests (256 doublings and adds per point)."""
    return point_tree_sum(curve, curve.scalar_mul(points, scalars_mont))


def msm(curve: Curve, scalars_mont, points):
    """The `best_multiexp` dispatch for what the main path needs: tiny
    variable-base MSMs.  Longer ones wait for the scan kernel."""
    n = int(scalars_mont.shape[0])
    if n == 0:
        return curve.identity((), points.device)
    if n <= 32:
        return naive_msm(curve, scalars_mont, points)
    raise NotImplementedError(VARIABLE_BASE_TODO)
