"""MSMs over a mesh: points row-sharded, one MSM per shard, one point per
shard exchanged (port of the JAX reference's dist/msm.py).

The bucket work stays on each shard; the only traffic is one projective
point a shard (`all_gather` of (D, 3, 8)), after which the partial sums
are added by a tree sum (kernel B).

`ShardedCachedMSM` is the fixed-base form: each shard holds a descriptor
of the engine's style over its slice of the bases.  "sorted" is the
reference's design, one `CachedMSM` a shard (its window tables, kernel 9);
"stream" one `StreamMSM` a shard (kernel D, or kernel 8 where a shard's
slice passes MAX_BAKED_ROWS).  The result is the same group element, not
the same projective words.
"""

from __future__ import annotations

import torch

from ..curves.curve import Curve
from ..fields.field import NWORDS
from ..msm.bucket_scan import msm_variable, point_tree_sum
from ..msm.msm import CachedMSM
from ..msm.stream_msm import StreamMSM
from .mesh import Mesh, all_gather, on_device, shard_rows


def _sum_parts(mesh: Mesh, curve: Curve, parts: list, device):
    """The sum of every shard's (3, 8) point, on `device`."""
    gathered = all_gather(mesh, parts)[0]                     # (D, 3, 8)
    with on_device(gathered.device):
        total = point_tree_sum(curve, gathered)
    return total.to(device)


def sharded_msm(mesh: Mesh, curve: Curve, scalars_mont, points, c: int = 8,
                block: int | None = None):
    """Variable-base MSM of (n, 8) Montgomery scalars and (n, 3, 8)
    projective points, rows sharded over the mesh (n divisible by its
    size): `msm_variable` on each shard (kernel 9).  Returns one projective
    point (3, 8) on the scalars' device, equal as a group element to
    `pippenger_msm(scalars, points)`."""
    n = scalars_mont.shape[0]
    if n % mesh.size:
        raise ValueError(f"n={n} not divisible by mesh size {mesh.size}")
    parts = []
    for s, p in zip(shard_rows(mesh, scalars_mont), shard_rows(mesh, points)):
        with on_device(s.device):
            parts.append(msm_variable(curve, s, p, c, block))
    return _sum_parts(mesh, curve, parts, scalars_mont.device)


class ShardedCachedMSM:
    """Fixed-base MSM descriptor with the bases sharded over the mesh: one
    descriptor a shard over its n / D bases, built once: a `CachedMSM` of
    window width c (None: `auto_c(n / D)`) and scan block `block`
    with style "sorted", a `StreamMSM` with "stream".  Calling it with
    (m <= n, 8) scalars returns one projective point (3, 8) on their
    device."""

    def __init__(self, mesh: Mesh, curve: Curve, points, c: int | None = None,
                 block: int | None = None, style: str = "stream"):
        self.mesh = mesh
        self.curve = curve
        self.n = points.shape[0]
        if self.n % mesh.size:
            raise ValueError(f"n={self.n} not divisible by mesh size "
                             f"{mesh.size}")
        if style not in ("stream", "sorted") or \
                (style == "stream" and c is not None):
            raise ValueError(f"no sharded descriptor of style {style!r} "
                             f"with c={c}")
        sorted_ = style == "sorted"
        self.engines = []
        for slab in shard_rows(mesh, points):
            with on_device(slab.device):
                self.engines.append(CachedMSM(curve, slab, c, block)
                                    if sorted_ else StreamMSM(curve, slab))

    def __call__(self, scalars_mont):
        m = scalars_mont.shape[0]
        if m > self.n:
            raise ValueError(f"{m} scalars for {self.n} bases")
        if m != self.n:
            scalars_mont = torch.cat([scalars_mont, scalars_mont.new_zeros(
                (self.n - m, NWORDS))], dim=0)
        parts = []
        for engine, s in zip(self.engines,
                             shard_rows(self.mesh, scalars_mont)):
            with on_device(s.device):
                parts.append(engine(s))
        return _sum_parts(self.mesh, self.curve, parts, scalars_mont.device)
