"""Grand-product scans over a mesh (port of the JAX reference's
dist/scan.py).

Each shard scans its slab (`Field.prefix_product`, kernel A), every shard
gathers the mesh.size slab totals, and each multiplies its slab by the
product of the totals to its left: one collective, no serial chain.
"""

from __future__ import annotations

import torch

from ..fields.field import Field
from .mesh import Mesh, all_gather, gather_rows, on_device, shard_rows


def sharded_prefix_product(mesh: Mesh, F: Field, a):
    """Inclusive running product along axis 0 of (n, 8) `a`, equal to
    `F.prefix_product(a)`.  `a` is a full tensor (the result comes back
    whole on its device) or this process's list of row slabs (the result
    is slabs too)."""
    slabs = shard_rows(mesh, a) if torch.is_tensor(a) else a
    loc = []
    for x in slabs:
        with on_device(x.device):
            loc.append(F.prefix_product(x))
    totals = all_gather(mesh, [x[-1] for x in loc])          # (D, 8) each
    out = []
    for i, (x, tot) in enumerate(zip(loc, totals)):
        with on_device(x.device):
            left = torch.arange(mesh.size, device=tot.device) < \
                mesh.first_shard + i
            mine = torch.where(left[:, None], tot,
                               F.ones((mesh.size,), tot.device))
            carry = F.prefix_product(mine)[-1]                # left slabs
            out.append(F.mul(x, carry))
    return gather_rows(mesh, out, a.device) if torch.is_tensor(a) else out
