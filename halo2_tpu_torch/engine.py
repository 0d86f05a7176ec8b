"""Acceleration-engine seam (port of the JAX reference's engine.py; the reference's
ZAL layer, halo2_middleware/src/zal.rs:57-243).

`H2cEngine` runs each MSM as it comes.  `GpuMsmEngine` replaces the TPU
engine: fixed bases (the SRS and its Lagrange form) become device-resident
descriptors, built once and reused by every commitment.  It is the engine
`ParamsKZG` and `ParamsIPA` start with.  Its `style`, as the reference's,
picks the descriptor: "stream" (the default) a `StreamMSM`, a baked table
(kernel D) up to k = 18 and the unbaked n-row table (kernel 8) from k = 19;
"sorted" a `CachedMSM`, window tables under a stable sort by bucket and the
segmented scan (kernel 9).  With a mesh (dist/mesh.py) its descriptors are
`ShardedCachedMSM`s: the bases split over the mesh's devices, one
descriptor of the style a shard.  Two deliberate differences from the
reference engine: the stream style has no window-width option (the stream
width is `STREAM_C`), and the descriptor cache is bounded.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Optional

from .curves.curve import Curve
from .msm.msm import CachedMSM, msm
from .msm.stream_msm import StreamMSM

STYLES = ("stream", "sorted")


class H2cEngine:
    """Default engine: straight MSM per call, no cached state."""

    def msm(self, curve: Curve, coeffs, bases):
        return msm(curve, coeffs, bases)

    def get_coeffs_descriptor(self, coeffs):
        return coeffs

    def get_base_descriptor(self, curve: Curve, bases):
        return bases

    def msm_with_cached_base(self, curve: Curve, coeffs, base_desc):
        return msm(curve, coeffs, base_desc)


class GpuMsmEngine(H2cEngine):
    """Engine with device-resident fixed-base descriptors of one style,
    sharded over `mesh` when one is given.

    style: "stream" (`StreamMSM`, kernels D and 8) or "sorted" (`CachedMSM`
    with window width c and scan block `block`, kernel 9); None reads the
    reference's HALO2_TPU_MSM_STYLE, else "stream".

    The cache maps id(bases) to (bases, descriptor) and keeps the bases
    alive, so a recycled id can never serve a stale table; at most
    `max_descriptors` tables are held (least recently used first out).  A
    prover needs two: g (or [s^i]G) and its Lagrange form."""

    def __init__(self, max_descriptors: int = 2, mesh=None,
                 style: str | None = None, c: int | None = None,
                 block: int | None = None):
        self.max_descriptors = max_descriptors
        self.mesh = mesh
        self.style = style or os.environ.get("HALO2_TPU_MSM_STYLE", "stream")
        if self.style not in STYLES:
            raise ValueError(f"unknown MSM style {self.style!r}: one of "
                             f"{STYLES}")
        if self.style == "stream" and c is not None:
            raise ValueError("the stream MSM's window width is STREAM_C; "
                             "c applies to style='sorted'")
        self.c = c
        self.block = block
        self._cache: OrderedDict = OrderedDict()

    def get_base_descriptor(self, curve: Curve, bases):
        key = id(bases)
        hit = self._cache.get(key)
        if hit is not None and hit[0] is bases:
            self._cache.move_to_end(key)
            return hit[1]
        if self.mesh is not None:
            from .dist.msm import ShardedCachedMSM
            desc = ShardedCachedMSM(self.mesh, curve, bases, self.c,
                                    self.block, self.style)
        elif self.style == "sorted":
            desc = CachedMSM(curve, bases, self.c, self.block)
        else:
            desc = StreamMSM(curve, bases)
        self._cache[key] = (bases, desc)
        while len(self._cache) > self.max_descriptors:
            self._cache.popitem(last=False)
        return desc

    def msm_with_cached_base(self, curve: Curve, coeffs, base_desc):
        return base_desc(coeffs)


@dataclass
class PlonkEngine:
    """The engine bundle threaded through keygen and the prover: the MSM
    backend, and the device mesh (dist/mesh.py) whose NTTs and permutation
    products are sharded, or None for one device."""
    msm_backend: H2cEngine = field(default_factory=GpuMsmEngine)
    mesh: Optional[Any] = None


class PlonkEngineConfig:
    """The builder of the reference's type-state engine config
    (zal.rs:196-243)."""

    @staticmethod
    def build_default() -> PlonkEngine:
        return PlonkEngine()

    @staticmethod
    def set_msm(engine: H2cEngine, mesh=None) -> PlonkEngine:
        """The bundle of `engine` and its mesh.  `mesh` defaults to the
        engine's own; one that differs from it raises, so that the MSMs
        and the transforms are sharded alike or not at all."""
        own = getattr(engine, "mesh", None)
        if mesh is None:
            mesh = own
        elif mesh is not own:
            raise ValueError("set_msm: the mesh differs from the MSM "
                             "engine's; build the engine with mesh=")
        return PlonkEngine(msm_backend=engine, mesh=mesh)
