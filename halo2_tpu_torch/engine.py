"""Acceleration-engine seam (port of halo2_tpu/engine.py; the reference's
ZAL layer, halo2_middleware/src/zal.rs:57-243).

`H2cEngine` runs each MSM as it comes.  `GpuMsmEngine` replaces the TPU
engine: fixed bases (the SRS and its Lagrange form) become device-resident
`StreamMSM` descriptors, built once and reused by every commitment; it is
the engine `ParamsKZG` starts with.  Two deliberate differences from the
reference engine: there is no window-width option (the stream width is
`STREAM_C`), and the descriptor cache is bounded.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

from .curves.curve import Curve
from .msm.msm import msm
from .msm.stream_msm import StreamMSM


class H2cEngine:
    """Default engine: straight MSM per call, no cached state."""

    def msm(self, curve: Curve, coeffs, bases):
        return msm(curve, coeffs, bases)

    def get_base_descriptor(self, curve: Curve, bases):
        return bases

    def msm_with_cached_base(self, curve: Curve, coeffs, base_desc):
        return msm(curve, coeffs, base_desc)


class GpuMsmEngine(H2cEngine):
    """Engine with device-resident fixed-base descriptors (kernel D).

    The cache maps id(bases) to (bases, descriptor) and keeps the bases
    alive, so a recycled id can never serve a stale table; at most
    `max_descriptors` tables are held (least recently used first out).  A
    KZG prover needs two: [s^i]G and its Lagrange form."""

    def __init__(self, max_descriptors: int = 2):
        self.max_descriptors = max_descriptors
        self._cache: OrderedDict = OrderedDict()

    def get_base_descriptor(self, curve: Curve, bases):
        key = id(bases)
        hit = self._cache.get(key)
        if hit is not None and hit[0] is bases:
            self._cache.move_to_end(key)
            return hit[1]
        desc = StreamMSM(curve, bases)
        self._cache[key] = (bases, desc)
        while len(self._cache) > self.max_descriptors:
            self._cache.popitem(last=False)
        return desc

    def msm_with_cached_base(self, curve: Curve, coeffs, base_desc):
        return base_desc(coeffs)


@dataclass
class PlonkEngine:
    """The engine bundle threaded through keygen and the prover."""
    msm_backend: H2cEngine = field(default_factory=GpuMsmEngine)
