"""Radix-2 NTT entry points (port of halo2_tpu/ntt/ntt.py).

Every length runs the four-step path around kernel C (ntt/fused.py); the
reference's stage-per-op path for short transforms computes the same values
and has no counterpart here.  Contract: `forward` / `inverse` equal the
reference's `NTT._transform` (`inverse` includes 1/n).
"""

from __future__ import annotations

import torch

from ..fields.field import Field
from .fused import FusedNTT


def powers(F: Field, base, n: int):
    """[1, base, ..., base^(n-1)] as (n, 8) words; base an encoded (8,)
    element.  Doubling construction: log2(n) batched multiplies."""
    assert n & (n - 1) == 0
    out = F.ones((1,), base.device)
    cur = base
    while out.shape[0] < n:
        out = torch.cat([out, F.mul(out, cur)], dim=0)
        cur = F.square(cur)
    return out


_CACHE: dict = {}


def get_ntt(F: Field, log_n: int, device,
            omega_int: int | None = None) -> FusedNTT:
    """NTT over the canonical 2^log_n subgroup of F (or a custom omega)."""
    if omega_int is None:
        assert log_n <= F.S
        omega_int = pow(F.root_of_unity, 1 << (F.S - log_n), F.p)
    key = (F.p, log_n, omega_int, str(device))
    ntt = _CACHE.get(key)
    if ntt is None:
        ntt = _CACHE[key] = FusedNTT(F, log_n, omega_int, device)
    return ntt
