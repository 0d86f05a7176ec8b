"""NTT over curve points (port of the JAX reference's curves/point_ntt.py;
the reference's `FftGroup`, halo2_backend/src/arithmetic.rs:17-54), used by
`g_to_lagrange` to build Lagrange-basis generators for IPA parameters.
Each butterfly stage is one batched scalar multiplication of the odd half
by its twiddles plus two adds, all on kernel B."""

from __future__ import annotations

import torch

from ..ntt import bit_reverse_indices, powers
from .curve import Curve


def _point_transform(curve: Curve, pts, log_n: int, tw):
    """Radix-2 decimation-in-time transform of (n, 3, 8) points with the
    twiddle powers tw (n / 2, 8)."""
    n = 1 << log_n
    a = pts[bit_reverse_indices(log_n, pts.device)]
    for s in range(1, log_n + 1):
        m = 1 << s
        half = m // 2
        a = a.reshape(n // m, m, 3, pts.shape[-1])
        e, o = a[:, :half], a[:, half:]
        t = curve.scalar_mul(o, tw[:: n // m][:half])
        a = torch.cat([curve.add(e, t), curve.add(e, curve.neg(t))], dim=1)
    return a.reshape(pts.shape)


def g_to_lagrange(curve: Curve, pts, log_n: int):
    """Coefficient-basis generators (n, 3, 8) -> Lagrange-basis generators:
    the inverse transform over the group, scaled by 1 / n
    (arithmetic.rs:30-54)."""
    F = curve.Fr
    n = 1 << log_n
    dev = pts.device
    omega = pow(F.root_of_unity, 1 << (F.S - log_n), F.p)
    omega_inv = pow(omega, F.p - 2, F.p)
    tw = powers(F, F.encode_int(omega_inv, dev), max(n // 2, 1))
    out = _point_transform(curve, pts, log_n, tw)
    n_inv = F.encode_int(pow(n, F.p - 2, F.p), dev)
    return curve.scalar_mul(out, n_inv.expand(n, n_inv.shape[-1]))
