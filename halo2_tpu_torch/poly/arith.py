"""Polynomial arithmetic helpers (port of halo2_tpu/poly/arith.py)."""

from __future__ import annotations

import torch

from ..fields.field import Field
from ..ntt import powers
from .poly import COEFF, unwrap

# Rows of one stacked evaluation dispatch: the stack, its product with the
# powers and the tree-sum halves stay below ~4x the stack, so 2^24 rows
# (512 MiB at 32 B an element) peaks near 2 GiB on the 80 GB card.
EVAL_STACK_ROWS = 1 << 24


def tree_sum(F: Field, a, dim: int = -2):
    """Sum of field elements along `dim` via log-depth pairwise adds."""
    a = a.movedim(dim, 0)
    while a.shape[0] > 1:
        n = a.shape[0]
        if n % 2:
            a = torch.cat([a, torch.zeros_like(a[:1])], dim=0)
            n += 1
        a = F.add(a[: n // 2], a[n // 2:])
    return a[0]


def _eval_stack(F: Field, polys, x):
    """(P, n, 8) coefficient stack at one encoded point x -> (P, 8)."""
    n = polys.shape[-2]
    xs = powers(F, x, 1 << max(n - 1, 0).bit_length())[:n]
    return tree_sum(F, F.mul(polys, xs), dim=-2)


def eval_polys_at_points(F: Field, requests):
    """[(poly, point_int), ...] -> [int]: one stacked dispatch and one host
    fetch per distinct point."""
    by_point: dict = {}
    for idx, (poly, point) in enumerate(requests):
        arr = unwrap(poly, COEFF, "eval_polys_at_points")
        by_point.setdefault(int(point), []).append((idx, arr))
    out = [0] * len(requests)
    for point, items in by_point.items():
        n_len = items[0][1].shape[-2]
        max_stack = max(1, EVAL_STACK_ROWS // max(n_len, 1))
        device = items[0][1].device
        for off in range(0, len(items), max_stack):
            chunk = items[off: off + max_stack]
            stack = torch.stack([arr for _, arr in chunk], dim=0)
            vals = _eval_stack(F, stack, F.encode_int(point, device))
            for (idx, _), v in zip(chunk, F.decode_ints(vals)):
                out[idx] = v
    return out


def kate_division(F: Field, poly, b):
    """Divide (..., n, 8) coefficients by (X - b), dropping the remainder;
    b an encoded (8,) point.  The reverse-Horner recurrence
    q_i = c_(i+1) + b q_(i+1) runs as a Hillis-Steele scan over the affine
    maps x -> b x + c_i (arithmetic.rs:101-120)."""
    poly = unwrap(poly, COEFF, "kate_division")
    coeffs = poly[..., 1:, :].flip(-2).movedim(-2, 0)   # c_(n-1) .. c_1
    m = coeffs.shape[0]
    fm = b.expand(coeffs.shape).contiguous()
    fa = coeffs
    d = 1
    while d < m:
        gm = torch.cat([F.ones((d,) + tuple(fm.shape[1:-1]), fm.device),
                        fm[:-d]], dim=0)
        ga = torch.cat([torch.zeros_like(fa[:d]), fa[:-d]], dim=0)
        # compose f after g: x -> fm (gm x + ga) + fa
        fm, fa = F.mul(fm, gm), F.add(F.mul(ga, fm), fa)
        d *= 2
    return fa.movedim(0, -2).flip(-2)


def prefix_product(F: Field, a):
    """Inclusive running product along axis 0."""
    return F.prefix_product(a)


def lagrange_interpolate_int(p: int, points: list, evals: list) -> list:
    """Host O(n^2) Lagrange interpolation over python ints
    (arithmetic.rs:177-230); coefficient list of len(points)."""
    assert len(points) == len(evals)
    if len(points) == 1:
        return [evals[0] % p]
    n = len(points)
    coeffs = [0] * n
    for i, (xi, yi) in enumerate(zip(points, evals)):
        num = [1]
        denom = 1
        for j, xj in enumerate(points):
            if j == i:
                continue
            new = [0] * (len(num) + 1)
            for d, c in enumerate(num):
                new[d] = (new[d] - c * xj) % p
                new[d + 1] = (new[d + 1] + c) % p
            num = new
            denom = (denom * (xi - xj)) % p
        scale = (yi * pow(denom, p - 2, p)) % p
        for d, c in enumerate(num):
            coeffs[d] = (coeffs[d] + c * scale) % p
    return coeffs


def eval_polynomial_int(p: int, coeffs: list, x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc
