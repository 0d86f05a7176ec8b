"""Basis-typed polynomial container (port of halo2_tpu/poly/poly.py).

A polynomial is an (..., n, 8) tensor plus a basis tag, checked and
unwrapped at every basis-sensitive boundary (domain transforms,
`Params.commit*`, `eval_polys_at_points`, `kate_division`, `PolyRef`).
Boundary functions accept a raw tensor or a `Poly`; a `Poly` of the wrong
basis raises `TypeError`, and typed inputs give typed outputs.
"""

from __future__ import annotations

import torch

COEFF = "coeff"
LAGRANGE = "lagrange"
EXTENDED = "extended"
_BASES = (COEFF, LAGRANGE, EXTENDED)


class Poly:
    __slots__ = ("values", "basis")

    def __init__(self, values, basis: str):
        if basis not in _BASES:
            raise TypeError(f"unknown polynomial basis {basis!r}")
        self.values = values
        self.basis = basis

    @staticmethod
    def coeff(values) -> "Poly":
        return Poly(values, COEFF)

    @staticmethod
    def lagrange(values) -> "Poly":
        return Poly(values, LAGRANGE)

    @staticmethod
    def extended(values) -> "Poly":
        return Poly(values, EXTENDED)

    @staticmethod
    def stack(polys, dim: int = 0) -> "Poly":
        bases = {p.basis for p in polys}
        if len(bases) != 1:
            raise TypeError(f"cannot stack mixed bases {sorted(bases)}")
        return Poly(torch.stack([p.values for p in polys], dim=dim),
                    bases.pop())

    @property
    def shape(self):
        return self.values.shape

    @property
    def ndim(self):
        return self.values.dim()

    def __len__(self):
        return self.values.shape[0]

    def __getitem__(self, idx) -> "Poly":
        return Poly(self.values[idx], self.basis)

    def __repr__(self):
        return f"Poly<{self.basis}>{tuple(self.values.shape)}"


def unwrap(x, basis: str, what: str = "operation"):
    if isinstance(x, Poly):
        if x.basis != basis:
            raise TypeError(
                f"{what} expects a {basis}-basis polynomial, got "
                f"{x.basis}-basis {x!r}")
        return x.values
    return x


def take(x, basis: str, what: str = "operation"):
    if isinstance(x, Poly):
        return unwrap(x, basis, what), True
    return x, False
