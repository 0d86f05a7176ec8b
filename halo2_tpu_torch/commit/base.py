"""Commitment-scheme shared types (port of the JAX reference's commit/base.py)."""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Optional


class Blind:
    """Blinding scalar; value is a host int."""

    __slots__ = ("value",)

    def __init__(self, value: int = 0):
        self.value = int(value)

    @staticmethod
    def random(Fr, rng) -> "Blind":
        return Blind(rng.randrange(Fr.p))

    def __repr__(self):
        return f"Blind({self.value})"


class PolyRef:
    """A committed coefficient-form polynomial plus its blind; queries group
    by object identity, like the reference's pointer equality."""

    __slots__ = ("poly", "blind")

    def __init__(self, poly, blind: Blind):
        from ..poly.poly import COEFF, unwrap
        self.poly = unwrap(poly, COEFF, "PolyRef")
        self.blind = blind


@dataclass
class ProverQuery:
    point: int
    poly_ref: PolyRef


@dataclass
class VerifierQuery:
    """Claimed evaluation of a commitment (affine int pair, or an MSM
    accumulator) at a point; `ident` names the slot it came from."""
    point: int
    commitment: Any
    eval: int
    is_msm: bool = False
    ident: Any = None

    def commitment_key(self):
        if self.ident is not None:
            return ("id", self.ident)
        if self.is_msm:
            return ("msm", id(self.commitment))
        return ("pt", self.commitment)


def new_rng(seed: Optional[int] = None) -> random.Random:
    return random.Random(seed) if seed is not None else random.SystemRandom()
