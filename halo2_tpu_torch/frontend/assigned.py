"""Deferred-division witness values — halo2_frontend/src/plonk/assigned.rs.

Circuit synthesis frequently divides (inverting a cell, normalizing a
slope); field inversion is the one expensive host-side op.  `Assigned`
represents values as exact rationals num/den over the integers and defers
the modular inversion until materialization, where `batch_evaluate`
resolves a whole column with ONE modular inversion (Montgomery batch trick
— the reference's `batch_invert_assigned`, frontend/src/circuit.rs:363-404).
"""

from __future__ import annotations

from typing import List, Sequence


class Assigned:
    """Zero / Trivial(n) / Rational(n, d) in one exact-rational carrier.

    Arithmetic never reduces mod p and never inverts; `evaluate(p)` (or the
    batched form) performs the single division at the end.
    """

    __slots__ = ("num", "den")

    def __init__(self, num: int, den: int = 1):
        if den == 0:
            raise ZeroDivisionError("Assigned with zero denominator")
        self.num = int(num)
        self.den = int(den)

    # constructors ------------------------------------------------------
    @staticmethod
    def zero() -> "Assigned":
        return Assigned(0)

    @staticmethod
    def trivial(v: int) -> "Assigned":
        return Assigned(v)

    @staticmethod
    def rational(num: int, den: int) -> "Assigned":
        return Assigned(num, den)

    # predicates --------------------------------------------------------
    def is_zero_vartime(self) -> bool:
        return self.num == 0

    # arithmetic (assigned.rs ops) ---------------------------------------
    @staticmethod
    def _coerce(other) -> "Assigned":
        return other if isinstance(other, Assigned) else Assigned(other)

    def __add__(self, other):
        o = self._coerce(other)
        if self.den == o.den:
            return Assigned(self.num + o.num, self.den)
        return Assigned(self.num * o.den + o.num * self.den,
                        self.den * o.den)

    __radd__ = __add__

    def __sub__(self, other):
        return self + (-self._coerce(other))

    def __rsub__(self, other):
        return self._coerce(other) + (-self)

    def __neg__(self):
        return Assigned(-self.num, self.den)

    def __mul__(self, other):
        o = self._coerce(other)
        return Assigned(self.num * o.num, self.den * o.den)

    __rmul__ = __mul__

    def square(self) -> "Assigned":
        return Assigned(self.num * self.num, self.den * self.den)

    def cube(self) -> "Assigned":
        return Assigned(self.num ** 3, self.den ** 3)

    def invert(self) -> "Assigned":
        """Deferred inversion: just swap numerator and denominator
        (assigned.rs `invert`).  0.invert() stays 0, matching the
        reference's `Rational(den, 0)` → evaluates to 0 convention."""
        if self.num == 0:
            return Assigned(0)
        return Assigned(self.den, self.num)

    def __truediv__(self, other):
        return self * self._coerce(other).invert()

    # evaluation ---------------------------------------------------------
    def evaluate(self, p: int) -> int:
        """num * den^-1 mod p (assigned.rs `evaluate`)."""
        num = self.num % p
        if num == 0:
            return 0
        den = self.den % p
        if den == 1:
            return num
        return num * pow(den, p - 2, p) % p

    def __repr__(self):
        if self.den == 1:
            return f"Assigned({self.num})"
        return f"Assigned({self.num}/{self.den})"

    def __eq__(self, other):
        if not isinstance(other, Assigned):
            return NotImplemented
        return self.num * other.den == other.num * self.den

    def __hash__(self):
        return hash((self.num, self.den))


def batch_evaluate(p: int, values: Sequence[Assigned]) -> List[int]:
    """Resolve many deferred divisions with one modular inversion
    (`batch_invert_assigned`): prefix-product all denominators, invert the
    total once, then peel per-element inverses off the running product."""
    dens = [(v.den % p) if isinstance(v, Assigned) else 1 for v in values]
    prefix = [1] * (len(dens) + 1)
    for i, d in enumerate(dens):
        prefix[i + 1] = prefix[i] * d % p
    inv_all = pow(prefix[-1], p - 2, p) if prefix[-1] else 0
    out = [0] * len(dens)
    for i in range(len(dens) - 1, -1, -1):
        inv_d = inv_all * prefix[i] % p
        inv_all = inv_all * dens[i] % p
        v = values[i]
        num = (v.num if isinstance(v, Assigned) else int(v)) % p
        out[i] = num * inv_d % p
    return out
