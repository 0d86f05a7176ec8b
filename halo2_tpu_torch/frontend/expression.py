"""Circuit expression AST: columns, selectors, challenges, queries.

Python rendering of halo2_frontend/src/plonk/circuit/expression.rs (Column
ordering rules :19-90, Expression variants :444-465) and the middleware AST
(halo2_middleware/src/expression.rs).  One Expression class serves both
layers; `Selector` nodes must be rewritten to fixed queries before a circuit
is compiled (mirroring the frontend->mid lowering at expression.rs:467-509).

Values are canonical python ints; device evaluation lives in
plonk/evaluation.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

# column kinds; ordering Instance < Advice < Fixed is consensus-critical
# (halo2_middleware/src/circuit.rs:175-192)
ADVICE = "advice"
FIXED = "fixed"
INSTANCE = "instance"
_KIND_ORDER = {INSTANCE: 0, ADVICE: 1, FIXED: 2}

FIRST_PHASE = 0
SECOND_PHASE = 1
THIRD_PHASE = 2


@dataclass(frozen=True, order=False)
class Column:
    kind: str
    index: int
    phase: int = 0      # meaningful for advice only

    def __lt__(self, other):
        # expression.rs:73-90: sort by kind order, then index (phase must not
        # influence ordering)
        return (_KIND_ORDER[self.kind], self.index) < (
            _KIND_ORDER[other.kind], other.index)

    def __repr__(self):
        return f"Column({self.kind}[{self.index}])"


@dataclass(frozen=True)
class Selector:
    index: int
    is_simple: bool = True

    def enable(self, region, offset: int):
        region.enable_selector(self, offset)

    def expr(self) -> "Expression":
        return Expression.selector(self)


@dataclass(frozen=True)
class Challenge:
    index: int
    phase: int

    def expr(self) -> "Expression":
        return Expression.challenge(self)


@dataclass(frozen=True)
class Rotation:
    i: int

    @staticmethod
    def cur():
        return Rotation(0)

    @staticmethod
    def prev():
        return Rotation(-1)

    @staticmethod
    def next():
        return Rotation(1)


class Expression:
    """Variant tags: const, selector, query, challenge, neg, sum, product,
    scaled.  Operator overloads build the tree; `evaluate` is the
    closure-fold from halo2_middleware/src/expression.rs:40-66."""

    __slots__ = ("tag", "value", "column", "rotation", "left", "right")

    def __init__(self, tag, value=None, column=None, rotation=None,
                 left=None, right=None):
        self.tag = tag
        self.value = value
        self.column = column
        self.rotation = rotation
        self.left = left
        self.right = right

    # constructors
    @staticmethod
    def const(v: int) -> "Expression":
        return Expression("const", value=int(v))

    @staticmethod
    def selector(s: Selector) -> "Expression":
        return Expression("selector", value=s)

    @staticmethod
    def query(column: Column, rotation: Rotation) -> "Expression":
        return Expression("query", column=column, rotation=rotation)

    @staticmethod
    def challenge(c: Challenge) -> "Expression":
        return Expression("challenge", value=c)

    # folds ------------------------------------------------------------

    def evaluate(self, constant, selector_fn, query_fn, challenge_fn,
                 negated, sum_, product, scaled):
        ev = lambda e: e.evaluate(constant, selector_fn, query_fn,
                                  challenge_fn, negated, sum_, product, scaled)
        t = self.tag
        if t == "const":
            return constant(self.value)
        if t == "selector":
            return selector_fn(self.value)
        if t == "query":
            return query_fn(self.column, self.rotation)
        if t == "challenge":
            return challenge_fn(self.value)
        if t == "neg":
            return negated(ev(self.left))
        if t == "sum":
            return sum_(ev(self.left), ev(self.right))
        if t == "product":
            return product(ev(self.left), ev(self.right))
        if t == "scaled":
            return scaled(ev(self.left), self.value)
        raise AssertionError(t)

    def degree(self) -> int:
        # expression.rs degree fold: queries and selectors are degree 1
        return self.evaluate(
            lambda _: 0, lambda _: 1, lambda c, r: 1, lambda _: 0,
            lambda a: a, max, lambda a, b: a + b, lambda a, _: a)

    def complexity(self) -> int:
        return self.evaluate(
            lambda _: 0, lambda _: 1, lambda c, r: 1, lambda _: 0,
            lambda a: a + 5, lambda a, b: a + b + 15,
            lambda a, b: a + b + 30, lambda a, _: a + 30)

    def identifier(self) -> str:
        t = self.tag
        if t == "const":
            return str(self.value)
        if t == "selector":
            return f"selector[{self.value.index}]"
        if t == "query":
            c = self.column
            return f"{c.kind}[{c.index}][{self.rotation.i}]"
        if t == "challenge":
            return f"challenge[{self.value.index}]"
        if t == "neg":
            return f"(-{self.left.identifier()})"
        if t == "sum":
            return f"({self.left.identifier()}+{self.right.identifier()})"
        if t == "product":
            return f"({self.left.identifier()}*{self.right.identifier()})"
        if t == "scaled":
            return f"{self.left.identifier()}*{self.value}"
        raise AssertionError(t)

    def map_queries(self, fn) -> "Expression":
        """Rebuild with query/selector/challenge leaves replaced via fn(expr)."""
        t = self.tag
        if t in ("const",):
            return self
        if t in ("selector", "query", "challenge"):
            return fn(self)
        if t == "neg":
            return Expression("neg", left=self.left.map_queries(fn))
        if t in ("sum", "product"):
            return Expression(t, left=self.left.map_queries(fn),
                              right=self.right.map_queries(fn))
        if t == "scaled":
            return Expression("scaled", value=self.value,
                              left=self.left.map_queries(fn))
        raise AssertionError(t)

    def uses_selector(self) -> bool:
        return self.evaluate(
            lambda _: False, lambda _: True, lambda c, r: False,
            lambda _: False, lambda a: a, lambda a, b: a or b,
            lambda a, b: a or b, lambda a, _: a)

    # operators ----------------------------------------------------------

    @staticmethod
    def _coerce(other):
        if isinstance(other, Expression):
            return other
        if isinstance(other, int):
            return Expression.const(other)
        return NotImplemented

    def __add__(self, other):
        other = Expression._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return Expression("sum", left=self, right=other)

    def __radd__(self, other):
        return Expression._coerce(other).__add__(self)

    def __sub__(self, other):
        other = Expression._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return Expression("sum", left=self, right=Expression("neg", left=other))

    def __rsub__(self, other):
        return Expression._coerce(other).__sub__(self)

    def __mul__(self, other):
        if isinstance(other, int):
            return Expression("scaled", value=other, left=self)
        other = Expression._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return Expression("product", left=self, right=other)

    def __rmul__(self, other):
        if isinstance(other, int):
            return Expression("scaled", value=other, left=self)
        return Expression._coerce(other).__mul__(self)

    def __neg__(self):
        return Expression("neg", left=self)

    def __repr__(self):
        return f"Expr({self.identifier()})"
