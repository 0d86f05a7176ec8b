"""ConstraintSystem builder.

Python rendering of halo2_frontend/src/plonk/circuit/constraint_system.rs:
column/selector/challenge allocation, gate & lookup & shuffle registration,
equality + constants, degree/blinding accounting, and lowering to the
middleware contract (`ConstraintSystemMid`) with selectors converted to fixed
columns (`directly_convert_selectors_to_fixed`, constraint_system.rs:662).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from .expression import (
    ADVICE, FIXED, INSTANCE, Column, Selector, Challenge, Expression, Rotation,
)


def _simple_selectors_of(expr: Expression):
    """All simple selectors appearing in `expr` (the reference's
    extract_simple_selector, expression.rs, tolerant to multiple)."""
    out = []

    def walk(e: Expression):
        if e.tag == "selector" and e.value.is_simple:
            out.append(e.value)
        for child in (e.left, e.right):
            if child is not None:
                walk(child)

    walk(expr)
    return out


@dataclass(frozen=True)
class TableColumn:
    """A fixed column wrapped for lookup-table use only (soundness guard,
    expression.rs:380-397)."""
    inner: Column


@dataclass
class Gate:
    name: str
    constraint_names: List[str]
    polys: List[Expression]
    queried_selectors: List[Selector] = field(default_factory=list)
    queried_cells: List[tuple] = field(default_factory=list)


@dataclass
class LookupArgument:
    name: str
    input_expressions: List[Expression]
    table_expressions: List[Expression]

    def required_degree(self) -> int:
        in_deg = max([1] + [e.degree() for e in self.input_expressions])
        tb_deg = max([1] + [e.degree() for e in self.table_expressions])
        return max(4, 2 + in_deg + tb_deg)


@dataclass
class ShuffleArgument:
    name: str
    input_expressions: List[Expression]
    shuffle_expressions: List[Expression]

    def required_degree(self) -> int:
        in_deg = max([1] + [e.degree() for e in self.input_expressions])
        sh_deg = max([1] + [e.degree() for e in self.shuffle_expressions])
        return max(2 + sh_deg, 2 + in_deg)


@dataclass
class PermutationArgument:
    columns: List[Column] = field(default_factory=list)

    def required_degree(self) -> int:
        return 3   # backend circuit.rs:292-325

    def add_column(self, col: Column):
        if col not in self.columns:
            self.columns.append(col)


class VirtualCells:
    """Query helper passed to gate closures (constraint_system.rs:1117-1166)."""

    def __init__(self, cs: "ConstraintSystem"):
        self.cs = cs
        self.queried_selectors: List[Selector] = []
        self.queried_cells: List[tuple] = []

    def query_advice(self, column: Column, at: Rotation) -> Expression:
        assert column.kind == ADVICE
        self.cs._record_query(column, at)
        self.queried_cells.append((column, at))
        return Expression.query(column, at)

    def query_fixed(self, column: Column, at: Rotation = Rotation(0)) -> Expression:
        assert column.kind == FIXED
        self.cs._record_query(column, at)
        self.queried_cells.append((column, at))
        return Expression.query(column, at)

    def query_instance(self, column: Column, at: Rotation) -> Expression:
        assert column.kind == INSTANCE
        self.cs._record_query(column, at)
        self.queried_cells.append((column, at))
        return Expression.query(column, at)

    def query_selector(self, selector: Selector) -> Expression:
        self.queried_selectors.append(selector)
        return Expression.selector(selector)

    def query_challenge(self, challenge: Challenge) -> Expression:
        return Expression.challenge(challenge)


class ConstraintSystem:
    def __init__(self):
        self.num_fixed_columns = 0
        self.num_advice_columns = 0
        self.num_instance_columns = 0
        self.num_selectors = 0
        self.num_challenges = 0
        self.advice_column_phase: List[int] = []
        self.challenge_phase: List[int] = []
        self.unblinded_advice_columns: List[int] = []
        self.selector_map: List[Column] = []
        self.gates: List[Gate] = []
        self.permutation = PermutationArgument()
        self.lookups: List[LookupArgument] = []
        self.shuffles: List[ShuffleArgument] = []
        self.constants: List[Column] = []
        self.minimum_degree: Optional[int] = None
        self.general_column_annotations = {}
        # deduped query lists (order of first use)
        self.advice_queries: List[Tuple[Column, Rotation]] = []
        self.num_advice_queries: List[int] = []
        self.fixed_queries: List[Tuple[Column, Rotation]] = []
        self.instance_queries: List[Tuple[Column, Rotation]] = []

    # -- columns ---------------------------------------------------------

    def advice_column(self) -> Column:
        return self.advice_column_in(0)

    def advice_column_in(self, phase: int) -> Column:
        col = Column(ADVICE, self.num_advice_columns, phase)
        self.num_advice_columns += 1
        self.advice_column_phase.append(phase)
        self.num_advice_queries.append(0)
        return col

    def unblinded_advice_column(self, phase: int = 0) -> Column:
        col = self.advice_column_in(phase)
        self.unblinded_advice_columns.append(col.index)
        return col

    def fixed_column(self) -> Column:
        col = Column(FIXED, self.num_fixed_columns)
        self.num_fixed_columns += 1
        return col

    def instance_column(self) -> Column:
        col = Column(INSTANCE, self.num_instance_columns)
        self.num_instance_columns += 1
        return col

    def selector(self) -> Selector:
        s = Selector(self.num_selectors, is_simple=True)
        self.num_selectors += 1
        return s

    def complex_selector(self) -> Selector:
        s = Selector(self.num_selectors, is_simple=False)
        self.num_selectors += 1
        return s

    def challenge_usable_after(self, phase: int) -> Challenge:
        # the challenge's phase tag is the phase whose commitments seed it:
        # it is squeezed after that phase's advice commitments and usable in
        # all later phases (constraint_system.rs:889, prover.rs:482-488)
        c = Challenge(self.num_challenges, phase)
        self.num_challenges += 1
        self.challenge_phase.append(phase)
        return c

    def lookup_table_column(self) -> TableColumn:
        return TableColumn(self.fixed_column())

    # -- equality / constants -------------------------------------------

    def enable_equality(self, column):
        col = column.inner if isinstance(column, TableColumn) else column
        self._record_query(col, Rotation(0))
        self.permutation.add_column(col)

    def enable_constant(self, column: Column):
        assert column.kind == FIXED
        if column not in self.constants:
            self.constants.append(column)
            self.enable_equality(column)

    # -- queries ---------------------------------------------------------

    def _record_query(self, column: Column, at: Rotation):
        if column.kind == ADVICE:
            if (column, at) not in self.advice_queries:
                self.advice_queries.append((column, at))
                self.num_advice_queries[column.index] += 1
        elif column.kind == FIXED:
            if (column, at) not in self.fixed_queries:
                self.fixed_queries.append((column, at))
        else:
            if (column, at) not in self.instance_queries:
                self.instance_queries.append((column, at))

    # -- gates / lookups / shuffles -------------------------------------

    def create_gate(self, name: str, constraints_fn: Callable):
        cells = VirtualCells(self)
        constraints = constraints_fn(cells)
        if isinstance(constraints, Expression):
            constraints = [constraints]
        named = []
        polys = []
        for i, c in enumerate(constraints):
            if isinstance(c, tuple):
                cname, expr = c
            else:
                cname, expr = str(i), c
            named.append(cname)
            polys.append(expr)
        assert polys, "gates must contain at least one constraint"
        self.gates.append(Gate(name, named, polys, cells.queried_selectors,
                               cells.queried_cells))

    def lookup(self, name: str, table_map_fn: Callable) -> int:
        """table_map_fn(cells) -> [(input_expr, TableColumn)]."""
        cells = VirtualCells(self)
        mapping = table_map_fn(cells)
        inputs, tables = [], []
        for inp, table in mapping:
            assert isinstance(table, TableColumn), \
                "lookup() requires TableColumns; use lookup_any for expressions"
            assert not inp.uses_selector() or True
            if inp.tag == "selector" and inp.value.is_simple:
                raise ValueError("expression containing simple selector "
                                 "supplied to lookup argument")
            inputs.append(inp)
            tables.append(cells.query_fixed(table.inner, Rotation(0)))
        index = len(self.lookups)
        self.lookups.append(LookupArgument(name, inputs, tables))
        return index

    def lookup_any(self, name: str, table_map_fn: Callable) -> int:
        """table_map_fn(cells) -> [(input_expr, table_expr)]."""
        cells = VirtualCells(self)
        mapping = table_map_fn(cells)
        inputs = [i for i, _ in mapping]
        tables = [t for _, t in mapping]
        index = len(self.lookups)
        self.lookups.append(LookupArgument(name, inputs, tables))
        return index

    def shuffle(self, name: str, shuffle_map_fn: Callable) -> int:
        cells = VirtualCells(self)
        mapping = shuffle_map_fn(cells)
        index = len(self.shuffles)
        self.shuffles.append(ShuffleArgument(
            name, [i for i, _ in mapping], [s for _, s in mapping]))
        return index

    def set_minimum_degree(self, degree: int):
        self.minimum_degree = degree

    # -- degree accounting (backend circuit.rs:100-180) ------------------

    def degree(self) -> int:
        # the permutation argument's degree-3 floor applies unconditionally
        # (backend circuit.rs:100-139)
        degree = self.permutation.required_degree()
        for lk in self.lookups:
            degree = max(degree, lk.required_degree())
        for sh in self.shuffles:
            degree = max(degree, sh.required_degree())
        for gate in self.gates:
            for poly in gate.polys:
                degree = max(degree, poly.degree())
        return max(degree, self.minimum_degree or 1)

    def blinding_factors(self) -> int:
        factors = max(self.num_advice_queries + [1])
        factors = max(3, factors)
        return factors + 1 + 1   # +1 multiopen eval, +1 safety

    def minimum_rows(self) -> int:
        return self.blinding_factors() + 3

    def usable_rows(self, k: int) -> int:
        """Rows of 2^k a circuit can assign: all but the blinding rows
        and the last."""
        return (1 << k) - (self.blinding_factors() + 1)

    def phases(self) -> List[int]:
        return sorted(set([0] + self.advice_column_phase +
                          self.challenge_phase))

    # -- selector conversion (constraint_system.rs:595-708) --------------

    def _replace_selectors(self, replacements):
        """Substitute selector leaves by expression, everywhere
        (constraint_system.rs replace_selectors_with_fixed)."""

        def replace(expr: Expression) -> Expression:
            if expr.tag == "selector":
                return replacements[expr.value.index]
            return expr

        for gate in self.gates:
            gate.polys = [p.map_queries(replace) for p in gate.polys]
        for lk in self.lookups:
            lk.input_expressions = [e.map_queries(replace)
                                    for e in lk.input_expressions]
            lk.table_expressions = [e.map_queries(replace)
                                    for e in lk.table_expressions]
        for sh in self.shuffles:
            sh.input_expressions = [e.map_queries(replace)
                                    for e in sh.input_expressions]
            sh.shuffle_expressions = [e.map_queries(replace)
                                      for e in sh.shuffle_expressions]
        self.num_selectors = 0

    def compress_selectors(self, selector_values):
        """Degree-budgeted packing of mutually-exclusive simple selectors
        into shared fixed columns (constraint_system.rs:595-659).  Returns
        the new fixed-column value lists to append; mutates self."""
        from .compress_selectors import SelectorDescription, process

        assert len(selector_values) == self.num_selectors
        # Max degree of any gate using each simple selector; complex or
        # unused selectors stay at 0 (constraint_system.rs:600-609).
        degrees = [0] * self.num_selectors
        for gate in self.gates:
            for poly in gate.polys:
                for sel in _simple_selectors_of(poly):
                    degrees[sel.index] = max(degrees[sel.index],
                                             poly.degree())
        max_degree = self.degree()

        new_columns: List[Column] = []

        def allocate_fixed_column() -> Expression:
            col = self.fixed_column()
            new_columns.append(col)
            self._record_query(col, Rotation(0))
            return Expression.query(col, Rotation(0))

        descriptions = [
            SelectorDescription(i, list(activations), degrees[i])
            for i, activations in enumerate(selector_values)
        ]
        polys, assignments = process(descriptions, max_degree,
                                     allocate_fixed_column)

        replacements = [None] * len(assignments)
        selector_map = [None] * len(assignments)
        for a in assignments:
            replacements[a.selector] = a.expression
            selector_map[a.selector] = new_columns[a.combination_index]
        self.selector_map = selector_map
        self._replace_selectors(replacements)
        return polys

    def directly_convert_selectors_to_fixed(self, selector_values):
        """Replace every selector with a dedicated fixed column holding its
        0/1 activations.  Returns the fixed-column value lists to append.
        Mutates gates/lookups/shuffles in place."""
        assert len(selector_values) == self.num_selectors
        new_cols = {}
        polys = []
        for sel_idx, values in enumerate(selector_values):
            col = self.fixed_column()
            new_cols[sel_idx] = col
            polys.append([1 if b else 0 for b in values])
            self.selector_map.append(col)

        def replace(expr: Expression) -> Expression:
            if expr.tag == "selector":
                col = new_cols[expr.value.index]
                self._record_query(col, Rotation(0))
                return Expression.query(col, Rotation(0))
            return expr

        for gate in self.gates:
            gate.polys = [p.map_queries(replace) for p in gate.polys]
        for lk in self.lookups:
            lk.input_expressions = [e.map_queries(replace)
                                    for e in lk.input_expressions]
            lk.table_expressions = [e.map_queries(replace)
                                    for e in lk.table_expressions]
        for sh in self.shuffles:
            sh.input_expressions = [e.map_queries(replace)
                                    for e in sh.input_expressions]
            sh.shuffle_expressions = [e.map_queries(replace)
                                      for e in sh.shuffle_expressions]
        self.num_selectors = 0
        return polys
