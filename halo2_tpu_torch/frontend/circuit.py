"""Circuit trait, Value/AssignedCell, regions, floor planning, compilation.

Python rendering of halo2_frontend/src/circuit.rs (compile_circuit :40-112,
WitnessCalculator :255-359, Layouter/Region user API :414-979) and the
single-pass floor planner (floor_planner/single_pass.rs): regions are
measured with a shape pass, placed at the earliest row where every used
column is free, then assigned.

Witness values are canonical python ints wrapped in `Value` (known/unknown);
reduction happens at assignment against the circuit's field modulus.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from .assigned import Assigned
from .constraint_system import ConstraintSystem
from .expression import (
    ADVICE, FIXED, INSTANCE, Column, Selector, Challenge, Rotation,
)


def _reduce_value(v, p: int) -> int:
    """Materialize a witness payload: resolve a deferred-division
    `Assigned` (one modular inversion) or reduce a plain int."""
    if isinstance(v, Assigned):
        return v.evaluate(p)
    return int(v) % p


def _materialize_column(p: int, col: List) -> List[int]:
    """Resolve a whole column of deferred payloads (int or `Assigned`) to
    canonical ints with at most ONE modular inversion — the reference's
    `batch_invert_assigned` (halo2_frontend/src/circuit.rs:363-404).  The
    per-cell `pow(den, p-2, p)` this replaces is O(cells) host modexps,
    noticeable at k>=18."""
    from .assigned import batch_evaluate
    if any(isinstance(v, Assigned) and v.den != 1 for v in col):
        return batch_evaluate(p, col)
    return [(v.num if isinstance(v, Assigned) else int(v)) % p for v in col]


class SynthesisError(Exception):
    pass


class NotEnoughRowsAvailable(Exception):
    def __init__(self, k):
        super().__init__(f"not enough rows available, need larger k than {k}")
        self.k = k


class Value:
    """Option-like witness wrapper (frontend/src/circuit/value.rs)."""

    __slots__ = ("_v",)

    def __init__(self, v=None):
        self._v = v

    @staticmethod
    def unknown() -> "Value":
        return Value(None)

    @staticmethod
    def known(v: int) -> "Value":
        return Value(int(v))

    def is_known(self) -> bool:
        return self._v is not None

    def value(self):
        return self._v

    def map(self, fn) -> "Value":
        return Value(fn(self._v)) if self._v is not None else Value()

    def zip(self, other: "Value") -> "Value":
        if self._v is None or other._v is None:
            return Value()
        return Value((self._v, other._v))

    def and_then(self, fn) -> "Value":
        return fn(self._v) if self._v is not None else Value()

    # Assigned lifting (value.rs:658-744 to_field/into_field)
    def to_field(self) -> "Value":
        """Wrap the payload as a deferred-division `Assigned`."""
        return self.map(lambda v: v if isinstance(v, Assigned)
                        else Assigned.trivial(v))

    def into_field(self) -> "Value":
        return self.to_field()

    def cube(self) -> "Value":
        return self.map(lambda v: v * v * v)

    # arithmetic combinators (reduction deferred to assignment)
    def __add__(self, other):
        other = other if isinstance(other, Value) else Value.known(other)
        return self.zip(other).map(lambda ab: ab[0] + ab[1])

    def __sub__(self, other):
        other = other if isinstance(other, Value) else Value.known(other)
        return self.zip(other).map(lambda ab: ab[0] - ab[1])

    def __mul__(self, other):
        other = other if isinstance(other, Value) else Value.known(other)
        return self.zip(other).map(lambda ab: ab[0] * ab[1])

    def double(self):
        return self.map(lambda v: 2 * v)

    def square(self):
        return self.map(lambda v: v * v)

    def invert(self, p: int = None) -> "Value":
        """With p: immediate modular inversion.  Without: deferred — lifts
        to `Assigned` and swaps numerator/denominator (free until the cell
        is materialized, where one batchable inversion resolves it)."""
        if p is None:
            return self.to_field().map(lambda a: a.invert())
        return self.map(lambda v: pow(v, p - 2, p) if v % p else 0)

    def __repr__(self):
        return f"Value({self._v})"


@dataclass(frozen=True)
class Cell:
    column: Column
    row: int


class AssignedCell:
    __slots__ = ("cell", "_value")

    def __init__(self, cell: Cell, value: Value):
        self.cell = cell
        self._value = value

    def value(self) -> Value:
        return self._value

    def copy_advice(self, region: "Region", column: Column,
                    offset: int) -> "AssignedCell":
        out = region.assign_advice(column, offset, self._value)
        if region._shape is None:   # only the assign pass records the copy
            region._layouter._assignment.copy(
                self.cell.column, self.cell.row, out.cell.column, out.cell.row)
        return out


class _RegionShape:
    """Shape-measuring sink for the first pass."""

    def __init__(self):
        self.columns = set()
        self.row_count = 0

    def note(self, column, offset):
        self.columns.add(column)
        self.row_count = max(self.row_count, offset + 1)


class Region:
    """User-facing region handle; in shape mode records geometry only."""

    def __init__(self, layouter, shape: Optional[_RegionShape], start: int):
        self._layouter = layouter
        self._shape = shape
        self._start = start

    @property
    def _assignment(self):
        return self._layouter._assignment

    def _abs(self, offset: int) -> int:
        return self._start + offset

    def assign_advice(self, column: Column, offset: int,
                      value) -> AssignedCell:
        if callable(value):
            value = value()
        if not isinstance(value, Value):
            value = Value.known(value)
        if self._shape is not None:
            self._shape.note(column, offset)
            return AssignedCell(Cell(column, offset), value)
        row = self._abs(offset)
        self._assignment.assign_advice(column, row, value)
        return AssignedCell(Cell(column, row), value)

    def assign_advice_column(self, column: Column, offset: int, values):
        """Bulk slice assignment: assigns values[i] to rows offset+i in one
        call.  The per-cell `assign_advice` walks every witness value
        through Python closures/Value objects — fine for gadget-sized
        regions, but zkEVM-class circuits assign millions of cells
        (the reference gets the same effect from rayon parallel regions,
        `thread-safe-region` / examples/vector-mul.rs; here the witness
        matrix is column-major anyway — WitnessCalculator::calc,
        halo2_frontend/src/circuit.rs:255-359)."""
        if not values:
            return
        if self._shape is not None:
            self._shape.note(column, offset + len(values) - 1)
            return
        row0 = self._abs(offset)
        sink = self._assignment
        if hasattr(sink, "assign_advice_slice"):
            sink.assign_advice_slice(column, row0, values)
        else:
            for i, v in enumerate(values):
                sink.assign_advice(
                    column, row0 + i,
                    v if isinstance(v, Value) else Value.known(v))

    def assign_fixed_column(self, column: Column, offset: int, values):
        """Bulk fixed-column slice (see assign_advice_column)."""
        if not values:
            return
        if self._shape is not None:
            self._shape.note(column, offset + len(values) - 1)
            return
        row0 = self._abs(offset)
        sink = self._assignment
        if hasattr(sink, "assign_fixed_slice"):
            sink.assign_fixed_slice(column, row0, values)
        else:
            for i, v in enumerate(values):
                sink.assign_fixed(
                    column, row0 + i,
                    v if isinstance(v, Value) else Value.known(v))

    def assign_advice_from_constant(self, column: Column, offset: int,
                                    constant: int) -> AssignedCell:
        cell = self.assign_advice(column, offset, Value.known(constant))
        if self._shape is None:
            self._layouter._constants_to_assign.append((constant, cell.cell))
        return cell

    def assign_advice_from_instance(self, instance: Column, instance_row: int,
                                    column: Column, offset: int) -> AssignedCell:
        if self._shape is not None:
            self._shape.note(column, offset)
            return AssignedCell(Cell(column, offset), Value.unknown())
        value = self._assignment.query_instance(instance, instance_row)
        row = self._abs(offset)
        self._assignment.assign_advice(column, row, value)
        self._assignment.copy(instance, instance_row, column, row)
        return AssignedCell(Cell(column, row), value)

    def assign_fixed(self, column: Column, offset: int, value) -> AssignedCell:
        if callable(value):
            value = value()
        if not isinstance(value, Value):
            value = Value.known(value)
        if self._shape is not None:
            self._shape.note(column, offset)
            return AssignedCell(Cell(column, offset), value)
        row = self._abs(offset)
        self._assignment.assign_fixed(column, row, value)
        return AssignedCell(Cell(column, row), value)

    def enable_selector(self, selector: Selector, offset: int):
        if self._shape is not None:
            self._shape.note(("selector", selector.index), offset)
            return
        self._assignment.enable_selector(selector, self._abs(offset))

    def constrain_equal(self, a: Cell, b: Cell):
        if self._shape is None:
            self._assignment.copy(a.column, a.row, b.column, b.row)

    def constrain_equal_rows(self, a: Column, a_offsets, b: Column,
                             b_offsets):
        """Bulk `constrain_equal`: column a at offset a_offsets[i] equals
        column b at offset b_offsets[i], for every i, in one call (see
        assign_advice_column).  A circuit with a copy a row would
        otherwise make two `Cell`s and a call per copy in every proof's
        synthesis, where the witness calculator drops them all."""
        if self._shape is not None:
            return
        start = self._start
        rows = ((start + i, start + j) for i, j in zip(a_offsets, b_offsets))
        sink = self._assignment
        if hasattr(sink, "copy_rows"):
            sink.copy_rows(a, b, rows)
        else:
            for i, j in rows:
                sink.copy(a, i, b, j)

    def constrain_constant(self, cell: Cell, constant: int):
        if self._shape is None:
            self._layouter._constants_to_assign.append((constant, cell))


class TableError(SynthesisError):
    """Lookup-table layout errors (frontend/src/plonk/error.rs TableError)."""


class _Table:
    """SimpleTableLayouter (table_layouter.rs:73-116): records per-column
    default values (the offset-0 assignment) and an assigned-cells bitmap."""

    def __init__(self, layouter, used_columns):
        self._layouter = layouter
        self._used = used_columns
        # TableColumn -> [default value | None, list[bool] assigned bitmap]
        self.default_and_assigned: Dict = {}

    def assign_cell(self, column, offset: int, value):
        if column in self._used:
            raise TableError(f"table column {column} already used in "
                             "another table")
        if callable(value):
            value = value()
        if not isinstance(value, Value):
            value = Value.known(value)
        entry = self.default_and_assigned.setdefault(column, [None, []])
        self._layouter._assignment.assign_fixed(column.inner, offset, value)
        if offset == 0:
            if entry[0] is None:
                # Use the value at offset 0 as the column default
                # (table_layouter.rs:100-107).
                entry[0] = value
            else:
                raise TableError(
                    f"attempted to overwrite default value of {column}")
        if len(entry[1]) <= offset:
            entry[1].extend([False] * (offset + 1 - len(entry[1])))
        entry[1][offset] = True


def compute_table_lengths(default_and_assigned) -> int:
    """All table columns must be fully assigned on [0, len) with equal len
    (table_layouter.rs:118-170); returns that shared length."""
    lengths = {}
    for col, (default, assigned) in default_and_assigned.items():
        if default is None or not assigned:
            raise TableError(f"table column {col} not assigned")
        if not all(assigned):
            raise TableError(f"table column {col} has unassigned gaps")
        lengths[col] = len(assigned)
    distinct = set(lengths.values())
    if len(distinct) > 1:
        raise TableError(f"uneven table column lengths: {lengths}")
    return distinct.pop() if distinct else 0


class Layouter:
    """Single-chip layouter (floor_planner/single_pass.rs:28-105)."""

    def __init__(self, assignment, constants: List[Column]):
        self._assignment = assignment
        self._constants = constants
        self._columns_cursor: Dict = {}
        self._constants_cursor = 0
        self._constants_to_assign: List = []
        self._table_columns = set()

    def assign_region(self, name: str, closure: Callable):
        # pass 1: measure
        shape = _RegionShape()
        self._assignment.enter_region(name)
        closure(Region(self, shape, 0))
        # place at earliest row where all used columns are free
        start = 0
        for col in shape.columns:
            start = max(start, self._columns_cursor.get(col, 0))
        for col in shape.columns:
            self._columns_cursor[col] = start + shape.row_count
        # pass 2: assign
        result = closure(Region(self, None, start))
        self._assignment.exit_region()
        self._flush_constants()
        return result

    def assign_table(self, name: str, closure: Callable):
        """Table region (single_pass.rs assign_table): cells at absolute
        rows, then unused rows [first_unused, usable) are filled with each
        column's default value so every usable row is a valid table entry."""
        self._assignment.enter_region(name)
        table = _Table(self, self._table_columns)
        result = closure(table)
        self._assignment.exit_region()
        first_unused = compute_table_lengths(table.default_and_assigned)
        for col in table.default_and_assigned:
            self._table_columns.add(col)
        for col, (default, _) in table.default_and_assigned.items():
            self._assignment.fill_from_row(col.inner, first_unused, default)
        return result

    def _flush_constants(self):
        if not self._constants_to_assign:
            return
        if not self._constants:
            raise SynthesisError(
                "constrain_constant requires an enable_constant column")
        col = self._constants[0]
        for constant, advice_cell in self._constants_to_assign:
            row = self._constants_cursor
            # constants column also advances the shared cursor
            self._columns_cursor[col] = max(
                self._columns_cursor.get(col, 0), row + 1)
            self._constants_cursor += 1
            self._assignment.assign_fixed(col, row, Value.known(constant))
            self._assignment.copy(col, row, advice_cell.column,
                                  advice_cell.row)
        self._constants_to_assign = []

    def constrain_instance(self, cell: Cell, instance: Column, row: int):
        self._assignment.copy(cell.column, cell.row, instance, row)

    def get_challenge(self, challenge: Challenge) -> Value:
        return self._assignment.get_challenge(challenge)

    def namespace(self, name: str) -> "NamespacedLayouter":
        """Namespaced view (circuit.rs:889-946).  The view pushes the
        namespace onto the assignment (when it implements the hooks) and
        reports gadget provenance on pop — see NamespacedLayouter."""
        return NamespacedLayouter(self, name)


class NamespacedLayouter:
    """`Layouter.namespace` result — the reference's NamespacedLayouter
    (halo2_frontend/src/circuit.rs:889-979).  On pop it hands the
    assignment the GADGET name that opened the namespace: the reference's
    `gadget-traces` feature resolves the caller's symbol from a backtrace
    on Drop (circuit.rs:948-979); the Python analog captures the caller's
    qualified function name at namespace creation.  Pop happens on
    context-manager exit, explicit `.pop()`, or GC — idempotent."""

    def __init__(self, parent, name: str):
        import inspect
        self._parent = parent
        self._popped = False
        gadget = None
        frame = inspect.currentframe()
        if frame is not None and frame.f_back is not None \
                and frame.f_back.f_back is not None:
            code = frame.f_back.f_back.f_code
            gadget = getattr(code, "co_qualname", code.co_name)
        self._gadget = gadget
        push = getattr(parent._assignment, "push_namespace", None)
        if push is not None:
            push(name)

    def __getattr__(self, k):
        return getattr(self._parent, k)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.pop()
        return False

    def __del__(self):
        try:
            self.pop()
        except Exception:
            pass

    def pop(self):
        if self._popped:
            return
        self._popped = True
        pop = getattr(self._parent._assignment, "pop_namespace", None)
        if pop is not None:
            pop(self._gadget)


class SimpleFloorPlanner:
    @staticmethod
    def synthesize(assignment, circuit, config, constants):
        layouter = Layouter(assignment, constants)
        circuit.synthesize(config, layouter)


class Circuit:
    """Base class (halo2_frontend/src/plonk/circuit.rs:241-284)."""

    floor_planner = SimpleFloorPlanner

    def without_witnesses(self) -> "Circuit":
        raise NotImplementedError

    def params(self):
        """Runtime circuit configuration parameters — the `circuit-params`
        feature's `Circuit::Params` (circuit.rs:250-262).  Returning a
        non-None value routes configuration through
        `configure_with_params`."""
        return None

    def configure_with_params(self, meta: ConstraintSystem, params):
        """circuit.rs:264-274: default ignores the params and calls plain
        `configure`, so circuits without runtime parameters need nothing."""
        return self.configure(meta)

    def configure(self, meta: ConstraintSystem):
        raise NotImplementedError

    def synthesize(self, config, layouter: Layouter):
        raise NotImplementedError


def configure_circuit(circuit: "Circuit", cs: ConstraintSystem):
    """The single configuration entry point: uses the circuit's runtime
    params when it provides them (`circuit-params` seam, circuit.rs:247-274)
    and plain `configure` otherwise."""
    params = circuit.params()
    if params is not None:
        return circuit.configure_with_params(cs, params)
    return circuit.configure(cs)


# ----------------------------------------------------------------------
# assignment sinks
# ----------------------------------------------------------------------

class KeygenAssembly:
    """Records fixed values, selectors, and copies (frontend keygen.rs:13-163)."""

    def __init__(self, p: int, k: int, cs: ConstraintSystem):
        self.p = p
        self.k = k
        self.n = 1 << k
        self.usable_rows = cs.usable_rows(k)
        self.fixed = [[0] * self.n for _ in range(cs.num_fixed_columns)]
        self.selectors = [[False] * self.n for _ in range(cs.num_selectors)]
        self.copies: List = []

    def enter_region(self, name):
        pass

    def exit_region(self):
        pass

    def enable_selector(self, selector: Selector, row: int):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        self.selectors[selector.index][row] = True

    def query_instance(self, column: Column, row: int) -> Value:
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        return Value.unknown()

    def assign_advice(self, column: Column, row: int, value: Value):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)

    def assign_advice_slice(self, column: Column, row0: int, values):
        if row0 + len(values) > self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)

    def assign_fixed(self, column: Column, row: int, value: Value):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        if value.is_known():
            # deferred payload; batch-resolved in compile_circuit
            self.fixed[column.index][row] = value.value()

    def assign_fixed_slice(self, column: Column, row0: int, values):
        if row0 + len(values) > self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        col = self.fixed[column.index]
        for i, v in enumerate(values):
            if isinstance(v, Value):
                if not v.is_known():
                    continue
                v = v.value()
            col[row0 + i] = v

    def copy(self, lcol: Column, lrow: int, rcol: Column, rrow: int):
        if lrow >= self.usable_rows or rrow >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        self.copies.append(((lcol, lrow), (rcol, rrow)))

    def fill_from_row(self, column: Column, from_row: int, value: Value):
        """Fill [from_row, usable_rows) with `value` (keygen.rs
        fill_from_row) — the table-column default-padding hook."""
        if from_row > self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        if value.is_known():
            v = value.value()
            col = self.fixed[column.index]
            for row in range(from_row, self.usable_rows):
                col[row] = v

    def get_challenge(self, challenge) -> Value:
        return Value.unknown()


class WitnessCollection:
    """Per-phase advice-only sink (frontend/src/circuit.rs:114-251)."""

    def __init__(self, p: int, k: int, cs: ConstraintSystem, phase: int,
                 instances: List[List[int]], challenges: Dict[int, int],
                 usable_rows: int):
        self.p = p
        self.k = k
        self.n = 1 << k
        self.cs = cs
        self.phase = phase
        self.instances = instances
        self.challenges = challenges
        self.usable_rows = usable_rows
        self.advice = {i: [0] * self.n
                       for i, ph in enumerate(cs.advice_column_phase)
                       if ph == phase}

    def enter_region(self, name):
        pass

    def exit_region(self):
        pass

    def enable_selector(self, selector, row):
        pass

    def query_instance(self, column: Column, row: int) -> Value:
        if row >= len(self.instances[column.index]):
            if row >= self.usable_rows:
                raise NotEnoughRowsAvailable(self.k)
            return Value.known(0)
        return Value.known(self.instances[column.index][row])

    def assign_advice(self, column: Column, row: int, value: Value):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        if column.phase != self.phase:
            return
        if not value.is_known():
            raise SynthesisError(
                f"unknown witness value at {column} row {row}")
        # store the deferred payload; divisions resolve column-batched at
        # the end of the phase (WitnessCalculator.calc)
        self.advice[column.index][row] = value.value()

    def assign_advice_slice(self, column: Column, row0: int, values):
        """Bulk path for Region.assign_advice_column: raw ints (or
        Assigned) land directly in the column list — no per-cell Value."""
        if row0 + len(values) > self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        if column.phase != self.phase:
            return
        col = self.advice[column.index]
        for i, v in enumerate(values):
            if isinstance(v, Value):
                if not v.is_known():
                    raise SynthesisError(
                        f"unknown witness value at {column} row {row0 + i}")
                v = v.value()
            col[row0 + i] = v

    def assign_fixed(self, column, row, value):
        pass

    def assign_fixed_slice(self, column, row0, values):
        pass

    def fill_from_row(self, column, from_row, value):
        pass

    def copy(self, *args):
        pass

    def copy_rows(self, *args):
        pass

    def get_challenge(self, challenge: Challenge) -> Value:
        if challenge.index in self.challenges:
            return Value.known(self.challenges[challenge.index])
        return Value.unknown()


# ----------------------------------------------------------------------
# compilation
# ----------------------------------------------------------------------

@dataclass
class Preprocessing:
    """halo2_middleware/src/circuit.rs:141-144."""
    fixed: List[List[int]]
    copies: List


@dataclass
class CompiledCircuit:
    """The frontend/backend contract (middleware circuit.rs:149-152)."""
    cs: ConstraintSystem     # selector-free after conversion
    preprocessing: Preprocessing


def compile_circuit(F, k: int, circuit: Circuit,
                    compress_selectors: bool = True):
    """Frontend compilation (frontend/src/circuit.rs:40-112).

    Returns (CompiledCircuit, config, cs).  With compress_selectors=True,
    mutually-exclusive simple selectors are packed into shared fixed columns
    (compress_selectors.rs); otherwise each selector becomes its own 0/1
    fixed column.  vk and pk must be generated with the same setting
    (halo2_proofs/src/plonk/keygen.rs:30-52).
    """
    cs = ConstraintSystem()
    config = configure_circuit(circuit, cs)
    n = 1 << k
    if n < cs.minimum_rows():
        raise NotEnoughRowsAvailable(k)

    assembly = KeygenAssembly(F.p, k, cs)
    circuit.floor_planner.synthesize(
        assembly, circuit.without_witnesses(), config, cs.constants)

    if compress_selectors:
        selector_polys = cs.compress_selectors(assembly.selectors)
    else:
        selector_polys = cs.directly_convert_selectors_to_fixed(
            assembly.selectors)
    # batch_invert_assigned equivalent (circuit.rs:82): one modular
    # inversion per fixed column resolves every deferred division
    fixed = [_materialize_column(F.p, col) for col in assembly.fixed]
    fixed.extend(selector_polys)

    return (CompiledCircuit(cs, Preprocessing(fixed, assembly.copies)),
            config, cs)


class WitnessCalculator:
    """Per-phase witness synthesis (frontend/src/circuit.rs:255-359)."""

    def __init__(self, F, k: int, circuit: Circuit, config, cs: ConstraintSystem,
                 instances: List[List[int]]):
        self.F = F
        self.k = k
        self.circuit = circuit
        self.config = config
        self.cs = cs
        self.instances = instances
        self.usable_rows = cs.usable_rows(k)

    def calc(self, phase: int, challenges: Dict[int, int]):
        """Returns {advice_col_index: list[int]} for columns in `phase`."""
        witness = WitnessCollection(
            self.F.p, self.k, self.cs, phase, self.instances, challenges,
            self.usable_rows)
        self.circuit.floor_planner.synthesize(
            witness, self.circuit, self.config, self.cs.constants)
        # batch_invert_assigned equivalent: one inversion per column
        return {i: _materialize_column(self.F.p, col)
                for i, col in witness.advice.items()}
