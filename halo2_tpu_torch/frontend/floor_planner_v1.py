"""V1 dual-pass floor planner.

Behavioral parity with halo2_frontend/src/circuit/floor_planner/v1.rs and
v1/strategy.rs: a measurement pass runs the circuit's `synthesize` once to
record every region's shape, the planner slots regions
biggest-advice-area-first into per-column free-interval maps (first fit,
which can fill gaps the single-pass planner leaves), and an assignment pass
replays `synthesize` with each region pinned at its planned start row.

`Circuit.synthesize` is therefore called twice and must be deterministic —
the same discipline the reference imposes (v1.rs:62-80).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .expression import ADVICE, Column, Challenge
from .circuit import (
    AssignedCell, Cell, Layouter, Region, SynthesisError, Value, _RegionShape,
)


@dataclass
class _EmptySpace:
    """Free interval [start, end); end=None means unbounded
    (v1/strategy.rs:17-30)."""
    start: int
    end: Optional[int]


class Allocations:
    """Sorted occupied-interval set for one column (v1/strategy.rs:49-93)."""

    def __init__(self):
        self.allocations: List[Tuple[int, int]] = []   # (start, end) sorted

    def unbounded_interval_start(self) -> int:
        return self.allocations[-1][1] if self.allocations else 0

    def free_intervals(self, start: int, end: Optional[int]):
        """Free intervals within [start, end) (v1/strategy.rs:63-93)."""
        out = []
        pos = start
        for a_start, a_end in self.allocations:
            if a_end <= pos:
                continue
            if end is not None and a_start >= end:
                break
            if a_start > pos:
                out.append(_EmptySpace(pos, min(a_start, end)
                                       if end is not None else a_start))
            pos = max(pos, a_end)
            if end is not None and pos >= end:
                return out
        if end is None or pos < end:
            out.append(_EmptySpace(pos, end))
        return out

    def allocate(self, start: int, length: int):
        self.allocations.append((start, start + length))
        self.allocations.sort()


def _first_fit_region(column_allocations: Dict[Column, Allocations],
                      columns: List[Column], length: int) -> int:
    """Earliest start where [start, start+length) is free in every column
    (v1/strategy.rs first_fit_region)."""
    if not columns:
        return 0
    allocs = [column_allocations.setdefault(c, Allocations())
              for c in columns]
    # candidate starts: 0 and every occupied-interval end across the columns
    candidates = {0}
    for a in allocs:
        for _, end in a.allocations:
            candidates.add(end)
    for start in sorted(candidates):
        ok = True
        for a in allocs:
            for s in a.free_intervals(start, start + length):
                if s.start == start and (s.end is None
                                         or s.end - s.start >= length):
                    break
            else:
                ok = False
            if not ok:
                break
        if ok:
            for a in allocs:
                a.allocate(start, length)
            return start
    raise AssertionError("first-fit must succeed on an unbounded domain")


def slot_in_biggest_advice_first(
        shapes: List[_RegionShape]) -> Tuple[List[int],
                                             Dict[Column, Allocations]]:
    """Plan region starts, sorting by advice area = #advice-columns x rows,
    descending (v1/strategy.rs slot_in_biggest_advice_first)."""
    column_allocations: Dict[Column, Allocations] = {}
    order = sorted(
        range(len(shapes)),
        key=lambda i: (-sum(1 for c in shapes[i].columns
                            if isinstance(c, Column) and c.kind == ADVICE)
                       * shapes[i].row_count, i))
    starts = [0] * len(shapes)
    for i in order:
        shape = shapes[i]
        cols = [c for c in shape.columns if isinstance(c, Column)]
        starts[i] = _first_fit_region(column_allocations, cols,
                                      shape.row_count)
    return starts, column_allocations


class _MeasureLayouter:
    """Pass 1: record region shapes without touching the assignment
    (v1.rs MeasurementPass)."""

    def __init__(self, assignment):
        self._assignment = assignment
        self.shapes: List[_RegionShape] = []
        self.table_names: List[str] = []

    def assign_region(self, name: str, closure: Callable):
        shape = _RegionShape()
        result = closure(Region(self, shape, 0))
        self.shapes.append(shape)
        return result

    def assign_table(self, name: str, closure: Callable):
        # tables are laid out by the assignment pass's table layouter;
        # measure them like plain regions so planning accounts for their
        # fixed columns
        return self.assign_region(name, closure)

    def constrain_instance(self, cell: Cell, instance: Column, row: int):
        pass

    def get_challenge(self, challenge: Challenge) -> Value:
        return self._assignment.get_challenge(challenge)

    def namespace(self, name: str) -> "_MeasureLayouter":
        return self


class _V1AssignLayouter(Layouter):
    """Pass 2: replay with planned region starts (v1.rs AssignmentPass)."""

    def __init__(self, assignment, constants, starts: List[int],
                 column_allocations: Dict[Column, Allocations]):
        super().__init__(assignment, constants)
        self._starts = starts
        self._next_region = 0
        self._allocations = column_allocations
        # constants cursor starts past everything planned in that column
        if constants:
            a = self._allocations.get(constants[0])
            if a is not None:
                self._constants_cursor = a.unbounded_interval_start()

    def assign_region(self, name: str, closure: Callable):
        if self._next_region >= len(self._starts):
            raise SynthesisError(
                "synthesize created more regions in the assignment pass than "
                "in the measurement pass — it must be deterministic")
        start = self._starts[self._next_region]
        self._next_region += 1
        self._assignment.enter_region(name)
        result = closure(Region(self, None, start))
        self._assignment.exit_region()
        self._flush_constants()
        return result

    def assign_table(self, name: str, closure: Callable):
        return self.assign_region(name, closure)


class V1FloorPlanner:
    """Dual-pass planner (v1.rs:28-80): measure, plan, assign."""

    @staticmethod
    def synthesize(assignment, circuit, config, constants):
        measure = _MeasureLayouter(assignment)
        circuit.synthesize(config, measure)
        starts, column_allocations = slot_in_biggest_advice_first(
            measure.shapes)
        layouter = _V1AssignLayouter(assignment, constants, starts,
                                     column_allocations)
        circuit.synthesize(config, layouter)
