"""MockProver (port of the JAX reference's dev/mock_prover.py): run the
full frontend without any crypto and check every constraint row by row
(halo2_frontend/src/dev.rs:290-1210).

Each gate polynomial is evaluated over the whole matrix at once on the
device (the backend's `evaluate_expression`, kernel A on the card) instead
of halo2's rayon per-row interpreter; lookup, shuffle and permutation
checks stay on the host (set, multiset and cycle logic), as in the
reference.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field as dataclass_field
from typing import Dict, List

import numpy as np

from .._build import resolve_device
from ..fields.field import Field
from ..frontend.circuit import (
    Circuit, Value, NotEnoughRowsAvailable, SynthesisError, _reduce_value,
    configure_circuit,
)
from ..frontend.constraint_system import ConstraintSystem
from ..frontend.expression import ADVICE, FIXED, INSTANCE, Column, Selector
from ..plonk.evaluation import evaluate_expression
from . import metadata
from .emitter import render_constraint_not_satisfied, render_lookup_failure


@dataclass
class VerifyFailure:
    """dev/failure.rs:130-232 analog.  `kind` distinguishes the variants
    (gate | cell_not_assigned | lookup | shuffle | permutation | instance);
    `location` is a metadata.InRegion/OutsideRegion failure location, and
    `cell_values` lists (VirtualCell, value) pairs for ConstraintNotSatisfied.
    `rendered` carries the emitter-grade block (aligned cell-layout table +
    labeled constraint + assigned values — failure/emitter.rs) when the
    failure kind supports it."""
    kind: str
    detail: str
    location: object = None
    cell_values: list = dataclass_field(default_factory=list)
    rendered: str = None

    def emit(self) -> str:
        """The reference's `Display`+emitter output (failure.rs:442-487)."""
        if self.rendered is not None:
            return self.rendered
        return repr(self)

    def __repr__(self):
        if self.rendered is not None:
            return self.rendered
        loc = f" {self.location}" if self.location is not None else ""
        cells = ""
        if self.cell_values:
            cells = "".join(f"\n    {c} = {v}" for c, v in self.cell_values)
        return f"{self.kind}: {self.detail}{loc}{cells}"


class _MockAssignment:
    """Records the complete matrix across all phases."""

    def __init__(self, F: Field, k: int, cs: ConstraintSystem,
                 instances, phase: int, challenges):
        self.F = F
        self.n = 1 << k
        self.k = k
        self.cs = cs
        self.phase = phase
        self.challenges = challenges
        self.usable_rows = self.n - (cs.blinding_factors() + 1)
        self.instances = instances
        self.fixed = [[None] * self.n for _ in range(cs.num_fixed_columns)]
        self.advice = [[None] * self.n for _ in range(cs.num_advice_columns)]
        self.selectors = [[False] * self.n for _ in range(cs.num_selectors)]
        self.copies = []
        self.current_region = None
        self.regions = []        # [{index, name, rows, columns, selectors}]
        self.assigned = set()    # {(kind, col_index, row)}

    def enter_region(self, name):
        self.current_region = {
            "index": len(self.regions), "name": str(name),
            "rows": set(), "columns": set(), "selectors": []}
        self.regions.append(self.current_region)

    def exit_region(self):
        self.current_region = None

    def _touch(self, kind, col_index: int, row: int):
        if self.current_region is not None:
            self.current_region["rows"].add(row)
            self.current_region["columns"].add((kind, col_index))

    def enable_selector(self, selector: Selector, row: int):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        self.selectors[selector.index][row] = True
        if self.current_region is not None:
            self.current_region["selectors"].append((selector.index, row))
            self.current_region["rows"].add(row)

    def query_instance(self, column: Column, row: int) -> Value:
        col = self.instances[column.index]
        if row < len(col):
            return Value.known(col[row])
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        return Value.known(0)

    def assign_advice(self, column: Column, row: int, value: Value):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        self._touch(ADVICE, column.index, row)
        if column.phase != self.phase:
            return
        if value.is_known():
            self.advice[column.index][row] = _reduce_value(value.value(), self.F.p)
            self.assigned.add((ADVICE, column.index, row))

    def assign_fixed(self, column: Column, row: int, value: Value):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        self._touch(FIXED, column.index, row)
        if value.is_known():
            self.fixed[column.index][row] = _reduce_value(value.value(), self.F.p)
            self.assigned.add((FIXED, column.index, row))

    def copy(self, lcol, lrow, rcol, rrow):
        if lrow >= self.usable_rows or rrow >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        self.copies.append(((lcol, lrow), (rcol, rrow)))

    def fill_from_row(self, column: Column, from_row: int, value: Value):
        """Table-column default padding (dev.rs fill_from_row analog)."""
        if from_row > self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        if value.is_known():
            v = _reduce_value(value.value(), self.F.p)
            for row in range(from_row, self.usable_rows):
                self.fixed[column.index][row] = v
                self.assigned.add((FIXED, column.index, row))

    def get_challenge(self, challenge) -> Value:
        if challenge.index in self.challenges:
            return Value.known(self.challenges[challenge.index])
        return Value.unknown()


class MockProver:
    """dev.rs:612-749 equivalent.  `timings` holds the seconds of the last
    run and verify: "synthesis" (every phase, host), "encode" (the matrices
    to the device), "gates" (every gate polynomial over every row on the
    device) and "host checks" (the rest)."""

    def __init__(self, F: Field, k: int, cs: ConstraintSystem, fixed, advice,
                 selectors, copies, instances, challenges, usable_rows,
                 device):
        self.F = F
        self.device = device
        self.k = k
        self.n = 1 << k
        self.cs = cs
        self.fixed = fixed
        self.advice = advice
        self.selectors = selectors
        self.copies = copies
        self.instances = instances
        self.challenges = challenges
        self.usable_rows = usable_rows
        self.regions = []
        self.assigned = set()
        self.timings = {}

    @staticmethod
    def run(F: Field, k: int, circuit: Circuit, instances: List[List[int]],
            device="cuda") -> "MockProver":
        """Synthesizes every phase on the host; the matrices and gate
        checks go to `device` (the card unless the caller names another)."""
        device = resolve_device(device)
        t0 = time.perf_counter()
        cs = ConstraintSystem()
        config = configure_circuit(circuit, cs)
        n = 1 << k
        if n < cs.minimum_rows():
            raise NotEnoughRowsAvailable(k)
        if len(instances) != cs.num_instance_columns:
            raise SynthesisError("invalid number of instance columns")

        # deterministic hash-chain challenges (dev.rs:686-694)
        challenges = {}
        seed = hashlib.blake2b(b"halo2_tpu-mockprover").digest()
        for idx in range(cs.num_challenges):
            seed = hashlib.blake2b(seed).digest()
            challenges[idx] = int.from_bytes(seed, "little") % F.p

        fixed = advice = selectors = copies = None
        usable = None
        regions = None
        assigned = set()
        for phase in cs.phases():
            sink = _MockAssignment(F, k, cs, instances, phase, challenges)
            if advice is not None:
                sink.advice = advice     # accumulate earlier phases
            circuit.floor_planner.synthesize(
                sink, circuit, config, cs.constants)
            fixed, advice = sink.fixed, sink.advice
            selectors, copies = sink.selectors, sink.copies
            usable = sink.usable_rows
            if regions is None:
                regions = sink.regions   # identical shape every phase
            assigned |= sink.assigned    # cells land in their own phase

        prover = MockProver(F, k, cs, fixed, advice, selectors, copies,
                            instances, challenges, usable, device)
        prover.regions = regions or []
        prover.assigned = assigned
        prover.timings["synthesis"] = time.perf_counter() - t0
        return prover

    # ------------------------------------------------------------------

    def _matrices(self):
        if getattr(self, "_matrices_cache", None) is not None:
            return self._matrices_cache
        F, n, dev = self.F, self.n, self.device

        def enc(cols):
            if not cols:
                return F.zeros((0, n), dev)
            return F.encode_ints_cols([[(v or 0) for v in col]
                                       for col in cols], dev)

        fixed = enc(self.fixed)
        advice = enc(self.advice)
        instance = enc([list(col) + [0] * (n - len(col))
                        for col in self.instances])
        selectors = enc([[1 if b else 0 for b in s] for s in self.selectors]
                        ) if self.selectors else None
        challenges = {i: F.encode_int(v, dev)
                      for i, v in self.challenges.items()}
        self._matrices_cache = (fixed, advice, instance, selectors,
                                challenges)
        return self._matrices_cache

    def verify(self) -> List[VerifyFailure]:
        return self.verify_at_rows(None, None)

    def verify_at_rows(self, gate_rows, lookup_input_rows
                       ) -> List[VerifyFailure]:
        """Restrict gate checks to `gate_rows` and lookup-input checks to
        `lookup_input_rows` (both iterables of row indices; None = all usable
        rows) — dev.rs `verify_at_rows` (dev.rs:742-749), used by callers
        that know which rows their sub-circuit occupies."""
        F = self.F
        failures: List[VerifyFailure] = []
        t0 = time.perf_counter()
        fixed, advice, instance, selectors, challenges = self._matrices()
        t1 = time.perf_counter()
        usable = self.usable_rows
        gate_rows = (None if gate_rows is None else
                     sorted(r for r in set(gate_rows) if 0 <= r < usable))
        lookup_input_rows = (
            None if lookup_input_rows is None else
            sorted(r for r in set(lookup_input_rows) if 0 <= r < usable))

        # unassigned cells queried by a selector-enabled gate inside a
        # region (dev.rs CellNotAssigned / failure.rs:130-146)
        failures.extend(self._check_assigned())

        # gates: every row in the usable region
        t2 = time.perf_counter()
        for gidx, gate in enumerate(self.cs.gates):
            gmeta = metadata.Gate(gidx, gate.name)
            for cidx, (cname, poly) in enumerate(
                    zip(gate.constraint_names, gate.polys)):
                vals = evaluate_expression(
                    F, poly, fixed=fixed, advice=advice, instance=instance,
                    challenges=challenges, device=self.device,
                    selectors=selectors)
                nonzero = (~F.is_zero(vals[:usable])).cpu().numpy()
                if gate_rows is not None:
                    mask = np.zeros(usable, dtype=bool)
                    mask[gate_rows] = True
                    nonzero = nonzero & mask
                if bool(np.any(nonzero)):
                    rows = np.nonzero(np.asarray(nonzero))[0][:5]
                    row0 = int(rows[0])
                    cmeta = metadata.Constraint(gmeta, cidx, cname)
                    location = self._region_at(row0)
                    cell_values = self._gate_cell_values(gate, row0)
                    failures.append(VerifyFailure(
                        "gate",
                        f"{cmeta} not satisfied at rows "
                        f"{list(map(int, rows))}",
                        location=location,
                        cell_values=cell_values,
                        rendered=render_constraint_not_satisfied(
                            F.p, cmeta, location, cell_values, poly)))

        t3 = time.perf_counter()

        # ConstraintPoisoned (failure.rs:158-171): a selector-enabled gate
        # at a row whose queried cells reach into the poisoned blinding
        # region (rows >= usable), where advice holds random values in a
        # real proof — the constraint cannot be meaningfully checked there.
        for gidx, gate in enumerate(self.cs.gates):
            if not gate.queried_selectors:
                continue
            rots = sorted({rot.i for _c, rot in gate.queried_cells})
            reach = [r for r in rots if r != 0]
            if not reach:
                continue
            sel_rows = set()
            for sel in gate.queried_selectors:
                sel_rows.update(
                    r for r in range(usable) if self.selectors[sel.index][r])
            gmeta = metadata.Gate(gidx, gate.name)
            for row in sorted(sel_rows):
                if any(not (0 <= row + ri < usable) for ri in rots):
                    failures.append(VerifyFailure(
                        "constraint_poisoned",
                        f"{gmeta} enabled at row {row} reaches poisoned "
                        f"rows (usable = {usable})",
                        location=self._region_at(row)))
                    break

        # InstanceCellNotAssigned (failure.rs:147-157): a selector-enabled
        # gate queries an instance cell beyond the provided values.
        for gidx, gate in enumerate(self.cs.gates):
            if not gate.queried_selectors:
                continue
            inst_q = [(c, rot) for c, rot in gate.queried_cells
                      if c.kind == INSTANCE]
            if not inst_q:
                continue
            sel_rows = set()
            for sel in gate.queried_selectors:
                sel_rows.update(
                    r for r in range(usable) if self.selectors[sel.index][r])
            gmeta = metadata.Gate(gidx, gate.name)
            done = False
            for row in sorted(sel_rows):
                for col, rot in inst_q:
                    irow = row + rot.i
                    if 0 <= irow < usable and \
                            irow >= len(self.instances[col.index]):
                        failures.append(VerifyFailure(
                            "instance_cell_not_assigned",
                            f"{gmeta} at row {row} queries unassigned "
                            f"instance cell {col}[{irow}]",
                            location=self._region_at(row)))
                        done = True
                        break
                if done:
                    break

        # lookups: each input row value must appear in the table multiset
        for lk in self.cs.lookups:
            inputs = [self._eval_host(e) for e in lk.input_expressions]
            tables = [self._eval_host(e) for e in lk.table_expressions]
            table_set = set(zip(*[t[:usable] for t in tables])) if tables else set()
            row_iter = (range(usable) if lookup_input_rows is None
                        else lookup_input_rows)
            for row in row_iter:
                tup = tuple(col[row] for col in inputs)
                if tup not in table_set:
                    lk_idx = self.cs.lookups.index(lk)
                    location = self._region_at(row)
                    failures.append(VerifyFailure(
                        "lookup",
                        f"lookup '{lk.name}' input {tup} at row {row} "
                        f"not in table",
                        location=location,
                        rendered=render_lookup_failure(
                            F.p, lk.name, lk_idx, location,
                            lk.input_expressions, list(tup))))
                    break

        # shuffles: multiset equality over usable rows
        for sh in self.cs.shuffles:
            inputs = [self._eval_host(e) for e in sh.input_expressions]
            shuf = [self._eval_host(e) for e in sh.shuffle_expressions]
            a = sorted(zip(*[c[:usable] for c in inputs])) if inputs else []
            b = sorted(zip(*[c[:usable] for c in shuf])) if shuf else []
            if a != b:
                failures.append(VerifyFailure(
                    "shuffle", f"shuffle '{sh.name}' multisets differ"))

        # permutation: all cells in a copy-cycle carry equal values
        for (lcol, lrow), (rcol, rrow) in self.copies:
            lv = self._cell_value(lcol, lrow)
            rv = self._cell_value(rcol, rrow)
            if lv != rv:
                failures.append(VerifyFailure(
                    "permutation",
                    f"copy constraint {lcol}@{lrow} ({lv}) != "
                    f"{rcol}@{rrow} ({rv})"))

        self.timings.update({"encode": t1 - t0, "gates": t3 - t2,
                             "host checks": time.perf_counter() - t3 + t2
                             - t1})
        return failures

    def _region_at(self, row: int):
        """FailureLocation at `row` (dev/failure.rs:42-74 find_expressions
        analog): InRegion with the offset relative to the region start, or
        OutsideRegion."""
        for r in self.regions:
            if row in r["rows"]:
                start = min(r["rows"]) if r["rows"] else 0
                return metadata.InRegion(
                    metadata.Region(r["index"], r["name"]), row - start)
        return metadata.OutsideRegion(row)

    def _gate_cell_values(self, gate, row: int):
        """(VirtualCell, value) pairs for every cell the gate queries at
        `row` — what the reference's failure emitter prints
        (failure/emitter.rs)."""
        out = []
        for col, rot in gate.queried_cells:
            r = (row + rot.i) % self.n
            vc = metadata.VirtualCell(col.kind, col.index, rot.i)
            out.append((vc, self._cell_value(col, r)))
        return out

    def _check_assigned(self) -> List[VerifyFailure]:
        """For every selector enabled inside a region, every advice cell the
        selector's gates query at that row must have been assigned."""
        failures = []
        seen = set()
        gates_by_selector: Dict[int, list] = {}
        for gidx, gate in enumerate(self.cs.gates):
            for s in gate.queried_selectors:
                gates_by_selector.setdefault(s.index, []).append(
                    (gidx, gate))
        for reg in self.regions:
            for sel_idx, row in reg["selectors"]:
                for gidx, gate in gates_by_selector.get(sel_idx, []):
                    for col, rot in gate.queried_cells:
                        if col.kind != ADVICE:
                            continue
                        r = row + rot.i
                        if not (0 <= r < self.usable_rows):
                            continue
                        key = (col.index, r)
                        if key in seen:
                            continue
                        if (ADVICE, col.index, r) not in self.assigned:
                            seen.add(key)
                            gmeta = metadata.Gate(gidx, gate.name)
                            vc = metadata.VirtualCell(
                                col.kind, col.index, rot.i)
                            failures.append(VerifyFailure(
                                "cell_not_assigned",
                                f"{gmeta} queries {vc} at row {r}, which "
                                f"was never assigned",
                                location=metadata.Region(
                                    reg["index"], reg["name"])))
        return failures

    def _eval_host(self, expr):
        """Evaluate an expression over all rows; returns list of ints."""
        fixed, advice, instance, selectors, challenges = self._matrices()
        vals = evaluate_expression(
            self.F, expr, fixed=fixed, advice=advice, instance=instance,
            challenges=challenges, device=self.device, selectors=selectors)
        return self.F.decode_ints(vals)

    def _cell_value(self, col: Column, row: int) -> int:
        if col.kind == ADVICE:
            return self.advice[col.index][row] or 0
        if col.kind == FIXED:
            return self.fixed[col.index][row] or 0
        inst = self.instances[col.index]
        return inst[row] if row < len(inst) else 0

    def assert_satisfied(self):
        failures = self.verify()
        if failures:
            raise AssertionError(
                "circuit not satisfied:\n" +
                "\n".join(f"  {f}" for f in failures))
