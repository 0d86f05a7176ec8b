"""Lookup-heavy benchmark circuit (BASELINE config 4, k=20 class).

The reference's zkEVM-scale workload is lookup-dominated: many wide
lookups over big tables, which is exactly what the backend's streamed
lookup cosets exist for (halo2_backend/src/plonk/evaluation.rs:486-558)
and what `benches/dev_lookup.rs:103-107` sweeps at k=14..18.  This circuit
is that shape, scaled: four independent 16-bit range lookups per row over
a full 2^16-entry table, one degree-3 arithmetic gate tying the looked-up
values together, one public input, and copy constraints — so a proof
exercises lookups (4 arguments x permute/product), permutation, vanishing
and multiopen at 2^k rows.

Witness synthesis uses the bulk column API (Region.assign_advice_column):
at k=20 this assigns ~5M cells in a handful of Python calls instead of 5M
closure invocations.
"""

from __future__ import annotations

from ..frontend.circuit import Cell, Circuit, Layouter
from ..frontend.constraint_system import ConstraintSystem, TableColumn
from ..frontend.expression import Column, Rotation

TABLE_BITS = 16


class LookupHeavyCircuit(Circuit):
    """Four 16-bit range lookups/row + acc = x0 + x1*x2 gate + public x0[0].

    rows: number of active witness rows (defaults to all usable rows at
    proof time; the keygen instance passes rows=0 and the witness is
    filled by `instance_for`)."""

    def __init__(self, p: int, witness=None, rows: int = 1,
                 table_bits: int = TABLE_BITS):
        self.p = p
        # witness: None (keygen) or dict {"x0".."x3": list[int],
        # "acc": list[int]}
        self.witness = witness
        # active-row count and table size; part of the circuit SHAPE (the
        # q fixed column and range table must be identical between the
        # keygen and proving assignments)
        self.rows = len(witness["x0"]) if witness is not None else rows
        self.table_bits = table_bits

    def without_witnesses(self) -> "LookupHeavyCircuit":
        return LookupHeavyCircuit(self.p, None, rows=self.rows,
                                  table_bits=self.table_bits)

    def configure(self, meta: ConstraintSystem):
        x = [meta.advice_column() for _ in range(4)]
        acc = meta.advice_column()
        q = meta.fixed_column()
        inst = meta.instance_column()
        table = meta.lookup_table_column()

        meta.enable_equality(x[0])
        meta.enable_equality(inst)

        for i in range(4):
            meta.lookup(f"range16_x{i}", lambda cells, col=x[i]: [
                (cells.query_advice(col, Rotation.cur()), table)])

        def arith(cells):
            x0 = cells.query_advice(x[0], Rotation.cur())
            x1 = cells.query_advice(x[1], Rotation.cur())
            x2 = cells.query_advice(x[2], Rotation.cur())
            a = cells.query_advice(acc, Rotation.cur())
            qv = cells.query_fixed(q, Rotation.cur())
            return [qv * (a - x0 - x1 * x2)]

        meta.create_gate("acc = x0 + x1*x2", arith)

        return {"x": x, "acc": acc, "q": q, "inst": inst, "table": table}

    def synthesize(self, config, layouter: Layouter):
        w = self.witness

        def build(region):
            if w is not None:
                for i in range(4):
                    region.assign_advice_column(
                        config["x"][i], 0, w[f"x{i}"])
                region.assign_advice_column(config["acc"], 0, w["acc"])
            # the q fixed column is part of the circuit shape — identical
            # in the keygen (witness-free) and proving assignments
            region.assign_fixed_column(config["q"], 0, [1] * self.rows)
            return self.rows

        rows = layouter.assign_region("bulk", build)
        # public input: x0[0] == instance[0]
        layouter.constrain_instance(Cell(config["x"][0], 0),
                                    config["inst"], 0)

        def build_table(table):
            # full range table; per-cell assignment is keygen-only cost
            for v in range(1 << self.table_bits):
                table.assign_cell(config["table"], v, v)

        layouter.assign_table("range16", build_table)
        return rows


def lookup_heavy_instance(F, k: int, rows: int | None = None,
                          seed: int = 42):
    """(circuit-with-witness, instances, keygen_circuit) for 2^k rows.

    `rows` defaults to every row the blinding budget allows.  Witness
    columns are numpy-generated 16-bit values; acc = x0 + x1*x2 stays
    < 2^33 so no modular reduction is needed host-side."""
    import numpy as np

    cs_probe = ConstraintSystem()
    LookupHeavyCircuit(F.p).configure(cs_probe)
    usable = (1 << k) - (cs_probe.blinding_factors() + 1)
    table_bits = min(TABLE_BITS, (usable - 1).bit_length() - 1)
    if rows is None:
        rows = usable
    assert rows <= usable and (1 << table_bits) <= usable

    g = np.random.Generator(np.random.PCG64(seed))
    xs = g.integers(0, 1 << table_bits, size=(4, rows), dtype=np.int64)
    acc = xs[0] + xs[1] * xs[2]
    witness = {f"x{i}": xs[i].tolist() for i in range(4)}
    witness["acc"] = acc.tolist()

    circuit = LookupHeavyCircuit(F.p, witness, table_bits=table_bits)
    instances = [[int(xs[0][0])]]
    return circuit, instances, circuit.without_witnesses()
