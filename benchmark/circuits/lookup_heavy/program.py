"""lookup_heavy on the port's public frontend API: a frozen copy of
`halo2_tpu_torch/compat/lookup_heavy.py::LookupHeavyCircuit`, so that the
benchmark's workload stays as it is whatever later changes make to the
port's own copy.  Witness synthesis uses the bulk column API
(`Region.assign_advice_column`), as the original does."""

from __future__ import annotations

from halo2_tpu_torch.frontend import (Cell, Circuit, ConstraintSystem,
                                      Rotation)

from . import plain


class LookupHeavyCircuit(Circuit):
    """Four range lookups a row, acc = x0 + x1 * x2 under q, public x0[0].
    `rows` (the active rows) and `table_bits` are part of the circuit's
    shape: keygen and proofs must see the same q column and table."""

    def __init__(self, witness=None, rows: int = 1,
                 table_bits: int = plain.TABLE_BITS):
        self.witness = witness
        self.rows = len(witness["x0"]) if witness is not None else rows
        self.table_bits = table_bits

    def without_witnesses(self) -> "LookupHeavyCircuit":
        return LookupHeavyCircuit(None, rows=self.rows,
                                  table_bits=self.table_bits)

    def configure(self, meta: ConstraintSystem):
        x = [meta.advice_column() for _ in range(plain.X_COLUMNS)]
        acc = meta.advice_column()
        q = meta.fixed_column()
        inst = meta.instance_column()
        table = meta.lookup_table_column()

        meta.enable_equality(x[0])
        meta.enable_equality(inst)

        for i in range(plain.X_COLUMNS):
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

    def synthesize(self, config, layouter):
        w = self.witness

        def build(region):
            if w is not None:
                for i in range(plain.X_COLUMNS):
                    region.assign_advice_column(config["x"][i], 0, w[f"x{i}"])
                region.assign_advice_column(config["acc"], 0, w["acc"])
            region.assign_fixed_column(config["q"], 0, [1] * self.rows)
            return self.rows

        rows = layouter.assign_region("bulk", build)
        layouter.constrain_instance(Cell(config["x"][0], 0), config["inst"],
                                    0)

        def build_table(table):
            for v in range(1 << self.table_bits):
                table.assign_cell(config["table"], v, v)

        layouter.assign_table("range16", build_table)
        return rows


def circuits(wit: dict, rows: int, usable: int):
    """(circuit with the witness, keygen circuit) for the plain witness."""
    tb = plain.table_bits(usable)
    adv = wit["advice"]
    columns = {f"x{i}": adv[i].tolist() for i in range(plain.X_COLUMNS)}
    columns["acc"] = adv[plain.X_COLUMNS].tolist()
    circuit = LookupHeavyCircuit(columns, table_bits=tb)
    return circuit, LookupHeavyCircuit(None, rows=rows, table_bits=tb)


def break_witness(circuit: LookupHeavyCircuit, rng):
    """The control: acc = x0 + x1 x2 + 1 on one active row drawn from
    `rng`, so the gate fails there.  Returns the function that mends it."""
    row = rng.randrange(circuit.rows)
    circuit.witness["acc"][row] += 1

    def mend():
        circuit.witness["acc"][row] -= 1
    return mend
