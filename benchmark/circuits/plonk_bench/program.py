"""plonk_bench on the port's public frontend API: benches/plonk.rs's
circuit in one region, its columns through the bulk column API
(`Region.assign_advice_column`, `assign_fixed_column`) and its copies
through the bulk `Region.constrain_equal_rows`, on the rows and columns
the source's per-region StandardPlonk gadget gives them.  A frontend
without the bulk copies (the port before it, the JAX package's) gets
them one `constrain_equal` at a time: the same permutation, since every
copy joins two cells no other copy names."""

from __future__ import annotations

from halo2_tpu_torch.frontend import Cell, Circuit, Rotation

from . import plain


class PlonkBenchCircuit(Circuit):
    """`rounds` rounds of raw_multiply, raw_add and their two copies.
    `columns`: the advice columns {"a", "b", "c"} as lists over the rows,
    or None for keygen."""

    def __init__(self, columns=None, rounds: int = 1):
        self.columns = columns
        self.rounds = rounds

    def without_witnesses(self) -> "PlonkBenchCircuit":
        return PlonkBenchCircuit(None, self.rounds)

    def configure(self, meta):
        meta.set_minimum_degree(5)
        a = meta.advice_column()
        b = meta.advice_column()
        c = meta.advice_column()
        for col in (a, b, c):
            meta.enable_equality(col)
        sm = meta.fixed_column()
        sa = meta.fixed_column()
        sb = meta.fixed_column()
        sc = meta.fixed_column()

        def gate(cells):
            aq = cells.query_advice(a, Rotation.cur())
            bq = cells.query_advice(b, Rotation.cur())
            cq = cells.query_advice(c, Rotation.cur())
            saq = cells.query_fixed(sa, Rotation.cur())
            sbq = cells.query_fixed(sb, Rotation.cur())
            scq = cells.query_fixed(sc, Rotation.cur())
            smq = cells.query_fixed(sm, Rotation.cur())
            return [aq * saq + bq * sbq + aq * bq * smq - cq * scq]

        meta.create_gate("Combined add-mult", gate)
        return dict(a=a, b=b, c=c, sm=sm, sa=sa, sb=sb, sc=sc)

    def synthesize(self, cfg, layouter):
        r = self.rounds

        def build(region):
            if self.columns is not None:
                for name in ("a", "b", "c"):
                    region.assign_advice_column(cfg[name], 0,
                                                self.columns[name])
            region.assign_fixed_column(cfg["sm"], 0, [1, 0] * r)
            region.assign_fixed_column(cfg["sa"], 0, [0, 1] * r)
            region.assign_fixed_column(cfg["sb"], 0, [0, 1] * r)
            region.assign_fixed_column(cfg["sc"], 0, [1, 1] * r)
            a, b, c = cfg["a"], cfg["b"], cfg["c"]
            mul, add = range(0, 2 * r, 2), range(1, 2 * r, 2)
            if hasattr(region, "constrain_equal_rows"):
                region.constrain_equal_rows(a, mul, a, add)     # a0 = a1
                region.constrain_equal_rows(b, add, c, mul)     # b1 = c0
                return
            for m, s in zip(mul, add):
                region.constrain_equal(Cell(a, m), Cell(a, s))
                region.constrain_equal(Cell(b, s), Cell(c, m))

        layouter.assign_region("plonk_bench", build)


def circuits(wit: dict, rows: int, usable: int):
    """(circuit with the witness, keygen circuit) for the plain witness."""
    adv = wit["advice"]
    columns = {name: list(adv[col]) for name, col in
               (("a", plain.A), ("b", plain.B), ("c", plain.C))}
    r = plain.rounds(rows)
    return PlonkBenchCircuit(columns, r), PlonkBenchCircuit(None, r)


def break_witness(circuit: PlonkBenchCircuit, rng):
    """The control, a copy fault: on one round drawn from `rng` the add
    row's a becomes a + 1 and its c (a + 1) + a^2.  The gate holds on
    every row; only the copy a0 = a1 fails.  Returns the function that
    mends it."""
    row = 2 * rng.randrange(circuit.rounds) + 1
    a, c = circuit.columns["a"], circuit.columns["c"]
    a[row] += 1
    c[row] = (c[row] + 1) % plain.P

    def mend():
        a[row] -= 1
        c[row] = (c[row] - 1) % plain.P
    return mend
