"""plonk_api on the port's public frontend API: a frozen copy of
`halo2_tpu_torch/compat/plonk_api.py` (`StandardPlonk`, `PlonkApiCircuit`),
so that the benchmark's workload stays as it is whatever later changes
make to the port's own copy."""

from __future__ import annotations

from halo2_tpu_torch.frontend import Circuit, Rotation, Value

from . import plain


class PlonkApiCircuit(Circuit):
    """plonk_api.rs's MyCircuit: ten rounds of (a*a = c; a + c = fin) with
    copies, one public input, the 4-entry lookup table.  `bad_round`, for
    the control, writes c = a*a + 1 in that round's multiply."""

    def __init__(self, a=None, bad_round=None):
        self.a = a
        self.bad_round = bad_round

    def without_witnesses(self):
        return PlonkApiCircuit(None)

    def configure(self, meta):
        e = meta.advice_column()
        a = meta.advice_column()
        b = meta.advice_column()
        sf = meta.fixed_column()
        c = meta.advice_column()
        d = meta.advice_column()
        p = meta.instance_column()
        meta.enable_equality(a)
        meta.enable_equality(b)
        meta.enable_equality(c)
        sm = meta.fixed_column()
        sa = meta.fixed_column()
        sb = meta.fixed_column()
        sc = meta.fixed_column()
        sp = meta.fixed_column()
        sl = meta.lookup_table_column()

        meta.lookup("lookup", lambda cells: [
            (cells.query_advice(a, Rotation.cur()), sl)])

        def combined_add_mult(cells):
            dq = cells.query_advice(d, Rotation.next())
            aq = cells.query_advice(a, Rotation.cur())
            sfq = cells.query_fixed(sf, Rotation.cur())
            eq = cells.query_advice(e, Rotation.prev())
            bq = cells.query_advice(b, Rotation.cur())
            cq = cells.query_advice(c, Rotation.cur())
            saq = cells.query_fixed(sa, Rotation.cur())
            sbq = cells.query_fixed(sb, Rotation.cur())
            scq = cells.query_fixed(sc, Rotation.cur())
            smq = cells.query_fixed(sm, Rotation.cur())
            return [aq * saq + bq * sbq + aq * bq * smq - (cq * scq)
                    + sfq * (dq * eq)]

        meta.create_gate("Combined add-mult", combined_add_mult)

        def public_input_gate(cells):
            aq = cells.query_advice(a, Rotation.cur())
            pq = cells.query_instance(p, Rotation.cur())
            spq = cells.query_fixed(sp, Rotation.cur())
            return [spq * (aq - pq)]

        meta.create_gate("Public input", public_input_gate)
        for col in (sf, e, d, p, sm, sa, sb, sc, sp):
            meta.enable_equality(col)
        return dict(a=a, b=b, c=c, d=d, e=e, sf=sf, sa=sa, sb=sb, sc=sc,
                    sm=sm, sp=sp, sl=sl)

    def synthesize(self, cfg, layouter):
        P = plain.P

        def row(name, vals, selectors):
            def build(region):
                v = [x if isinstance(x, Value) else Value.known(x)
                     for x in vals]
                lhs = region.assign_advice(cfg["a"], 0, lambda: v[0])
                region.assign_advice(
                    cfg["d"], 0, lambda: v[0].map(lambda x: pow(x, 4, P)))
                rhs = region.assign_advice(cfg["b"], 0, lambda: v[1])
                region.assign_advice(
                    cfg["e"], 0, lambda: v[1].map(lambda x: pow(x, 4, P)))
                out = region.assign_advice(cfg["c"], 0, lambda: v[2])
                for col, s in zip(("sa", "sb", "sc", "sm"), selectors):
                    region.assign_fixed(cfg[col], 0, s)
                return lhs.cell, rhs.cell, out.cell
            return layouter.assign_region(name, build)

        def copy(left, right):
            def build(region):
                region.constrain_equal(left, right)
                region.constrain_equal(left, right)
            layouter.assign_region("copy", build)

        def public_input(region):
            region.assign_advice(cfg["a"], 0, lambda: Value.known(
                plain.PUBLIC))
            region.assign_fixed(cfg["sp"], 0, 1)

        layouter.assign_region("public_input", public_input)
        for i in range(plain.ROUNDS):
            if self.a is None:
                vals = (Value.unknown(),) * 3
                mul, add = vals, vals
            else:
                a = self.a % P
                sq = a * a % P
                bad = 1 if i == self.bad_round else 0
                mul = (a, a, (sq + bad) % P)
                add = (a, sq, (sq + a) % P)
            a0, _b0, c0 = row("raw_multiply", mul, (0, 0, 1, 1))
            a1, b1, _c1 = row("raw_add", add, (1, 1, 1, 0))
            copy(a0, a1)
            copy(b1, c0)

        def build_table(tab):
            for index, value in enumerate(plain.table()):
                tab.assign_cell(cfg["sl"], index, value)

        layouter.assign_table("", build_table)


def circuits(wit: dict, rows: int, usable: int):
    """(circuit with the reference's witness, keygen circuit)."""
    return PlonkApiCircuit(plain.a_value()), PlonkApiCircuit(None)


def break_witness(circuit: PlonkApiCircuit, rng):
    """The control: c = a*a + 1 in one round's multiply, so its gate (and
    the copy b1 = c0) fails.  Returns the function that mends it."""
    circuit.bad_round = rng.randrange(plain.ROUNDS)

    def mend():
        circuit.bad_round = None
    return mend
