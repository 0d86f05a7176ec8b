"""Replica of the reference's `plonk_api` test circuit.

Semantic re-implementation (not a translation) of the `MyCircuit` /
`StandardPlonk` pair in halo2_proofs/tests/plonk_api.rs:33-420, used to
anchor byte-compatibility: the reference pins the full pretty-Debug
`PinnedVerificationKey` string for this circuit at K=5 on IPA/Vesta
(plonk_api.rs:659-1141); tests/fixtures/ carries that string verbatim as an
imported test vector, and tests/test_pinned_vk.py asserts our frontend +
keygen reproduce it byte-for-byte.

Circuit shape: standard-PLONK gate over 5 advice columns (e, a, b, c, d),
7 fixed columns (sf, sm, sa, sb, sc, sp, sl-table), 1 instance column; one
lookup of advice `a` into table `sl`; copy constraints among a/b/c; a
"Combined add-mult" gate and a "Public input" gate.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..frontend.circuit import Circuit, Layouter, Value
from ..frontend.constraint_system import ConstraintSystem, TableColumn
from ..frontend.expression import Column, Rotation


@dataclass
class PlonkConfig:
    a: Column
    b: Column
    c: Column
    d: Column
    e: Column
    sf: Column
    sa: Column
    sb: Column
    sc: Column
    sm: Column
    sp: Column
    sl: TableColumn


class StandardPlonk:
    """The StandardCs gadget (plonk_api.rs:54-280)."""

    def __init__(self, config: PlonkConfig, p: int):
        self.config = config
        self.p = p

    def raw_multiply(self, layouter: Layouter, f):
        cfg = self.config

        def build(region):
            state = {}

            def first():
                state["v"] = tuple(
                    v if isinstance(v, Value) else Value.known(v)
                    for v in f())
                return state["v"][0]

            lhs = region.assign_advice(cfg.a, 0, first)
            region.assign_advice(
                cfg.d, 0,
                lambda: state["v"][0].map(lambda x: pow(x, 4, self.p)))
            rhs = region.assign_advice(cfg.b, 0, lambda: state["v"][1])
            region.assign_advice(
                cfg.e, 0,
                lambda: state["v"][1].map(lambda x: pow(x, 4, self.p)))
            out = region.assign_advice(cfg.c, 0, lambda: state["v"][2])

            region.assign_fixed(cfg.sa, 0, 0)
            region.assign_fixed(cfg.sb, 0, 0)
            region.assign_fixed(cfg.sc, 0, 1)
            region.assign_fixed(cfg.sm, 0, 1)
            return (lhs.cell, rhs.cell, out.cell)

        return layouter.assign_region("raw_multiply", build)

    def raw_add(self, layouter: Layouter, f):
        cfg = self.config

        def build(region):
            state = {}

            def first():
                state["v"] = tuple(
                    v if isinstance(v, Value) else Value.known(v)
                    for v in f())
                return state["v"][0]

            lhs = region.assign_advice(cfg.a, 0, first)
            region.assign_advice(
                cfg.d, 0,
                lambda: state["v"][0].map(lambda x: pow(x, 4, self.p)))
            rhs = region.assign_advice(cfg.b, 0, lambda: state["v"][1])
            region.assign_advice(
                cfg.e, 0,
                lambda: state["v"][1].map(lambda x: pow(x, 4, self.p)))
            out = region.assign_advice(cfg.c, 0, lambda: state["v"][2])

            region.assign_fixed(cfg.sa, 0, 1)
            region.assign_fixed(cfg.sb, 0, 1)
            region.assign_fixed(cfg.sc, 0, 1)
            region.assign_fixed(cfg.sm, 0, 0)
            return (lhs.cell, rhs.cell, out.cell)

        return layouter.assign_region("raw_add", build)

    def copy(self, layouter: Layouter, left, right):
        def build(region):
            region.constrain_equal(left, right)
            region.constrain_equal(left, right)

        layouter.assign_region("copy", build)

    def public_input(self, layouter: Layouter, f):
        cfg = self.config

        def build(region):
            value = region.assign_advice(cfg.a, 0, f)
            region.assign_fixed(cfg.sp, 0, 1)
            return value.cell

        return layouter.assign_region("public_input", build)

    def lookup_table(self, layouter: Layouter, values):
        def build(table):
            for index, value in enumerate(values):
                table.assign_cell(self.config.sl, index, value)

        layouter.assign_table("", build)


class PlonkApiCircuit(Circuit):
    """plonk_api.rs MyCircuit: 10 iterations of (a*a=c; a+c=fin) with copy
    constraints, one public input, one 4-entry lookup table."""

    def __init__(self, p: int, a=None, lookup_table=None):
        self.p = p
        self.a = a  # witness value or None (keygen mode)
        self.lookup_table = lookup_table if lookup_table is not None else []

    def without_witnesses(self):
        return PlonkApiCircuit(self.p, None, self.lookup_table)

    def configure(self, meta: ConstraintSystem) -> PlonkConfig:
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

        meta.enable_equality(sf)
        meta.enable_equality(e)
        meta.enable_equality(d)
        meta.enable_equality(p)
        meta.enable_equality(sm)
        meta.enable_equality(sa)
        meta.enable_equality(sb)
        meta.enable_equality(sc)
        meta.enable_equality(sp)

        return PlonkConfig(a=a, b=b, c=c, d=d, e=e, sf=sf, sa=sa, sb=sb,
                           sc=sc, sm=sm, sp=sp, sl=sl)

    def synthesize(self, config: PlonkConfig, layouter: Layouter):
        cs = StandardPlonk(config, self.p)
        p = self.p

        cs.public_input(layouter, lambda: 2)

        a_val = None if self.a is None else self.a % p

        for _ in range(10):
            if a_val is None:
                # keygen pass: closures still run but values are unknown.
                # Our frontend calls the closure in both passes, so provide
                # Value.unknown() payloads via Value-aware closures.
                a0, _b0, c0 = cs.raw_multiply(
                    layouter, lambda: (Value.unknown(),) * 3)
                a1, b1, _c1 = cs.raw_add(
                    layouter, lambda: (Value.unknown(),) * 3)
            else:
                sq = (a_val * a_val) % p
                fin = (sq + a_val) % p
                a0, _b0, c0 = cs.raw_multiply(
                    layouter, lambda: (a_val, a_val, sq))
                a1, b1, _c1 = cs.raw_add(
                    layouter, lambda: (a_val, sq, fin))
            cs.copy(layouter, a0, a1)
            cs.copy(layouter, b1, c0)

        cs.lookup_table(layouter, self.lookup_table)


def plonk_api_instance(F) -> tuple:
    """(circuit-with-witness, instances) per the `common!` macro
    (plonk_api.rs:421-428): a = 2834758237 * ZETA, public input = 2,
    lookup table = [2, a, a, 0]."""
    a = (2834758237 * F.zeta) % F.p
    instance = 2
    lookup_table = [instance, a, a, 0]
    return PlonkApiCircuit(F.p, a, lookup_table), [[instance]]
