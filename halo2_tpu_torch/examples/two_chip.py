"""two-chip.rs: d = (a + b) * c composed from an add chip and a mul chip,
each with its own selector and gate (reference:
halo2_proofs/examples/two-chip.rs).

Port of the JAX reference's examples/two_chip.py:
`python -m halo2_tpu_torch.examples.two_chip`.
"""

from ..fields import PASTA_FP as F
from ..frontend import (
    Circuit, ConstraintSystem, Layouter, Rotation, Value,
)
from ..dev import MockProver


class AddChip:
    """c = a + b (two-chip.rs AddChip)."""

    @staticmethod
    def configure(meta, advice):
        s_add = meta.selector()

        def add_gate(cells):
            lhs = cells.query_advice(advice[0], Rotation.cur())
            rhs = cells.query_advice(advice[1], Rotation.cur())
            out = cells.query_advice(advice[0], Rotation.next())
            s = cells.query_selector(s_add)
            return [s * (lhs + rhs - out)]

        meta.create_gate("add", add_gate)
        return s_add

    @staticmethod
    def add(layouter, advice, s_add, a, b):
        def closure(region):
            s_add.enable(region, 0)
            a.copy_advice(region, advice[0], 0)
            b.copy_advice(region, advice[1], 0)
            return region.assign_advice(advice[0], 1, a.value() + b.value())
        return layouter.assign_region("add", closure)


class MulChip:
    """c = a * b (two-chip.rs MulChip)."""

    @staticmethod
    def configure(meta, advice):
        s_mul = meta.selector()

        def mul_gate(cells):
            lhs = cells.query_advice(advice[0], Rotation.cur())
            rhs = cells.query_advice(advice[1], Rotation.cur())
            out = cells.query_advice(advice[0], Rotation.next())
            s = cells.query_selector(s_mul)
            return [s * (lhs * rhs - out)]

        meta.create_gate("mul", mul_gate)
        return s_mul

    @staticmethod
    def mul(layouter, advice, s_mul, a, b):
        def closure(region):
            s_mul.enable(region, 0)
            a.copy_advice(region, advice[0], 0)
            b.copy_advice(region, advice[1], 0)
            return region.assign_advice(advice[0], 1, a.value() * b.value())
        return layouter.assign_region("mul", closure)


class FieldCircuit(Circuit):
    """d = (a + b) * c via the two chips over shared advice columns."""

    def __init__(self, a=Value.unknown(), b=Value.unknown(),
                 c=Value.unknown()):
        self.a = a if isinstance(a, Value) else Value.known(a)
        self.b = b if isinstance(b, Value) else Value.known(b)
        self.c = c if isinstance(c, Value) else Value.known(c)

    def without_witnesses(self):
        return FieldCircuit()

    def configure(self, meta: ConstraintSystem):
        advice = [meta.advice_column(), meta.advice_column()]
        instance = meta.instance_column()
        meta.enable_equality(instance)
        for col in advice:
            meta.enable_equality(col)
        s_add = AddChip.configure(meta, advice)
        s_mul = MulChip.configure(meta, advice)
        return {"advice": advice, "instance": instance,
                "s_add": s_add, "s_mul": s_mul}

    def synthesize(self, config, layouter: Layouter):
        advice = config["advice"]

        def load(name, value):
            return layouter.assign_region(
                name, lambda region: region.assign_advice(advice[0], 0, value))

        a = load("load a", self.a)
        b = load("load b", self.b)
        c = load("load c", self.c)
        ab = AddChip.add(layouter, advice, config["s_add"], a, b)
        d = MulChip.mul(layouter, advice, config["s_mul"], ab, c)
        layouter.constrain_instance(d.cell, config["instance"], 0)


def main(k: int = 6, prove: bool = True, device="cuda"):
    a, b, c = 2, 3, 4
    d = ((a + b) * c) % F.p

    prover = MockProver.run(F, k, FieldCircuit(a, b, c), [[d]],
                            device=device)
    assert prover.verify() == []
    print(f"MockProver: satisfied (d = {d})")

    if prove:
        from ..api import keygen, create_proof, verify
        from ..commit import ParamsIPA, new_rng
        from ..curves import VESTA

        params = ParamsIPA.new(VESTA, k, device=device)
        pk = keygen(F, params, k, FieldCircuit())
        proof = create_proof(params, pk, [FieldCircuit(a, b, c)],
                             [[[d]]], new_rng(0))
        assert verify(params, pk.vk, proof, [[[d]]])
        print(f"proof verified ({len(proof)} bytes)")


if __name__ == "__main__":
    main()
