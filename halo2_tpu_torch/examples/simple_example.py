"""simple-example.rs: prove c = constant * a^2 * b^2 with a mul chip.

Runs MockProver, then a real keygen -> prove -> verify roundtrip over
IPA/Vesta (reference: halo2_proofs/examples/simple-example.rs).

Port of the JAX reference's examples/simple_example.py:
`python -m halo2_tpu_torch.examples.simple_example`.
"""

from ..fields import PASTA_FP as F
from ..frontend import (
    Circuit, ConstraintSystem, Layouter, Rotation, Value,
)
from ..dev import MockProver


class SimpleCircuit(Circuit):
    def __init__(self, constant=0, a=Value.unknown(), b=Value.unknown()):
        self.constant = constant
        self.a = a if isinstance(a, Value) else Value.known(a)
        self.b = b if isinstance(b, Value) else Value.known(b)

    def without_witnesses(self):
        return SimpleCircuit(self.constant)

    def configure(self, meta: ConstraintSystem):
        advice = [meta.advice_column(), meta.advice_column()]
        instance = meta.instance_column()
        constant = meta.fixed_column()
        meta.enable_equality(instance)
        meta.enable_constant(constant)
        for c in advice:
            meta.enable_equality(c)
        s_mul = meta.selector()

        def mul_gate(cells):
            lhs = cells.query_advice(advice[0], Rotation.cur())
            rhs = cells.query_advice(advice[1], Rotation.cur())
            out = cells.query_advice(advice[0], Rotation.next())
            s = cells.query_selector(s_mul)
            return [s * (lhs * rhs - out)]

        meta.create_gate("mul", mul_gate)
        return {"advice": advice, "instance": instance, "s_mul": s_mul}

    def synthesize(self, config, layouter: Layouter):
        advice = config["advice"]

        def load(name, value):
            return layouter.assign_region(
                name, lambda region: region.assign_advice(advice[0], 0, value))

        def load_constant(value):
            return layouter.assign_region(
                "constant",
                lambda region: region.assign_advice_from_constant(
                    advice[0], 0, value))

        def mul(name, a_cell, b_cell):
            def closure(region):
                config["s_mul"].enable(region, 0)
                a_cell.copy_advice(region, advice[0], 0)
                b_cell.copy_advice(region, advice[1], 0)
                return region.assign_advice(
                    advice[0], 1, a_cell.value() * b_cell.value())
            return layouter.assign_region(name, closure)

        a = load("load a", self.a)
        b = load("load b", self.b)
        const = load_constant(self.constant)
        ab = mul("a*b", a, b)
        absq = mul("ab*ab", ab, ab)
        c = mul("c", const, absq)
        layouter.constrain_instance(c.cell, config["instance"], 0)


def main(k: int = 6, prove: bool = True, device="cuda"):
    constant, a, b = 7, 2, 3
    c = (constant * a**2 * b**2) % F.p

    prover = MockProver.run(F, k, SimpleCircuit(constant, a, b), [[c]],
                            device=device)
    assert prover.verify() == [], prover.verify()
    print(f"MockProver: satisfied (c = {c})")

    bad = MockProver.run(F, k, SimpleCircuit(constant, a, b), [[c + 1]],
                         device=device)
    assert bad.verify() != []
    print("MockProver: wrong instance rejected")

    if prove:
        from ..api import keygen, create_proof, verify
        from ..commit import ParamsIPA, new_rng
        from ..curves import VESTA

        params = ParamsIPA.new(VESTA, k, device=device)
        pk = keygen(F, params, k, SimpleCircuit(constant))
        proof = create_proof(params, pk, [SimpleCircuit(constant, a, b)],
                             [[[c]]], new_rng(0))
        assert verify(params, pk.vk, proof, [[[c]]])
        print(f"proof verified ({len(proof)} bytes)")


if __name__ == "__main__":
    main()
