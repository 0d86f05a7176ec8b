"""vector-mul.rs: elementwise c[i] = a[i] * b[i] over three advice columns,
with each product in its own region (the reference uses this example to
exercise thread-safe parallel region assignment; regions here are
independent in the same way).

Port of the JAX reference's examples/vector_mul.py:
`python -m halo2_tpu_torch.examples.vector_mul`.
"""

from ..fields import PASTA_FP as F
from ..frontend import (
    Circuit, ConstraintSystem, Layouter, Rotation, Value,
)
from ..dev import MockProver


class VectorMulCircuit(Circuit):
    def __init__(self, a=None, b=None, n=None):
        self.a = a
        self.b = b
        self.n = n if n is not None else len(a or [])

    def without_witnesses(self):
        return VectorMulCircuit(n=self.n)

    def configure(self, meta: ConstraintSystem):
        advice = [meta.advice_column() for _ in range(3)]
        instance = meta.instance_column()
        meta.enable_equality(instance)
        for col in advice:
            meta.enable_equality(col)
        s_mul = meta.selector()

        def mul_gate(cells):
            lhs = cells.query_advice(advice[0], Rotation.cur())
            rhs = cells.query_advice(advice[1], Rotation.cur())
            out = cells.query_advice(advice[2], Rotation.cur())
            s = cells.query_selector(s_mul)
            return [s * (lhs * rhs - out)]

        meta.create_gate("mul", mul_gate)
        return {"advice": advice, "instance": instance, "s_mul": s_mul}

    def synthesize(self, config, layouter: Layouter):
        advice = config["advice"]
        values_a = self.a if self.a is not None else [None] * self.n
        values_b = self.b if self.b is not None else [None] * self.n

        outs = []
        for i in range(self.n):
            av = (Value.known(values_a[i]) if values_a[i] is not None
                  else Value.unknown())
            bv = (Value.known(values_b[i]) if values_b[i] is not None
                  else Value.unknown())

            def closure(region, av=av, bv=bv):
                config["s_mul"].enable(region, 0)
                region.assign_advice(advice[0], 0, av)
                region.assign_advice(advice[1], 0, bv)
                return region.assign_advice(advice[2], 0, av * bv)

            outs.append(layouter.assign_region(f"mul {i}", closure))

        for i, out in enumerate(outs):
            layouter.constrain_instance(out.cell, config["instance"], i)


def main(k: int = 7, n: int = 16, prove: bool = True, device="cuda"):
    a = [(3 * i + 1) % F.p for i in range(n)]
    b = [(5 * i + 2) % F.p for i in range(n)]
    c = [(x * y) % F.p for x, y in zip(a, b)]

    prover = MockProver.run(F, k, VectorMulCircuit(a, b), [c],
                            device=device)
    assert prover.verify() == []
    print(f"MockProver: satisfied ({n} products)")

    if prove:
        from ..api import keygen, create_proof, verify
        from ..commit import ParamsIPA, new_rng
        from ..curves import VESTA

        params = ParamsIPA.new(VESTA, k, device=device)
        pk = keygen(F, params, k, VectorMulCircuit(n=n))
        proof = create_proof(params, pk, [VectorMulCircuit(a, b)],
                             [[c]], new_rng(0))
        assert verify(params, pk.vk, proof, [[c]])
        print(f"proof verified ({len(proof)} bytes)")


if __name__ == "__main__":
    main()
