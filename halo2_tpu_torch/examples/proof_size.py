"""proof-size.rs: run the cost model over a lookup circuit and print the
estimated proof sizes as JSON (reference:
halo2_proofs/examples/proof-size.rs + dev/cost_model.rs).

Port of the JAX reference's examples/proof_size.py:
`python -m halo2_tpu_torch.examples.proof_size`.
"""

import json

from ..frontend import (
    Circuit, ConstraintSystem, Layouter, Rotation, Value,
)
from ..dev import CircuitCost, from_circuit_to_model_circuit


class TestCircuit(Circuit):
    """8-bit-table lookup circuit (proof-size.rs TestCircuit)."""

    TABLE_BITS = 8
    ROWS = 1 << 9

    def without_witnesses(self):
        return TestCircuit()

    def configure(self, meta: ConstraintSystem):
        advice = meta.advice_column()
        table = meta.lookup_table_column()
        selector = meta.complex_selector()

        def table_map(cells):
            s = cells.query_selector(selector)
            a = cells.query_advice(advice, Rotation.cur())
            return [(s * a, table)]

        meta.lookup("lookup", table_map)
        return {"advice": advice, "table": table, "selector": selector}

    def synthesize(self, config, layouter: Layouter):
        def fill_table(table):
            for row in range(1 << self.TABLE_BITS):
                table.assign_cell(config["table"], row,
                                  Value.known(row + 1))

        layouter.assign_table("8-bit table", fill_table)

        def assign_values(region):
            for offset in range(self.ROWS):
                config["selector"].enable(region, offset)
                region.assign_advice(config["advice"], offset,
                                     Value.known((offset % 256) + 1))

        layouter.assign_region("assign values", assign_values)


def main(k: int = 11):
    model = from_circuit_to_model_circuit(k, TestCircuit(), "kzg-gwc")
    print("Cost of circuit with 8 bit lookup table:")
    print(json.dumps(model, indent=2))

    cost = CircuitCost.measure(k, TestCircuit())
    from ..dev.cost_model import calibrate_verifier
    cal = calibrate_verifier()
    for scheme in ("ipa", "kzg-gwc", "kzg-shplonk"):
        vt = cost.verification_time(scheme, calibration=cal)
        print(f"{scheme}: ~{cost.proof_size(scheme)} bytes, "
              f"verification at least {vt*1e3:.3f}ms")


if __name__ == "__main__":
    main()
