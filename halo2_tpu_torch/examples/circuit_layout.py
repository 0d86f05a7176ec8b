"""circuit-layout.rs: render the region/cell layout picture of a circuit
and print its dot graph (reference: halo2_proofs/examples/circuit-layout.rs,
"dev-graph" feature).

Port of the JAX reference's examples/circuit_layout.py:
`python -m halo2_tpu_torch.examples.circuit_layout`.
"""

from ..dev.graph import CircuitLayout, circuit_dot_graph
from .simple_example import SimpleCircuit


def main(k: int = 5, out: str = "layout.png"):
    circuit = SimpleCircuit(7)
    recorder = CircuitLayout().render(k, circuit, out)
    print(f"wrote {out}: {len(recorder.regions)} regions, "
          f"{recorder.total_rows} rows used")
    print(circuit_dot_graph(k, circuit))


if __name__ == "__main__":
    main()
