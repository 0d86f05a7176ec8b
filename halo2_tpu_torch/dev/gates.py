"""Gate inspector (port of the JAX reference's dev/gates.py;
halo2_frontend/src/dev/gates.rs:CircuitGates::collect):
pretty-print every gate's constraints and queried cells for a circuit."""

from __future__ import annotations

from ..frontend.circuit import Circuit, configure_circuit
from ..frontend.constraint_system import ConstraintSystem


class CircuitGates:
    def __init__(self, cs: ConstraintSystem):
        self.cs = cs

    @staticmethod
    def collect(circuit: Circuit) -> "CircuitGates":
        cs = ConstraintSystem()
        configure_circuit(circuit, cs)
        return CircuitGates(cs)

    def __str__(self) -> str:
        lines = []
        for gate in self.cs.gates:
            lines.append(f"{gate.name}:")
            for name, poly in zip(gate.constraint_names, gate.polys):
                lines.append(f"  - {name}: {poly.identifier()} "
                             f"(degree {poly.degree()})")
        for lk in self.cs.lookups:
            ins = ", ".join(e.identifier() for e in lk.input_expressions)
            tab = ", ".join(e.identifier() for e in lk.table_expressions)
            lines.append(f"lookup {lk.name}: [{ins}] in [{tab}]")
        for sh in self.cs.shuffles:
            ins = ", ".join(e.identifier() for e in sh.input_expressions)
            out = ", ".join(e.identifier() for e in sh.shuffle_expressions)
            lines.append(f"shuffle {sh.name}: [{ins}] ~ [{out}]")
        if self.cs.permutation.columns:
            cols = ", ".join(str(c) for c in self.cs.permutation.columns)
            lines.append(f"permutation over: {cols}")
        return "\n".join(lines)

    def queries(self) -> dict:
        return {
            "advice": [(str(c), r.i) for c, r in self.cs.advice_queries],
            "fixed": [(str(c), r.i) for c, r in self.cs.fixed_queries],
            "instance": [(str(c), r.i) for c, r in self.cs.instance_queries],
        }
