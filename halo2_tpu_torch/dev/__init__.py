from . import metadata
from .mock_prover import MockProver, VerifyFailure
from .cost_model import CircuitCost, from_circuit_to_model_circuit
from .gates import CircuitGates
from .tfp import TracingFloorPlanner, TracingAssignment
from .graph import CircuitLayout, circuit_dot_graph

__all__ = ["MockProver", "VerifyFailure", "CircuitCost",
           "from_circuit_to_model_circuit", "CircuitGates",
           "TracingFloorPlanner", "TracingAssignment",
           "CircuitLayout", "circuit_dot_graph", "metadata"]
