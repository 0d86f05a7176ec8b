from .expression import (
    ADVICE, FIXED, INSTANCE, FIRST_PHASE, SECOND_PHASE, THIRD_PHASE,
    Column, Selector, Challenge, Expression, Rotation,
)
from .constraint_system import (
    ConstraintSystem, TableColumn, Gate, LookupArgument, ShuffleArgument,
    VirtualCells,
)
from .circuit import (
    Circuit, Value, Cell, AssignedCell, Region, Layouter, SimpleFloorPlanner,
    SynthesisError, NotEnoughRowsAvailable,
    CompiledCircuit, Preprocessing, compile_circuit, WitnessCalculator,
)
from .assigned import Assigned, batch_evaluate
from .floor_planner_v1 import V1FloorPlanner

__all__ = [
    "Assigned", "batch_evaluate",
    "ADVICE", "FIXED", "INSTANCE", "FIRST_PHASE", "SECOND_PHASE",
    "THIRD_PHASE", "Column", "Selector", "Challenge", "Expression", "Rotation",
    "ConstraintSystem", "TableColumn", "Gate", "LookupArgument",
    "ShuffleArgument", "VirtualCells",
    "Circuit", "Value", "Cell", "AssignedCell", "Region", "Layouter",
    "SimpleFloorPlanner", "SynthesisError", "NotEnoughRowsAvailable",
    "CompiledCircuit", "Preprocessing", "compile_circuit", "WitnessCalculator",
    "V1FloorPlanner",
]
