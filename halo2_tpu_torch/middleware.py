"""The frontend<->backend contract, the halo2_middleware analog (port of
the JAX reference's middleware.py, with the same JSON).

The reference keeps this layer tiny (865 LoC): one struct of circuit
metadata (`ConstraintSystemMid`, halo2_middleware/src/circuit.rs:103-137),
the preprocessed fixed values and copy list (`Preprocessing`, :141-144),
and their bundle (`CompiledCircuit`, :149-152).  Everything the backend
needs crosses here as plain host data, the natural point to ship a
compiled circuit to a proving service.

Invariants owned by this layer:
  * `Any` column ordering Instance < Advice < Fixed (circuit.rs:175-192).
  * Expressions reaching the backend contain no Selector nodes
    (expression.rs:471 `unreachable!`); selector compression happens in
    `compile_circuit` before the contract is formed.
  * The ZAL acceleration seam (`zal.rs:57-243`) is `engine.py`
    (`PlonkEngine`, `GpuMsmEngine`'s cached fixed-base tables).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .frontend.circuit import CompiledCircuit, Preprocessing, compile_circuit
from .frontend.constraint_system import (
    ConstraintSystem, Gate, LookupArgument, PermutationArgument,
    ShuffleArgument,
)
from .frontend.expression import (
    ADVICE, FIXED, INSTANCE, Challenge, Column, Expression, Rotation,
)
from .engine import (
    GpuMsmEngine, H2cEngine, PlonkEngine, PlonkEngineConfig,
)

__all__ = [
    "CompiledCircuit", "Preprocessing", "compile_circuit",
    "ConstraintSystem", "LookupArgument", "PermutationArgument",
    "ShuffleArgument",
    "ADVICE", "FIXED", "INSTANCE", "Challenge", "Column", "Expression",
    "Rotation",
    "GpuMsmEngine", "H2cEngine", "PlonkEngine", "PlonkEngineConfig",
    "ConstraintSystemMid", "PreprocessingMid", "CompiledCircuitMid",
    "compiled_to_mid", "expr_to_obj", "expr_from_obj",
]


# ----------------------------------------------------------------------
# serializable contract types (ConstraintSystemMid, circuit.rs:103-152)
# ----------------------------------------------------------------------

def expr_to_obj(e: Expression):
    """Expression -> JSON-able nested lists.  Selector nodes are rejected:
    expressions crossing the contract must be selector-free
    (expression.rs:471 `unreachable!`)."""
    return e.evaluate(
        lambda v: ["c", format(v, "x")],
        lambda s: (_ for _ in ()).throw(
            ValueError("selector must be compressed before the contract")),
        lambda col, rot: ["q", col.kind, col.index, rot.i, col.phase],
        lambda ch: ["ch", ch.index, ch.phase],
        lambda a: ["neg", a],
        lambda a, b: ["add", a, b],
        lambda a, b: ["mul", a, b],
        lambda a, k: ["scl", a, format(k, "x")])


def expr_from_obj(o) -> Expression:
    tag = o[0]
    if tag == "c":
        return Expression.const(int(o[1], 16))
    if tag == "q":
        return Expression.query(Column(o[1], o[2], o[4]), Rotation(o[3]))
    if tag == "ch":
        return Expression.challenge(Challenge(o[1], o[2]))
    if tag == "neg":
        return -expr_from_obj(o[1])
    if tag == "add":
        return expr_from_obj(o[1]) + expr_from_obj(o[2])
    if tag == "mul":
        return expr_from_obj(o[1]) * expr_from_obj(o[2])
    if tag == "scl":
        return expr_from_obj(o[1]) * int(o[2], 16)   # scaled node
    raise ValueError(f"unknown expression tag {tag!r}")


def _col_obj(c: Column):
    return [c.kind, c.index, c.phase]


def _col_from(o) -> Column:
    return Column(o[0], o[1], o[2])


@dataclass
class ConstraintSystemMid:
    """The frontend->backend circuit contract
    (halo2_middleware/src/circuit.rs:103-137) as a distinct, serializable
    value: column counts and phases, selector-free gates, lookup/shuffle/
    permutation arguments, and the minimum-degree override.

    Deviation from halo2: its `GateMid` holds exactly one polynomial;
    here a gate keeps its named constraint list (the backend consumes them
    identically, and the pinned-vk Debug rendering flattens per-constraint
    either way)."""

    num_fixed_columns: int
    num_advice_columns: int
    num_instance_columns: int
    num_challenges: int
    unblinded_advice_columns: List[int]
    advice_column_phase: List[int]
    challenge_phase: List[int]
    gates: List[Gate]
    lookups: List[LookupArgument]
    shuffles: List[ShuffleArgument]
    permutation: PermutationArgument
    minimum_degree: Optional[int] = None
    general_column_annotations: Dict = field(default_factory=dict)

    @staticmethod
    def from_frontend(cs: ConstraintSystem) -> "ConstraintSystemMid":
        """The `From<ConstraintSystem> for ConstraintSystemMid` lowering
        (constraint_system.rs:193-255); requires selectors already
        converted to fixed columns."""
        for g in cs.gates:
            for poly in g.polys:
                _assert_selector_free(poly)
        return ConstraintSystemMid(
            num_fixed_columns=cs.num_fixed_columns,
            num_advice_columns=cs.num_advice_columns,
            num_instance_columns=cs.num_instance_columns,
            num_challenges=cs.num_challenges,
            unblinded_advice_columns=list(cs.unblinded_advice_columns),
            advice_column_phase=list(cs.advice_column_phase),
            challenge_phase=list(cs.challenge_phase),
            gates=cs.gates,
            lookups=cs.lookups,
            shuffles=cs.shuffles,
            permutation=cs.permutation,
            minimum_degree=cs.minimum_degree,
            general_column_annotations=dict(cs.general_column_annotations),
        )

    def to_frontend(self) -> ConstraintSystem:
        """Reconstruct a backend-consumable ConstraintSystem (the inverse
        seam, used after deserializing a shipped circuit)."""
        cs = ConstraintSystem()
        cs.num_fixed_columns = self.num_fixed_columns
        cs.num_advice_columns = self.num_advice_columns
        cs.num_instance_columns = self.num_instance_columns
        cs.num_challenges = self.num_challenges
        cs.unblinded_advice_columns = list(self.unblinded_advice_columns)
        cs.advice_column_phase = list(self.advice_column_phase)
        cs.challenge_phase = list(self.challenge_phase)
        cs.gates = self.gates
        cs.lookups = self.lookups
        cs.shuffles = self.shuffles
        cs.permutation = self.permutation
        cs.minimum_degree = self.minimum_degree
        cs.general_column_annotations = dict(self.general_column_annotations)
        return cs

    # -- serde ----------------------------------------------------------

    def to_obj(self):
        return {
            "num_fixed_columns": self.num_fixed_columns,
            "num_advice_columns": self.num_advice_columns,
            "num_instance_columns": self.num_instance_columns,
            "num_challenges": self.num_challenges,
            "unblinded_advice_columns": list(self.unblinded_advice_columns),
            "advice_column_phase": list(self.advice_column_phase),
            "challenge_phase": list(self.challenge_phase),
            "gates": [{
                "name": g.name,
                "constraint_names": list(g.constraint_names),
                "polys": [expr_to_obj(pl) for pl in g.polys],
            } for g in self.gates],
            "lookups": [{
                "name": lk.name,
                "input_expressions": [expr_to_obj(e)
                                      for e in lk.input_expressions],
                "table_expressions": [expr_to_obj(e)
                                      for e in lk.table_expressions],
            } for lk in self.lookups],
            "shuffles": [{
                "name": sh.name,
                "input_expressions": [expr_to_obj(e)
                                      for e in sh.input_expressions],
                "shuffle_expressions": [expr_to_obj(e)
                                        for e in sh.shuffle_expressions],
            } for sh in self.shuffles],
            "permutation": [_col_obj(c) for c in self.permutation.columns],
            "minimum_degree": self.minimum_degree,
        }

    @staticmethod
    def from_obj(o) -> "ConstraintSystemMid":
        perm = PermutationArgument()
        perm.columns = [_col_from(c) for c in o["permutation"]]
        return ConstraintSystemMid(
            num_fixed_columns=o["num_fixed_columns"],
            num_advice_columns=o["num_advice_columns"],
            num_instance_columns=o["num_instance_columns"],
            num_challenges=o["num_challenges"],
            unblinded_advice_columns=list(o["unblinded_advice_columns"]),
            advice_column_phase=list(o["advice_column_phase"]),
            challenge_phase=list(o["challenge_phase"]),
            gates=[Gate(g["name"], list(g["constraint_names"]),
                        [expr_from_obj(pl) for pl in g["polys"]])
                   for g in o["gates"]],
            lookups=[LookupArgument(
                lk["name"],
                [expr_from_obj(e) for e in lk["input_expressions"]],
                [expr_from_obj(e) for e in lk["table_expressions"]])
                for lk in o["lookups"]],
            shuffles=[ShuffleArgument(
                sh["name"],
                [expr_from_obj(e) for e in sh["input_expressions"]],
                [expr_from_obj(e) for e in sh["shuffle_expressions"]])
                for sh in o["shuffles"]],
            permutation=perm,
            minimum_degree=o["minimum_degree"],
        )


def _assert_selector_free(e: Expression):
    def walk(x):
        if x is None:
            return
        if x.tag == "selector":
            raise ValueError(
                "selector reached the middleware contract "
                "(compress_selectors must run first; expression.rs:471)")
        walk(x.left)
        walk(x.right)
    walk(e)


@dataclass
class PreprocessingMid:
    """Preprocessing (circuit.rs:141-144): fixed column values + the copy
    list, both as plain host data."""
    fixed: List[List[int]]
    copies: List   # [((Column, row), (Column, row)), ...]

    def to_obj(self):
        return {
            "fixed": [[format(v, "x") for v in col] for col in self.fixed],
            "copies": [[_col_obj(lc), lr, _col_obj(rc), rr]
                       for (lc, lr), (rc, rr) in self.copies],
        }

    @staticmethod
    def from_obj(o) -> "PreprocessingMid":
        return PreprocessingMid(
            fixed=[[int(v, 16) for v in col] for col in o["fixed"]],
            copies=[((_col_from(lc), lr), (_col_from(rc), rr))
                    for lc, lr, rc, rr in o["copies"]],
        )


@dataclass
class CompiledCircuitMid:
    """CompiledCircuit (circuit.rs:149-152): the complete serializable
    output of circuit compilation — ship this to the proving pipeline."""
    cs: ConstraintSystemMid
    preprocessing: PreprocessingMid

    def to_json(self) -> str:
        return json.dumps({"cs": self.cs.to_obj(),
                           "preprocessing": self.preprocessing.to_obj()})

    @staticmethod
    def from_json(s: str) -> "CompiledCircuitMid":
        o = json.loads(s)
        return CompiledCircuitMid(
            ConstraintSystemMid.from_obj(o["cs"]),
            PreprocessingMid.from_obj(o["preprocessing"]))

    def to_compiled_circuit(self) -> CompiledCircuit:
        """Bridge back to the in-process compiled form the backend keygen
        consumes."""
        return CompiledCircuit(
            self.cs.to_frontend(),
            Preprocessing(self.preprocessing.fixed,
                          self.preprocessing.copies))


def compiled_to_mid(compiled: CompiledCircuit) -> CompiledCircuitMid:
    """Lower an in-process CompiledCircuit to the serializable contract."""
    return CompiledCircuitMid(
        ConstraintSystemMid.from_frontend(compiled.cs),
        PreprocessingMid(compiled.preprocessing.fixed,
                         compiled.preprocessing.copies))
