"""The shuffle and two-phase test circuits on the port's frontend: copies
of the reference test suite's `ShuffleCircuit` (the shape of
halo2_proofs/tests/shuffle_api.rs) and `PhaseCircuit` (phase-1 advice, a
challenge squeezed after phase 0, phase-2 advice), a variant of the
latter that KZG can prove, and witnesses that fill every usable row of
2^k for the chip paths, each with a bad witness a verifier must
reject."""

from __future__ import annotations

import numpy as np

from ..frontend.circuit import Circuit, Layouter, Value
from ..frontend.constraint_system import ConstraintSystem
from ..frontend.expression import Rotation

SEED = 0


class ShuffleCircuit(Circuit):
    """Two advice columns constrained to be permutations of each other
    where a complex selector is on."""

    def __init__(self, original=None, shuffled=None, n_rows=None):
        self.original = original
        self.shuffled = shuffled
        self.n_rows = n_rows if n_rows is not None else len(original or [])

    def without_witnesses(self):
        return ShuffleCircuit(None, None, self.n_rows)

    def configure(self, meta: ConstraintSystem):
        a = meta.advice_column()
        b = meta.advice_column()
        s = meta.complex_selector()

        def shuffle_map(cells):
            sv = cells.query_selector(s)
            av = cells.query_advice(a, Rotation.cur())
            bv = cells.query_advice(b, Rotation.cur())
            return [(sv * av, sv * bv)]

        meta.shuffle("shuffle", shuffle_map)
        return {"a": a, "b": b, "s": s}

    def synthesize(self, config, layouter: Layouter):
        def fill(region):
            for i in range(self.n_rows):
                config["s"].enable(region, i)
                x = (Value.known(self.original[i])
                     if self.original is not None else Value.unknown())
                y = (Value.known(self.shuffled[i])
                     if self.shuffled is not None else Value.unknown())
                region.assign_advice(config["a"], i, x)
                region.assign_advice(config["b"], i, y)

        layouter.assign_region("rows", fill)


class PhaseCircuit(Circuit):
    """A phase-2 column that must equal the phase-1 column times a
    challenge squeezed after phase 0.  Where `wrong_row` is given, that
    row's phase-2 cell is a * theta + 1, a witness the gate must reject."""

    def __init__(self, values=None, n_rows=None, wrong_row=None):
        self.values = values
        self.n_rows = n_rows if n_rows is not None else len(values or [])
        self.wrong_row = wrong_row

    def without_witnesses(self):
        return type(self)(None, self.n_rows)

    def configure(self, meta: ConstraintSystem):
        a = meta.advice_column_in(0)
        theta = meta.challenge_usable_after(0)
        b = meta.advice_column_in(1)
        q = meta.selector()

        def gate(cells):
            qv = cells.query_selector(q)
            av = cells.query_advice(a, Rotation.cur())
            bv = cells.query_advice(b, Rotation.cur())
            ch = cells.query_challenge(theta)
            return [qv * (bv - av * ch)]

        meta.create_gate("phase", gate)
        return {"a": a, "b": b, "q": q, "theta": theta}

    def synthesize(self, config, layouter: Layouter):
        theta = layouter.get_challenge(config["theta"])

        def fill(region):
            for i in range(self.n_rows):
                config["q"].enable(region, i)
                v = (Value.known(self.values[i]) if self.values is not None
                     else Value.unknown())
                av = region.assign_advice(config["a"], i, v)
                bv = av.value() * theta
                region.assign_advice(config["b"], i,
                                     bv + 1 if i == self.wrong_row else bv)

        layouter.assign_region("rows", fill)


class PhaseEqualityCircuit(PhaseCircuit):
    """PhaseCircuit with equality enabled on both columns.  PhaseCircuit's
    quotient h has degree below n, so its second piece is the zero
    polynomial; on KZG, whose commitments carry no blind, that piece
    commits to the identity, which no transcript takes (the reference and
    halo2 refuse it alike; tests/test_torch_shuffle.py holds both to it).
    The permutation argument raises h's degree, so this circuit proves on
    KZG too."""

    def configure(self, meta: ConstraintSystem):
        config = super().configure(meta)
        meta.enable_equality(config["a"])
        meta.enable_equality(config["b"])
        return config


def _usable_rows(circuit_cls, k: int) -> int:
    meta = ConstraintSystem()
    circuit_cls().configure(meta)
    return meta.usable_rows(k)


def shuffle_instance(k: int):
    """A ShuffleCircuit over every usable row of 2^k: random 64-bit values
    and a permutation of them, both from SEED; its keygen circuit (no
    witness); and the same with one permuted value changed, which is no
    permutation."""
    rows = _usable_rows(ShuffleCircuit, k)
    rng = np.random.default_rng(SEED)
    original = rng.integers(0, 1 << 63, size=rows, dtype=np.int64).tolist()
    shuffled = [original[i] for i in rng.permutation(rows)]
    bad = [shuffled[0] + 1] + shuffled[1:]
    return (ShuffleCircuit(original, shuffled), ShuffleCircuit(n_rows=rows),
            ShuffleCircuit(original, bad))


def phase_instance(k: int):
    """A PhaseEqualityCircuit over every usable row of 2^k with random
    64-bit values from SEED; its keygen circuit; and the same with the
    phase-2 cell of row 0 off by one."""
    rows = _usable_rows(PhaseEqualityCircuit, k)
    rng = np.random.default_rng(SEED)
    values = rng.integers(0, 1 << 63, size=rows, dtype=np.int64).tolist()
    return (PhaseEqualityCircuit(values), PhaseEqualityCircuit(n_rows=rows),
            PhaseEqualityCircuit(values, wrong_row=0))
