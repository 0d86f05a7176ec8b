"""halo2's plonk bench circuit (`benchmark/circuits/plonk_bench/`) on KZG
with GWC over Keccak256, the benchmark's `kzg-gwc` scheme, on the CPU:
the plain Keccak-256 on its known vectors and its transcript against the
port's; the port's proofs at k = 6 and 8 accepted by the plain verifier
and a copy fault, a gate fault and a flipped W refused; the declared shape
against keygen's; the bulk program against the source's per-region form;
the proof bytes against the JAX package's; the GWC spans and counter in
the prover's record; `Prover.timings`."""

import json
import os
import random

import pytest
import torch

from halo2_tpu import api as ref_api
from halo2_tpu.commit import ParamsKZG as RefParamsKZG
from halo2_tpu.commit import ProverGWC as RefProverGWC
from halo2_tpu.fields import BN254_FR as REF_F
from halo2_tpu.frontend import SimpleFloorPlanner as RefFloorPlanner
from halo2_tpu.transcript import Keccak256Write as RefKeccak256Write
from halo2_tpu_torch import api, native, trace
from halo2_tpu_torch.commit import ProverGWC
from halo2_tpu_torch.curves import BN254_G1
from halo2_tpu_torch.fields import BN254_FR as F
from halo2_tpu_torch.dev import MockProver
from halo2_tpu_torch.frontend import (Cell, Circuit, Value,
                                      WitnessCalculator, compile_circuit)
from halo2_tpu_torch.frontend.circuit import configure_circuit
from halo2_tpu_torch.frontend.constraint_system import ConstraintSystem
from halo2_tpu_torch.plonk import Prover
from halo2_tpu_torch.transcript import Keccak256Write

from benchmark import harness
from benchmark.reference import bn254
from benchmark.reference.keccak import keccak256
from benchmark.reference.keccak_transcript import Keccak256Read
from benchmark.reference.shape import Shape
from benchmark.reference.srs import srs_secret

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "kzg-gwc-plonk_bench-k20"
GWC_PARTS = ["gwc_fold [T24+]", "gwc_divide [T24+]", "gwc_commit [T24+]"]


def _config(k):
    with open(os.path.join(ROOT, "benchmark", "configs",
                           CONFIG + ".json")) as f:
        cfg = json.load(f)
    cfg["k"] = k
    return cfg


SCHEME = harness.scheme_module(_config(6))
PLAIN, PROGRAM = harness.circuit_modules(_config(6))


class Case:
    """One k's keys, witness and plain verifying key."""

    def __init__(self, k):
        self.k = k
        self.config = _config(k)
        self.shape = Shape(self.config["shape"], k, bn254.G1)
        self.rows = self.shape.usable_rows
        self.params, _F, self.classes = SCHEME.program(self.config, "cpu")
        self.wit = PLAIN.witness(k, self.rows, self.rows, 5)
        self.circuit, kg = PROGRAM.circuits(self.wit, self.rows, self.rows)
        self.pk = api.keygen(F, self.params, k, kg)
        self.key = SCHEME.reference_key(self.shape, self.config, PLAIN,
                                        self.rows)

    def prove(self, seed, circuit=None, timings=None) -> bytes:
        return api.create_proof(self.params, self.pk,
                                [circuit or self.circuit], [[]],
                                random.Random(seed), timings=timings,
                                **self.classes)

    def verify(self, proof):
        SCHEME.verify(self.shape, self.key, proof, [])


@pytest.fixture(scope="module")
def cases():
    return {k: Case(k) for k in (6, 8)}


# -- Keccak-256 and its transcript -------------------------------------

@pytest.mark.parametrize("msg, digest", [
    (b"", "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"),
    (b"abc",
     "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"),
])
def test_plain_keccak256_known_vectors(msg, digest):
    assert keccak256(msg).hex() == digest


def test_plain_reader_squeezes_the_port_writers_challenges():
    """Points, scalars and common scalars across the 136-byte rate, a
    challenge after each: the reader's challenges are the writer's."""
    rng = random.Random(3)
    g = (BN254_G1.gen_x, BN254_G1.gen_y)
    w = Keccak256Write(BN254_G1)
    script, got = [], [w.squeeze_challenge()]
    for i in range(6):
        kind = ("point", "scalar", "common")[i % 3]
        s = rng.randrange(F.p)
        if kind == "point":
            w.write_point(g)
        elif kind == "scalar":
            w.write_scalar(s)
        else:
            w.common_scalar(s)
        script.append((kind, s))
        got.append(w.squeeze_challenge())
    r = Keccak256Read(bn254.G1, w.finalize())
    want = [r.squeeze_challenge()]
    for kind, s in script:
        if kind == "point":
            assert r.read_point() == g
        elif kind == "scalar":
            assert r.read_scalar() == s
        else:
            r.common_scalar(s)
        want.append(r.squeeze_challenge())
    assert r.at_end() and got == want


# -- the plain verifier on the port's proofs -----------------------------

@pytest.mark.parametrize("k, seed", [(6, 1), (6, 2), (8, 1), (8, 2)])
def test_plain_gwc_verifier_accepts_the_ports_proof(cases, k, seed):
    cases[k].verify(cases[k].prove(seed))


def _gate_fault(case):
    """c of one add row off by one: the gate fails there, and no copy
    holds that cell."""
    row = 2 * random.Random(9).randrange(PLAIN.rounds(case.rows)) + 1
    circuit, _ = PROGRAM.circuits(case.wit, case.rows, case.rows)
    circuit.columns["c"][row] += 1
    return circuit


@pytest.mark.parametrize("fault", ["copy", "gate", "w_byte"])
def test_plain_gwc_verifier_rejects_a_fault(cases, fault):
    case = cases[6]
    if fault == "copy":
        circuit, _ = PROGRAM.circuits(case.wit, case.rows, case.rows)
        PROGRAM.break_witness(circuit, random.Random(4))
        proof = case.prove(1, circuit)
    elif fault == "gate":
        proof = case.prove(1, _gate_fault(case))
    else:
        # the last 32 bytes are the last point's W
        proof = bytearray(case.prove(1))
        proof[-32] ^= 0x02
        proof = bytes(proof)
    with pytest.raises(SCHEME.Rejected):
        case.verify(proof)


def test_break_witness_mends(cases):
    case = cases[6]
    circuit, _ = PROGRAM.circuits(case.wit, case.rows, case.rows)
    before = {c: list(v) for c, v in circuit.columns.items()}
    PROGRAM.break_witness(circuit, random.Random(4))()
    assert circuit.columns == before


def test_declared_shape_is_keygens(cases):
    case = cases[6]
    harness.check_shape(case.shape, case.pk.vk)
    assert case.key.fixed_commitments == case.pk.vk.fixed_commitments
    assert case.key.permutation_commitments == \
        case.pk.vk.permutation.commitments
    assert case.key.transcript_repr == case.pk.vk.transcript_repr


# -- the bulk program against the source's per-region form ----------------

class PerRegion(Circuit):
    """benches/plonk.rs as written: a region a raw_multiply, a raw_add and
    a copy, through the per-cell API."""

    def __init__(self, a_values=None, rounds=1):
        self.a_values = a_values
        self.rounds = rounds

    def without_witnesses(self):
        return PerRegion(None, self.rounds)

    def configure(self, meta):
        return PROGRAM.PlonkBenchCircuit.configure(self, meta)

    def synthesize(self, cfg, layouter):
        P = PLAIN.P

        def raw(name, vals, sels):
            def build(region):
                cells = [region.assign_advice(cfg[c], 0, lambda v=v: v).cell
                         for c, v in zip("abc", vals)]
                for col, s in zip(("sa", "sb", "sc", "sm"), sels):
                    region.assign_fixed(cfg[col], 0, s)
                return cells
            return layouter.assign_region(name, build)

        def copy(left, right):
            layouter.assign_region("copy", lambda region:
                                   region.constrain_equal(left, right))

        for i in range(self.rounds):
            if self.a_values is None:
                mul = add = (Value.unknown(),) * 3
            else:
                a = self.a_values[i]
                sq = a * a % P
                mul = tuple(map(Value.known, (a, a, sq)))
                add = tuple(map(Value.known, (a, sq, (sq + a) % P)))
            a0, _b0, c0 = raw("raw_multiply", mul, (0, 0, 1, 1))
            a1, b1, _c1 = raw("raw_add", add, (1, 1, 1, 0))
            copy(a0, a1)
            copy(b1, c0)


def _synthesized(k, circuit):
    compiled, _cfg, _cs = compile_circuit(F, k, circuit.without_witnesses())
    cs = ConstraintSystem()
    config = configure_circuit(circuit, cs)
    advice = WitnessCalculator(F, k, circuit, config, cs, []).calc(0, {})
    copies = [((lc.kind, lc.index, lr), (rc.kind, rc.index, rr))
              for (lc, lr), (rc, rr) in compiled.preprocessing.copies]
    return advice, compiled.preprocessing.fixed, copies


def test_bulk_program_is_the_per_region_circuit():
    k = 6
    rows = Shape(_config(k)["shape"], k, bn254.G1).usable_rows
    wit = PLAIN.witness(k, rows, rows, 5)
    bulk, _ = PROGRAM.circuits(wit, rows, rows)
    source = PerRegion(wit["advice"][PLAIN.A][0::2], PLAIN.rounds(rows))
    got, want = _synthesized(k, bulk), _synthesized(k, source)
    # the bulk copies come column pair by column pair, the source's round
    # by round: no two copies share a cell, so the permutation is the same
    assert got[:2] == want[:2]
    assert sorted(got[2]) == sorted(want[2]) == sorted(
        (("advice",) + left[1:], ("advice",) + right[1:])
        for left, right in PLAIN.copies(k, rows))


class TwoRegions(Circuit):
    """Three rows of x, then a region of four whose offsets 0, 1 equal its
    offsets 2, 3: in bulk, or a `constrain_equal` a copy."""

    def __init__(self, bulk, xs=(1, 2, 3, 5, 6, 5, 6)):
        self.bulk, self.xs = bulk, xs

    def without_witnesses(self):
        return self

    def configure(self, meta):
        x = meta.advice_column()
        meta.enable_equality(x)
        return x

    def synthesize(self, x, layouter):
        layouter.assign_region("head", lambda region: region.
                               assign_advice_column(x, 0, self.xs[:3]))

        def body(region):
            region.assign_advice_column(x, 0, self.xs[3:])
            if self.bulk:
                region.constrain_equal_rows(x, [0, 1], x, [2, 3])
            else:
                for i in (0, 1):
                    region.constrain_equal(Cell(x, 3 + i), Cell(x, 5 + i))
        layouter.assign_region("body", body)


def test_constrain_equal_rows_is_constrain_equal():
    """Offsets count from the region's start; keygen records the same
    copies as one `constrain_equal` each; a sink without a bulk path
    (MockProver's) gets them one by one and finds a broken one."""
    k = 4
    got, want = (compile_circuit(F, k, TwoRegions(bulk))[0]
                 .preprocessing.copies for bulk in (True, False))
    assert got == want and [(lr, rr) for (_, lr), (_, rr) in got] == \
        [(3, 5), (4, 6)]
    assert MockProver.run(F, k, TwoRegions(True), [],
                          device="cpu").verify() == []
    bad = TwoRegions(True, xs=(1, 2, 3, 5, 6, 5, 7))
    assert MockProver.run(F, k, bad, [], device="cpu").verify() != []


# -- the JAX package's proof bytes ---------------------------------------

class RefPlonkBench(PROGRAM.PlonkBenchCircuit):
    """The benchmark's circuit on the JAX package's floor planner."""

    floor_planner = RefFloorPlanner

    def without_witnesses(self):
        return RefPlonkBench(None, self.rounds)


def test_proof_bytes_equal_the_jax_packages(cases):
    case = cases[6]
    k, seed = 6, 11
    ref_params = RefParamsKZG.setup(k, s=srs_secret(case.config["srs_seed"]))
    ref_circuit = RefPlonkBench(case.circuit.columns, case.circuit.rounds)
    ref_pk = ref_api.keygen(REF_F, ref_params, k,
                            ref_circuit.without_witnesses())
    want = ref_api.create_proof(ref_params, ref_pk, [ref_circuit], [[]],
                                random.Random(seed),
                                transcript_cls=RefKeccak256Write,
                                multiopen_prover_cls=RefProverGWC)
    assert case.prove(seed) == want


# -- the GWC spans and counter -------------------------------------------

def test_proof_bytes_equal_without_the_native_encoder(cases, monkeypatch):
    """Every advice value is full-width: with the native encoder each goes
    through it, and without the library value by value, to the same
    proof bytes."""
    proofs = []
    for present in (True, False):
        if not present:
            monkeypatch.setattr(native, "encode_lib", lambda: None)
        record = {}
        proofs.append(cases[6].prove(3, timings=record))
        wide = 3 * cases[6].pk.vk.domain.n      # a, b, c, tails included
        assert record["encode_wide"] == wide
        assert record["encode_native"] == (wide if present else 0)
    assert proofs[0] == proofs[1]


def test_gwc_spans_nest_in_the_opening_and_count_its_points(cases):
    case = cases[6]
    record = {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.profiler_ranges():
            proof = case.prove(1, timings=record)
    assert proof == case.prove(1)
    assert all(trace.SPANS[k] == "multiopen [T24+]" for k in GWC_PARTS)
    assert 0 < sum(record[k] for k in GWC_PARTS) <= record["multiopen [T24+]"]
    # x and omega x: the advice, fixed, sigma, h and random polynomials
    # at x, the permutation product at both
    assert record["gwc_points"] == 2
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("halo2["):
            spans.setdefault(e.name()[6:-1], []).append(
                (e.start_ns(), e.end_ns()))
    (a, b), = spans["multiopen [T24+]"]
    for name in GWC_PARTS:
        assert len(spans[name]) == 2
        assert all(a <= s and t <= b for s, t in spans[name])


def test_the_multiopen_reaches_the_proofs_trace(cases, monkeypatch):
    """Inside a proof `trace.current()` is the proof's trace; outside one
    it is a new trace that keeps no record."""
    seen = []
    create = ProverGWC.create_proof

    def spy(self, *args):
        seen.append(trace.current())
        return create(self, *args)
    monkeypatch.setattr(ProverGWC, "create_proof", spy)
    record = {}
    cases[6].prove(1, timings=record)
    assert seen[0].record is record
    outside = trace.current()
    assert not outside.keep and outside is not trace.current()


# -- Prover.timings -------------------------------------------------------

def test_prover_timings_is_its_record(cases, monkeypatch):
    """The reference keeps its step table on the prover: the port's
    `Prover.timings` reads the trace's record, and cannot be set."""
    made = []

    class Keep(Prover):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
    monkeypatch.setattr(api, "Prover", Keep)
    record = {}
    cases[6].prove(1, timings=record)
    cases[6].prove(1)
    with_record, without = made
    assert with_record.timings is record
    assert "evals [T15-23]" in without.timings
    assert without.timings is without.trace.record
    with pytest.raises(AttributeError):
        without.timings = {}
