"""The port's dev tools against the JAX reference's, on the CPU: every case
of test_mock_prover.py through both MockProvers with equal failure lists
(kind, message, location, cell values, rendered text); the cost model's
fields, proof sizes, verifier MSM sizes and JSON; the gates inspector's
text and queries; the tracing floor planner's events; the dot graph; the
layout picture.  Exact equality."""

import pytest
import torch

import circuits as ref_circuits
from halo2_tpu import dev as ref_dev
from halo2_tpu import frontend as ref_fe
from halo2_tpu.fields import PASTA_FP as REF_F
from halo2_tpu_torch import dev, frontend
from halo2_tpu_torch.examples import simple_example
from halo2_tpu_torch.fields import PASTA_FP as F
from tests._torch_params_cache import own_params_cache  # noqa: F401

torch.set_num_threads(1)

K = 4


def _circuits(fe, simple):
    """test_mock_prover.py's circuits over the frontend module `fe`, with
    `simple` that frontend's SimpleCircuit."""
    Value, Rotation = fe.Value, fe.Rotation

    class BrokenGateCircuit(simple):
        """Enables the mul gate but witnesses a wrong product."""

        def synthesize(self, config, layouter):
            advice = config["advice"]

            def closure(region):
                config["s_mul"].enable(region, 0)
                region.assign_advice(advice[0], 0, Value.known(2))
                region.assign_advice(advice[1], 0, Value.known(3))
                return region.assign_advice(advice[0], 1, Value.known(7))

            cell = layouter.assign_region("bad mul", closure)
            layouter.constrain_instance(cell.cell, config["instance"], 0)

    class UnassignedCellCircuit(simple):
        """Enables the mul gate but never assigns the output cell."""

        def synthesize(self, config, layouter):
            advice = config["advice"]

            def closure(region):
                config["s_mul"].enable(region, 0)
                region.assign_advice(advice[0], 0, Value.known(2))
                return region.assign_advice(advice[1], 0, Value.known(3))

            layouter.assign_region("incomplete mul", closure)

    class RotCircuit(fe.Circuit):
        def __init__(self, row):
            self.row = row

        def without_witnesses(self):
            return RotCircuit(self.row)

        def configure(self, meta):
            a = meta.advice_column()
            s = meta.complex_selector()
            meta.create_gate("step", lambda cells: [
                cells.query_selector(s) * (
                    cells.query_advice(a, Rotation.next())
                    - cells.query_advice(a, Rotation.cur()))])
            return {"a": a, "s": s}

        def synthesize(self, config, layouter):
            def build(region):
                config["s"].enable(region, 0)
                region.assign_advice(config["a"], 0, 1)
                if self.row == 0:
                    region.assign_advice(config["a"], 1, 1)

            if self.row:
                layouter.assign_region("pad", lambda region: region.
                                       assign_advice(config["a"],
                                                     self.row - 1, 0))
            layouter.assign_region("rot", build)

    class InstCircuit(fe.Circuit):
        def without_witnesses(self):
            return InstCircuit()

        def configure(self, meta):
            a = meta.advice_column()
            p = meta.instance_column()
            s = meta.complex_selector()
            meta.create_gate("public", lambda cells: [
                cells.query_selector(s) * (
                    cells.query_advice(a, Rotation.cur())
                    - cells.query_instance(p, Rotation.cur()))])
            return {"a": a, "s": s}

        def synthesize(self, config, layouter):
            def build(region):
                config["s"].enable(region, 0)
                region.assign_advice(config["a"], 0, 5)
                config["s"].enable(region, 1)
                region.assign_advice(config["a"], 1, 0)

            layouter.assign_region("r", build)

    def made(a=2, b=3, constant=7):
        return simple(constant, Value.known(a), Value.known(b))

    return {"made": made, "broken": BrokenGateCircuit,
            "unassigned": UnassignedCellCircuit, "rot": RotCircuit,
            "inst": InstCircuit}


def _usable_rows(circuit_cls) -> int:
    cs = frontend.ConstraintSystem()
    circuit_cls(0).configure(cs)
    return cs.usable_rows(K)


REF = _circuits(ref_fe, ref_circuits.SimpleCircuit)
PORT = _circuits(frontend, simple_example.SimpleCircuit)
C = (7 * 2 * 2 * 3 * 3) % F.p
C_OTHER = (7 * 2 * 2 * 4 * 4) % F.p

# case -> (k, circuit maker over a circuit table, instances)
CASES = {
    "satisfied": (K, lambda t: t["made"](), [[C]]),
    "wrong-instance": (K, lambda t: t["made"](), [[(C + 1) % F.p]]),
    "wrong-witness": (K, lambda t: t["made"](), [[C_OTHER]]),
    "broken-gate": (K, lambda t: t["broken"](7), [[7]]),
    "unassigned-cell": (K, lambda t: t["unassigned"](0), [[]]),
    "broken-gate-k5": (5, lambda t: t["broken"](7), [[0]]),
    "poison-safe": (K, lambda t: t["rot"](0), []),
    "poisoned": (K, lambda t: t["rot"](_usable_rows(t["rot"]) - 1), []),
    "instance-cell": (K, lambda t: t["inst"](), [[5]]),
}


def _summary(failures):
    return [(f.kind, f.detail, type(f.location).__name__, str(f.location),
             [(str(c), v) for c, v in f.cell_values], f.rendered, repr(f),
             f.emit()) for f in failures]


def _run_both(case):
    k, make, inst = CASES[case]
    ref = ref_dev.MockProver.run(REF_F, k, make(REF), inst)
    port = dev.MockProver.run(F, k, make(PORT), inst, device="cpu")
    return ref, port


@pytest.mark.parametrize("case", CASES)
def test_mock_prover_failures_equal_the_reference(case):
    ref, port = _run_both(case)
    want = _summary(ref.verify())
    assert _summary(port.verify()) == want
    assert (want == []) == (case in ("satisfied", "poison-safe"))
    if want:
        with pytest.raises(AssertionError) as theirs:
            ref.assert_satisfied()
        with pytest.raises(AssertionError) as mine:
            port.assert_satisfied()
        assert str(mine.value) == str(theirs.value)
    else:
        port.assert_satisfied()


def test_verify_at_rows_equals_the_reference():
    ref, port = _run_both("broken-gate-k5")
    bad = [0]
    ok = [r for r in range(port.usable_rows) if r not in bad]
    for gate_rows, lookup_rows in ((ok, ok), (bad, None)):
        assert _summary(port.verify_at_rows(gate_rows, lookup_rows)) == \
            _summary(ref.verify_at_rows(gate_rows, lookup_rows))
    assert [f.kind for f in port.verify_at_rows(bad, None)].count("gate")


def test_too_small_k_raises_in_both():
    with pytest.raises(ref_fe.NotEnoughRowsAvailable):
        ref_dev.MockProver.run(REF_F, 3, REF["made"](), [[C]])
    with pytest.raises(frontend.NotEnoughRowsAvailable):
        dev.MockProver.run(F, 3, PORT["made"](), [[C]], device="cpu")


def test_shuffle_and_phase_failures_equal_the_reference():
    """The shuffle and two-phase circuits (tests/circuits.py and the
    port's compat/shuffle_api.py): honest witnesses pass; a
    non-permutation and a phase-2 cell off by one fail alike."""
    from halo2_tpu_torch.compat import shuffle_api
    for ref_c, port_c in (
            (ref_circuits.ShuffleCircuit([1, 2, 3, 4], [4, 3, 2, 1]),
             shuffle_api.ShuffleCircuit([1, 2, 3, 4], [4, 3, 2, 1])),
            (ref_circuits.ShuffleCircuit([1, 2, 3, 4], [4, 3, 2, 5]),
             shuffle_api.ShuffleCircuit([1, 2, 3, 4], [4, 3, 2, 5])),
            (ref_circuits.PhaseCircuit([7, 8, 9]),
             shuffle_api.PhaseCircuit([7, 8, 9]))):
        want = _summary(ref_dev.MockProver.run(REF_F, 5, ref_c, []).verify())
        got = _summary(dev.MockProver.run(F, 5, port_c, [],
                                          device="cpu").verify())
        assert got == want
    bad = dev.MockProver.run(F, 5, shuffle_api.PhaseCircuit(
        [7, 8, 9], wrong_row=1), [], device="cpu").verify()
    assert [(f.kind, f.detail.split(" at ")[-1]) for f in bad] == \
        [("gate", "rows [1]")]


def test_plonk_api_failures_equal_the_reference():
    """plonk_api (BN254) with its instance and with the instance + 1, whose
    public input enters through a gate: a gate failure, in both."""
    from halo2_tpu.compat.plonk_api import plonk_api_instance as ref_instance
    from halo2_tpu.fields import BN254_FR as REF_FR
    from halo2_tpu_torch.compat.plonk_api import plonk_api_instance
    from halo2_tpu_torch.fields import BN254_FR
    kinds = []
    for bump in (0, 1):
        ref_c, inst = ref_instance(REF_FR)
        inst = [[v + bump for v in col] for col in inst]
        want = _summary(ref_dev.MockProver.run(REF_FR, 5, ref_c, inst)
                        .verify())
        got = _summary(dev.MockProver.run(
            BN254_FR, 5, plonk_api_instance(BN254_FR)[0], inst,
            device="cpu").verify())
        assert got == want
        kinds.append([f[0] for f in got])
    assert kinds == [[], ["gate"]]


@pytest.mark.parametrize("k", [5, 11])
def test_cost_model_equals_the_reference(k):
    from halo2_tpu_torch.examples import proof_size
    for ref_c, port_c in ((REF["made"](), PORT["made"]()),
                          (_ref_proof_size().TestCircuit(),
                           proof_size.TestCircuit())):
        ref_cost = ref_dev.CircuitCost.measure(k, ref_c)
        cost = dev.CircuitCost.measure(k, port_c)
        assert cost == dev.CircuitCost(**vars(ref_cost))
        assert cost.to_json() == ref_cost.to_json()
        for scheme in ("ipa", "kzg-gwc", "kzg-shplonk"):
            assert cost.proof_size(scheme) == ref_cost.proof_size(scheme)
            assert cost.verifier_msm_sizes(scheme) == \
                ref_cost.verifier_msm_sizes(scheme)
            assert dev.from_circuit_to_model_circuit(k, port_c, scheme) == \
                ref_dev.from_circuit_to_model_circuit(k, ref_c, scheme)


def _ref_proof_size():
    """The reference's examples/proof_size.py (it configures JAX for the
    CPU on import, as tests/conftest.py already has)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "proof_size.py")
    spec = importlib.util.spec_from_file_location("_ref_proof_size", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_circuit_gates_equal_the_reference():
    ref = ref_dev.CircuitGates.collect(REF["made"]())
    port = dev.CircuitGates.collect(PORT["made"]())
    assert str(port) == str(ref)
    assert port.queries() == ref.queries()
    assert "mul" in str(port) and len(port.queries()["advice"]) == 3


def test_tracing_events_equal_the_reference():
    """Both planners log the same events for SimpleCircuit, and for it
    inside a namespace (whose pop names the opening function)."""
    events = {}
    for name, fe, F_, d, make in (("ref", ref_fe, REF_F, ref_dev, REF),
                                  ("port", frontend, F, dev, PORT)):
        circuit = make["made"]()
        log = events[name] = []
        circuit.floor_planner = d.TracingFloorPlanner(
            fe.SimpleFloorPlanner, log_fn=log.append)
        kw = {} if name == "ref" else {"device": "cpu"}
        assert d.MockProver.run(F_, K, circuit, [[C]], **kw).verify() == []

        def synth_in_namespace(self, config, layouter,
                               _orig=type(circuit).synthesize):
            with layouter.namespace("my gadget") as ns:
                _orig(self, config, ns)

        circuit.synthesize = synth_in_namespace.__get__(circuit)
        d.MockProver.run(F_, K, circuit, [[C]], **kw)
    assert events["port"] == events["ref"]
    assert "push_namespace: my gadget" in events["port"]
    assert any(e.startswith("copy") for e in events["port"])


def test_dot_graph_and_layout_equal_the_reference(tmp_path):
    assert dev.circuit_dot_graph(5, PORT["made"]()) == \
        ref_dev.circuit_dot_graph(5, REF["made"]())
    pytest.importorskip("matplotlib")
    recorder = dev.CircuitLayout().render(5, PORT["made"](),
                                          str(tmp_path / "layout.png"))
    ref_recorder = ref_dev.CircuitLayout().render(
        5, REF["made"](), str(tmp_path / "ref.png"))
    assert (tmp_path / "layout.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert [(r.name, sorted(r.rows), sorted(r.columns))
            for r in recorder.regions] == \
        [(r.name, sorted(r.rows), sorted(r.columns))
         for r in ref_recorder.regions]
