"""Whole runs of the harness on the CPU at a small k: the declared shape
against keygen's, the plain verifier against the program's proofs, the
traced run's readings, and the control and planted faults, each of which
must make `correct` false."""

from __future__ import annotations

import sys
import time
import types

import pytest

from benchmark import control, harness

from .conftest import SMALL_K, cells

CELLS = cells()


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _keygen(root, workload):
    from halo2_tpu_torch import api
    cell = harness.load_cell(workload, root)
    shape = cell.shape
    plain, program = harness.circuit_modules(cell.config)
    rows = harness.active_rows(cell.traffic, shape.usable_rows)
    params, F, _classes = cell.scheme.program(cell.config, "cpu")
    wit = plain.witness(SMALL_K, rows, shape.usable_rows, 3)
    _c, kg = program.circuits(wit, rows, shape.usable_rows)
    return cell, plain, rows, api.keygen(F, params, SMALL_K, kg)


@pytest.mark.parametrize("workload", CELLS)
def test_declared_shape_matches_keygen(small_root, workload):
    cell, plain, rows, pk = _keygen(small_root, workload)
    harness.check_shape(cell.shape, pk.vk)
    vk = cell.scheme.reference_key(cell.shape, cell.config, plain, rows)
    assert vk.fixed_commitments == pk.vk.fixed_commitments
    assert vk.permutation_commitments == pk.vk.permutation.commitments
    assert vk.transcript_repr == pk.vk.transcript_repr
    # a declared shape that differs is refused
    poly = cell.config["shape"]["gates"][0]["polys"][0]
    poly[0] = "product" if poly[0] == "sum" else "sum"
    with pytest.raises(harness.RunError, match="gates"):
        harness.check_shape(cell.shape, pk.vk)


@pytest.mark.parametrize("workload", CELLS)
def test_a_run_is_correct_and_reads_its_layers(small_root, workload):
    res = harness.run(workload, 2**31 + 12345, 0.1, True,
                      time.perf_counter(), device="cpu", root=small_root)
    traced = harness.load_cell(workload, small_root).traffic["trace_proofs"]
    assert res["checks"] == {"checked": traced, "rejected": 0}
    assert res["attempted"] == traced
    m = res["metrics"]
    for name in ("witness_commit_s", "argument_s", "quotient_s", "open_s",
                 "proof_mfu"):
        assert m[name]["value"] > 0
    # no device on the CPU: the device's readers find nothing to read
    assert "msm_roofline" not in m and "device_idle" not in m
    assert res["busy_s"] == 0.0 and res["window_s"] > 0


@pytest.mark.parametrize("workload, fault", [
    (CELLS[0], f) for f in control.FAULTS] + [
    (w, "witness") for w in CELLS[1:]])
def test_the_control_and_each_fault_come_out_not_correct(small_root,
                                                         workload, fault):
    out = control.run_fault(workload, 7, 0.1, fault, time.perf_counter(),
                            device="cpu", root=small_root)
    assert out["correct"] is False
    assert out["rejected"] == out["checked"] >= 1


@pytest.mark.parametrize("stage", ["metric", "reference"])
def test_a_run_that_loads_jax_after_the_window_gives_no_result(
        small_root, monkeypatch, stage):
    """A per-layer metric's reader, or the reference, that imports `jax`
    once the window has closed: the run raises instead of a result."""
    def load_jax():
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))

    if stage == "metric":
        load_module = harness.load_module

        def loading(path, name):
            if name == "benchmark.metrics.device_idle":
                load_jax()
            return load_module(path, name)
        monkeypatch.setattr(harness, "load_module", loading)
    else:
        check = harness.check_proofs

        def checking(*args):
            load_jax()
            return check(*args)
        monkeypatch.setattr(harness, "check_proofs", checking)
    with pytest.raises(harness.RunError, match=r"\['jax'\]"):
        harness.run(CELLS[0], 5, 0.1, True, time.perf_counter(),
                    device="cpu", root=small_root)
