"""The harness's arithmetic: the window, the interval union, the work
counts, the JAX check and the result line."""

from __future__ import annotations

import json
import random
import subprocess
import sys

import numpy as np
import pytest

from benchmark import jaxcheck, run, timing, work
from benchmark.reference import bn254
from benchmark.reference.shape import Shape

from .conftest import ROOT, config


def test_prove_s_is_the_window_over_its_proofs():
    clock = iter([0.0, 4.0, 9.0, 15.0]).__next__     # proofs of 4, 5, 6 s
    calls = []
    window, done, durations = timing.run_window(
        10.0, calls.append, clock=clock)
    assert (window, done, durations) == (15.0, 3, [4.0, 5.0, 6.0])
    assert calls == [0, 1, 2]
    assert timing.per_step(window, done) == 5.0
    with pytest.raises(ValueError):
        timing.per_step(1.0, 0)


def test_window_runs_the_steps_it_must_trace():
    clock = iter([0.0, 20.0, 40.0]).__next__
    _w, done, _d = timing.run_window(1.0, lambda i: None, clock=clock,
                                     min_steps=2)
    assert done == 2


@pytest.mark.parametrize("ivs, length", [
    ([], 0.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(5, 6), (0, 2), (1, 3), (3, 4)], 5.0),
    ([(0, 10), (2, 3), (4, 5)], 10.0),
    ([(0, 1), (2, 3)], 2.0),
])
def test_idle_union_of_overlapping_intervals(ivs, length):
    assert timing.union_length(ivs) == length
    assert sum(t - s for s, t in timing.merged(ivs)) == length


def test_ntt_count_of_a_known_transform():
    # 2^3 points: 3 stages of 4 butterflies, one product each
    assert work.ntt_products(3) == 12
    assert work.ntt_bytes(3) == 2 * 32 * 8
    cfg = config("kzg-lookup_heavy-k20")
    shape = Shape(cfg["shape"], 20, bn254.G1)
    w = work.ntt_work(shape, "bn254")
    # instance 1 + advice 5 + 3 a lookup x 4 + one permutation set = 19
    # columns, each to coefficients at 2^20 and to the extended 2^22, and
    # h back from 2^22
    assert w.items.count("lagrange_to_coeff 2^20") == 19
    assert w.items.count("coeff_to_extended 2^22") == 19
    assert w.items.count("extended_to_coeff 2^22") == 1
    assert w.bound() == "multiplies"


def _digits_brute(v: int, c: int, windows: int) -> int:
    half, count, carry = 1 << (c - 1), 0, 0
    for w in range(windows):
        d = ((v >> (c * w)) & ((1 << c) - 1)) + carry
        carry = 1 if d > half else 0
        d -= carry << c
        count += d != 0
    assert carry == 0
    return count


@pytest.mark.parametrize("c", [4, 6, 13])
def test_msm_digit_count_against_python_ints(c):
    rng = random.Random(c)
    values = [rng.randrange(1 << rng.choice([1, 8, 16, 33, 61]))
              for _ in range(500)] + [0, 1, (1 << c) - 1, 1 << (c - 1),
                                      (1 << (c - 1)) + 1]
    windows = work.n_windows(c, "bn254")
    got = work.nonzero_digits(np.array(values, np.int64), c, windows)
    want = sum(_digits_brute(v, c, windows) for v in values)
    assert got == want
    # the balanced digits give the value back
    v = values[3]
    digits, carry = [], 0
    for w in range(windows):
        d = ((v >> (c * w)) & ((1 << c) - 1)) + carry
        carry = 1 if d > 1 << (c - 1) else 0
        digits.append(d - (carry << c))
    assert sum(d << (c * w) for w, d in enumerate(digits)) == v


def test_auto_c_and_windows():
    assert [work.auto_c(1 << k) for k in (6, 14, 17, 20)] == [4, 11, 13, 13]
    assert work.n_windows(13, "bn254") == 20


def test_jax_check_compares_whole_top_level_names():
    assert jaxcheck.forbidden_loaded(
        ["halo2_tpu_torch", "halo2_tpu_torch.api", "jaxtyping", "numpy"]) \
        == []
    assert jaxcheck.forbidden_loaded(
        ["halo2_tpu", "halo2_tpu.fields", "jax.numpy", "jaxlib", "flax.nn",
         "halo2_tpu_torch"]) == ["flax.nn", "halo2_tpu", "halo2_tpu.fields",
                                 "jax.numpy", "jaxlib"]


def test_the_harness_and_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.harness, benchmark.control, benchmark.tracing\n"
            "import benchmark.reference.plonk\n"
            "from benchmark import jaxcheck\n"
            "print(jaxcheck.forbidden_loaded())\n"
            "import halo2_tpu_torch.api, halo2_tpu_torch.config\n"
            "print(jaxcheck.forbidden_loaded())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, check=True).stdout
    assert out.split("\n")[:2] == ["[]", "[]"]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.plonk, benchmark.reference.srs\n"
            "import benchmark.circuits.lookup_heavy.plain\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('halo2_tpu', 'halo2_tpu_torch', 'jax', 'torch')))\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, check=True).stdout
    assert out.strip() == "[]"


def test_result_line_keys(capsys):
    result = {"checks": {"checked": 3, "rejected": 0}, "attempted": 3,
              "peak": 123, "metrics": {"prove_s": {"value": 1.5,
                                                   "unit": "s"}}}
    line = run.result_line(result, "NVIDIA H100 80GB HBM3")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"] == {"platform": "gpu",
                              "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 123}
    json.dumps(line)
    err = capsys.readouterr().err.strip().split("\n")
    assert err[-2:] == ["compared rejected_proofs=0 (limit 0)",
                        "compared checked_proofs=3 (limit: at least 1)"]
    traced = dict(result, busy_s=0.5, window_s=4.0,
                  breakdown={"device_ops": [], "idle_gaps": []})
    line = run.result_line(traced, "x")
    assert list(line)[-2:] == ["breakdown", "compared"]
    assert line["device"]["busy_s"] == 0.5
    rejected = dict(result, checks={"checked": 3, "rejected": 1})
    assert run.result_line(rejected, "x")["correct"] is False


def test_the_run_refuses_to_start_without_a_card(monkeypatch, capsys):
    import torch
    for var in ("TRITON_CACHE_DIR", "HALO2_TPU_CACHE"):
        monkeypatch.setenv(var, "unset by the test")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "kzg-lookup_heavy-k20.full", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_no_line_is_printed_once_jax_is_loaded(monkeypatch, capsys):
    import types
    result = {"checks": {"checked": 1, "rejected": 0}, "attempted": 1,
              "peak": 1, "metrics": {}}
    assert run.emit(result, "x") == 0
    assert json.loads(capsys.readouterr().out)["correct"] is True
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.emit(result, "x") != 0
    out = capsys.readouterr()
    assert out.out == "" and "['jax']" in out.err
