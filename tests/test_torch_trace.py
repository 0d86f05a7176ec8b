"""The prover's record (`halo2_tpu_torch.trace`) on lookup_heavy at
K_LH = 6, KZG / SHPLONK, on the CPU: every span and counter key of a
proof's record, the T3-4 and T9-11 parts within their steps, the proof
bytes with no record, with one and with the profiler ranges on, the
`halo2[...]` ranges only on request and nested as `SPANS` says, the MSM
counters against `stream_counters()`, and no wait for the device without
a record.  The `-m gpu` case holds `kernel_launches` to the kernels'
launch counts on the card.  The file imports nothing of JAX, so on a
machine without JAX run the card's case as

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_trace.py
"""

import contextlib
import random

import pytest
import torch

from halo2_tpu_torch import _build, api, trace
from halo2_tpu_torch.commit import ParamsKZG, ProverSHPLONK
from halo2_tpu_torch.compat.lookup_heavy import lookup_heavy_instance
from halo2_tpu_torch.fields import BN254_FR as F
from halo2_tpu_torch.msm import stream_msm

# The plain versions run many small tensor ops: one thread per worker
# is as fast and leaves the other cores to the other test workers.
torch.set_num_threads(1)

K_LH = 6
T34 = "witness+advice_commits [T3-4]"
T34_PARTS = ["synthesis [T3-4]", "blind [T3-4]", "encode [T3-4]",
             "msms [T3-4]", "normalize+write [T3-4]", "set [T3-4]"]
T911 = "grand_products [T9-11]"
T911_PARTS = ["permutation_commit [T9]", "lookup_products [T10]",
              "shuffle_products [T11]"]
# the GWC multi-open's parts: no span of a SHPLONK proof
GWC_PARTS = ["gwc_fold [T24+]", "gwc_divide [T24+]", "gwc_commit [T24+]"]
STEPS = ["instances [T1-2]", T34, "lookup_permute [T5-6]", T911,
         "vanishing_random [T12]", "evaluate_h [T13]", "h_pieces [T14]",
         "evals [T15-23]", "multiopen [T24+]"]
COUNTERS = ["kernel_launches", "msm_streamed", "msm_added", "host_wait",
            "encode_narrow", "encode_wide", "encode_native"]


def _keys(device):
    circuit, inst, kg_circuit = lookup_heavy_instance(F, K_LH)
    params = ParamsKZG.new(K_LH, device=device)
    pk = api.keygen(F, params, K_LH, kg_circuit)
    return params, pk, circuit, inst


def _prove(keys, timings=None, seed=1) -> bytes:
    params, pk, circuit, inst = keys
    return api.create_proof(params, pk, [circuit], [inst],
                            random.Random(seed),
                            multiopen_prover_cls=ProverSHPLONK,
                            timings=timings)


@pytest.fixture(scope="module")
def keys():
    return _keys("cpu")


@pytest.fixture(scope="module")
def recorded(keys):
    """(proof, record, stream_counters() before, after) of one proof with
    a record."""
    before = stream_msm.stream_counters()
    record = {}
    proof = _prove(keys, record)
    return proof, record, before, stream_msm.stream_counters()


def _profiled(keys, ranges: bool):
    """One proof under the profiler (host activity), with the ranges on or
    off: (proof, {span: [(start ns, end ns), ...]} of its `halo2[...]`
    ranges).  The raw events: `prof.events()` takes seconds more."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.profiler_ranges() if ranges else contextlib.nullcontext():
            proof = _prove(keys, {})
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("halo2["):
            spans.setdefault(e.name()[6:-1], []).append(
                (e.start_ns(), e.end_ns()))
    return proof, spans


@pytest.fixture(scope="module")
def ranged(keys):
    """One proof profiled with the ranges on: (proof, its ranges, closes
    a span name)."""
    closes = {}
    close = trace.Trace.close

    def counted(self, name):
        closes[name] = closes.get(name, 0) + 1
        close(self, name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace.Trace, "close", counted)
        proof, spans = _profiled(keys, True)
    return proof, spans, closes


def test_record_holds_every_span_and_counter(recorded):
    """Every step and part the record names, and the seven counters; the
    parts of T3-4 and of T9-11 within their steps."""
    _, record, _, _ = recorded
    want = STEPS + T34_PARTS + T911_PARTS + COUNTERS
    assert sorted(record) == sorted(want)
    assert sorted(trace.SPANS) == sorted(STEPS + T34_PARTS + T911_PARTS
                                         + GWC_PARTS)
    assert list(trace.COUNTERS) == COUNTERS
    assert all(record[k] >= 0 for k in want)
    assert 0 < sum(record[k] for k in T34_PARTS) <= record[T34]
    assert sum(record[k] for k in T911_PARTS) <= record[T911]
    assert record["kernel_launches"] == 0       # the CPU runs no kernel
    assert record["host_wait"] == 0.0


def test_msm_counters_are_the_stream_counters_growth(recorded):
    _, record, before, after = recorded
    assert record["msm_streamed"] == after["streamed"] - before["streamed"]
    assert record["msm_added"] == after["added"] - before["added"]
    assert 0 < record["msm_added"] < record["msm_streamed"]


def test_encode_counters_count_the_proofs_columns(keys, recorded):
    """The instance and the witness rows of every advice column go to the
    device as 64-bit words (16-bit values and their sums), the drawn
    blinding rows as 32-byte words, all of them in the native pass."""
    _, record, _, _ = recorded
    pk = keys[1]
    cs = pk.vk.cs.cs
    n, bf = pk.vk.domain.n, pk.vk.cs.blinding_factors()
    na = cs.num_advice_columns
    assert record["encode_narrow"] == \
        na * (n - bf - 1) + cs.num_instance_columns * n
    assert record["encode_wide"] == na * (bf + 1)
    assert record["encode_native"] == record["encode_wide"]


def test_a_record_accumulates_over_proofs(keys, recorded):
    """A dict passed to a second proof holds the sums of both."""
    _, one, _, _ = recorded
    record = dict(one)
    _prove(keys, record, seed=2)
    assert record["msm_streamed"] == 2 * one["msm_streamed"]
    assert all(record[k] > one[k] for k in STEPS)


def test_proof_bytes_with_and_without_the_record_and_ranges(keys, recorded,
                                                            ranged):
    assert _prove(keys) == recorded[0] == ranged[0]


def test_no_range_without_the_opt_in(keys):
    assert _profiled(keys, False)[1] == {}


def test_ranges_once_a_close_nested_as_the_spans_say(ranged):
    _, spans, closes = ranged
    assert {k: len(v) for k, v in spans.items()} == closes
    assert sorted(closes) == sorted(set(trace.SPANS) - set(GWC_PARTS))
    assert closes["synthesis [T3-4]"] == 2      # configure, then phase 0
    for name, intervals in spans.items():
        parent = trace.SPANS[name]
        for s, t in intervals:
            if parent is None:
                assert not any(a <= s and t <= b for k, iv in spans.items()
                               if k != name for a, b in iv)
            else:
                assert any(a <= s and t <= b for a, b in spans[parent])


def test_no_device_wait_without_a_record(keys, monkeypatch):
    calls = []
    monkeypatch.setattr(trace, "_sync", lambda device: calls.append(device))
    _prove(keys)
    assert calls == []
    _prove(keys, {})
    # one a close: each span once, synthesis twice (configure, phase 0)
    assert len(calls) == len(trace.SPANS) - len(GWC_PARTS) + 1


@pytest.mark.parametrize("case", ["outside its parent", "not innermost"])
def test_spans_must_nest(case):
    t = trace.Trace({})
    t.open("lookup_permute [T5-6]")
    with pytest.raises(RuntimeError):
        if case == "outside its parent":
            t.open("encode [T3-4]")
        else:
            t.close("evals [T15-23]")


@pytest.mark.gpu
def test_kernel_launches_are_the_launch_counts_growth():
    """On the card: a proof's `kernel_launches` is the growth of
    `_build.launch_counts()` over it, above 0, and the same again for the
    same seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    keys = _keys("cuda")
    _prove(keys, seed=3)                        # builds and warms up
    got = []
    for _ in range(2):
        before = sum(_build.launch_counts().values())
        record = {}
        _prove(keys, record, seed=3)
        assert record["kernel_launches"] == \
            sum(_build.launch_counts().values()) - before
        got.append(record["kernel_launches"])
        assert record["host_wait"] > 0
    assert got[0] == got[1] > 0
