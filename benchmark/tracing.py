"""The traced run: ranges around the program's layer entry points and
steps, put in from the benchmark's side, and the reduction of a
`torch.profiler` trace to device busy time, each layer's device time and
the idle gaps by host step.

Ranges (`torch.profiler.record_function`, named `bench.<layer>.<what>`):
  ntt   the four `EvaluationDomain` transforms
  msm   the engine's `msm` and `msm_with_cached_base`, and the commitment
        schemes' calls of `msm.msm.msm` (KZG's and IPA's)
  step  witness synthesis, the advice commits, the prover's steps between
        its step-table ticks, the multi-open prover
  proof one whole `create_proof`
A kernel belongs to the outermost range of a layer whose host interval
holds its launch, so a renamed or replaced kernel still counts."""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Tuple

from .timing import merged, overlap, union_length

PREFIX = "bench."
NTT_METHODS = ("lagrange_to_coeff", "coeff_to_lagrange", "coeff_to_extended",
               "extended_to_coeff")


def _wrap(name, fn):
    import torch

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    wrapped.__wrapped__ = fn
    return wrapped


@contextlib.contextmanager
def ranges():
    """Puts the ranges in for the duration, and takes them out after."""
    import torch
    from halo2_tpu_torch import engine
    from halo2_tpu_torch.commit import ipa, ipa_multiopen, kzg, shplonk, gwc
    from halo2_tpu_torch.frontend import circuit
    from halo2_tpu_torch.plonk import prover
    from halo2_tpu_torch.poly import domain

    patches: List[Tuple[object, str, object]] = []

    def patch(owner, attr, name):
        orig = owner.__dict__[attr]
        patches.append((owner, attr, orig))
        setattr(owner, attr, _wrap(PREFIX + name, orig))

    for m in NTT_METHODS:
        patch(domain.EvaluationDomain, m, f"ntt.{m}")
    patch(engine.H2cEngine, "msm", "msm.engine_msm")
    patch(engine.H2cEngine, "msm_with_cached_base", "msm.cached_base")
    patch(engine.GpuMsmEngine, "msm_with_cached_base", "msm.cached_base")
    patch(kzg, "msm", "msm.kzg")
    patch(ipa, "msm", "msm.ipa")
    patch(circuit.WitnessCalculator, "calc", "step.synthesis")
    patch(prover.Prover, "commit_phase", "step.advice_commits")
    patch(prover.Prover, "create_proof", "step.prover")
    for mod, cls in ((shplonk, "ProverSHPLONK"), (gwc, "ProverGWC"),
                     (ipa_multiopen, "ProverIPA")):
        patch(getattr(mod, cls), "create_proof", "step.multiopen")

    orig_tick = prover.Prover.__dict__["_tick"]

    def tick(self, name):
        orig_tick(self, name)
        with torch.profiler.record_function(PREFIX + "tick." + name):
            pass
    patches.append((prover.Prover, "_tick", orig_tick))
    prover.Prover._tick = tick
    try:
        yield
    finally:
        for owner, attr, orig in reversed(patches):
            setattr(owner, attr, orig)


def reduce(events) -> dict:
    """From a profiler's `events()`: device intervals, each layer's device
    seconds, the device ops by time, and the idle time by host step.

    The profiler mirrors each range on the device, from the first to the
    last kernel launched inside it; work on one stream runs in launch
    order, so the device operations inside a layer's mirrored spans are
    the layer's.  A layer's device time is the union of the device's
    operation intervals within the union of its spans."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device_iv, ops = [], defaultdict(float)
    spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    host: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    ticks = []
    for e in events:
        name = e.name
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if name.startswith(PREFIX):
                spans[name[len(PREFIX):].split(".", 1)[0]].append((s, t))
            else:
                device_iv.append((s, t))
                ops[name] += (t - s) / 1e6
        elif name.startswith(PREFIX + "tick."):
            ticks.append((s, name[len(PREFIX) + 5:]))
        elif name.startswith(PREFIX):
            host[name[len(PREFIX):]].append((s, t))

    dev = merged(device_iv)
    layer_s = {layer: overlap(dev, merged(spans.get(layer, []))) / 1e6
               for layer in ("ntt", "msm")}
    proofs = merged(host.get("proof", []))
    segments = _step_segments(host, ticks)
    gaps = defaultdict(float)
    for ps, pt in proofs:
        inside = [(max(s, ps), min(t, pt)) for s, t in dev
                  if t > ps and s < pt]
        edge = ps
        for s, t in inside + [(pt, pt)]:
            if s > edge:
                _charge(gaps, segments, edge, s)
            edge = max(edge, t)
    return {
        "busy_s": union_length(device_iv) / 1e6,
        "layer_device_s": layer_s,
        "layer_spans": {k: len(v) for k, v in spans.items()},
        "device_ops": sorted(ops.items(), key=lambda kv: -kv[1]),
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1]),
        "n_device_intervals": len(device_iv),
        "proof_wall_s": sum(t - s for s, t in proofs) / 1e6,
    }


def _charge(gaps, segments, a, b):
    """Charges the idle interval [a, b] to the host steps it overlaps."""
    left = b - a
    for s, t, label in segments:
        o = min(b, t) - max(a, s)
        if o > 0:
            gaps[label] += o / 1e6
            left -= o
    if left > 0:
        gaps["between steps"] += left / 1e6


_STEP_NAMES = {"synthesis": "witness synthesis [T3-4]",
               "advice_commits": "advice commits [T3-4]",
               "multiopen": "multiopen [T24+]"}


def _step_segments(host, ticks):
    """Disjoint (start, end, step) of the host's steps: synthesis, the
    advice commits, each prover step between its ticks, the multi-open."""
    segs = []
    for key, label in _STEP_NAMES.items():
        segs += [(s, t, label) for s, t in host.get("step." + key, [])]
    ticks = sorted(ticks)
    for s, t in host.get("step.prover", []):
        edge = s
        for ts, name in ticks:
            if s <= ts <= t:
                segs.append((edge, ts, name))
                edge = ts
    return sorted(segs)
