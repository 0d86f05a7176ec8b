"""One run of one cell: set-up, the measured window, the traced proofs,
the check of every proof by the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name in `BENCHMARK.json`:
  configs/<config>.json          sizes, shape, scheme; names its circuit
  schemes/<scheme>.py            the program's params and prover classes,
                                 the reference's key and verifier
  circuits/<circuit>/plain.py    the witness rule and fixed data, plain
  circuits/<circuit>/program.py  the circuit on the port's frontend
  traffic/<traffic>.json         the mix: active rows, proofs to trace
  metrics/<metric>.py            read(readings) -> value or None
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import random
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

from . import jaxcheck, work
from .reference.shape import Shape
from .timing import HostLoad, per_step, run_window

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GIB = float(1 << 30)
SHARE_MAX = 100.0


class RunError(RuntimeError):
    """The run cannot give a result (a check of its own failed)."""


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    bench: dict
    config: dict
    traffic: dict
    scheme: object

    @property
    def shape(self) -> Shape:
        return Shape(self.config["shape"], self.config["k"],
                     self.scheme.REFERENCE_CURVE)


def load_cell(workload: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = [w for w in bench["workloads"] if w["name"] == workload]
    if not wl:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    wl = wl[0]
    cfg = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", wl["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(workload, bench, config, traffic, scheme_module(config))


def scheme_module(config: dict):
    scheme = load_module(os.path.join(HERE, "schemes",
                                      config["scheme"] + ".py"),
                         "benchmark.schemes." + config["scheme"])
    if (config["curve"], config["transcript"]) != (scheme.CURVE,
                                                   scheme.TRANSCRIPT):
        raise RunError(f"{config['scheme']} runs on {scheme.CURVE} with "
                       f"{scheme.TRANSCRIPT}")
    return scheme


def circuit_modules(config: dict):
    base = os.path.join(HERE, "circuits", config["circuit"])
    pkg = f"benchmark.circuits.{config['circuit']}"
    return (load_module(os.path.join(base, "plain.py"), pkg + ".plain"),
            load_module(os.path.join(base, "program.py"), pkg + ".program"))


def active_rows(traffic: dict, usable: int) -> int:
    """The traffic's share of the usable rows, at least one row."""
    return max(1, int(usable * traffic["rows"]))


def program_shape(vk) -> dict:
    """The program's constraint system in the plain shape's terms."""
    cs_back = vk.cs
    cs = cs_back.cs

    def expr(e):
        t = e.tag
        if t == "query":
            return ["query", e.column.kind, e.column.index, e.rotation.i]
        if t == "const":
            return ["const", e.value]
        if t == "neg":
            return ["neg", expr(e.left)]
        if t == "scaled":
            return ["scaled", expr(e.left), e.value]
        if t in ("sum", "product"):
            return [t, expr(e.left), expr(e.right)]
        raise RunError(f"the plain shape has no {t!r} node")

    def queries(lst):
        return [[c.index, r.i] for c, r in lst]

    return {
        "num_advice_columns": cs.num_advice_columns,
        "num_fixed_columns": cs.num_fixed_columns,
        "num_instance_columns": cs.num_instance_columns,
        "gates": [[expr(p) for p in g.polys] for g in cs.gates],
        "lookups": [[lk.name, [expr(e) for e in lk.input_expressions],
                     [expr(e) for e in lk.table_expressions]]
                    for lk in cs.lookups],
        "permutation": [[c.kind, c.index] for c in cs.permutation.columns],
        "advice_queries": queries(cs_back.advice_queries),
        "fixed_queries": queries(cs_back.fixed_queries),
        "instance_queries": queries(cs_back.instance_queries),
        "degree": vk.cs_degree,
        "blinding_factors": cs_back.blinding_factors(),
        "extended_k": vk.domain.extended_k,
    }


def check_shape(shape: Shape, vk):
    """The declared shape must be keygen's constraint system."""
    declared, got = shape.as_data(), program_shape(vk)
    bad = [k for k in declared if declared[k] != got[k]]
    if bad:
        raise RunError("the configuration's declared shape differs from "
                       f"keygen's constraint system in {bad}")
    if vk.cs.cs.shuffles or vk.cs.cs.num_challenges:
        raise RunError("the plain verifier takes no shuffles or challenges")


@dataclass
class Readings:
    """What the traced run hands the per-layer metric readers."""
    steps: List[dict] = field(default_factory=list)
    traced_proofs: int = 0
    traced_wall_s: float = 0.0
    busy_s: float = 0.0
    layer_device_s: dict = field(default_factory=dict)
    msm_work: Optional[work.LayerWork] = None
    ntt_work: Optional[work.LayerWork] = None


def _power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"


class _Tracer:
    """The profiler over the window's first proofs, with the ranges in;
    its events are read once the window has closed."""

    def __init__(self, torch, cuda: bool):
        from . import tracing
        self.PROOF = tracing.PREFIX + "proof"
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.ranges = tracing.ranges()
        self.wall = 0.0

    def start(self):
        self.ranges.__enter__()
        self.prof.start()

    def stop(self):
        self.prof.stop()
        self.ranges.__exit__(None, None, None)

    def events(self):
        return self.prof.events()


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", root: str = ROOT,
        patch_program=None) -> dict:
    """One run; returns the result line's object.  `patch_program`, for
    the control and the planted faults, is called with the circuit and
    its program module once set-up is done, before the window."""
    import torch
    from halo2_tpu_torch import api

    cell = load_cell(workload, root)
    config, traffic = cell.config, cell.traffic
    k = config["k"]
    shape = cell.shape
    scheme = cell.scheme
    plain, program = circuit_modules(config)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    rows = active_rows(traffic, shape.usable_rows)
    t0 = time.perf_counter()
    params, F, prover_classes = scheme.program(config, dev)
    t_params = time.perf_counter() - t0
    wit = plain.witness(k, rows, shape.usable_rows, seed)
    circuit, kg_circuit = program.circuits(wit, rows, shape.usable_rows)
    instances = wit["instance"]
    t0 = time.perf_counter()
    pk = api.keygen(F, params, k, kg_circuit)
    sync()
    t_keygen = time.perf_counter() - t0
    check_shape(shape, pk.vk)

    def prove(i: int, timings: dict) -> bytes:
        proof = api.create_proof(
            params, pk, [circuit], [instances], random.Random(f"{seed}:{i}"),
            timings=timings, **prover_classes)
        sync()
        return proof

    t0 = time.perf_counter()
    prove(-1, {})
    t_warm = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    log(f"[setup] params {t_params:.3f} s, keygen {t_keygen:.3f} s, warm-up "
        f"proof {t_warm:.3f} s, set-up {setup_s:.3f} s")
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if patch_program is not None:
        patch_program(circuit, program)

    proofs: List[bytes] = []
    steps: List[dict] = []          # the step table of each proof
    profiled: List[bool] = []
    traced = traffic["trace_proofs"] if trace else 0
    tracer = _Tracer(torch, cuda) if trace else None

    def step(i: int):
        timings: dict = {}
        if i < traced:
            if i == 0:
                tracer.start()
            t0 = time.perf_counter()
            with torch.profiler.record_function(tracer.PROOF):
                proofs.append(prove(i, timings))
            tracer.wall += time.perf_counter() - t0
            if i == traced - 1:
                tracer.stop()
        else:
            proofs.append(prove(i, timings))
        steps.append(timings)
        profiled.append(i < traced)

    with HostLoad() as host:
        window_s, n_done, durations = run_window(seconds, step,
                                                 min_steps=max(1, traced))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log(f"[window] {n_done} proofs in {window_s:.3f} s: "
        + ", ".join(f"{d:.3f}" for d in durations))
    log(f"[host] {host.summary()}")

    result = {"metrics": {}}
    if not trace:
        result["metrics"] = {
            "prove_s": {"value": per_step(window_s, n_done), "unit": "s"},
            "peak_mem_gib": {"value": peak / GIB, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    else:
        from . import tracing
        red = tracing.reduce(tracer.events())
        lookup_cols = plain.lookup_columns(
            plain.fixed_columns(k, rows, shape.usable_rows), wit)
        plain_steps = [t for t, p in zip(steps, profiled) if not p]
        r = Readings(
            steps=plain_steps or steps, traced_proofs=traced,
            traced_wall_s=tracer.wall, busy_s=red["busy_s"],
            layer_device_s=red["layer_device_s"],
            msm_work=scheme.msm_work(shape, wit["advice"], lookup_cols,
                                     wit["instance"]),
            ntt_work=work.ntt_work(shape, config["curve"]))
        log(f"[trace] {traced} proofs, wall {tracer.wall:.3f} s, busy "
            f"{red['busy_s']:.4f} s, {red['n_device_intervals']} device "
            f"ops; layer device s {red['layer_device_s']} over "
            f"{red['layer_spans']} spans; least s a proof: "
            f"msm {r.msm_work.seconds:.6f} ({r.msm_work.bound()}-bound), ntt "
            f"{r.ntt_work.seconds:.6f} ({r.ntt_work.bound()}-bound); card: "
            f"{_power_limit() if cuda else 'cpu'}")
        result["metrics"] = read_metrics(cell, r)
        result["breakdown"] = {
            "device_ops": [[n[:120], v] for n, v in red["device_ops"][:10]],
            "idle_gaps": [[n, v] for n, v in red["idle_gaps"][:10]],
        }
        result["busy_s"], result["window_s"] = red["busy_s"], tracer.wall

    # the program's state goes before the reference runs
    del pk, params, circuit, kg_circuit
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    result["checks"] = check_proofs(cell, scheme, plain, wit, rows, proofs,
                                    seed)
    result.update(attempted=n_done, peak=max(peak, setup_peak))
    guard_jax()
    return result


def guard_jax():
    """No result where JAX or the JAX package has been loaded: called once
    the metric readers and the reference have run, the last modules that a
    run loads."""
    found = jaxcheck.forbidden_loaded()
    if found:
        raise RunError(f"JAX or the JAX package is loaded: {found}")


def read_metrics(cell: Cell, r: Readings) -> dict:
    out = {}
    for m in cell.bench["per_layer"]:
        if "workloads" in m and cell.name not in m["workloads"]:
            continue
        mod = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                          "benchmark.metrics." + m["name"])
        v = mod.read(r)
        if v is None:
            continue
        if (m["name"].endswith("_roofline") or "mfu" in m["name"]) and \
                not 0.0 < v <= SHARE_MAX:
            raise RunError(f"{m['name']} reads {v} %, outside (0, 100]: "
                           "its work or its time is counted wrong")
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def check_proofs(cell: Cell, scheme, plain, wit, rows: int,
                 proofs: List[bytes], seed: int) -> dict:
    """Every proof of the window, or a sample drawn from the seed, checked
    by the plain verifier against the verifying key it works out itself."""
    shape = cell.shape
    t0 = time.perf_counter()
    key = scheme.reference_key(shape, cell.config, plain, rows)
    t_vk = time.perf_counter() - t0
    limit = cell.traffic["check_proofs"]
    picks = list(range(len(proofs)))
    if len(picks) > limit:
        picks = sorted(random.Random(f"check:{seed}").sample(picks, limit))
    rejected = []
    t0 = time.perf_counter()
    for i in picks:
        try:
            scheme.verify(shape, key, proofs[i], wit["instance"])
        except scheme.Rejected as e:
            rejected.append((i, str(e)))
    log(f"[check] reference key {t_vk:.3f} s; {len(picks)} proofs in "
        f"{time.perf_counter() - t0:.3f} s; rejected: {rejected or 'none'}")
    return {"checked": len(picks), "rejected": len(rejected)}
