"""Kernel C (csrc/ntt.cu) and the transforms around it on the card: what
the transforms cost, who calls them, and what the device does inside them.

    python -m halo2_tpu_torch.tools.ntt_census [--paths k18,k20,ipa14,micro]
                                               [--timing-only]

Prints, for the built library, C's registers, spills, resident blocks per
SM and SASS multiplies (the busiest loop's, and per butterfly); C's time
for one base pass of 2^10 points on 2^10 columns (BN254 Fr) and 2^8 on
2^8 (Pasta Fp, Fq) by CUDA events; whole forward, inverse and coset
(`coeff_to_extended`, `extended_to_coeff`) transforms at 2^18, 2^20 and
2^22 (BN254 Fr) and 2^14, 2^16 (Pasta Fp, Fq).  Then, per path (KZG
plonk_api k=18, KZG lookup_heavy k=20, IPA plonk_api k=14 over Vesta, the
bench's micro stage at k=18): every transform (`FusedNTT._transform`) by
(field, log n, batch, direction, coset or not), every C launch by its
shape, every launch by kernel with kernel A's split by caller (inside a
transform or not), peak device memory; and one profiled prove whose
transforms are each bracketed by synchronisations and a profiler range,
whose mirror on the device's clock holds the kernels launched inside it:
C's, A's and the rest's (copies, cat, fills) by name, against the
prove's busy device time.  The last line is one JSON
object of it all.  `--timing-only` stops after the times.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import random
import sys
import time
from collections import Counter

import torch

from .. import _build
from . import card
from .alu_probe import random_elems

PATHS = ("k18", "k20", "ipa14", "micro")
DOMAIN_FNS = ("lagrange_to_coeff", "coeff_to_lagrange", "coeff_to_extended",
              "extended_to_coeff")
COSET_FNS = ("coeff_to_extended", "extended_to_coeff")
WINDOW = "ntt_census::transform"     # the profiler range around a transform
# functions whose kernel-A launches belong to a transform
TRANSFORM_FRAMES = {"_run", "_transform", "_chunk_batched", *DOMAIN_FNS}


def log(msg: str):
    print(msg, flush=True)


# ----------------------------------------------------------------------
# kernel C as built
# ----------------------------------------------------------------------

def c_build() -> dict:
    """Registers, spills, resident blocks per SM and SASS multiplies of
    every kernel-C function."""
    from ..ntt import fused
    from .ec_census import resident_blocks
    ptxas = card.ptxas_report()
    sass = card.sass_report()
    out = {}
    for fn in sorted(sass):
        if "k_ntt" not in fn:
            continue
        r = dict(ptxas.get(fn, {}))
        loops = sass[fn]["loops"]
        busiest = max((lp["kinds"] for lp in loops),
                      key=lambda k: sum(k.values())) if loops else {}
        r["multiplies"] = sass[fn]["kinds"]
        r["total"] = sum(sass[fn]["kinds"].values())
        r["busiest_loop"] = busiest
        r["per_butterfly"] = sum(busiest.values()) / \
            fused.BUTTERFLIES_PER_ROUND
        r["threads"] = fused.THREADS
        if "registers" in r:
            by_regs = resident_blocks(r["registers"], fused.THREADS)
            r["blocks_per_sm"] = min(by_regs,
                                     (232448 - 1024) // fused.SMEM_BYTES)
        out[fn] = r
    return out


def c_pass(F, log_m: int, cols: int, dev):
    """A thunk that runs one base pass of C: 2^log_m points on `cols`
    columns, laid out (1, m, cols) as the first pass of a 2^(2 log_m)
    transform reads them."""
    from ..ntt import fused
    from ..ntt.ntt import get_ntt
    m = 1 << log_m
    ntt = get_ntt(F, 2 * log_m, dev)
    x = random_elems(F, m * cols, 5, dev).reshape(1, m, cols, 8)
    spec = fused.column_pass(ntt, x, log_m, False)
    return lambda: fused.base_ntt(F, spec)


def c_times(dev) -> dict:
    from ..fields import BN254_FR, PASTA_FP, PASTA_FQ
    out = {}
    for F, lm in ((BN254_FR, 10), (PASTA_FP, 8), (PASTA_FQ, 8)):
        fn = c_pass(F, lm, 1 << lm, dev)
        out[f"{F.name} 2^{lm} x 2^{lm}"] = dict(
            ms=card.cuda_ms(fn, 20), device_ms=card.device_ms(fn, 10))
    return out


def transform_times(dev) -> dict:
    """Whole transforms of one column: forward, inverse, and the coset
    pair of a domain whose extended size is 2^log_n (j = 5: 4x)."""
    from ..fields import BN254_FR, PASTA_FP, PASTA_FQ
    from ..ntt.ntt import get_ntt
    from ..poly import EvaluationDomain
    out = {}
    for F, sizes in ((BN254_FR, (18, 20, 22)), (PASTA_FP, (14, 16)),
                     (PASTA_FQ, (14, 16))):
        for log_n in sizes:
            ntt = get_ntt(F, log_n, dev)
            a = random_elems(F, 1 << log_n, log_n, dev)
            dom = EvaluationDomain(F, 5, log_n - 2, dev)
            c = a[: dom.n]
            out[f"{F.name} 2^{log_n}"] = dict(
                forward=card.cuda_ms(lambda: ntt.forward(a), 10),
                inverse=card.cuda_ms(lambda: ntt.inverse(a), 10),
                coset_forward=card.cuda_ms(
                    lambda: dom.coeff_to_extended(c), 10),
                coset_inverse=card.cuda_ms(
                    lambda: dom.extended_to_coeff(a), 10))
    return out


# ----------------------------------------------------------------------
# hooks
# ----------------------------------------------------------------------

class Census:
    """While active: transforms by key, C launches by shape, kernel A's
    launches by caller; with `windows`, each outermost transform runs
    between two synchronisations inside a `record_function` range."""

    def __init__(self, windows: bool = False):
        self.windows = windows
        self.transforms = Counter()
        self.c_shapes = Counter()
        self.a_callers = Counter()
        self._coset = False
        self._depth = 0

    def _bracket(self, fn, *args, **kw):
        if not self.windows or self._depth:
            self._depth += 1
            try:
                return fn(*args, **kw)
            finally:
                self._depth -= 1
        self._depth += 1
        try:
            torch.cuda.synchronize()
            with torch.profiler.record_function(WINDOW):
                out = fn(*args, **kw)
                torch.cuda.synchronize()
            return out
        finally:
            self._depth -= 1

    @contextlib.contextmanager
    def active(self):
        from ..ntt import fused
        from ..poly import domain as dom_mod
        orig_t = fused.FusedNTT._transform
        orig_c = fused.base_ntt
        orig_launch = _build.Kernel.launch
        orig_dom = {name: getattr(dom_mod.EvaluationDomain, name)
                    for name in DOMAIN_FNS}
        census = self

        def transform(ntt, a, inv, *args, **kw):
            batch = 1
            for d in a.shape[:-2]:
                batch *= d
            census.transforms[(ntt.F.name, ntt.log_n, batch,
                               "inverse" if inv else "forward",
                               census._coset)] += 1
            return census._bracket(orig_t, ntt, a, inv, *args, **kw)

        def base_ntt(F, p):
            census.c_shapes[(F.name, p.log_m, tuple(d[0] for d in p.dims))
                            + p.flags()] += 1
            return orig_c(F, p)

        def launch(kernel, *args):
            if kernel.name == "h2_field_binop":
                census.a_callers[a_caller(sys._getframe(1))] += 1
            return orig_launch(kernel, *args)

        def wrap_dom(name, orig):
            def fn(dom, a, *args, **kw):
                prev = census._coset
                census._coset = name in COSET_FNS
                try:
                    return census._bracket(orig, dom, a, *args, **kw)
                finally:
                    census._coset = prev
            return fn

        fused.FusedNTT._transform = transform
        fused.base_ntt = base_ntt
        _build.Kernel.launch = launch
        for name, orig in orig_dom.items():
            setattr(dom_mod.EvaluationDomain, name, wrap_dom(name, orig))
        try:
            yield self
        finally:
            fused.FusedNTT._transform = orig_t
            fused.base_ntt = orig_c
            _build.Kernel.launch = orig_launch
            for name, orig in orig_dom.items():
                setattr(dom_mod.EvaluationDomain, name, orig)


def a_caller(frame) -> str:
    """'transform' when a frame of ntt/ or poly/domain.py in a transform
    function is on the stack, 'tables' for the plan's and the domain's
    tables, else 'other'."""
    while frame is not None:
        code = frame.f_code
        path = code.co_filename.replace("\\", "/")
        if ("/ntt/" in path or path.endswith("/poly/domain.py")):
            if code.co_name in TRANSFORM_FRAMES:
                return "transform"
            if code.co_name in ("_make_plan", "__init__"):
                return "tables"
        frame = frame.f_back
    return "other"


# ----------------------------------------------------------------------
# the profiled prove
# ----------------------------------------------------------------------

def profiled_split(fn) -> dict:
    """fn() under torch.profiler with the transforms bracketed: the
    prove's wall, busy device time, and device time by kernel class
    inside and outside the transforms."""
    from torch.profiler import ProfilerActivity, profile
    census = Census(windows=True)
    torch.cuda.synchronize()
    with census.active(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    ranges = [e for e in events if e.name == WINDOW]
    # the range's mirror on the device's clock spans the kernels launched
    # inside it; the host's range only where the trace has no mirror
    windows = sorted((e.time_range.start, e.time_range.end) for e in ranges
                     if e.device_type == cuda)
    clock = "device" if windows else "host"
    windows = windows or sorted((e.time_range.start, e.time_range.end)
                                for e in ranges)
    kernels = [e for e in events
               if e.device_type == cuda and e.name != WINDOW]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, start, end = 0.0, None, None
    for a, b in spans:
        if end is None or a > end:
            busy += 0 if end is None else end - start
            start, end = a, b
        else:
            end = max(end, b)
    busy += 0 if end is None else end - start

    def inside(e):
        s, t = e.time_range.start, e.time_range.end
        return any(a <= s and t <= b for a, b in windows)

    split = {"inside": Counter(), "outside": Counter()}
    names = Counter()
    for e in kernels:
        cls = kernel_class(e.name)
        where = "inside" if inside(e) else "outside"
        dur = (e.time_range.end - e.time_range.start) / 1e3
        split[where][cls] += dur
        if where == "inside":
            names[e.name.split("(")[0][:60]] += dur
    return dict(wall_ms=wall_ms, busy_ms=busy / 1e3, kernels=len(kernels),
                transforms=sum(e.device_type != cuda for e in ranges),
                windows=len(windows), clock=clock,
                inside={k: round(v, 4) for k, v in split["inside"].items()},
                outside={k: round(v, 4) for k, v in split["outside"].items()},
                inside_by_name={k: round(v, 4)
                                for k, v in names.most_common(12)})


def kernel_class(name: str) -> str:
    low = name.lower()
    if "k_ntt" in low:
        return "C"
    if "k_field_binop" in low:
        return "A"
    if "copy" in low or "cat" in low or "transpose" in low:
        return "copy/cat"
    if "fill" in low:
        return "fill"
    return "other"


# ----------------------------------------------------------------------
# the paths
# ----------------------------------------------------------------------

def _kzg():
    from ..commit import ProverSHPLONK
    return dict(multiopen_prover_cls=ProverSHPLONK)


def path_setup(name: str, dev):
    """(params, pk, circuit, inst, prove kwargs) of one path, made inside
    a census."""
    from ..api import keygen
    from ..commit import ParamsIPA, ParamsKZG
    from ..compat import plonk_api
    from ..compat.lookup_heavy import lookup_heavy_instance
    from ..curves import VESTA
    from ..fields import BN254_FR, PASTA_FP
    if name == "k18":
        circuit, inst = plonk_api.plonk_api_instance(BN254_FR)
        params = ParamsKZG.new(18, device=dev)
        return params, keygen(BN254_FR, params, 18, circuit), circuit, \
            inst, _kzg()
    if name == "k20":
        circuit, inst, kg = lookup_heavy_instance(BN254_FR, 20)
        params = ParamsKZG.new(20, device=dev)
        return params, keygen(BN254_FR, params, 20, kg), circuit, inst, \
            _kzg()
    circuit, inst = plonk_api.plonk_api_instance(PASTA_FP)
    params = ParamsIPA.new(VESTA, 14, device=dev)
    return params, keygen(PASTA_FP, params, 14, circuit), circuit, inst, {}


def run_path(name: str, dev) -> dict:
    from ..api import create_proof
    from .. import bench
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    out = {}
    if name == "micro":
        with Census().active() as c:
            res = bench.stage_micro(dev, k=18)
        torch.cuda.synchronize()
        out["ntt_elems_per_sec"] = res.get("ntt_elems_per_sec")
        out["bench"] = {k: v for k, v in res.items()
                        if isinstance(v, (int, float))}
        parts = {"micro": c}
    else:
        t0 = time.time()
        with Census().active() as kg:
            params, pk, circuit, inst, kw = path_setup(name, dev)
            torch.cuda.synchronize()
        out["setup_s"] = time.time() - t0
        create_proof(params, pk, [circuit], [inst], random.Random(1), **kw)
        torch.cuda.synchronize()
        before = _build.launch_counts()
        with Census().active() as pr:
            t0 = time.time()
            create_proof(params, pk, [circuit], [inst], random.Random(2),
                         **kw)
            torch.cuda.synchronize()
            out["prove_s"] = time.time() - t0
        out["prove_launches"] = {k: v - before.get(k, 0)
                                 for k, v in _build.launch_counts().items()
                                 if v - before.get(k, 0)}
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["profile"] = profiled_split(lambda: create_proof(
            params, pk, [circuit], [inst], random.Random(3), **kw))
        parts = {"params+keygen": kg, "prove": pr}
    out["launches"] = {k: v for k, v in _build.launch_counts().items() if v}
    for part, c in parts.items():
        out[part] = dict(
            transforms=sorted([list(k) + [n] for k, n in
                               c.transforms.items()], key=str),
            c_launches=sorted([[str(x) for x in k] + [n] for k, n in
                               c.c_shapes.items()], key=str),
            a_by_caller=dict(c.a_callers))
    return out


def print_path(name: str, r: dict):
    for key in ("setup_s", "prove_s", "peak_mem_gib", "ntt_elems_per_sec"):
        if key in r:
            log(f"[{name}] {key} {r[key]}")
    log(f"[{name}] launches (whole run): {r['launches']}")
    if "prove_launches" in r:
        log(f"[{name}] launches (one prove): {r['prove_launches']}")
    for part in ("params+keygen", "prove", "micro"):
        if part not in r:
            continue
        p = r[part]
        log(f"[{name} {part}] kernel A launches by caller: "
            f"{p['a_by_caller']}")
        for t in p["transforms"]:
            field, log_n, batch, direction, coset, n = t
            log(f"[{name} {part}] transform {field} 2^{log_n} batch {batch} "
                f"{direction}{' coset' if coset else ''}: x{n}")
        for c in p["c_launches"]:
            log(f"[{name} {part}] C {' '.join(c[:-1])}: x{c[-1]}")
    if "profile" in r:
        p = r["profile"]
        log(f"[{name}] profiled prove {p['wall_ms']:.1f} ms, device busy "
            f"{p['busy_ms']:.1f} ms (idle share "
            f"{1 - p['busy_ms'] / p['wall_ms']:.3f}), {p['kernels']} device "
            f"kernels, {p['transforms']} transforms bracketed ({p['windows']} "
            f"windows on the {p['clock']}'s clock); inside "
            f"them (ms): {p['inside']}; outside: {p['outside']}")
        log(f"[{name}] inside the transforms by kernel (ms): "
            f"{p['inside_by_name']}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--timing-only", action="store_true")
    args = ap.parse_args(argv)
    dev = card.require_cuda()
    log(card.name_and_power())
    out = dict(device=card.name_and_power())
    out["build"] = c_build()
    for fn, r in out["build"].items():
        log(f"[build C] {fn}: {r}")
    out["c_ms"] = c_times(dev)
    for k, v in out["c_ms"].items():
        log(f"[C] {k}: {v['ms']:.4f} ms (device {v['device_ms']:.4f} ms)")
    out["transform_ms"] = transform_times(dev)
    for k, v in out["transform_ms"].items():
        log(f"[transform] {k}: " + ", ".join(f"{d} {ms:.4f} ms"
                                             for d, ms in v.items()))
    if not args.timing_only:
        for name in args.paths.split(","):
            out[name] = run_path(name, dev)
            print_path(name, out[name])
    print(json.dumps(out, default=str), flush=True)
    return out


if __name__ == "__main__":
    main()
