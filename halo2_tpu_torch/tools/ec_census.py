"""Kernel B (csrc/ec.cu) and kernel 9 (csrc/scan.cu) on the card: what they
cost per launch, who launches them, and what kernel 9's levels look like.

    python -m halo2_tpu_torch.tools.ec_census [--k 14]

Prints, for the built library, each of B's and 9's functions' registers,
spills and resident blocks of 128 threads per SM (the register file's
limit, from ptxas's count) and its SASS multiplies by kind; B's time per
launch on Vesta and BN254 at batch sizes 1, 64, 4,096, 8,192 and 2^16 (CUDA
events over back-to-back launches, so the host's dispatch is in it); then
IPA plonk_api proves over Vesta at 2^k rows: one steady prove timed, one
profiled (device busy time, B's and 9's device time by function), and one
with every launch of B's entries attributed to its caller
(`caller_census`) and every kernel-9 call recorded: its elements M, block, lanes, mode, the share of elements
whose infinity flag is set, whether it is a scan level or a tails call, and
its time when run again; and the whole variable-base MSM of the
opening's largest size, 2^(k-1) points, at fixed blocks.  The last line is
one JSON object of it all.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import sys
import time
from collections import Counter

import torch

from .. import _build
from . import card

B_KERNELS = ("h2_ec_add", "h2_ec_madd", "h2_ec_double", "h2_ec_scalar_mul",
             "h2_ec_horner")
SIZES = (1, 64, 1 << 12, 1 << 13, 1 << 16)
# the group-law entry points themselves: a caller is the first frame
# outside them
_GENERIC = {("curve.py", "add"), ("curve.py", "madd"), ("curve.py", "double"),
            ("curve.py", "neg")}


def _where(frame) -> str:
    return (f"{os.path.basename(frame.f_code.co_filename)[:-3]}."
            f"{frame.f_code.co_name}")


def caller_of(frame) -> str:
    """'function < its caller' of the first frame above `frame` that is
    not a group-law wrapper (cuda_ec.py, Curve.add / madd / double / neg)
    or the launch itself."""
    while frame is not None:
        name = os.path.basename(frame.f_code.co_filename)
        if name not in ("cuda_ec.py", "_build.py", "ec_census.py") and \
                (name, frame.f_code.co_name) not in _GENERIC:
            up = frame.f_back
            return _where(frame) + (f" < {_where(up)}" if up else "")
        frame = frame.f_back
    return "?"


@contextlib.contextmanager
def caller_census(names=B_KERNELS):
    """Count the launches of the kernels in `names` by (kernel, caller)
    while the block runs.  The launch counts of `_build` are untouched."""
    counts = Counter()
    orig = _build.Kernel.launch

    def launch(self, *args):
        if self.name in names:
            counts[self.name, caller_of(sys._getframe(1))] += 1
        return orig(self, *args)

    _build.Kernel.launch = launch
    try:
        yield counts
    finally:
        _build.Kernel.launch = orig


def census_lines(counts) -> list:
    """'kernel: n (caller), ...' per kernel, largest first."""
    by_kernel = {}
    for (kernel, caller), n in counts.items():
        by_kernel.setdefault(kernel, []).append((n, caller))
    return [f"{k}: {sum(n for n, _ in v)} = " + ", ".join(
        f"{n} {c}" for n, c in sorted(v, reverse=True))
        for k, v in sorted(by_kernel.items())]


def resident_blocks(registers: int, threads: int = 128) -> int:
    """Blocks of `threads` per SM that the register file holds (65,536
    registers, allocated per warp in units of 256; at most 64 warps and 32
    blocks per SM)."""
    per_warp = -(-registers * 32 // 256) * 256
    warps = min(64, 65536 // per_warp)
    return min(32, warps // (threads // 32))


def build_report() -> dict:
    """Registers, spills, resident blocks and SASS multiplies by kind of
    every function of kernels B and 9."""
    ptxas = card.ptxas_report()
    sass = card.sass_report()
    out = {}
    for fn in sorted(sass):
        if not any(k in fn for k in ("k_ec_", "k_scan_level")):
            continue
        r = dict(ptxas.get(fn, {}))
        if "registers" in r:
            r["blocks_per_sm"] = resident_blocks(r["registers"])
        r["multiplies"] = sass[fn]["kinds"]
        r["total"] = sum(sass[fn]["kinds"].values())
        out[fn] = r
    return out


def random_points(G, n: int, seed: int, dev):
    """n points [k_i]G from a numpy seed (a few identities)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ks = [int(v) for v in rng.integers(1, 1 << 62, size=n)]
    pts = G.generator_mul(G.Fr.encode_ints(ks, dev))
    pts[3::97] = G.identity((1,), dev)
    return pts


def launch_times(G, dev, sizes=SIZES, reps: int = 50) -> dict:
    """B's add, madd and double at each batch size: ms per launch (CUDA
    events over back-to-back launches, the host's dispatch included) and
    the device's own ms (torch.profiler), as (ms, device ms)."""
    pts = random_points(G, max(sizes), 1, dev)
    other = random_points(G, max(sizes), 2, dev)
    aff = G.batch_normalize(other)
    inf = G.is_identity(other)
    out = {}
    for n in sizes:
        P, Q, A, I = pts[:n], other[:n], aff[:n], inf[:n]
        ops = dict(add=lambda: G.add(P, Q), madd=lambda: G.madd(P, A, I),
                   double=lambda: G.double(P))
        out[n] = {op: (card.cuda_ms(fn, reps), card.device_ms(fn, 10))
                  for op, fn in ops.items()}
    return out


def _recording_scans(bs):
    calls = []
    orig = bs.scan_level

    def wrapper(curve, keys, pts, block, mode):
        out = orig(curve, keys, pts, block, mode)
        calls.append(dict(args=(curve, keys, pts, block, mode),
                          caller=_where(sys._getframe(1))))
        return out

    return calls, orig, wrapper


def scan_census(calls) -> list:
    """One row per kernel-9 call: M, block, lanes, mode, infinity share,
    level or tails; the time of each distinct shape run again."""
    from ..fields.cuda_ops import NWORDS
    from ..msm import bucket_scan as bs
    rows, timed = [], {}
    for c in calls:
        curve, keys, pts, block, mode = c["args"]
        m = keys.shape[0]
        if mode == bs.PROJECTIVE:
            inf = curve.is_identity(pts)
        else:
            inf = (pts[:, 2 * NWORDS] & 1) != 0
        shape = (m, block, mode, c["caller"])
        if shape not in timed:
            timed[shape] = card.cuda_ms(lambda: bs.scan_level(*c["args"]), 5)
        rows.append(dict(M=m, block=block, lanes=m // block, mode=mode,
                         inf_share=float(inf.float().mean()),
                         kind="tails" if "_pieces" in c["caller"] else
                         "level", ms=timed[shape]))
    return rows


def ipa_census(k: int, dev) -> dict:
    """One steady IPA prove at 2^k rows: B's launches by caller, kernel 9's
    calls, wall time."""
    from ..api import create_proof, keygen
    from ..commit import ParamsIPA
    from ..compat import plonk_api
    from ..curves import VESTA
    from ..fields import PASTA_FP
    from ..msm import bucket_scan as bs
    circuit, inst = plonk_api.plonk_api_instance(PASTA_FP)
    t0 = time.time()
    params = ParamsIPA.new(VESTA, k, device=dev)
    pk = keygen(PASTA_FP, params, k, circuit)
    print(f"[ipa] params and keygen at k={k}: {time.time() - t0:.2f} s",
          flush=True)
    create_proof(params, pk, [circuit], [inst], random.Random(1))
    torch.cuda.synchronize()
    t0 = time.time()
    create_proof(params, pk, [circuit], [inst], random.Random(2))
    torch.cuda.synchronize()
    wall = time.time() - t0
    device = profiled(lambda: create_proof(params, pk, [circuit], [inst],
                                           random.Random(3)))
    calls, orig, wrapper = _recording_scans(bs)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    bs.scan_level = wrapper
    try:
        with caller_census() as counts:
            create_proof(params, pk, [circuit], [inst], random.Random(4))
            torch.cuda.synchronize()
    finally:
        bs.scan_level = orig
    launches = _build.launch_counts()
    return dict(wall_s=wall, launches=launches, by_caller=counts,
                scans=scan_census(calls), params=params, device=device)


def profiled(fn) -> dict:
    """fn() under torch.profiler: wall ms, device busy ms (the union of
    kernel intervals), device kernels, and device ms and calls of kernels
    B and 9 by function."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, start, end = 0.0, None, None
    for a, b in spans:
        if end is None or a > end:
            busy += 0 if end is None else end - start
            start, end = a, b
        else:
            end = max(end, b)
    busy += 0 if end is None else end - start
    by_fn = {}
    for e in prof.key_averages():
        for prefix in ("k_ec_add", "k_ec_madd", "k_ec_double",
                       "k_ec_scalar_mul", "k_ec_horner", "k_scan_level"):
            if prefix in e.key:
                ms, n = by_fn.get(prefix, (0.0, 0))
                by_fn[prefix] = (ms + e.self_device_time_total / 1e3,
                                 n + e.count)
    return dict(wall_ms=wall_ms, busy_ms=busy / 1e3, kernels=len(spans),
                by_fn=by_fn)


def msm_by_block(params, n: int, blocks) -> dict:
    """The whole variable-base MSM of n random scalars against the params'
    first n generators (c = 8, as the opening's MSMs at n >= 2^12) with
    every level at one fixed block, per block: ms by CUDA events."""
    from ..msm import bucket_scan as bs
    from .alu_probe import random_elems
    G = params.curve
    s = random_elems(G.Fr, n, 3, params.device)
    return {b: card.cuda_ms(lambda: bs.msm_variable(G, s, params.g[:n], 8, b),
                            3) for b in blocks}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=14)
    args = ap.parse_args(argv)
    dev = card.require_cuda()
    from ..curves import BN254_G1, VESTA
    print(card.name_and_power(), flush=True)
    build = build_report()
    for fn, r in build.items():
        print(f"[build] {fn}: {r}", flush=True)
    times = {}
    for G in (VESTA, BN254_G1):
        times[G.name] = launch_times(G, dev)
        for n, t in times[G.name].items():
            print(f"[B per launch] {G.name} n={n}: " + ", ".join(
                f"{op} {ms:.4f} ms (device {dev_ms:.4f})"
                for op, (ms, dev_ms) in t.items()), flush=True)
    ipa = ipa_census(args.k, dev)
    b_total = sum(ipa["launches"].get(n, 0) for n in B_KERNELS)
    print(f"[ipa k={args.k}] steady prove {ipa['wall_s']:.3f} s; kernel B "
          f"launches {b_total}; all launches {ipa['launches']}", flush=True)
    d = ipa["device"]
    print(f"[ipa k={args.k}] profiled prove {d['wall_ms']:.1f} ms, device "
          f"busy {d['busy_ms']:.1f} ms (idle share "
          f"{1 - d['busy_ms'] / d['wall_ms']:.3f}), {d['kernels']} device "
          f"kernels; kernels B and 9: " + "; ".join(
              f"{k} {ms:.1f} ms x{n}" for k, (ms, n) in d["by_fn"].items()),
          flush=True)
    for line in census_lines(ipa["by_caller"]):
        print(f"[ipa k={args.k}] B by caller: {line}", flush=True)
    shapes = Counter((r["M"], r["block"], r["lanes"], r["mode"], r["kind"],
                      round(r["inf_share"], 4), round(r["ms"], 4))
                     for r in ipa["scans"])
    for (m, block, lanes, mode, kind, inf, ms), n in sorted(
            shapes.items(), key=lambda kv: -kv[0][0]):
        print(f"[kernel 9] x{n} {kind} M={m} block={block} lanes={lanes} "
              f"mode={mode} inf_share={inf} {ms:.4f} ms", flush=True)
    scan_ms = sum(r["ms"] for r in ipa["scans"])
    n = 1 << (args.k - 1)
    by_block = msm_by_block(ipa["params"], n, (8, 16, 32, 64))
    print(f"[msm_variable] {n} points, c=8, ms by fixed block: {by_block}",
          flush=True)
    print(f"[kernel 9] {len(ipa['scans'])} calls a prove, {scan_ms:.2f} ms "
          f"summed (each call's shape timed alone)", flush=True)
    out = dict(device=card.name_and_power(), build=build, per_launch=times,
               ipa=dict(k=args.k, wall_s=ipa["wall_s"], b_launches=b_total,
                        device=ipa["device"],
                        launches=ipa["launches"],
                        by_caller=census_lines(ipa["by_caller"]),
                        scans=[f"{k}" for k in shapes.items()],
                        scan_ms=scan_ms, msm_ms_by_block=by_block))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
