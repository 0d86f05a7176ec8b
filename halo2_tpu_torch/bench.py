"""The port's benchmark: fixed-base MSM throughput through `StreamMSM` (the
engine commitments use), the NTT, the card's Montgomery-product rate on
kernel 10 (the carry-chain product the MSM and NTT kernels run) with the
roofline fractions, and the end-to-end prover.

    python -m halo2_tpu_torch.bench

Port of the JAX reference's bench.py, with its stages, its environment
variables and its one JSON line on stdout (logs go to stderr):

  {"metric": "msm_points_per_sec", "value": N, "unit": "points/s",
   "vs_baseline": R, "roofline": {...}, "e2e": {...}, "e2e20": {...}}

vs_baseline compares against 1e6 points/s, the reference's ballpark for
halo2curves' `best_multiexp` on a multicore x86 host (BASELINE.md).

Each stage (micro, e2e, sweep) runs in its own subprocess, so the device
memory of one is released before the next starts.  Every stage function
takes a `device` (default "cuda"); the tests call them on the CPU at small
sizes, where they only return their numbers (CPU times, no device metric).

Timing: `torch.cuda.synchronize()` around each timed section on the host
clock, and CUDA events for the single streamed multiply.  Sections shorter
than `min_s` (0.5 s) are repeated, 4x more each time, until they are not.
On the card, the stage refuses numbers that break the card's own limits: a
streamed multiply moves 96 B (two 32-byte inputs, one output), so the
streamed rate x 96 B must stay within 1.05 x 3.35 TB/s; the ALU rate within
1.05 x the rate that kernel 10's own SASS allows at the guide's IMAD rate,
and within 1.05 x the rate at the least multiplies a schoolbook
Montgomery product needs; and both roofline fractions inside (0, 1.2).
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import subprocess
import sys
import time

import torch

from ._build import resolve_device
from .curves import BN254_G1
from .fields import BN254_FR
from .fields.cuda_ops import NWORDS
from .msm import StreamMSM
from .msm.bucket_scan import n_windows_for, point_prefix_sum
from .msm.msm import auto_c
from .msm.stream_msm import STREAM_C
from .ntt import get_ntt
from .tools import card
from .tools.alu_probe import mont_repeat, random_elems

BASELINE_POINTS_PER_SEC = 1e6
RESULT_MARK = "##BENCH_RESULT## "
MULS_PER_MADD = 11       # Renes-Costello Alg 8 (a = 0), b3 by add chains
BYTES_PER_STREAMED_MUL = 96
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def _seconds(fn, dev):
    """(fn(), wall seconds), the device synchronised before and after."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def _device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


# ----------------------------------------------------------------------
# stage: micro (MSM + NTT + roofline)
# ----------------------------------------------------------------------

def gen_points(curve, k: int, device):
    """pts[i] = (i+1) G for i < 2^k: a log-depth inclusive prefix sum of
    point adds (kernel B)."""
    g = curve.from_affine_ints([(curve.gen_x, curve.gen_y)], device)
    return point_prefix_sum(curve, g.expand(1 << k, 3, NWORDS).contiguous())


def stage_micro(device="cuda", k: int = None, ntt_k: int = 18,
                rk: int = 1 << 21, mul_reps: int = 64, ntt_reps: int = 32,
                runs: int = 5, min_s: float = 0.5) -> dict:
    """MSM points/s at 2^k (HALO2_TPU_BENCH_K, default 18), the 2^ntt_k NTT
    rate, the Montgomery-product rate on kernel 10 at rk elements, the
    streamed kernel-A rate, and the roofline fractions."""
    dev = resolve_device(device)
    if k is None:
        k = int(os.environ.get("HALO2_TPU_BENCH_K", "18"))
    curve = BN254_G1
    F = curve.Fr
    n = 1 << k
    log(f"device: {_device_name(dev)}")

    pts, t = _seconds(lambda: gen_points(curve, k, dev), dev)
    log(f"point gen (2^{k} points): {t:.2f}s")
    engine, t = _seconds(lambda: StreamMSM(curve, pts), dev)
    log(f"StreamMSM table precompute: {t:.2f}s")

    scal = [random_elems(F, n, i, dev) for i in range(runs + 1)]
    _, t = _seconds(lambda: engine(scal[runs]), dev)
    log(f"msm first: {t:.2f}s")
    for s in scal[:3]:
        engine(s)
    while True:
        batches = [_seconds(lambda: [engine(s) for s in scal[:runs]], dev)[1]
                   for _ in range(2)]            # best of 2
        elapsed = min(batches)
        log(f"msm batches: {batches}")
        if elapsed >= min_s:
            break
        runs *= 4
        scal = [random_elems(F, n, i, dev) for i in range(runs)]
    msm_time = elapsed / runs
    pps = n / msm_time
    log(f"msm: {msm_time * 1e3:.3f} ms for 2^{k} points -> {pps:,.0f} "
        f"points/s ({runs} runs, elapsed {elapsed:.3f}s)")

    # ---- NTT: chained forward transforms, widened until >= min_s
    ntt = get_ntt(F, ntt_k, dev)
    a = random_elems(F, 1 << ntt_k, 99, dev)
    ntt.forward(a)                     # builds the plan outside the timing

    def chain():
        x = a
        for _ in range(ntt_reps):
            x = ntt.forward(x)
        return x

    while True:
        elapsed = _seconds(chain, dev)[1]
        if elapsed >= min_s:
            break
        ntt_reps *= 4
        log(f"ntt: widening to {ntt_reps} chained reps")
    ntt_time = elapsed / ntt_reps
    ntt_rate = (1 << ntt_k) / ntt_time
    log(f"ntt 2^{ntt_k}: {ntt_time * 1e3:.4f} ms -> {ntt_rate:,.0f} elems/s "
        f"({ntt_reps} chained, elapsed {elapsed:.3f}s)")

    # ---- the ALU rate: mul_reps dependent Montgomery products per element
    # in registers, inside one launch of kernel 10, widened until >= min_s
    a0 = random_elems(F, rk, 77, dev)
    b0 = random_elems(F, rk, 78, dev)
    mont_repeat(F, a0, b0, mul_reps)
    while True:
        elapsed = _seconds(lambda: mont_repeat(F, a0, b0, mul_reps), dev)[1]
        if elapsed >= min_s:
            break
        mul_reps *= 4
    mul_rate = rk * mul_reps / elapsed
    log(f"field mul (ALU, kernel 10 x{mul_reps}): {mul_rate / 1e6:,.0f} M "
        f"muls/s (elapsed {elapsed:.3f}s)")

    # ---- one streamed kernel-A multiply at rk elements
    F.mul(a0, b0)
    if dev.type == "cuda":
        stream_s = card.cuda_ms(lambda: F.mul(a0, b0), 10) / 1e3
    else:
        stream_s = _seconds(lambda: F.mul(a0, b0), dev)[1]
    mul_stream_rate = rk / stream_s
    log(f"field mul (streamed, kernel A): {mul_stream_rate / 1e6:,.0f} M "
        f"muls/s ({mul_stream_rate * BYTES_PER_STREAMED_MUL / 1e9:.0f} GB/s "
        f"implied)")

    # ---- roofline fractions.  The reference's formula counts auto_c(n)
    # windows (c = 13, 20 windows at k = 18); the engine timed above is
    # StreamMSM at c = STREAM_C (43 windows), so its own fraction is printed
    # beside.
    c_used = auto_c(n)
    n_win = n_windows_for(F, c_used)
    msm_roofline = mul_rate / (n_win * MULS_PER_MADD)
    msm_frac = pps / msm_roofline
    eng_win = n_windows_for(F, STREAM_C)
    msm_roofline_eng = mul_rate / (eng_win * MULS_PER_MADD)
    msm_frac_eng = pps / msm_roofline_eng
    log(f"msm roofline (c={c_used}, {n_win} windows x {MULS_PER_MADD} muls): "
        f"{msm_roofline:,.0f} pts/s -> fraction {msm_frac:.4f}; against the "
        f"engine's own {eng_win} windows: {msm_roofline_eng:,.0f} pts/s -> "
        f"fraction {msm_frac_eng:.4f}")
    ntt_muls_per_elem = ntt_k / 2 + 2
    ntt_roofline = mul_rate / ntt_muls_per_elem
    ntt_frac = ntt_rate / ntt_roofline
    log(f"ntt roofline ({ntt_muls_per_elem:.0f} muls/elem): "
        f"{ntt_roofline:,.0f} elems/s -> fraction {ntt_frac:.4f}")

    roofline = {
        "field_mul_per_s": round(mul_rate),
        "field_mul_methodology": "ALU-bound: mul_reps dependent carry-chain "
            "Montgomery products (fe_mul_chain, the product of the MSM and "
            "NTT kernels) per element in registers inside one launch of "
            "kernel 10",
        "field_mul_reps": mul_reps,
        "field_mul_stream_per_s": round(mul_stream_rate),
        "msm_windows": n_win,
        "msm_roofline_pts_per_s": round(msm_roofline),
        "msm_fraction": msm_frac,
        "msm_engine_windows": eng_win,
        "msm_engine_roofline_pts_per_s": round(msm_roofline_eng),
        "msm_engine_fraction": msm_frac_eng,
        "ntt_roofline_elems_per_s": round(ntt_roofline),
        "ntt_fraction": ntt_frac,
    }
    if dev.type == "cuda":
        roofline.update(_card_guards(mul_rate, mul_stream_rate, msm_frac,
                                     ntt_frac))
    return {
        "device": _device_name(dev),
        "k": k,
        "msm_points_per_sec": round(pps),
        "msm_ms": msm_time * 1e3,
        "ntt_elems_per_sec": round(ntt_rate),
        "roofline": roofline,
    }


def _card_guards(mul_rate, mul_stream_rate, msm_frac, ntt_frac) -> dict:
    """Refuse numbers the card cannot produce (the methodology broke);
    return the ALU bounds they were held to: the rate kernel 10's own SASS
    allows, and the rate at the least multiplies an 8-word schoolbook
    Montgomery product needs (`card.least_multiplies`), both at the guide's
    IMAD rate."""
    bound = card.Bounds(card.sass_multiplies(), card.max_sm_clock_mhz())
    per_mul = card.mont_repeat_multiplies("Bn254Fr")
    alu_bound = bound.rate / per_mul
    least = card.least_multiplies(BN254_FR)
    least_bound = bound.rate / least
    stream_bytes = mul_stream_rate * BYTES_PER_STREAMED_MUL
    imad = bound.imad_per_clk_sm(mul_rate * per_mul)
    log(f"guards: streamed {stream_bytes / 1e12:.3f} TB/s against "
        f"{card.HBM_BYTES_PER_S / 1e12:.2f}; ALU {mul_rate / 1e9:.2f} G muls/s "
        f"against {alu_bound / 1e9:.2f} ({per_mul:g} IMAD per product, "
        f"{card.IMAD_PER_CLK_SM} per clock per SM at {bound.clock_mhz:.0f} "
        f"MHz) and {least_bound / 1e9:.2f} (the least {least} per product), "
        f"share {mul_rate / least_bound:.3f}; measured {imad:.1f} IMAD per "
        f"clock per SM")
    assert stream_bytes <= 1.05 * card.HBM_BYTES_PER_S, (
        f"streamed mul rate implies {stream_bytes / 1e9:.0f} GB/s > the "
        "card's HBM rate")
    assert mul_rate <= 1.05 * alu_bound, (
        f"ALU rate {mul_rate:.3g} muls/s > kernel 10's IMAD bound "
        f"{alu_bound:.3g}")
    assert mul_rate <= 1.05 * least_bound, (
        f"ALU rate {mul_rate:.3g} muls/s > the schoolbook least-multiplies "
        f"bound {least_bound:.3g}")
    assert 0 < msm_frac < 1.2, f"degenerate msm fraction {msm_frac:.3g}"
    assert 0 < ntt_frac < 1.2, f"degenerate ntt fraction {ntt_frac:.3g}"
    return {"field_mul_alu_bound_per_s": round(alu_bound),
            "field_mul_least_bound_per_s": round(least_bound),
            "imad_per_product": per_mul,
            "least_imad_per_product": least,
            "alu_imad_per_clk_sm": imad,
            "max_sm_clock_mhz": bound.clock_mhz}


# ----------------------------------------------------------------------
# stage: e2e prover
# ----------------------------------------------------------------------

def bench_e2e(k: int, circuit_kind: str = "plonk_api",
              device="cuda") -> dict:
    """keygen -> two proves -> verify at 2^k rows, KZG/BN254 with the SHPLONK
    multiopen and a Blake2b transcript.  circuit_kind "plonk_api" is the
    reference's plonk_api circuit (BASELINE config 3 at k=18); "lookup" the
    lookup-heavy circuit (four 16-bit range lookups per row, BASELINE
    config 4 at k=20).  The steady (second) prove's step table is logged and
    returned; `proof_sha256` names the steady proof's bytes."""
    from .api import create_proof, keygen, verify
    from .commit import (ParamsKZG, ProverSHPLONK, SingleStrategyKZG,
                         VerifierSHPLONK)
    dev = resolve_device(device)
    F = BN254_FR
    log(f"[e2e] {circuit_kind} circuit, KZG/BN254 + SHPLONK, k={k}, "
        f"{_device_name(dev)}")
    if circuit_kind == "lookup":
        from .compat.lookup_heavy import lookup_heavy_instance
        circuit, instances, keygen_circuit = lookup_heavy_instance(F, k)
    else:
        from .compat.plonk_api import plonk_api_instance
        circuit, instances = plonk_api_instance(F)
        keygen_circuit = circuit

    params, t_params = _seconds(lambda: ParamsKZG.new(k, device=dev), dev)
    log(f"[e2e] params: {t_params:.2f}s")
    pk, t_keygen = _seconds(lambda: keygen(F, params, k, keygen_circuit), dev)
    log(f"[e2e] keygen: {t_keygen:.2f}s")

    def prove(seed, timings):
        return create_proof(params, pk, [circuit], [instances],
                            random.Random(seed),
                            multiopen_prover_cls=ProverSHPLONK,
                            timings=timings)

    _, t_first = _seconds(lambda: prove(1, {}), dev)
    log(f"[e2e] prove (first): {t_first:.2f}s")
    timings = {}
    proof, t_prove = _seconds(lambda: prove(2, timings), dev)
    log(f"[e2e] prove (steady): {t_prove:.2f}s; step table:")
    for name, secs in timings.items():
        log(f"[e2e]   {name:34s} {secs:8.3f}s")

    ok, t_verify = _seconds(lambda: verify(
        params, pk.vk, proof, [instances],
        multiopen_verifier_cls=VerifierSHPLONK,
        strategy_cls=SingleStrategyKZG), dev)
    log(f"[e2e] verify: {t_verify:.3f}s ok={ok}")
    assert ok, "e2e proof failed verification"

    return {
        "k": k,
        "circuit": circuit_kind,
        "scheme": "KZG/BN254 + SHPLONK + Blake2b",
        "device": _device_name(dev),
        "params_s": t_params,
        "keygen_s": t_keygen,
        "prove_first_s": t_first,
        "prove_s": t_prove,
        "verify_s": t_verify,
        "proof_bytes": len(proof),
        "proof_sha256": hashlib.sha256(proof).hexdigest(),
        "steps_s": dict(timings),
    }


def bench_sweep(ks, device="cuda") -> list:
    """keygen / prove / verify over k in one process: the analog of the
    reference's criterion sweep (halo2_proofs/benches/plonk.rs:306-346)."""
    out = []
    for k in ks:
        out.append(bench_e2e(k, device=device))
        log(f"[sweep] k={k} done")
    return out


# ----------------------------------------------------------------------
# orchestration
# ----------------------------------------------------------------------

def _run_stage(args, timeout):
    """Run a stage in a subprocess, stderr passed through; parse the marked
    JSON line of its stdout.  None on failure (the headline still prints)."""
    cmd = [sys.executable, "-m", "halo2_tpu_torch.bench"] + args
    log(f"[driver] {' '.join(cmd)}")
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, timeout=timeout,
                              cwd=ROOT)
    except subprocess.TimeoutExpired:
        log(f"[driver] stage {args} timed out after {timeout}s")
        return None
    for line in proc.stdout.decode(errors="replace").splitlines():
        if line.startswith(RESULT_MARK):
            return json.loads(line[len(RESULT_MARK):])
    log(f"[driver] stage {args} produced no result (rc={proc.returncode})")
    return None


def _stage(argv) -> dict:
    stage = argv[argv.index("--stage") + 1]
    if stage == "micro":
        return stage_micro()
    if stage == "e2e":
        k = int(argv[argv.index("--k") + 1])
        kind = (argv[argv.index("--circuit") + 1]
                if "--circuit" in argv else "plonk_api")
        return bench_e2e(k, kind)
    if stage == "sweep":
        return bench_sweep([int(x) for x in
                            argv[argv.index("--ks") + 1].split(",")])
    raise SystemExit(f"unknown stage {stage}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if "--stage" in argv:
        # periodic thread dumps to stderr: a hang is diagnosable from the log
        import faulthandler
        faulthandler.enable()
        faulthandler.dump_traceback_later(600, repeat=True, file=sys.stderr)
        print(RESULT_MARK + json.dumps(_stage(argv)), flush=True)
        return

    card.require_cuda()
    env = os.environ.get
    e2e = None
    if env("HALO2_TPU_BENCH_NO_E2E") != "1":
        e2e = _run_stage(["--stage", "e2e", "--k",
                          env("HALO2_TPU_BENCH_E2E_K", "18")], timeout=5400)
    # BASELINE config 4: lookup-heavy k=20 (the unbaked stream table)
    e2e20 = None
    if env("HALO2_TPU_BENCH_NO_E2E20") != "1":
        e2e20 = _run_stage(["--stage", "e2e", "--k",
                            env("HALO2_TPU_BENCH_E2E20_K", "20"),
                            "--circuit", "lookup"], timeout=5400)
    # the k sweep, opt-in: it reruns the whole pipeline per k
    sweep = None
    if env("HALO2_TPU_BENCH_SWEEP"):
        sweep = _run_stage(["--stage", "sweep", "--ks",
                            env("HALO2_TPU_BENCH_SWEEP_KS", "12,14,16,18")],
                           timeout=10800)
    micro = _run_stage(["--stage", "micro"], timeout=3600)

    pps = micro["msm_points_per_sec"] if micro else 0
    out = {
        "metric": "msm_points_per_sec",
        "value": pps,
        "unit": "points/s",
        "vs_baseline": round(pps / BASELINE_POINTS_PER_SEC, 4),
        "card": card.name_and_power(),
    }
    if micro:
        out["roofline"] = micro["roofline"]
        out["ntt_elems_per_sec"] = micro["ntt_elems_per_sec"]
        out["vs_cpu_estimate"] = {
            "msm_multiple": round(pps / BASELINE_POINTS_PER_SEC, 2),
            "chip_potential_multiple": round(
                micro["roofline"]["msm_roofline_pts_per_s"]
                / BASELINE_POINTS_PER_SEC, 1),
            "methodology": "BASELINE.md: reference CPU best_multiexp "
                           "ballpark 1e6 pts/s; potential = measured ALU "
                           "roofline / same base",
        }
    if e2e is not None:
        out["e2e"] = e2e
    if e2e20 is not None:
        out["e2e20"] = e2e20
    if sweep is not None:
        out["sweep"] = sweep
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
