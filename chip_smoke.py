"""Smoke run of the PyTorch / CUDA port (halo2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the four CUDA kernels from halo2_tpu_torch/csrc, holds each against
its plain PyTorch version on the card, proves plonk_api at k=8 on the CPU
(plain versions) and on the GPU (kernels) and requires equal proof bytes,
then drives the main path at k=18 — ParamsKZG.new, keygen, create_proof
(a first and N_STEADY steady runs), verify, and a tampered proof — with
every kernel's launch count.  Any failure exits non-zero.  The line before the last is a
JSON object of per-kernel results; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

It needs a CUDA device and nvcc, imports nothing of JAX, and exits with
code 2 and no result when no GPU is visible.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

import numpy as np

K_MAIN = 18
K_CMP = 8
N_STEADY = 5          # steady proves at K_MAIN, for their spread


def log(msg: str):
    print(msg, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.modules.setdefault("jax", None)     # the port must not need JAX
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from halo2_tpu_torch import _build
    from halo2_tpu_torch._shared import plonk_api
    from halo2_tpu_torch.api import create_proof, keygen, verify
    from halo2_tpu_torch.commit import ParamsKZG
    from halo2_tpu_torch.curves import BN254_G1
    from halo2_tpu_torch.fields import BN254_FR

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    _build.library()
    log(f"[build] kernels ready in {time.time() - t0:.2f} s (nvcc "
        f"{'%.2f s' % _build.build_seconds if _build.build_seconds else 'reused'})")

    results = check_kernels(torch, dev, BN254_FR, BN254_G1)

    # ---- k=8: CPU (plain versions) and GPU (kernels) give one proof
    F = BN254_FR
    circuit, inst = plonk_api().plonk_api_instance(F)
    proofs = {}
    for where in ("cpu", dev):
        t0 = time.time()
        params = ParamsKZG.new(K_CMP, device=where)
        pk = keygen(F, params, K_CMP, circuit)
        proof = create_proof(params, pk, [circuit], [inst], random.Random(1))
        ok = verify(params, pk.vk, proof, [inst])
        if not ok:
            raise AssertionError(f"k={K_CMP} proof on {where} did not verify")
        proofs[str(where)] = proof
        log(f"[k={K_CMP}] {where}: keygen+prove+verify "
            f"{time.time() - t0:.2f} s, {len(proof)} proof bytes, verify=True")
    if proofs["cpu"] != proofs[str(dev)]:
        raise AssertionError("CPU-plain and GPU-kernel proofs differ")
    log(f"[k={K_CMP}] CPU-plain and GPU-kernel proof bytes are equal")

    # ---- the main path at k=18, through the kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.time()
    params = ParamsKZG.new(K_MAIN, device=dev)
    torch.cuda.synchronize()
    t_params = time.time() - t0
    t0 = time.time()
    pk = keygen(F, params, K_MAIN, circuit)
    torch.cuda.synchronize()
    t_keygen = time.time() - t0
    log(f"[k={K_MAIN}] ParamsKZG.new {t_params:.2f} s, keygen "
        f"{t_keygen:.2f} s")
    steady = []
    for seed, run in enumerate(["first"] + ["steady"] * N_STEADY, start=1):
        timings = {}
        t0 = time.time()
        proof = create_proof(params, pk, [circuit], [inst],
                             random.Random(seed), timings=timings)
        torch.cuda.synchronize()
        wall = time.time() - t0
        if run == "steady":
            steady.append(wall)
        steps = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        log(f"[k={K_MAIN}] prove ({run}) {wall:.3f} s; steps: {steps}")
    log(f"[k={K_MAIN}] steady prove over {N_STEADY} runs: median "
        f"{sorted(steady)[N_STEADY // 2]:.3f} s, min {min(steady):.3f} s, "
        f"max {max(steady):.3f} s")
    t0 = time.time()
    ok = verify(params, pk.vk, proof, [inst])
    t_verify = time.time() - t0
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    rejected = not verify(params, pk.vk, bytes(bad), [inst])
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[k={K_MAIN}] verify {ok} in {t_verify:.3f} s; tampered proof "
        f"rejected {rejected}; peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {counts}")
    if not ok or not rejected:
        raise AssertionError("k=18 verification failed")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {counts}")

    profile_prove(torch, params, pk, circuit, inst)
    results["h2_stream_bucket"].update(check_msm_main(torch, params))
    for name, r in results.items():
        r["launches"] = counts[name]
    log(json.dumps({"kernels": list(results.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ----------------------------------------------------------------------
# kernel checks
# ----------------------------------------------------------------------

def cuda_ms(torch, fn, reps: int = 3) -> float:
    """Mean time of fn() on the card by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(torch, a, b) -> int:
    """Largest word difference (0 means bit-identical)."""
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def expect_equal(torch, what: str, a, b) -> int:
    err = max_err(torch, a, b)
    if err != 0:
        raise AssertionError(f"{what}: kernel and plain version differ "
                             f"(max word difference {err})")
    return err


def random_elems(torch, F, n: int, seed: int, dev):
    """n canonical elements from a numpy seed, with 0, 1 and p-1 first."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    words[:, 7] %= (F.p >> 224)            # below p's top word: canonical
    words[:3] = 0
    words[1, 0] = 1
    for i in range(8):
        words[2, i] = ((F.p - 1) >> (32 * i)) & 0xFFFFFFFF
    t = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev)
    return F.to_mont(t)


def check_kernels(torch, dev, Fr, G1) -> dict:
    from halo2_tpu_torch.curves import cuda_ec
    from halo2_tpu_torch.fields import BN254_FQ, cuda_ops
    from halo2_tpu_torch.msm import naive_msm
    from halo2_tpu_torch.msm.stream_msm import (StreamMSM, stream_bucket,
                                                stream_bucket_plain,
                                                stream_keys)
    from halo2_tpu_torch.ntt import get_ntt
    from halo2_tpu_torch.ntt.fused import base_ntt, base_ntt_plain
    results = {}

    # A: field ops at 2^21 elements, both BN254 fields
    n = 1 << 21
    err = 0
    for F, seed in ((Fr, 1), (BN254_FQ, 2)):
        a = random_elems(torch, F, n, seed, dev)
        b = random_elems(torch, F, n, seed + 10, dev).flip(0)
        for mode, name in ((cuda_ops.MUL, "mul"), (cuda_ops.ADD, "add"),
                           (cuda_ops.SUB, "sub")):
            err = max(err, expect_equal(
                torch, f"field {name} {F.name}",
                cuda_ops.binop(F, mode, a, b),
                cuda_ops.binop_plain(F, mode, a, b)))
    a = random_elems(torch, Fr, n, 3, dev)
    b = random_elems(torch, Fr, n, 4, dev)
    ms = cuda_ms(torch, lambda: cuda_ops.binop(Fr, cuda_ops.MUL, a, b), 10)
    plain = cuda_ms(torch, lambda: cuda_ops.binop_plain(Fr, cuda_ops.MUL,
                                                        a, b), 1)
    log(f"[kernel A] field mul/add/sub x2 fields at 2^21: equal; mul "
        f"{ms:.3f} ms vs plain {plain:.1f} ms")
    results["h2_field_binop"] = dict(
        name="field_binop", route="cuda",
        source="halo2_tpu_torch/csrc/field.cu",
        replaces="halo2_tpu/fields/pallas_ops.py:138",
        max_abs_err=err, ms=ms, plain_ms=plain)

    # B: EC ops at 2^16 points: random, identities, P+P, P+(-P)
    m = 1 << 16
    P = G1.generator_mul(random_elems(torch, Fr, m, 5, dev))
    Q = G1.generator_mul(random_elems(torch, Fr, m, 6, dev))
    Q[: m // 4] = P[: m // 4]                      # P + P
    Q[m // 4: m // 2] = G1.neg(P[m // 4: m // 2])  # P + (-P)
    P[-64:] = G1.identity((64,), dev)              # identities
    Qa = G1.batch_normalize(Q)
    inf = G1.is_identity(Q)
    inf[1::7] = True
    ops = (("add", 181, lambda: cuda_ec.ec_add(G1, P, Q),
            lambda: cuda_ec.ec_add_plain(G1, P, Q)),
           ("madd", 222, lambda: cuda_ec.ec_madd(G1, P, Qa, inf),
            lambda: cuda_ec.ec_madd_plain(G1, P, Qa, inf)),
           ("double", 251, lambda: cuda_ec.ec_double(G1, P),
            lambda: cuda_ec.ec_double_plain(G1, P)))
    for op, line, kernel, plain_fn in ops:
        err = expect_equal(torch, f"ec {op}", kernel(), plain_fn())
        ms = cuda_ms(torch, kernel, 10)
        plain = cuda_ms(torch, plain_fn, 1)
        log(f"[kernel B] ec {op} at 2^16: equal; {ms:.3f} ms vs plain "
            f"{plain:.1f} ms")
        results[f"h2_ec_{op}"] = dict(
            name=f"ec_{op}", route="cuda", source="halo2_tpu_torch/csrc/ec.cu",
            replaces=f"halo2_tpu/curves/pallas_ec.py:{line}",
            max_abs_err=err, ms=ms, plain_ms=plain)

    # C: base NTT calls of the 2^18 and 2^20 (extended) transforms, then
    # whole transforms against the CPU path
    err = 0
    timing = None
    for log_n in (K_MAIN, K_MAIN + 2):
        ntt = get_ntt(Fr, log_n, dev)
        x = random_elems(torch, Fr, 1 << log_n, 7 + log_n, dev)
        _, l1, l2 = ntt._plan[log_n]
        for lm, shape in ((l1, (1, 1 << l1, 1 << l2, 8)),
                          (l2, (1, 1 << l2, 1 << l1, 8))):
            xb = x.reshape(shape)
            table = ntt._tables[(lm, False, "base")]
            err = max(err, expect_equal(torch, f"ntt base 2^{lm} in 2^{log_n}",
                                        base_ntt(Fr, xb, table, lm),
                                        base_ntt_plain(Fr, xb, table, lm)))
            timing = (xb, table, lm)
        back = ntt.inverse(ntt.forward(x))
        if max_err(torch, back, x) != 0:
            raise AssertionError(f"ntt 2^{log_n}: inverse(forward(x)) != x")
    small = random_elems(torch, Fr, 1 << 12, 11, dev).reshape(2, 1 << 11, 8)
    err = max(err, expect_equal(
        torch, "ntt 2^11 GPU vs CPU",
        get_ntt(Fr, 11, dev).forward(small).cpu(),
        get_ntt(Fr, 11, "cpu").forward(small.cpu())))
    xb, table, lm = timing
    ms = cuda_ms(torch, lambda: base_ntt(Fr, xb, table, lm), 10)
    plain = cuda_ms(torch, lambda: base_ntt_plain(Fr, xb, table, lm), 1)
    ntt20 = get_ntt(Fr, K_MAIN + 2, dev)
    x20 = random_elems(torch, Fr, 1 << (K_MAIN + 2), 9, dev)
    full = cuda_ms(torch, lambda: ntt20.forward(x20), 3)
    log(f"[kernel C] base NTT in 2^18 and 2^20 transforms: equal; base "
        f"2^{lm} x 2^{xb.shape[2]} {ms:.3f} ms vs plain {plain:.1f} ms; "
        f"full forward 2^20 {full:.3f} ms")
    results["h2_ntt_base"] = dict(
        name="ntt_base", route="cuda", source="halo2_tpu_torch/csrc/ntt.cu",
        replaces="halo2_tpu/ntt/fused.py:119",
        max_abs_err=err, ms=ms, plain_ms=plain)

    # D: MSM at n = 2^12 against naive_msm, random and adversarial scalars
    n = 1 << 12
    bases = G1.generator_mul(random_elems(torch, Fr, n, 12, dev))
    bases[5] = G1.identity((), dev)
    desc = StreamMSM(G1, bases)
    err = 0
    rng = np.random.default_rng(13)
    cases = {
        "random": random_elems(torch, Fr, n, 14, dev),
        "zeros": Fr.zeros((n,), dev),
        "all-equal": random_elems(torch, Fr, 8, 15, dev)[3:4].expand(
            n, 8).contiguous(),
        "p-1": Fr.encode_ints([Fr.p - 1] * n, dev),
        "sparse": Fr.encode_ints([int(v) for v in rng.integers(
            0, 3, size=n)], dev),
    }
    for case, s in cases.items():
        keys = stream_keys(G1, s, desc.lanes)
        err = max(err, expect_equal(
            torch, f"stream buckets ({case})",
            stream_bucket(G1, keys, desc.table),
            stream_bucket_plain(G1, keys, desc.table)))
        got = G1.to_affine_ints(desc(s)[None])
        want = G1.to_affine_ints(naive_msm(G1, s, bases)[None])
        if got != want:
            raise AssertionError(f"MSM 2^12 ({case}) != naive_msm")
    log(f"[kernel D] stream buckets at n=2^12 equal to plain; MSM == "
        f"naive_msm for {', '.join(cases)}")
    results["h2_stream_bucket"] = dict(
        name="stream_bucket", route="cuda",
        source="halo2_tpu_torch/csrc/msm.cu",
        replaces="halo2_tpu/msm/stream_msm.py:198", max_abs_err=err)
    return results


def profile_prove(torch, params, pk, circuit, inst):
    """One more steady prove under torch.profiler: device busy time (union
    of kernel intervals) against wall time, and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    from halo2_tpu_torch.api import create_proof
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        create_proof(params, pk, [circuit], [inst], random.Random(3))
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, start, end = 0.0, None, None
    for s, e in spans:
        if end is None or s > end:
            if end is not None:
                busy_us += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        busy_us += end - start
    if busy_us <= 0:
        raise AssertionError("the profiled prove ran nothing on the device")
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    kernels = "; ".join(f"{e.key.split('(')[0][:40]} "
                        f"{e.self_device_time_total / 1e3:.1f} ms x{e.count}"
                        for e in top[:6])
    log(f"[k={K_MAIN}] profiled prove {wall_ms:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms, idle share "
        f"{1 - busy_us / 1e3 / wall_ms:.3f}; top device time: {kernels}")


def check_msm_main(torch, params) -> dict:
    """Kernel D against its plain version at the k=18 shape: the baked
    Lagrange-basis table of the main path, random scalars."""
    from halo2_tpu_torch.fields import BN254_FR as Fr
    from halo2_tpu_torch.msm.stream_msm import (stream_bucket,
                                                stream_bucket_plain,
                                                stream_keys)
    G1 = params.curve
    desc = params.engine.msm_backend.get_base_descriptor(G1,
                                                         params.g_lagrange)
    s = random_elems(torch, Fr, params.n, 21, params.device)
    keys = stream_keys(G1, s, desc.lanes)
    err = expect_equal(torch, "stream buckets at k=18",
                       stream_bucket(G1, keys, desc.table),
                       stream_bucket_plain(G1, keys, desc.table))
    ms = cuda_ms(torch, lambda: stream_bucket(G1, keys, desc.table), 5)
    plain = cuda_ms(torch, lambda: stream_bucket_plain(G1, keys, desc.table),
                    1)
    msm_ms = cuda_ms(torch, lambda: desc(s), 3)
    log(f"[kernel D] stream buckets at k=18 ({tuple(desc.table.shape)}): "
        f"equal; {ms:.3f} ms vs plain {plain:.1f} ms; whole MSM "
        f"{msm_ms:.3f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain)


if __name__ == "__main__":
    sys.exit(main())
