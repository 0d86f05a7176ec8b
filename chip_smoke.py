"""Smoke run of the PyTorch / CUDA port (halo2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from halo2_tpu_torch/csrc and holds each of
them, and each of their BN254 and Pasta instances, against its plain
PyTorch version on the card word for word.  Proves on the CPU (plain
versions) and on the GPU (kernels) and requires equal proof bytes: KZG
plonk_api at k=8, IPA/Vesta plonk_api at k=6, and the shuffle and
two-phase circuits at k=8 on KZG / GWC / Keccak256.  Then it drives
fourteen main paths, each with the launch counts set to 0 just before it
and read just after:

  k=18 plonk_api, KZG / SHPLONK  (kernels A, B, C, D, the ordering pass)
  k=18 plonk_api under the sorted fixed-base MSM (GpuMsmEngine(style=
       "sorted"): CachedMSM's window tables, the sort and kernel 9), on the
       path's params: keygen with the path's VK, the path's first proof
       byte for byte, a steady prove, verify, a tampered proof rejected
       and a profiled prove  (A, B's add and doubling, C, 9; no D and no
       ordering pass)
  serde k=18 on that path's keys: the VK in every SerdeFormat, the PK in
       RAW_BYTES and PROCESSED and the params written and read back onto
       the card, equal; a PK element >= p refused; a prove with the read
       keys equal to the path's first proof byte for byte  (A, B's add, C,
       the ordering pass, D)
  middleware k=18: keygen from the JSON contract equal to the path's keys
       (A, B's add, C, the ordering pass, D)
  mock k=18: the MockProver on the card, plonk_api (its instance and the
       instance + 1), the shuffle circuit (honest, not a permutation) and
       the two-phase circuit (a phase-2 cell off by one at row 0)  (A)
  k=18 shuffle (shuffle_api.rs's circuit), KZG / GWC / Keccak256, and
  k=18 two-phase, KZG / SHPLONK / Keccak256, both through ProofConfig on
       the plonk_api path's params and tables  (A, B's add, C, D, the
       ordering pass)
  k=18 plonk_api on a mesh of four shards of cuda:0 (dist/), on the
       path's params: meshed keygen with the path's VK, the path's first
       proof byte for byte, a steady prove, verify and a tampered proof
       rejected  (A, B's add and doubling, C, D, the ordering pass)
  k=20 lookup_heavy, KZG / SHPLONK, on the unbaked table (kernel 8)
  k=14 plonk_api, IPA / Vesta, opening MSMs on the segmented scan (kernel 9);
       its ParamsIPA.new fills an empty params cache, and a second one
       reads it back (both timed, the bytes equal)
  batch IPA k=14 on that path's keys: a BatchVerifier accepting three
       honest proofs and refusing them with one tampered  (A, the ordering
       pass, D)
  k=14 plonk_api, IPA, under the sorted MSM (c = 11): keygen with the
       path's VK and its first proof byte for byte  (A, B, C, 9)
  bench micro k=18: the port bench's micro stage (MSM, NTT, kernel 10)
  probes: the ALU, gather and transpose probes (kernels 10-15)

the five proving paths (plonk_api, shuffle and two-phase at k=18,
lookup_heavy, IPA) each with params (the shuffle and two-phase paths reuse
the k=18 ones), keygen, a first and steady proves with their step tables,
verify, and a tampered proof that must be rejected (the shuffle path also
a non-permutation witness, the two-phase path a phase-2 cell off by
one), then one profiled prove (device busy and idle
share; not on lookup_heavy).  The cost model's proof sizes are printed
beside the real proofs' of the k=18 KZG and k=14 IPA paths.  The ordering pass and
kernel D are held against their plain versions at the k=18 table, the
ordering pass and kernel 8 at the k=20 one, for random, 16-bit, zero,
equal and one-bucket scalars, and the sorted MSM (CachedMSM, c = 13: baked
at k=18, unbaked in five chunks of four windows at k=20) against the same
StreamMSM for the same scalars, timed by steps (digits, sort, gather, scan
levels, folds, chunk combine) beside it, with its table's build time and
bytes, and kernel 9's first call of each shape of one sorted MSM held
against its plain version; both are timed on random scalars and on the
scalars of a real commitment of one more prove, whose nonzero shares are
printed with each path's counts of elements streamed and added; the
build's registers, spills, occupancy and SASS multiplies by kind are
printed first.  Kernel C (every pass of the four-step NTT) is held against
its plain version on every pass of forward and coset transforms at 2^18,
2^20 (BN254) and 2^14, 2^16 (Pasta), whole transforms against the CPU at
2^11 and 2^12 (forward, inverse, coset both ways), and on each main path
the first pass of each shape (field, log m, column dims with their
strides, row limits, twiddle size and flags) is recorded with every
column, so in the path's block layout, and held against its plain
version on its own inputs after the path.  On the IPA path
every kernel D and kernel 9 call of one more prove is recorded and held
against its plain version on its own inputs.  Kernel B's two chains (the
double-and-add scalar multiplication and the Horner combine, one launch
each) are held against
their plain versions at the IPA fold's shape (8,192 Vesta points, one
scalar), with per-lane BN254 scalars including 0, 1 and p - 1, and at the
Horner shapes of the k=20 unbaked MSM (BN254, 43 windows of 6 bits) and
of the IPA opening's MSMs (Vesta, 33 windows of 8 bits and 65 of 4); each
main path prints kernel B's launches split by caller.  At k=20 one MSM through the unbaked table must equal, as a group
element, the same MSM through a baked table built for the check.  Beside
the mesh path, the sharded primitives on four shards of cuda:0 are held
against their one-device twins (the NTT at 2^20 BN254 and 2^16 Pasta,
forward and inverse, the prefix product at 2^18, sharded_msm at 2^16
Vesta, ShardedCachedMSM at 2^18 BN254) and timed beside them (copies on
one card: nothing about NVLink); ProofConfig(k=8, mesh_devices=<visible
cards>) must prove the unmeshed bytes and one card more must raise; and
tests/_torch_multihost_child.py runs in two processes of two shards of
cuda:0 over gloo, whose flat and hybrid 2^20 transforms must equal the
one-process one.  Kernels
10-15 are held against their plain versions at the bench's and the
probes' shapes, and
timed beside the PyTorch call that computes the same function where there
is one (gather: `index_select`, transposes: `.t().contiguous()`);
kernels 10 and 11 also at a tail (2^12 K + 3 elements, K a thread's) and
below one block, and against the least multiplies a schoolbook Montgomery
product needs, their own SASS count beside it; kernel 12 also in its
IMAD.WIDE form; every kernel's share of its bound is printed at the
guide's IMAD rate and at kernel 12's measured rate.  Any failure exits
non-zero.
The line before the last is a JSON object of per-kernel results (time,
plain version's time, bound, launches); the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

It needs one CUDA device, nvcc and cuobjdump, imports nothing of JAX or of
the JAX package, and exits with code 2 and no result when no GPU is
visible.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import random
import shutil
import sys
import tempfile
import time
import types

import numpy as np

K_MAIN = 18
K_CMP = 8
N_STEADY = 3          # steady proves at K_MAIN, for their spread
K_LOOKUP = 20
K_IPA = 14
K_IPA_CMP = 6
N_STEADY_BIG = 2      # steady proves at K_LOOKUP, K_IPA and the K_MAIN
                      # shuffle and phase paths
SHARDS = 4            # shards of the mesh paths, all on cuda:0
K_MULTIHOST = 20      # the multi-process NTT, two processes x
MULTIHOST_SHARDS = 2  # MULTIHOST_SHARDS shards of cuda:0 each
# the paths proved through ProofConfig on the K_MAIN plonk_api path's
# params: the reference's shuffle_api.rs circuit for an EVM verifier, and
# the two-phase circuit
CONFIG_PATHS = {"shuffle": dict(scheme="kzg-gwc", transcript="keccak256"),
                "phase": dict(scheme="kzg-shplonk", transcript="keccak256")}

# The reference's TPU kernels, by file and line in the JAX package.
REFERENCE = "halo2_tpu"
# each curve's name in the kernels' SASS function names
SASS_TAG = {"bn254::G1": "Bn254G1", "pasta::Pallas": "Pallas",
            "pasta::Vesta": "Vesta"}
# kernel 9's template arguments <curve, AFFINE, PACKED> per scan mode
SCAN_SASS = {0: "Lb0ELb0E", 1: "Lb1ELb0E", 2: "Lb1ELb1E"}
# kernel B's per-op SASS multiplier counts before the chain product (PR 4)
B_CIOS = {"add": 2817, "madd": 2579, "double": 1787}
# the kernels of a path under GpuMsmEngine(style="sorted"): A, B's add and
# doubling (folds, window tables), C, and kernel 9 for every commitment
SORTED_NEED = ("h2_field_binop", "h2_ec_add", "h2_ec_double", "h2_ntt_base",
               "h2_scan_level")


def log(msg: str):
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str, walls: dict):
    t0 = time.time()
    log(f"[phase] {name} ...")
    yield
    walls[name] = time.time() - t0
    log(f"[phase] {name} done in {walls[name]:.2f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    # the port must need neither JAX nor the JAX package
    sys.modules.setdefault("jax", None)
    sys.modules.setdefault(REFERENCE, None)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from halo2_tpu_torch import _build
    from halo2_tpu_torch.tools import card

    t_start = time.time()
    walls: dict = {}
    dev = torch.device("cuda", 0)
    # the run's own, empty IPA params cache, removed at exit
    cache = tempfile.mkdtemp(prefix="halo2_smoke_cache_")
    atexit.register(shutil.rmtree, cache, True)
    os.environ["HALO2_TPU_CACHE"] = cache
    smi = card.name_and_power()
    clock_mhz = card.max_sm_clock_mhz()
    log(smi)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"max SM clock {clock_mhz:.0f} MHz")
    with phase("build", walls):
        _build.library()
        log(f"[build] nvcc {'%.2f s' % _build.build_seconds if _build.build_seconds else 'reused'}")
        bound = card.Bounds(card.sass_multiplies(), clock_mhz)
        log_stream_build(torch)

    results = {}
    with phase("kernels A-D, BN254", walls):
        results.update(check_kernels(torch, dev, bound))
    with phase("kernels A-D, Pasta instances", walls):
        check_pasta(torch, dev, bound, results)
    with phase("kernel B's chains: scalar mul and Horner", walls):
        results.update(check_chains(torch, dev, bound))
    with phase("kernel 9 on sorted streams", walls):
        results.update(check_kernel_9(torch, dev))
    with phase(f"KZG k={K_CMP} CPU == GPU", walls):
        compare_kzg_cpu_gpu(torch, dev)
    with phase(f"IPA k={K_IPA_CMP} CPU == GPU", walls):
        compare_ipa_cpu_gpu(torch, dev)
    with phase(f"shuffle and phase k={K_CMP}, GWC + Keccak256, CPU == GPU",
               walls):
        compare_config_cpu_gpu(torch, dev)

    counts = {}
    with phase(f"KZG plonk_api k={K_MAIN}", walls):
        path, kzg_proof = run_kzg_plonk_api(torch, dev, counts)
    with phase(f"ordering pass and kernel D at k={K_MAIN}", walls):
        check_stream_main(torch, *path, bound, results)
    with phase(f"sorted MSM at k={K_MAIN}, baked == StreamMSM", walls):
        check_sorted_msm(torch, path[0], results)
    with phase(f"KZG plonk_api k={K_MAIN} under the sorted MSM", walls):
        run_sorted_path(torch, f"KZG plonk_api k={K_MAIN}, sorted MSM",
                        _config(dev, K_MAIN), *path, kzg_proof, counts,
                        SORTED_NEED, 1, True)
    with phase(f"serde k={K_MAIN}", walls):
        check_serde(torch, *path, kzg_proof, counts)
    with phase(f"middleware k={K_MAIN}", walls):
        check_middleware(torch, *path, counts)
    with phase(f"mock k={K_MAIN}", walls):
        check_mock(torch, dev, counts)
    for name in CONFIG_PATHS:
        with phase(f"KZG {name} k={K_MAIN}", walls):
            run_config_path(torch, path[0], counts, name)
    with phase(f"dist primitives, {SHARDS} shards on cuda:0", walls):
        check_dist_primitives(torch, dev)
    with phase(f"KZG plonk_api k={K_MAIN} on a {SHARDS}-shard mesh", walls):
        run_mesh_path(torch, dev, *path, kzg_proof, counts)
    with phase("ProofConfig mesh_devices", walls):
        check_config_mesh(torch, dev)
    with phase(f"multihost: 2 processes x {MULTIHOST_SHARDS} shards on "
               f"cuda:0, gloo", walls):
        check_multihost(torch, dev)
    del path
    with phase(f"KZG lookup_heavy k={K_LOOKUP}", walls):
        path = run_lookup_heavy(torch, dev, counts)
    with phase(f"ordering pass and kernel 8 at k={K_LOOKUP}, unbaked == "
               f"baked", walls):
        check_stream_main(torch, *path, bound, results)
        check_unbaked_vs_baked(torch, path[0])
    with phase(f"sorted MSM at k={K_LOOKUP}, unbaked == StreamMSM", walls):
        check_sorted_msm(torch, path[0], results)
    del path
    with phase(f"IPA plonk_api k={K_IPA}", walls):
        (params, pk, circuit, inst), ipa_proof, t_cold = run_ipa(
            torch, dev, counts)
        check_ipa_cache(torch, params, t_cold)
    with phase(f"kernels D and 9 at the k={K_IPA} prove's calls", walls):
        check_ipa_main(torch, params, pk, circuit, inst, bound, results)
    with phase(f"batch IPA k={K_IPA}", walls):
        check_batch(torch, params, pk, circuit, inst, counts)
    with phase(f"IPA plonk_api k={K_IPA} under the sorted MSM", walls):
        run_sorted_path(torch, f"IPA plonk_api k={K_IPA}, sorted MSM",
                        _config(dev, K_IPA, curve="vesta", scheme="ipa"),
                        params, pk, circuit, inst, ipa_proof, counts,
                        SORTED_NEED + ("h2_ec_scalar_mul", "h2_ec_horner"),
                        0, False)
    del params, pk
    log_cost_model(len(kzg_proof), len(ipa_proof))
    with phase(f"bench micro k={K_MAIN}", walls):
        run_bench_micro(torch, dev, counts)
    with phase("kernel 12 at (8, 2^21)", walls):
        results["h2_u32_mul_repeat"] = check_kernel_12(torch, dev, bound)
    with phase("kernel 10 at 2^21", walls):
        results["h2_mont_repeat"] = check_kernel_10(torch, dev, bound,
                                                    results)
    with phase("probes", walls):
        run_probes(torch, counts)
    with phase("kernels 11, 13-15 at the probes' shapes", walls):
        check_probes(torch, dev, bound, results)

    for name, r in results.items():
        r["launches"] = sum(c.get(name, 0) for c in counts.values())
        r["launches_by_path"] = {path: c.get(name, 0)
                                 for path, c in counts.items()}
    missing = [k for k in _build.KERNELS if k not in results]
    if missing:
        raise AssertionError(f"kernels without a result: {missing}")
    shares_at_measured_rates(results)
    total = time.time() - t_start
    log("[walls] " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
        + f"; whole run {total:.2f} s")
    log(smi)
    log(json.dumps({"kernels": list(results.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ----------------------------------------------------------------------
# kernel checks (bounds and timing: halo2_tpu_torch/tools/card.py)
# ----------------------------------------------------------------------

def max_err(torch, a, b) -> int:
    """Largest word difference (0 means bit-identical)."""
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    if a.numel() == 0:
        return 0
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


def _entry(name, source, line, err, root=REFERENCE, **kw):
    """A kernel's entry; `line` is file:line of the TPU kernel in the JAX
    package (root None: in the repo's bench.py or tools/; line None: the
    kernel replaces none of its own)."""
    return dict(name=name, route="cuda", source=f"halo2_tpu_torch/csrc/{source}",
                replaces=f"{root}/{line}" if root and line else line,
                max_abs_err=err, **kw)


def check_field(torch, dev, F, n: int, seed: int, bound, tag: str):
    """Kernel A for field F at n elements: mul / add / sub equal to plain;
    the mul timed."""
    from halo2_tpu_torch.fields import cuda_ops
    from halo2_tpu_torch.tools import card
    a = random_elems(torch, F, n, seed, dev)
    b = random_elems(torch, F, n, seed + 10, dev).flip(0)
    err, plain = 0, None
    for mode, name in ((cuda_ops.MUL, "mul"), (cuda_ops.ADD, "add"),
                       (cuda_ops.SUB, "sub")):
        want, t = card.timed(lambda: cuda_ops.binop_plain(F, mode, a, b))
        plain = t if plain is None else plain
        err = max(err, expect_equal(
            torch, f"field {name} {F.name}", cuda_ops.binop(F, mode, a, b),
            want))
    ms = card.cuda_ms(lambda: cuda_ops.binop(F, cuda_ops.MUL, a, b), 10)
    b_ = bound(3 * 32 * n, n * bound.per_elem(
        "k_field_binop", tag, "Li0E"))
    log(f"[kernel A] {F.name} mul/add/sub at 2^{n.bit_length() - 1}: equal; "
        f"mul {ms:.3f} ms vs plain {plain:.1f} ms; bound {b_['bound_ms']:.4f} "
        f"ms ({b_['bound_by']})")
    return err, ms, plain, b_


def check_ec(torch, dev, G, m: int, seed: int, bound, tag: str) -> dict:
    """Kernel B for curve G at m points: random, identities, P+P, P+(-P)."""
    from halo2_tpu_torch.curves import cuda_ec
    from halo2_tpu_torch.tools import card
    P = G.generator_mul(random_elems(torch, G.Fr, m, seed, dev))
    Q = G.generator_mul(random_elems(torch, G.Fr, m, seed + 1, dev))
    Q[: m // 4] = P[: m // 4]                      # P + P
    Q[m // 4: m // 2] = G.neg(P[m // 4: m // 2])   # P + (-P)
    P[-64:] = G.identity((64,), dev)               # identities
    Qa = G.batch_normalize(Q)
    inf = G.is_identity(Q)
    inf[1::7] = True
    out = {}
    for op, line, kernel, plain_fn, io in (
            ("add", 181, lambda: cuda_ec.ec_add(G, P, Q),
             lambda: cuda_ec.ec_add_plain(G, P, Q), 3 * 96),
            ("madd", 222, lambda: cuda_ec.ec_madd(G, P, Qa, inf),
             lambda: cuda_ec.ec_madd_plain(G, P, Qa, inf), 96 + 64 + 1 + 96),
            ("double", 251, lambda: cuda_ec.ec_double(G, P),
             lambda: cuda_ec.ec_double_plain(G, P), 2 * 96)):
        want, plain = card.timed(plain_fn)
        err = expect_equal(torch, f"ec {op} {G.name}", kernel(), want)
        ms = card.cuda_ms(kernel, 10)
        fn = {"add": "k_ec_addI", "madd": "k_ec_maddI",
              "double": "k_ec_doubleI"}[op]
        b_ = bound(io * m, m * bound.per_elem(fn, tag))
        b_["device_ms"] = card.device_ms(kernel, 10)
        log(f"[kernel B] {G.name} ec {op} at 2^{m.bit_length() - 1}: equal; "
            f"{ms:.4f} ms a launch (device {b_['device_ms']:.4f} ms) vs plain "
            f"{plain:.1f} ms; bound {b_['bound_ms']:.4f} ms "
            f"({b_['bound_by']})")
        out[op] = (line, err, ms, plain, b_)
    return out


def c_products(log_m: int) -> int:
    """Carry-chain products of one column of a plain kernel-C pass (no
    factors): a radix-4 step of round t does four, or one (d1's) where its
    stage twiddles are 1 (l = j0 >> t = 0); an odd log_m's last radix-2
    stage does none."""
    q4, total, t = (1 << log_m) >> 2, 0, 0
    while t + 1 < log_m:
        ones = min(q4, 1 << t)               # j0 with l = 0
        total += 4 * (q4 - ones) + ones
        t += 2
    return total


def c_per_product(bound, tag) -> float:
    """Kernel C's SASS multiplier instructions per product (and so per
    butterfly with a twiddle): its radix-4 round loop's, over the round's
    four products."""
    from halo2_tpu_torch.ntt.fused import BUTTERFLIES_PER_ROUND
    from halo2_tpu_torch.tools import card
    return sum(card.loop_multiplies(("k_ntt", tag)).values()) \
        / BUTTERFLIES_PER_ROUND


def ntt_bound(bound, F, tag, lm, cols):
    """One plain pass of kernel C, 2^lm points on `cols` columns: bytes in +
    out + the m/2 powers; the products this pass does (`c_products`) at
    C's own multiplier instructions per product.  `least_bound_ms`: the
    same at the product's least multiplies (`card.least_multiplies`), as
    C's own count includes what ptxas left unfused."""
    from halo2_tpu_torch.tools import card
    m = 1 << lm
    nbytes = 2 * 32 * m * cols + 32 * max(m // 2, 1)
    b = bound(nbytes, c_products(lm) * cols * c_per_product(bound, tag))
    b["least_bound_ms"] = bound(
        nbytes, c_products(lm) * cols * card.least_multiplies(F))["bound_ms"]
    return b


def c_shape(F, p) -> tuple:
    """A kernel-C pass's whole shape: field, log m, column dims with their
    strides, j, row limits, the twiddle's (dim, log n, log lo) and flags;
    the column count it gives decides the block layout."""
    return (F.name, p.log_m, tuple(p.dims), tuple(p.j), p.src_rows,
            p.dst_rows, None if p.twiddle is None else p.twiddle[:3],
            p.flags())


@contextlib.contextmanager
def c_recorder(torch):
    """While the block runs, keep the first kernel-C pass of each shape
    (`c_shape`), every column of it: its spec, with a host copy of the
    whole range of src it reads, for `check_c_calls` after the path (whose
    launches then count in no path)."""
    from dataclasses import replace

    from halo2_tpu_torch.ntt import fused
    seen = {}
    orig = fused.base_ntt

    def wrapper(F, p):
        key = c_shape(F, p)
        if key not in seen:
            m = 1 << p.log_m
            hi = sum((d[0] - 1) * d[1] for d in p.dims) + (m - 1) * p.j[0] + 1
            # the host keeps the copy, and no reference to the path's
            # buffers, so the path's peak memory is its own
            seen[key] = (F, replace(p, src=p.src.reshape(-1, 8)[:hi].cpu(),
                                    dst=None))
        return orig(F, p)

    fused.base_ntt = wrapper
    try:
        yield seen
    finally:
        fused.base_ntt = orig


def check_c_calls(torch, tag, seen) -> int:
    """Each recorded pass, kernel against plain version on its own inputs
    and all its columns (so in the path's block layout) into zeroed
    outputs (the zeros show the rows a truncating pass must not write)."""
    from dataclasses import replace

    from halo2_tpu_torch.ntt.fused import (_log_cols, base_ntt,
                                           base_ntt_plain, sm_count)
    err, t0, done = 0, time.time(), []
    for key, (F, p) in sorted(seen.items(), key=lambda kv: str(kv[0])):
        m = 1 << p.log_m
        hi = sum((d[0] - 1) * d[3] for d in p.dims) + (m - 1) * p.j[2] + 1
        src = p.src.to(p.powers.device)
        outs = [torch.zeros(hi, 8, dtype=torch.int32, device=src.device)
                for _ in range(2)]
        got = base_ntt(F, replace(p, src=src, dst=outs[0]))
        want = base_ntt_plain(F, replace(p, src=src, dst=outs[1]),
                              chunk=1 << 19)
        flags = "+".join(key[-1]) or "plain"
        per_block = 1 << _log_cols(p.log_m, p.cols, sm_count(src.device.index))
        err = max(err, expect_equal(
            torch, f"{tag}: kernel C 2^{p.log_m} {F.name} {flags} "
            f"{p.cols} columns", got, want))
        done.append(f"{F.name} 2^{p.log_m} {flags} {p.cols} cols "
                    f"{per_block}/block")
        del src, outs, got, want
    log(f"[{tag}] kernel C equal to plain, every column, on the first pass "
        f"of each of {len(seen)} shapes ({time.time() - t0:.1f} s): "
        + "; ".join(done))
    return err


def check_ntt(torch, dev, F, log_ns, seed: int, bound, tag: str):
    """Kernel C inside transforms of 2^log_n for each log_n: every pass of
    a forward and of the coset pair of a domain extended to 2^log_n held
    against its plain version, inverse(forward(x)) == x; forward, inverse
    and the coset pair equal to the CPU path at 2^11 and 2^12; one plain
    pass of 2^l1 points on 2^l1 columns timed (l1: the first split's
    base), its device time and the whole forward at the last log_n."""
    from halo2_tpu_torch.ntt import get_ntt
    from halo2_tpu_torch.ntt.fused import (base_ntt, base_ntt_plain,
                                           column_pass)
    from halo2_tpu_torch.poly import EvaluationDomain
    from halo2_tpu_torch.tools import card
    err = 0
    for log_n in log_ns:
        ntt = get_ntt(F, log_n, dev)
        dom = EvaluationDomain(F, 5, log_n - 2, dev)
        x = random_elems(torch, F, 1 << log_n, seed + log_n, dev)
        with c_recorder(torch) as seen:
            ntt.forward(x)
            dom.extended_to_coeff(dom.coeff_to_extended(x[: dom.n]))
        err = max(err, check_c_calls(torch, f"ntt 2^{log_n} {F.name}", seen))
        if max_err(torch, ntt.inverse(ntt.forward(x)), x) != 0:
            raise AssertionError(f"ntt 2^{log_n}: inverse(forward(x)) != x")
    for log_n in (11, 12):
        a = random_elems(torch, F, 2 << log_n, seed, dev).reshape(
            2, 1 << log_n, 8)
        gpu, cpu = get_ntt(F, log_n, dev), get_ntt(F, log_n, "cpu")
        dg = EvaluationDomain(F, 5, log_n - 2, dev)
        dc = EvaluationDomain(F, 5, log_n - 2, "cpu")
        for what, got, want in (
                ("forward", lambda: gpu.forward(a), lambda: cpu.forward(
                    a.cpu())),
                ("inverse", lambda: gpu.inverse(a), lambda: cpu.inverse(
                    a.cpu())),
                ("coset forward", lambda: dg.coeff_to_extended(a[:, :dg.n]),
                 lambda: dc.coeff_to_extended(a[:, :dc.n].cpu())),
                ("coset inverse", lambda: dg.extended_to_coeff(a),
                 lambda: dc.extended_to_coeff(a.cpu()))):
            err = max(err, expect_equal(
                torch, f"ntt 2^{log_n} {what} GPU vs CPU {F.name}",
                got().cpu(), want()))
    lm = get_ntt(F, log_ns[-1], dev)._plan[log_ns[-1]][1]
    ntt = get_ntt(F, 2 * lm, dev)
    xb = random_elems(torch, F, 1 << (2 * lm), seed, dev).reshape(
        1, 1 << lm, 1 << lm, 8)
    spec = column_pass(ntt, xb, lm, False)
    ms = card.cuda_ms(lambda: base_ntt(F, spec), 10)
    dev_ms = card.device_ms(lambda: base_ntt(F, spec), 10)
    plain = card.timed(lambda: base_ntt_plain(F, spec))[1]
    b_ = ntt_bound(bound, F, tag, lm, 1 << lm)
    b_["device_ms"] = dev_ms
    ntt = get_ntt(F, log_ns[-1], dev)
    x = random_elems(torch, F, 1 << log_ns[-1], seed, dev)
    full = card.cuda_ms(lambda: ntt.forward(x), 3)
    log(f"[kernel C] {F.name} passes of 2^{log_ns} transforms and their "
        f"coset pairs equal to plain; 2^11, 2^12 GPU == CPU; pass 2^{lm} x "
        f"2^{lm} {ms:.4f} ms (device {dev_ms:.4f}) vs plain {plain:.1f} ms; "
        f"bound {b_['bound_ms']:.4f} ms ({b_['bound_by']}, "
        f"{c_per_product(bound, tag):.1f} multiplies a product; "
        f"{b_['least_bound_ms']:.4f} ms at the least "
        f"{card.least_multiplies(F)}); "
        f"whole "
        f"forward 2^{log_ns[-1]} {full:.3f} ms")
    return err, ms, plain, b_


STREAM_CASES = ("random", "16-bit", "zeros", "all-equal", "one-bucket")


def stream_scalars(torch, Fr, n: int, seed: int, dev, kind: str):
    """n scalars of one kind: random; below 2^16 (three nonzero windows);
    zeros; all equal; all 1 (one bucket of window 0 holds every element);
    p - 1; sparse (0, 1 or 2)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return random_elems(torch, Fr, n, seed, dev)
    if kind == "16-bit":
        return Fr.encode_ints([int(v) for v in rng.integers(
            0, 1 << 16, size=n)], dev)
    if kind == "zeros":
        return Fr.zeros((n,), dev)
    if kind == "all-equal":
        return random_elems(torch, Fr, 8, seed, dev)[3:4].expand(
            n, 8).contiguous()
    if kind == "one-bucket":
        return Fr.encode_ints([1] * n, dev)
    if kind == "p-1":
        return Fr.encode_ints([Fr.p - 1] * n, dev)
    return Fr.encode_ints([int(v) for v in rng.integers(0, 3, size=n)], dev)


def stream_split(G, keys, per_window: bool):
    """(nkeys, pieces, slots) of a stream pass over keys."""
    from halo2_tpu_torch.msm import stream_msm as sm
    nkeys = sm.n_keys(keys, per_window)
    pieces = sm.pieces_for(G, keys.numel(), nkeys, keys.device)
    return nkeys, pieces, sm.slots_for(pieces, nkeys)


def accumulate(G, order, table, info, per_window, nkeys, slots):
    """Kernel 8 (per_window) or kernel D."""
    from halo2_tpu_torch.msm import stream_msm as sm
    if per_window:
        return sm.stream_bucket_windows(G, order, table, info, nkeys, slots)
    return sm.stream_bucket(G, order, table, info, slots)


def check_order(torch, keys, per_window: bool, pieces: int, order, info,
                what: str):
    """The ordering pass's (order, info) on keys against its plain version
    (the order up to T): returns (error, the plain version's time in ms)."""
    from halo2_tpu_torch.msm import stream_msm as sm
    from halo2_tpu_torch.tools import card
    (p_order, p_info), ms = card.timed(
        lambda: sm.msm_order_plain(keys, per_window, pieces))
    total = int(info[0])
    return max(expect_equal(torch, f"{what}: ordering pass info", info,
                            p_info),
               expect_equal(torch, f"{what}: ordered list", order[:total],
                            p_order[:total])), ms


def check_pass(torch, G, keys, table, per_window: bool, what: str):
    """The ordering pass and kernel D or 8 on keys against their plain
    versions (the accumulate pass on the kernel's order): returns (ordering
    error, accumulate error, T, the two plain versions' times in ms)."""
    from halo2_tpu_torch.msm import stream_msm as sm
    from halo2_tpu_torch.tools import card
    nkeys, pieces, slots = stream_split(G, keys, per_window)
    order, info = sm.msm_order(keys, per_window, pieces)
    err_o, order_plain = check_order(torch, keys, per_window, pieces, order,
                                     info, what)
    total = int(info[0])
    got = accumulate(G, order, table, info, per_window, nkeys, slots)
    want, acc_plain = card.timed(lambda: sm.accumulate_plain(
        G, order, table, info, nkeys, slots))
    err_a = expect_equal(torch, f"{what}: partial sums", got, want)
    return err_o, err_a, total, order_plain, acc_plain


def check_stream(torch, dev, G, n: int, seed: int):
    """The ordering pass and kernels D and 8 at n bases against their
    plain versions on random and adversarial scalar sets; both MSMs equal
    naive_msm.  Returns (ordering error, D error, 8 error)."""
    from halo2_tpu_torch.msm import naive_msm
    from halo2_tpu_torch.msm import stream_msm as sm
    Fr = G.Fr
    bases = G.generator_mul(random_elems(torch, Fr, n, seed, dev))
    bases[5] = G.identity((), dev)
    desc = sm.StreamMSM(G, bases)
    unbaked = sm.pack_base_stream_table(G, bases)
    cases = STREAM_CASES + ("p-1", "sparse")
    err = [0, 0, 0]
    for case in cases:
        s = stream_scalars(torch, Fr, n, seed + 2, dev, case)
        keys = sm.stream_keys(G, s)
        for per_window, table in ((False, desc.table), (True, unbaked)):
            eo, ea = check_pass(torch, G, keys, table, per_window,
                                f"{G.name} {case} per_window={per_window}")[:2]
            err[0] = max(err[0], eo)
            err[2 if per_window else 1] = max(err[2 if per_window else 1], ea)
        want = G.to_affine_ints(naive_msm(G, s, bases)[None])
        if G.to_affine_ints(desc(s)[None]) != want:
            raise AssertionError(f"baked MSM {G.name} ({case}) != naive")
        if G.to_affine_ints(sm.msm_stream_unbaked(G, s, unbaked)[None]) \
                != want:
            raise AssertionError(f"unbaked MSM {G.name} ({case}) != naive")
    log(f"[ordering pass, kernels D, 8] {G.name} at n=2^{n.bit_length() - 1}"
        f": equal to plain, MSMs == naive_msm for {', '.join(cases)}")
    return err


def check_kernels(torch, dev, bound) -> dict:
    from halo2_tpu_torch.curves import BN254_G1 as G1
    from halo2_tpu_torch.fields import BN254_FQ, BN254_FR as Fr
    results = {}
    err_q = check_field(torch, dev, BN254_FQ, 1 << 21, 2, bound, "Bn254Fq")[0]
    err, ms, plain, b_ = check_field(torch, dev, Fr, 1 << 21, 1, bound,
                                     "Bn254Fr")
    results["h2_field_binop"] = _entry(
        "field_binop", "field.cu", "fields/pallas_ops.py:138",
        max(err, err_q), ms=ms, plain_ms=plain, **b_)
    for op, (line, err, ms, plain, b_) in check_ec(
            torch, dev, G1, 1 << 16, 5, bound, "Bn254G1").items():
        results[f"h2_ec_{op}"] = _entry(
            f"ec_{op}", "ec.cu", f"curves/pallas_ec.py:{line}", err,
            ms=ms, plain_ms=plain, **b_)
    err, ms, plain, b_ = check_ntt(torch, dev, Fr, (K_MAIN, K_MAIN + 2), 7,
                                   bound, "Bn254Fr")
    results["h2_ntt_base"] = _entry("ntt_base", "ntt.cu", "ntt/fused.py:119",
                                    err, ms=ms, plain_ms=plain, **b_)
    err_o, err_d, err_8 = check_stream(torch, dev, G1, 1 << 12, 12)
    results["h2_msm_order"] = _entry("msm_order", "msm.cu", None, err_o,
                                     part_of="rows 7-8 (kernels D and 8)")
    results["h2_stream_bucket"] = _entry(
        "stream_bucket", "msm.cu", "msm/stream_msm.py:198", err_d)
    results["h2_stream_bucket_windows"] = _entry(
        "stream_bucket_windows", "msm.cu", "msm/stream_msm.py:356", err_8)
    return results


def check_pasta(torch, dev, bound, results: dict):
    """The Pasta instances of kernels A-D (and 8) against their plain
    versions; their times go to each kernel's "instances"."""
    from halo2_tpu_torch.curves import PALLAS, VESTA
    from halo2_tpu_torch.fields import PASTA_FP, PASTA_FQ
    for F, tag, seed in ((PASTA_FP, "PastaFp", 31), (PASTA_FQ, "PastaFq", 33)):
        err, ms, plain, b_ = check_field(torch, dev, F, 1 << 21, seed, bound,
                                         tag)
        r = results["h2_field_binop"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r.setdefault("instances", {})[F.name] = dict(ms=ms, plain_ms=plain,
                                                     **b_)
        err, ms, plain, b_ = check_ntt(torch, dev, F, (14, 16), seed, bound,
                                       tag)
        r = results["h2_ntt_base"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r.setdefault("instances", {})[F.name] = dict(ms=ms, plain_ms=plain,
                                                     **b_)
    for G, tag, seed in ((PALLAS, "Pallas", 35), (VESTA, "Vesta", 37)):
        for op, (line, err, ms, plain, b_) in check_ec(
                torch, dev, G, 1 << 16, seed, bound, tag).items():
            r = results[f"h2_ec_{op}"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r.setdefault("instances", {})[G.name] = dict(ms=ms, plain_ms=plain,
                                                         **b_)
        errs = check_stream(torch, dev, G, 1 << 12, seed)
        for name, err in zip(("h2_msm_order", "h2_stream_bucket",
                              "h2_stream_bucket_windows"), errs):
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               err)


def _stream_of_scan(torch, G, n: int, seed: int, dev, kind: str):
    """A sorted (keys, affine rows) stream of n elements: random buckets,
    or one bucket owning every element; identity points and a tail of
    SENTINEL_KEY padding."""
    from halo2_tpu_torch.msm import bucket_scan as bs
    pts = G.generator_mul(random_elems(torch, G.Fr, n, seed, dev))
    pts[3::11] = G.identity((1,), dev)
    rows = bs.pack_affine_rows(G.batch_normalize(pts), G.is_identity(pts))
    g = torch.Generator(device="cpu").manual_seed(seed)
    if kind == "one-bucket":
        keys = torch.full((n,), 2 * 7 + 1, dtype=torch.int32)
    else:
        keys = torch.sort(torch.randint(0, 2 * 50, (n,), generator=g,
                                        dtype=torch.int64))[0].to(torch.int32)
    keys[-96:] = bs.SENTINEL_KEY
    return keys.to(dev), rows, pts


def check_scan_call(torch, args, want, what: str) -> int:
    """One kernel-9 call against the plain version's (finals, lane
    keys)."""
    from halo2_tpu_torch.msm import bucket_scan as bs
    finals, lane_keys = bs.scan_level(*args)
    err = expect_equal(torch, what, finals, want[0])
    if not torch.equal(lane_keys, want[1]):
        raise AssertionError(f"{what}: lane keys differ")
    return err


def check_kernel_9(torch, dev) -> dict:
    """Kernel 9 on sorted streams, every curve and mode: one bucket owning
    every element in lanes of 64, random runs in lanes of 8 (the IPA
    path's checks add its own blocks), identity points, sentinel padding;
    affine rows with packed signed keys, plain affine rows, projective
    points."""
    from halo2_tpu_torch.curves import BN254_G1, PALLAS, VESTA
    from halo2_tpu_torch.msm import bucket_scan as bs
    err = 0
    for G in (BN254_G1, PALLAS, VESTA):
        for kind, block in (("one-bucket", 64), ("random", 8)):
            keys, rows, pts = _stream_of_scan(torch, G, 1 << 14, 41, dev, kind)
            for mode, data, k in ((bs.PACKED, rows, keys),
                                  (bs.AFFINE, rows, keys >> 1),
                                  (bs.PROJECTIVE, pts, keys >> 1)):
                args = (G, k, data, block, mode)
                err = max(err, check_scan_call(
                    torch, args, bs.scan_level_plain(*args),
                    f"scan {G.name} {kind} mode {mode} block {block}"))
    log("[kernel 9] scan levels equal to plain for BN254 / Pallas / Vesta, "
        "packed / affine / projective, one bucket in lanes of 64 and random "
        "runs in lanes of 8")
    return {"h2_scan_level": _entry("scan_level", "scan.cu",
                                    "msm/bucket_scan.py:221", err)}


# ----------------------------------------------------------------------
# kernel B's chains
# ----------------------------------------------------------------------

def chain_bound(bound, nbytes: float, total: float, critical: float) -> dict:
    """A chain's bound: the larger of bytes over the HBM rate, all its
    multiplier instructions at the guide's rate, and its critical path, the
    multiplier instructions of its longest thread, one issued per clock at
    most (each step of a chain needs the one before)."""
    b_ = bound(nbytes, total)
    crit = critical / (bound.clock_mhz * 1e3)
    if crit > b_["bound_ms"]:
        b_.update(bound_ms=crit, bound_by="operations")
    b_["critical_path_ms"] = crit
    return b_


def b_step_multiplies(bound, tag: str) -> tuple:
    """SASS multiplier instructions of one complete add and one doubling
    (kernel B's elementwise functions) on the curve `tag`."""
    return (bound.per_elem("k_ec_addI", tag),
            bound.per_elem("k_ec_doubleI", tag))


def check_scalar_mul(torch, dev, G, n: int, seed: int, bound, tag: str,
                     one: bool) -> list:
    """The scalar-mul chain at n points against scalar_mul_plain, with one
    scalar for all (one) or per-lane scalars (0, 1 and p - 1 first); with
    one scalar, also the batch's last point alone (the fold's last round),
    against the same plain run.  Returns [(points, error, ms, plain ms,
    bound)] per batch."""
    from halo2_tpu_torch.curves import cuda_ec
    from halo2_tpu_torch.tools import card
    P = G.double(G.generator_mul(random_elems(torch, G.Fr, n, seed, dev)))
    P[7] = G.identity((), dev)
    k = random_elems(torch, G.Fr, n, seed + 1, dev)
    k = k[5] if one else k
    want, plain = card.timed(lambda: cuda_ec.scalar_mul_plain(G, P, k))
    add, dbl = b_step_multiplies(bound, tag)
    ks = G.Fr.decode_ints(k.reshape(-1, 8))
    per = [add * bin(s).count("1") + dbl * max(s.bit_length() - 1, 0)
           for s in ks]
    out = []
    for m in (n, 1) if one else (n,):
        Pm, wm = P[n - m:], want[n - m:]
        what = (f"scalar mul {G.name} n={m} "
                f"{'one scalar' if one else 'per lane'}")
        err = expect_equal(torch, what, G.scalar_mul(Pm, k), wm)
        ms = card.cuda_ms(lambda: G.scalar_mul(Pm, k), 5)
        total = sum(per) * (m if one else 1)
        b_ = chain_bound(bound, 2 * 96 * m + 32 * len(ks), total, max(per))
        log(f"[kernel B chain] {what}: equal; {ms:.3f} ms vs plain "
            f"{plain:.1f} ms (at n={n}); bound {b_['bound_ms']:.4f} ms "
            f"({b_['bound_by']}; critical path {b_['critical_path_ms']:.4f} "
            f"ms)")
        out.append((m, err, ms, plain, b_))
    return out


def check_horner(torch, dev, G, nw: int, c: int, seed: int, bound, tag: str):
    """The Horner chain on nw per-window sums (general Z, the top one the
    identity) against horner_windows_plain on the same words, run on the
    CPU, where one sum takes the plain version's python-int side; returns
    (error, ms, plain ms on the CPU, bound)."""
    from halo2_tpu_torch.msm import bucket_scan as bs
    from halo2_tpu_torch.tools import card
    S = G.double(G.generator_mul(random_elems(torch, G.Fr, nw, seed, dev)))
    S[-1] = G.identity((), dev)
    t0 = time.perf_counter()
    want = bs.horner_windows_plain(G, S.cpu(), c)
    plain = (time.perf_counter() - t0) * 1e3
    what = f"Horner {G.name} nw={nw} c={c}"
    err = expect_equal(torch, what, bs.horner_windows(G, S, c).cpu(), want)
    ms = card.cuda_ms(lambda: bs.horner_windows(G, S, c), 10)
    add, dbl = b_step_multiplies(bound, tag)
    steps = nw * (c * dbl + add)
    b_ = chain_bound(bound, 96 * (nw + 1), steps, steps)
    log(f"[kernel B chain] {what}: equal; {ms:.3f} ms vs plain {plain:.1f} "
        f"ms on the CPU; bound {b_['bound_ms']:.4f} ms ({b_['bound_by']})")
    return err, ms, plain, b_


def check_chains(torch, dev, bound) -> dict:
    """Kernel B's two chains at the main paths' shapes: the IPA fold's
    scalar mul (8,192 Vesta points, one scalar; and its last round, one
    point), per-lane BN254 scalars with 0, 1 and p - 1; Horner at the k=20
    unbaked MSM's 43 windows of 6 bits (BN254) and the IPA opening's 33 of
    8 and 65 of 4 (Vesta)."""
    from halo2_tpu_torch.curves import BN254_G1, VESTA
    from halo2_tpu_torch.msm import stream_msm as sm
    from halo2_tpu_torch.msm.bucket_scan import n_windows_for
    (n, err, ms, plain, b_), one_point = check_scalar_mul(
        torch, dev, VESTA, 1 << 13, 51, bound, "Vesta", True)
    sm_entry = _entry("ec_scalar_mul", "ec.cu", None, err,
                      part_of="rows 3-5 (kernel B)",
                      loop_of=f"{REFERENCE}/curves/curve.py:218",
                      points=n, ms=ms, plain_ms=plain, **b_)
    [per_lane] = check_scalar_mul(torch, dev, BN254_G1, 1 << 10, 53, bound,
                                  "Bn254G1", False)
    inst = {}
    for label, (n, err, ms, plain, b_) in (("Vesta, one scalar, 1 point",
                                            one_point),
                                           ("BN254, per lane", per_lane)):
        sm_entry["max_abs_err"] = max(sm_entry["max_abs_err"], err)
        inst[label] = dict(points=n, ms=ms, plain_ms=plain, **b_)
    sm_entry["instances"] = inst
    shapes = [(BN254_G1, "Bn254G1", n_windows_for(BN254_G1.Fr, sm.STREAM_C),
               sm.STREAM_C)] + [(VESTA, "Vesta", n_windows_for(VESTA.Fr, c), c)
                                for c in (8, 4)]
    h_entry, inst = None, {}
    for G, tag, nw, c in shapes:
        err, ms, plain, b_ = check_horner(torch, dev, G, nw, c, 55, bound, tag)
        r = dict(nw=nw, c=c, ms=ms, plain_ms=plain, **b_)
        if h_entry is None:
            h_entry = _entry("ec_horner", "ec.cu", None, err,
                             part_of="rows 3-5 (kernel B)",
                             loop_of=f"{REFERENCE}/msm/bucket_scan.py:601",
                             **r)
        else:
            h_entry["max_abs_err"] = max(h_entry["max_abs_err"], err)
            inst[f"{G.name} nw={nw} c={c}"] = r
    h_entry["instances"] = inst
    return {"h2_ec_scalar_mul": sm_entry, "h2_ec_horner": h_entry}


# ----------------------------------------------------------------------
# CPU == GPU proofs
# ----------------------------------------------------------------------

def compare_kzg_cpu_gpu(torch, dev):
    from halo2_tpu_torch.api import create_proof, keygen, verify
    from halo2_tpu_torch.commit import (ParamsKZG, ProverSHPLONK,
                                        SingleStrategyKZG, VerifierSHPLONK)
    from halo2_tpu_torch.compat import plonk_api
    from halo2_tpu_torch.fields import BN254_FR as F
    circuit, inst = plonk_api.plonk_api_instance(F)
    proofs = {}
    for where in ("cpu", dev):
        t0 = time.time()
        params = ParamsKZG.new(K_CMP, device=where)
        pk = keygen(F, params, K_CMP, circuit)
        proof = create_proof(params, pk, [circuit], [inst], random.Random(1),
                             multiopen_prover_cls=ProverSHPLONK)
        if not verify(params, pk.vk, proof, [inst],
                      multiopen_verifier_cls=VerifierSHPLONK,
                      strategy_cls=SingleStrategyKZG):
            raise AssertionError(f"KZG k={K_CMP} proof on {where} failed")
        proofs[str(where)] = proof
        log(f"[KZG k={K_CMP}] {where}: keygen+prove+verify "
            f"{time.time() - t0:.2f} s, {len(proof)} proof bytes")
    if proofs["cpu"] != proofs[str(dev)]:
        raise AssertionError("KZG CPU-plain and GPU-kernel proofs differ")
    log(f"[KZG k={K_CMP}] CPU-plain and GPU-kernel proof bytes are equal")


@contextlib.contextmanager
def own_params_cache():
    """A new, empty IPA params cache inside the run's own for the block, so
    that ParamsIPA.new makes its params there instead of reading a file
    that an earlier phase or the other side of a comparison wrote."""
    root = os.environ["HALO2_TPU_CACHE"]
    os.environ["HALO2_TPU_CACHE"] = tempfile.mkdtemp(dir=root)
    try:
        yield
    finally:
        os.environ["HALO2_TPU_CACHE"] = root


def compare_ipa_cpu_gpu(torch, dev):
    """IPA params, keygen, prove and verify on the CPU's plain versions
    and on the card's kernels, each side with params it made itself: the
    proof bytes must be equal."""
    from halo2_tpu_torch.api import create_proof, keygen, verify
    from halo2_tpu_torch.commit import ParamsIPA
    from halo2_tpu_torch.compat import plonk_api
    from halo2_tpu_torch.curves import VESTA
    from halo2_tpu_torch.fields import PASTA_FP as F
    circuit, inst = plonk_api.plonk_api_instance(F)
    proofs = {}
    for where in ("cpu", dev):
        t0 = time.time()
        with own_params_cache():
            params = ParamsIPA.new(VESTA, K_IPA_CMP, device=where)
        pk = keygen(F, params, K_IPA_CMP, circuit)
        proof = create_proof(params, pk, [circuit], [inst], random.Random(1))
        if not verify(params, pk.vk, proof, [inst]):
            raise AssertionError(f"IPA k={K_IPA_CMP} proof on {where} failed")
        proofs[str(where)] = proof
        log(f"[IPA k={K_IPA_CMP}] {where}: params+keygen+prove+verify "
            f"{time.time() - t0:.2f} s, {len(proof)} proof bytes")
    if proofs["cpu"] != proofs[str(dev)]:
        raise AssertionError("IPA CPU-plain and GPU-kernel proofs differ")
    log(f"[IPA k={K_IPA_CMP}] CPU-plain and GPU-kernel proof bytes are equal")


def config_instance(name: str, k: int):
    """(circuit, keygen circuit, bad-witness circuit) of a CONFIG_PATHS
    circuit at every usable row of 2^k: the shuffle's bad witness is no
    permutation, the two-phase circuit's has one phase-2 cell off by one."""
    from halo2_tpu_torch.compat import shuffle_api
    return getattr(shuffle_api, f"{name}_instance")(k)


def compare_config_cpu_gpu(torch, dev):
    """The CONFIG_PATHS circuits at K_CMP under GWC + Keccak256 through
    ProofConfig: CPU-plain and GPU-kernel proof bytes must be equal."""
    for name in CONFIG_PATHS:
        circuit, kg_circuit, _ = config_instance(name, K_CMP)
        proofs = {}
        for where in ("cpu", dev):
            t0 = time.time()
            cfg = _config(where, K_CMP, scheme="kzg-gwc",
                          transcript="keccak256")
            params = cfg.params()
            pk = cfg.keygen(kg_circuit, params=params)
            proof = cfg.prove(pk, [circuit], [[]], random.Random(1),
                              params=params)
            if not cfg.verify(pk.vk, proof, [[]], params=params):
                raise AssertionError(f"{name} k={K_CMP} proof on {where} "
                                     f"failed")
            proofs[str(where)] = proof
            log(f"[{name} k={K_CMP} GWC+Keccak256] {where}: params+keygen+"
                f"prove+verify {time.time() - t0:.2f} s, {len(proof)} proof "
                f"bytes")
        if proofs["cpu"] != proofs[str(dev)]:
            raise AssertionError(f"{name}: CPU-plain and GPU-kernel proofs "
                                 f"differ")
        log(f"[{name} k={K_CMP} GWC+Keccak256] CPU-plain and GPU-kernel "
            f"proof bytes are equal")


# ----------------------------------------------------------------------
# the main paths
# ----------------------------------------------------------------------

def prove_verify(torch, tag, cfg, params, pk, circuit, inst, n_steady,
                 bad_circuit=None):
    """Through ProofConfig `cfg` on `params`: a first and n_steady steady
    proves with their step tables, verify, a tampered proof that must be
    rejected and, where given, a proof of a bad witness that must be
    rejected too.  Returns the first proof (random.Random(1))."""
    steady = []
    for seed, run in enumerate(["first"] + ["steady"] * n_steady, start=1):
        timings = {}
        t0 = time.time()
        proof = cfg.prove(pk, [circuit], [inst], random.Random(seed),
                          params=params, timings=timings)
        torch.cuda.synchronize()
        wall = time.time() - t0
        if run == "steady":
            steady.append(wall)
        else:
            first = proof
        steps = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        log(f"[{tag}] prove ({run}) {wall:.3f} s; steps: {steps}")
    log(f"[{tag}] steady prove over {n_steady} runs: median "
        f"{sorted(steady)[n_steady // 2]:.3f} s, min {min(steady):.3f} s, "
        f"max {max(steady):.3f} s")
    t0 = time.time()
    ok = cfg.verify(pk.vk, proof, [inst], params=params)
    t_verify = time.time() - t0
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    rejected = not cfg.verify(pk.vk, bytes(bad), [inst], params=params)
    log(f"[{tag}] verify {ok} in {t_verify:.3f} s; tampered proof rejected "
        f"{rejected}; {len(proof)} proof bytes")
    if not ok or not rejected:
        raise AssertionError(f"{tag}: verification failed")
    if bad_circuit is not None:
        bad = cfg.prove(pk, [bad_circuit], [inst], random.Random(99),
                        params=params)
        if cfg.verify(pk.vk, bad, [inst], params=params):
            raise AssertionError(f"{tag}: a bad witness's proof verified")
        log(f"[{tag}] the proof of a bad witness is rejected")
    return first


def run_path(torch, tag, counts, need, body):
    """Run one main path with the launch counts set to 0 just before and
    read just after; every kernel in `need` must have launched.  Kernel
    B's launches are also counted by caller (a walk up the Python stack
    at each of them)."""
    from halo2_tpu_torch import _build
    from halo2_tpu_torch.msm import stream_msm as sm
    from halo2_tpu_torch.tools import ec_census
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    sm.reset_stream_counters()
    with ec_census.caller_census() as by_caller, c_recorder(torch) as seen:
        out = body()
    torch.cuda.synchronize()
    c = _build.launch_counts()
    counts[tag] = c
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] peak device memory {peak / 2**30:.2f} GiB; launches {c}")
    for line in ec_census.census_lines(by_caller):
        log(f"[{tag}] kernel B launches by caller: {line}")
    sc = sm.stream_counters()
    log(f"[{tag}] fixed-base MSM elements: streamed {sc['streamed']}, added "
        f"{sc['added']} (nonzero share "
        f"{sc['added'] / max(1, sc['streamed']):.4f})")
    idle = [k for k in need if c.get(k, 0) <= 0]
    if idle:
        raise AssertionError(f"{tag}: kernels not launched: {idle}")
    if seen:
        check_c_calls(torch, tag, seen)
    return out


def _config(dev, k: int, **kw):
    """The path's ProofConfig; by default KZG / SHPLONK / Blake2b."""
    from halo2_tpu_torch.config import ProofConfig
    return ProofConfig(k=k, device=str(dev), **kw)


def run_kzg_plonk_api(torch, dev, counts):
    from halo2_tpu_torch.api import keygen
    from halo2_tpu_torch.commit import ParamsKZG
    from halo2_tpu_torch.compat import plonk_api
    from halo2_tpu_torch.fields import BN254_FR as F
    tag = f"KZG plonk_api k={K_MAIN}"
    circuit, inst = plonk_api.plonk_api_instance(F)

    def body():
        t0 = time.time()
        params = ParamsKZG.new(K_MAIN, device=dev)
        torch.cuda.synchronize()
        t_params = time.time() - t0
        t0 = time.time()
        pk = keygen(F, params, K_MAIN, circuit)
        torch.cuda.synchronize()
        log(f"[{tag}] ParamsKZG.new {t_params:.2f} s, keygen "
            f"{time.time() - t0:.2f} s")
        return params, pk, prove_verify(torch, tag, cfg, params, pk,
                                        circuit, inst, N_STEADY)

    cfg = _config(dev, K_MAIN)
    params, pk, proof = run_path(torch, tag, counts, (
        "h2_field_binop", "h2_ec_add", "h2_ec_madd", "h2_ec_double",
        "h2_ntt_base", "h2_msm_order", "h2_stream_bucket"), body)
    profile_prove(torch, tag, cfg, params, pk, circuit, inst)
    return (params, pk, circuit, inst), proof


def run_lookup_heavy(torch, dev, counts):
    from halo2_tpu_torch.api import keygen
    from halo2_tpu_torch.commit import ParamsKZG
    from halo2_tpu_torch.compat.lookup_heavy import lookup_heavy_instance
    from halo2_tpu_torch.fields import BN254_FR as F
    tag = f"KZG lookup_heavy k={K_LOOKUP}"
    t0 = time.time()
    circuit, inst, kg_circuit = lookup_heavy_instance(F, K_LOOKUP)
    log(f"[{tag}] witness generation {time.time() - t0:.2f} s")

    def body():
        t0 = time.time()
        params = ParamsKZG.new(K_LOOKUP, device=dev)
        torch.cuda.synchronize()
        t_params = time.time() - t0
        t0 = time.time()
        pk = keygen(F, params, K_LOOKUP, kg_circuit)
        torch.cuda.synchronize()
        log(f"[{tag}] ParamsKZG.new {t_params:.2f} s, keygen "
            f"{time.time() - t0:.2f} s; "
            f"{len(pk.vk.cs.cs.lookups)} lookups")
        prove_verify(torch, tag, _config(dev, K_LOOKUP), params, pk,
                     circuit, inst, N_STEADY_BIG)
        return params, pk

    params, pk = run_path(torch, tag, counts, (
        "h2_field_binop", "h2_ec_add", "h2_ec_madd", "h2_ec_double",
        "h2_ntt_base", "h2_msm_order", "h2_stream_bucket_windows",
        "h2_ec_horner"), body)
    return params, pk, circuit, inst


def run_ipa(torch, dev, counts):
    from halo2_tpu_torch.api import keygen
    from halo2_tpu_torch.commit import ParamsIPA
    from halo2_tpu_torch.compat import plonk_api
    from halo2_tpu_torch.curves import VESTA
    from halo2_tpu_torch.fields import PASTA_FP as F
    tag = f"IPA plonk_api k={K_IPA}"
    circuit, inst = plonk_api.plonk_api_instance(F)

    def body():
        t0 = time.time()
        params = ParamsIPA.new(VESTA, K_IPA, device=dev)
        torch.cuda.synchronize()
        t_params = time.time() - t0
        t0 = time.time()
        pk = keygen(F, params, K_IPA, circuit)
        torch.cuda.synchronize()
        log(f"[{tag}] ParamsIPA.new {t_params:.2f} s (host hash-to-curve "
            f"and point NTT, an empty params cache), keygen "
            f"{time.time() - t0:.2f} s")
        return params, pk, prove_verify(torch, tag, cfg, params, pk, circuit,
                                        inst, N_STEADY_BIG), t_params

    cfg = _config(dev, K_IPA, curve="vesta", scheme="ipa")
    params, pk, proof, t_params = run_path(torch, tag, counts, (
        "h2_field_binop", "h2_ec_add", "h2_ec_double", "h2_ntt_base",
        "h2_msm_order", "h2_stream_bucket", "h2_scan_level",
        "h2_ec_scalar_mul", "h2_ec_horner"), body)
    profile_prove(torch, tag, cfg, params, pk, circuit, inst)
    return (params, pk, circuit, inst), proof, t_params


def check_ipa_cache(torch, params, t_cold: float):
    """A warm ParamsIPA.new(VESTA, K_IPA): it reads the file the path's
    cold one wrote into the run's empty params cache; both write its
    bytes."""
    from halo2_tpu_torch.commit import ParamsIPA
    from halo2_tpu_torch.commit.ipa import params_cache_path
    from halo2_tpu_torch.curves import VESTA
    path = params_cache_path(VESTA, K_IPA)
    warm, t_warm = timed(torch, lambda: ParamsIPA.new(VESTA, K_IPA,
                                                      device=params.device))
    with open(path, "rb") as f:
        data = f.read()
    if params.write() != data or warm.write() != data:
        raise AssertionError("IPA params cache: cold, warm and file differ")
    log(f"[IPA params cache] {len(data)} bytes; ParamsIPA.new({VESTA.name}, "
        f"{K_IPA}) cold {t_cold:.2f} s, warm {t_warm:.2f} s; the cold "
        f"params, the warm ones and the file have equal bytes")


def run_config_path(torch, params, counts, name):
    """A CONFIG_PATHS circuit at every usable row of 2^K_MAIN through
    ProofConfig on the plonk_api path's params (and so its cached
    fixed-base tables): keygen, a first and steady proves, verify, a
    tampered proof and a bad witness (config_instance) rejected, then one
    profiled prove.  Kernel B's mixed add and doubling run only where
    params are made (`Curve.generator_mul` in ParamsKZG.setup) and where
    their fixed-base tables are baked (`StreamMSM`), both of which the
    path reuses, so they are not among the path's kernels."""
    tag = f"KZG {name} k={K_MAIN}"
    cfg = _config(params.device, K_MAIN, **CONFIG_PATHS[name])
    t0 = time.time()
    circuit, kg_circuit, bad = config_instance(name, K_MAIN)
    log(f"[{tag}] {cfg.scheme} + {cfg.transcript} through ProofConfig; "
        f"witness of {kg_circuit.n_rows} rows in {time.time() - t0:.2f} s")

    def body():
        t0 = time.time()
        pk = cfg.keygen(kg_circuit, params=params)
        torch.cuda.synchronize()
        d = pk.vk.domain
        log(f"[{tag}] keygen {time.time() - t0:.2f} s; extended k "
            f"{d.extended_k}, quotient degree {d.quotient_poly_degree}")
        prove_verify(torch, tag, cfg, params, pk, circuit, [], N_STEADY_BIG,
                     bad)
        return pk

    pk = run_path(torch, tag, counts, (
        "h2_field_binop", "h2_ec_add", "h2_ntt_base", "h2_msm_order",
        "h2_stream_bucket"), body)
    profile_prove(torch, tag, cfg, params, pk, circuit, [])


# ----------------------------------------------------------------------
# the multi-device layer (dist/) on one card
# ----------------------------------------------------------------------

def check_dist_primitives(torch, dev):
    """ShardedNTT (forward, inverse), sharded_prefix_product, sharded_msm
    and ShardedCachedMSM on Mesh([cuda:0] * SHARDS) against their
    one-device twins on the same inputs (transforms and products word for
    word, MSMs as group elements), each timed beside its twin."""
    from halo2_tpu_torch.curves import BN254_G1, VESTA
    from halo2_tpu_torch.dist import (Mesh, ShardedCachedMSM, ShardedNTT,
                                      sharded_msm, sharded_prefix_product)
    from halo2_tpu_torch.fields import BN254_FR, PASTA_FP
    from halo2_tpu_torch.msm import StreamMSM
    from halo2_tpu_torch.msm.bucket_scan import msm_variable
    from halo2_tpu_torch.ntt import get_ntt
    from halo2_tpu_torch.tools import card
    mesh = Mesh([dev] * SHARDS)
    log(f"[dist] {mesh}; the times below count copies on one card and say "
        f"nothing about NVLink")

    def compare(what, sharded, twin, same):
        if not same(sharded(), twin()):
            raise AssertionError(f"dist {what}: sharded and one-device "
                                 f"results differ")
        ms, twin_ms = card.cuda_ms(sharded), card.cuda_ms(twin)
        log(f"[dist] {what}: equal; sharded {ms:.3f} ms, one device "
            f"{twin_ms:.3f} ms ({ms / twin_ms:.2f}x)")

    for F, log_n in ((BN254_FR, 20), (PASTA_FP, 16)):
        a = random_elems(torch, F, 1 << log_n, 40 + log_n, dev)
        dist, single = ShardedNTT(mesh, F, log_n), get_ntt(F, log_n, dev)
        compare(f"NTT forward {F.name} 2^{log_n}", lambda: dist.forward(a),
                lambda: single.forward(a), torch.equal)
        compare(f"NTT inverse {F.name} 2^{log_n}", lambda: dist.inverse(a),
                lambda: single.inverse(a), torch.equal)
    F = BN254_FR
    a = random_elems(torch, F, 1 << 18, 60, dev)
    compare(f"prefix product {F.name} 2^18",
            lambda: sharded_prefix_product(mesh, F, a),
            lambda: F.prefix_product(a), torch.equal)
    for G, log_n, what in ((VESTA, 16, "sharded_msm (kernel 9)"),
                           (BN254_G1, 18, "ShardedCachedMSM (kernel D)")):
        pts = G.generator_mul(random_elems(torch, G.Fr, 1 << log_n, 61, dev))
        s = random_elems(torch, G.Fr, 1 << log_n, 62, dev)
        if G is VESTA:
            sharded = lambda: sharded_msm(mesh, G, s, pts)      # noqa: E731
            twin = lambda: msm_variable(G, s, pts)              # noqa: E731
        else:
            cached, table = ShardedCachedMSM(mesh, G, pts), StreamMSM(G, pts)
            sharded = lambda: cached(s)                         # noqa: E731
            twin = lambda: table(s)                             # noqa: E731
        compare(f"{what} {G.name} 2^{log_n}", sharded, twin,
                lambda p, q: bool(G.eq(p, q)))


def run_mesh_path(torch, dev, params, pk, circuit, inst, first_proof,
                  counts):
    """The k=18 plonk_api path on Mesh([cuda:0] * SHARDS), on its params:
    meshed keygen (the VK must equal the path's), the first proof
    (random.Random(1), the path's first proof byte for byte), one steady
    prove with its step table, verify and a tampered proof rejected, then
    one profiled prove.  The params' engine is restored after."""
    from halo2_tpu_torch import api
    from halo2_tpu_torch.commit import (ProverSHPLONK, SingleStrategyKZG,
                                        VerifierSHPLONK)
    from halo2_tpu_torch.dist import Mesh
    from halo2_tpu_torch.engine import GpuMsmEngine, PlonkEngineConfig
    tag = f"KZG plonk_api k={K_MAIN} on {SHARDS} shards"
    mesh = Mesh([dev] * SHARDS)
    engine = PlonkEngineConfig.set_msm(GpuMsmEngine(mesh=mesh), mesh=mesh)
    F = pk.vk.F

    def verify(mpk, proof):
        return api.verify(params, mpk.vk, proof, [inst],
                          multiopen_verifier_cls=VerifierSHPLONK,
                          strategy_cls=SingleStrategyKZG)

    def body():
        mpk, t = timed(torch, lambda: api.keygen(F, params, K_MAIN, circuit,
                                                 engine=engine))
        if mpk.vk.pinned() != pk.vk.pinned():
            raise AssertionError(f"{tag}: meshed VK differs from the path's")
        log(f"[{tag}] keygen {t:.2f} s; VK equals the path's")
        for seed, run in ((1, "first"), (2, "steady")):
            timings = {}
            proof, t = timed(torch, lambda: api.create_proof(
                params, mpk, [circuit], [inst], random.Random(seed),
                multiopen_prover_cls=ProverSHPLONK, engine=engine,
                timings=timings))
            steps = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
            log(f"[{tag}] prove ({run}) {t:.3f} s; steps: {steps}")
            if run == "first" and proof != first_proof:
                raise AssertionError(f"{tag}: the first proof differs from "
                                     f"the unmeshed path's")
        bad = bytearray(proof)
        bad[len(bad) // 2] ^= 1
        if not verify(mpk, proof) or verify(mpk, bytes(bad)):
            raise AssertionError(f"{tag}: verification failed")
        log(f"[{tag}] the first proof equals the unmeshed path's byte for "
            f"byte; verify True; tampered proof rejected")
        return mpk

    def prove(mpk, circuits, instances, rng, params):
        return api.create_proof(params, mpk, circuits, instances, rng,
                                multiopen_prover_cls=ProverSHPLONK,
                                engine=engine)

    saved = params.engine
    try:
        # the shards' tables are baked anew (doublings); no mixed add runs
        # on the path's params (it runs in ParamsKZG.setup)
        mpk = run_path(torch, tag, counts, (
            "h2_field_binop", "h2_ec_add", "h2_ec_double", "h2_ntt_base",
            "h2_msm_order", "h2_stream_bucket"), body)
        profile_prove(torch, tag, types.SimpleNamespace(prove=prove), params,
                      mpk, circuit, inst)
    finally:
        params.set_engine(saved)


def check_config_mesh(torch, dev):
    """ProofConfig(k=K_CMP, mesh_devices=<visible cards>) proves the bytes
    of the unmeshed ProofConfig; one card more than is visible raises."""
    from halo2_tpu_torch.commit import ParamsKZG
    from halo2_tpu_torch.compat import plonk_api
    cards = torch.cuda.device_count()
    params = ParamsKZG.new(K_CMP, device=dev)
    proofs = []
    for cfg in (_config(dev, K_CMP), _config(dev, K_CMP, mesh_devices=cards)):
        circuit, inst = plonk_api.plonk_api_instance(cfg.F)
        pk = cfg.keygen(circuit, params=params)
        proofs.append(cfg.prove(pk, [circuit], [inst], random.Random(1),
                                params=params))
        if not cfg.verify(pk.vk, proofs[-1], [inst], params=params):
            raise AssertionError(f"ProofConfig mesh_devices={cfg.mesh_devices}"
                                 f": verification failed")
    if proofs[0] != proofs[1]:
        raise AssertionError(f"ProofConfig mesh_devices={cards}: proof bytes "
                             f"differ from the unmeshed ones")
    try:
        _config(dev, K_CMP, mesh_devices=cards + 1).engine()
    except ValueError as e:
        log(f"[ProofConfig] mesh_devices={cards + 1} raises: {e}")
    else:
        raise AssertionError(f"mesh_devices={cards + 1} did not raise")
    log(f"[ProofConfig] k={K_CMP} mesh_devices={cards} proves the unmeshed "
        f"bytes ({len(proofs[0])} bytes)")


def check_multihost(torch, dev):
    """tests/_torch_multihost_child.py in two processes of
    MULTIHOST_SHARDS shards of cuda:0 each over gloo, on the flat and the
    hybrid mesh: the 2^K_MULTIHOST BN254 ShardedNTT must equal the
    one-process transform of the same coefficients word for word."""
    import subprocess
    import tempfile
    from halo2_tpu_torch.fields import BN254_FR as F
    from halo2_tpu_torch.ntt import get_ntt
    child = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                         "_torch_multihost_child.py")
    rng = random.Random(77)
    a = F.encode_ints([rng.randrange(F.p) for _ in range(1 << K_MULTIHOST)],
                      dev)
    want = get_ntt(F, K_MULTIHOST, dev).forward(a).cpu()
    log("[multihost] backend gloo: one card cannot hold two NCCL ranks, so "
        "the chunks of CUDA slabs go through host memory")
    with tempfile.TemporaryDirectory() as tmp:
        for layout in ("flat", "hybrid"):
            out = os.path.join(tmp, f"{layout}.pt")
            init = "file://" + os.path.join(tmp, f"{layout}.rendezvous")
            t0 = time.time()
            procs = [subprocess.Popen(
                [sys.executable, child, str(rank), "2", init,
                 str(K_MULTIHOST), out, layout, str(dev),
                 str(MULTIHOST_SHARDS), "gloo"],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                for rank in range(2)]
            try:
                errs = [p.communicate(timeout=300)[1] for p in procs]
            finally:
                for p in procs:
                    p.kill()
                    p.wait()
            if any(p.returncode for p in procs):
                raise AssertionError(f"multihost {layout}: " + " | ".join(
                    e.decode()[-1500:] for e in errs))
            if not torch.equal(torch.load(out), want):
                raise AssertionError(f"multihost {layout}: the 2-process NTT "
                                     f"differs from the one-process one")
            log(f"[multihost] {layout}: 2 x {MULTIHOST_SHARDS} shards, "
                f"2^{K_MULTIHOST} forward and inverse, equal to one process; "
                f"{time.time() - t0:.2f} s with the processes' start-up")


# ----------------------------------------------------------------------
# serde, middleware, MockProver and batch verification on the paths' keys
# ----------------------------------------------------------------------

PK_TENSORS = ("l0", "l_last", "l_active_row", "fixed_values", "fixed_polys",
              "fixed_cosets")
PERM_TENSORS = ("permutations", "polys", "cosets")


def timed(torch, fn):
    """(fn(), its seconds), the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def check_keys_equal(torch, tag, pk, other):
    """The verifying keys' pinned form and hash, and every tensor of the
    proving keys, equal."""
    if (other.vk.pinned() != pk.vk.pinned()
            or other.vk.transcript_repr != pk.vk.transcript_repr):
        raise AssertionError(f"{tag}: verifying keys differ")
    differ = [n for n in PK_TENSORS
              if not torch.equal(getattr(other, n), getattr(pk, n))]
    differ += [n for n in PERM_TENSORS
               if not torch.equal(getattr(other.permutation, n),
                                  getattr(pk.permutation, n))]
    if differ:
        raise AssertionError(f"{tag}: proving key tensors differ: {differ}")


def check_serde(torch, params, pk, circuit, inst, proof, counts):
    """The k=18 plonk_api path's keys and params written and read back onto
    the card: the VK in every format, the PK in RAW_BYTES and PROCESSED,
    the params in ParamsKZG.write's default RAW_BYTES; a RAW_BYTES PK with
    one element >= p refused; then a prove with the read params and PK
    under the path's first seed, which must give the path's first proof
    byte for byte, and verify."""
    from halo2_tpu_torch.commit import ParamsKZG
    from halo2_tpu_torch.compat import (SerdeFormat, pk_read, pk_write,
                                        vk_read, vk_write)
    from halo2_tpu_torch.fields import BN254_FR as F
    tag = f"serde k={K_MAIN}"
    cfg = _config(params.device, K_MAIN)

    def rate(nbytes, secs):
        return f"{secs:.3f} s ({nbytes / secs / 1e9:.2f} GB/s)"

    def body():
        for fmt in SerdeFormat:
            data, t_w = timed(torch, lambda: vk_write(pk.vk, fmt))
            vk, t_r = timed(torch, lambda: vk_read(F, params, K_MAIN, circuit,
                                                   data, fmt))
            if (vk.pinned() != pk.vk.pinned()
                    or vk.transcript_repr != pk.vk.transcript_repr):
                raise AssertionError(f"{tag}: VK {fmt.name} read back differs")
            log(f"[{tag}] vk {fmt.name}: {len(data)} bytes, write "
                f"{t_w:.4f} s, read {t_r:.3f} s (with the circuit's compile)")
        read = {}
        for fmt in (SerdeFormat.RAW_BYTES, SerdeFormat.PROCESSED):
            data, t_w = timed(torch, lambda: pk_write(pk, fmt))
            back, t_r = timed(torch, lambda: pk_read(F, params, K_MAIN,
                                                     circuit, data, fmt))
            check_keys_equal(torch, f"{tag} pk {fmt.name}", pk, back)
            log(f"[{tag}] pk {fmt.name}: {len(data)} bytes, write "
                f"{rate(len(data), t_w)}, read {rate(len(data), t_r)}")
            read[fmt] = back
            if fmt == SerdeFormat.RAW_BYTES:
                bad = bytearray(data)
                # the top byte of l0's first element: >= p
                bad[len(vk_write(pk.vk, fmt)) + 4 + 31] = 0xFF
                try:
                    pk_read(F, params, K_MAIN, circuit, bytes(bad), fmt)
                except ValueError as e:
                    log(f"[{tag}] pk RAW_BYTES with an element >= p refused: "
                        f"{e}")
                else:
                    raise AssertionError(f"{tag}: an element >= p was read")
                del bad
            del data
        del read[SerdeFormat.RAW_BYTES]
        data, t_w = timed(torch, params.write)
        back, t_r = timed(torch, lambda: ParamsKZG.read(
            data, s_secret=params.s_secret, device=params.device))
        if not (torch.equal(back.g, params.g)
                and torch.equal(back.g_lagrange, params.g_lagrange)
                and (back.g2, back.s_g2) == (params.g2, params.s_g2)):
            raise AssertionError(f"{tag}: params read back differ")
        log(f"[{tag}] params RAW_BYTES: {len(data)} bytes, write "
            f"{rate(len(data), t_w)}, read {rate(len(data), t_r)} (range "
            f"and curve checks of {2 * params.n} points)")
        pk2 = read[SerdeFormat.PROCESSED]
        again, t_p = timed(torch, lambda: cfg.prove(
            pk2, [circuit], [inst], random.Random(1), params=back))
        if again != proof:
            raise AssertionError(f"{tag}: the proof from read keys differs")
        if not cfg.verify(pk2.vk, again, [inst], params=back):
            raise AssertionError(f"{tag}: the proof from read keys failed")
        log(f"[{tag}] prove with the read params and PK {t_p:.3f} s (tables "
            f"baked anew): the path's first proof byte for byte; verifies")

    run_path(torch, tag, counts, (
        "h2_field_binop", "h2_ec_add", "h2_ntt_base", "h2_msm_order",
        "h2_stream_bucket"), body)


def check_middleware(torch, params, pk, circuit, inst, counts):
    """plonk_api at k=18 through the middleware contract: compile ->
    compiled_to_mid -> JSON -> from_json -> keygen on the path's params,
    which must give the path's keys."""
    from halo2_tpu_torch.fields import BN254_FR as F
    from halo2_tpu_torch.frontend import compile_circuit
    from halo2_tpu_torch.middleware import CompiledCircuitMid, compiled_to_mid
    from halo2_tpu_torch.plonk import keygen
    tag = f"middleware k={K_MAIN}"

    def body():
        text, t_j = timed(torch, lambda: compiled_to_mid(compile_circuit(
            F, K_MAIN, circuit)[0]).to_json())
        mid, t_r = timed(torch, lambda: CompiledCircuitMid.from_json(text))
        pk2, t_k = timed(torch, lambda: keygen(
            F, params, mid.to_compiled_circuit(), K_MAIN))
        check_keys_equal(torch, tag, pk, pk2)
        log(f"[{tag}] compile + to_json {t_j:.2f} s ({len(text)} "
            f"characters), from_json {t_r:.2f} s, keygen {t_k:.2f} s: the "
            f"path's keys")

    run_path(torch, tag, counts, (
        "h2_field_binop", "h2_ec_add", "h2_ntt_base", "h2_msm_order",
        "h2_stream_bucket"), body)


def check_mock(torch, dev, counts):
    """The MockProver at k=18 on the card: plonk_api with its instance (no
    failure) and with the instance + 1 (a gate failure: its public input
    enters through the 'Public input' gate), the shuffle circuit's honest
    witness (none) and its non-permutation (a shuffle failure), and the
    two-phase circuit's phase-2 cell off by one at row 0 (a gate failure
    at that row alone)."""
    from halo2_tpu_torch.compat import plonk_api, shuffle_api
    from halo2_tpu_torch.dev import MockProver
    from halo2_tpu_torch.fields import BN254_FR as F
    tag = f"mock k={K_MAIN}"
    circuit, inst = plonk_api.plonk_api_instance(F)
    shuffle, _, no_shuffle = shuffle_api.shuffle_instance(K_MAIN)
    _, _, bad_phase = shuffle_api.phase_instance(K_MAIN)
    cases = [("plonk_api", circuit, inst, []),
             ("plonk_api, instance + 1", circuit,
              [[v + 1 for v in col] for col in inst], ["gate"]),
             ("shuffle", shuffle, [], []),
             ("shuffle, no permutation", no_shuffle, [], ["shuffle"]),
             ("phase, row 0 off by one", bad_phase, [], ["gate"])]

    def body():
        for name, c, i, want in cases:
            t0 = time.time()
            prover = MockProver.run(F, K_MAIN, c, i, device=dev)
            failures = prover.verify()
            wall = time.time() - t0
            kinds = [f.kind for f in failures]
            if kinds != want:
                raise AssertionError(f"{tag} {name}: failures {failures}")
            if name.startswith("phase") and not failures[0].detail.endswith(
                    "at rows [0]"):
                raise AssertionError(f"{tag} {name}: {failures[0].detail}")
            steps = ", ".join(f"{k} {v:.3f}"
                              for k, v in prover.timings.items())
            log(f"[{tag}] {name}: {kinds or 'satisfied'} in {wall:.3f} s; "
                f"steps: {steps}" + (f"; {failures[0].detail}"
                                     if failures else ""))

    run_path(torch, tag, counts, ("h2_field_binop",), body)


def check_batch(torch, params, pk, circuit, inst, counts):
    """The IPA k=14 path's keys: three honest proofs (made before the
    counts are reset) through one BatchVerifier, which must accept them,
    and with one of them tampered, which it must refuse; beside it, the
    three verified one by one."""
    from halo2_tpu_torch.plonk import BatchVerifier
    tag = f"batch IPA k={K_IPA}"
    cfg = _config(params.device, K_IPA, curve="vesta", scheme="ipa")
    proofs = [cfg.prove(pk, [circuit], [inst], random.Random(seed),
                        params=params) for seed in (11, 12, 13)]
    bad = bytearray(proofs[1])
    bad[len(bad) // 2] ^= 1

    def batch(items):
        b = BatchVerifier(random.Random(5))
        for proof in items:
            b.add_proof([inst], proof)
        return b.finalize(params, pk.vk)

    def body():
        singles, t_s = timed(torch, lambda: [
            cfg.verify(pk.vk, p, [inst], params=params) for p in proofs])
        ok, t_b = timed(torch, lambda: batch(proofs))
        refused, t_r = timed(torch, lambda: not batch(
            [proofs[0], bytes(bad), proofs[2]]))
        log(f"[{tag}] three single verifies {t_s:.3f} s ({singles}); "
            f"batch finalize {t_b:.3f} s ({ok}); with one tampered "
            f"{t_r:.3f} s (refused {refused})")
        if not (all(singles) and ok and refused):
            raise AssertionError(f"{tag}: batch verification failed")

    run_path(torch, tag, counts, ("h2_field_binop", "h2_msm_order",
                                  "h2_stream_bucket"), body)


def log_cost_model(kzg_len: int, ipa_len: int):
    """The cost model's proof sizes beside the real proofs' (an estimate,
    printed, not checked)."""
    from halo2_tpu_torch.compat import plonk_api
    from halo2_tpu_torch.dev import CircuitCost
    from halo2_tpu_torch.fields import BN254_FR, PASTA_FP
    kzg = CircuitCost.measure(K_MAIN, plonk_api.plonk_api_instance(
        BN254_FR)[0]).proof_size("kzg-shplonk")
    ipa = CircuitCost.measure(K_IPA, plonk_api.plonk_api_instance(
        PASTA_FP)[0]).proof_size("ipa")
    log(f"[cost model] plonk_api k={K_MAIN} kzg-shplonk: model {kzg} bytes, "
        f"proof {kzg_len}; k={K_IPA} ipa: model {ipa} bytes, proof "
        f"{ipa_len}")


def profile_prove(torch, tag, cfg, params, pk, circuit, inst):
    """One more steady prove under torch.profiler: device busy time (union
    of kernel intervals) against wall time, the number of device kernels,
    and the kernels that take the time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        cfg.prove(pk, [circuit], [inst], random.Random(3), params=params)
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
    averages = prof.key_averages()
    top = sorted(averages, key=lambda e: -e.self_device_time_total)
    kernels = "; ".join(f"{e.key.split('(')[0][:40]} "
                        f"{e.self_device_time_total / 1e3:.1f} ms x{e.count}"
                        for e in top[:6])
    log(f"[{tag}] profiled prove {wall_ms:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms, idle share "
        f"{1 - busy_us / 1e3 / wall_ms:.3f}, {len(spans)} device kernels; "
        f"top device time: {kernels}")
    named = []
    for prefix in ("k_ntt", "k_order_", "k_stream_bucket", "k_ec_add",
                   "k_ec_madd", "k_ec_double", "k_ec_scalar_mul",
                   "k_ec_horner", "k_scan_level", "k_field_binop"):
        hits = [e for e in averages if prefix in e.key]
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        named.append(f"{prefix}* {ms:.1f} ms x{sum(e.count for e in hits)}")
    log(f"[{tag}] profiled prove, device time by kernel: " + "; ".join(named))


# ----------------------------------------------------------------------
# kernels at the main paths' shapes
# ----------------------------------------------------------------------

def log_stream_build(torch):
    """The kernels as built: registers, spills and resident blocks per SM
    of kernels D and 8 and the ordering pass's kernels (ptxas -v,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor) and of kernels B and 9
    (ptxas -v and the register file's limit); the multiplies by kind of B
    and 9, B's per op beside PR 4's CIOS counts, and those in the busiest
    loop of B's chains, D, 8 and kernels 10 and 12."""
    from halo2_tpu_torch.msm import stream_msm as sm
    from halo2_tpu_torch.tools import card
    for fn, r in sorted(card.ptxas_report().items()):
        if any(k in fn for k in ("k_stream_bucket", "k_order_", "k_ntt",
                                 "k_mont_repeatI7Bn254Fr", "k_u32")):
            log(f"[ptxas] {fn}: {r}")
    for fn, r in sorted(card.sass_report().items()):
        if "k_ntt" in fn:
            log(f"[sass] kernel C {fn}: {r['kinds']}; loops "
                + "; ".join(f"{lp['start']:x}-{lp['end']:x} {lp['kinds']}"
                            for lp in r["loops"]))
    for curve, tag in ((0, "Bn254G1"), (1, "Pallas"), (2, "Vesta")):
        for per_window in (False, True):
            log(f"[occupancy] {'kernel 8' if per_window else 'kernel D'} "
                f"{tag}: {sm.occupancy(curve, per_window)}")
    from halo2_tpu_torch.tools import ec_census
    for fn, r in ec_census.build_report().items():
        log(f"[build B/9] {fn}: {r}")
    mults = card.sass_multiplies()
    for tag in ("Bn254G1", "Vesta"):
        per = {op: [v for f, v in mults.items()
                    if f"k_ec_{op}I" in f and tag in f][0]
               for op in ("add", "madd", "double")}
        log(f"[sass] kernel B {tag} multiplier instructions per op: "
            + ", ".join(f"{op} {per[op]} (CIOS product, PR 4: {B_CIOS[op]})"
                        for op in per))
    for parts in (("k_ec_scalar_mulI", "Vesta"), ("k_ec_hornerI", "Bn254G1"),
                  ("k_stream_bucketI", "Bn254G1"),
                  ("k_stream_bucket_windowsI", "Bn254G1"),
                  ("k_stream_bucketI", "Vesta"),
                  ("k_mont_repeat", "Bn254Fr"), ("k_u32_mul_repeat",),
                  ("k_wide_mul_repeat",)):
        log(f"[sass] {' '.join(parts)}: busiest loop "
            f"{card.loop_multiplies(parts)}")


def stream_bound(bound, G, fn, keys, total: int, slots: int):
    """Rows 7-8 (the ordering pass and the accumulate pass): the keys and
    the nonzero elements' rows read once, the partial sums written once;
    the multiplies of the element loop's body (SASS) per nonzero
    element."""
    from halo2_tpu_torch.tools import card
    per = sum(card.loop_multiplies((fn, SASS_TAG[G.name])).values())
    return bound(4 * keys.numel() + 72 * total + 96 * slots, per * total)


def time_pass(torch, G, keys, table, per_window: bool) -> dict:
    """CUDA-event times of one MSM's steps on keys: the ordering pass, the
    accumulate pass (kernel D or 8), the per-key sums of its partial sums
    (kernel B) and the whole `stream_buckets`; with the nonzero count."""
    from halo2_tpu_torch.msm import stream_msm as sm
    from halo2_tpu_torch.tools import card
    nkeys, pieces, slots = stream_split(G, keys, per_window)
    order, info = sm.msm_order(keys, per_window, pieces)
    partials = accumulate(G, order, table, info, per_window, nkeys, slots)
    return dict(
        total=int(info[0]), pieces=int(info[2]), step=int(info[1]),
        slots=slots,
        order_ms=card.cuda_ms(lambda: sm.msm_order(keys, per_window, pieces),
                              5),
        acc_ms=card.cuda_ms(lambda: accumulate(G, order, table, info,
                                               per_window, nkeys, slots), 3),
        reduce_ms=card.cuda_ms(lambda: sm.key_sums(G, partials, info, nkeys),
                               3),
        buckets_ms=card.cuda_ms(lambda: sm.stream_buckets(
            G, keys, table, per_window), 3))


def check_stream_main(torch, params, pk, circuit, inst, bound, results):
    """The ordering pass and kernel D (baked table, k=18) or 8 (unbaked,
    k=20) against their plain versions at the main path's table, for
    random, 16-bit, zero, equal and one-bucket scalars; timed on random
    scalars and on the scalars of real commitments of one more prove,
    whose nonzero shares are printed."""
    from halo2_tpu_torch.msm import stream_msm as sm
    from halo2_tpu_torch.tools import card
    G = params.curve
    desc = params.engine.msm_backend.get_base_descriptor(G, params.g_lagrange)
    per_window = not desc.baked
    name = "h2_stream_bucket_windows" if per_window else "h2_stream_bucket"
    kern = "kernel 8" if per_window else "kernel D"
    tag = f"k={params.k}"
    err_o = err_a = 0
    for kind in STREAM_CASES:
        s = stream_scalars(torch, G.Fr, params.n, 21, params.device, kind)
        keys = sm.stream_keys(G, s)
        eo, ea, total, order_p, acc_p = check_pass(
            torch, G, keys, desc.table, per_window, f"{tag} {kind}")
        if kind == "random":
            order_plain, plain = order_p, acc_p
        err_o, err_a = max(err_o, eo), max(err_a, ea)
        log(f"[{kern}] {tag} {kind}: ordering pass and accumulate pass "
            f"equal to plain ({total} nonzero of {keys.numel()})")
    s = stream_scalars(torch, G.Fr, params.n, 21, params.device, "random")
    keys = sm.stream_keys(G, s)
    t = time_pass(torch, G, keys, desc.table, per_window)
    msm_ms = card.cuda_ms(lambda: desc(s), 3)
    fn = "k_stream_bucket_windowsI" if per_window else "k_stream_bucketI"
    b_ = stream_bound(bound, G, fn, keys, t["total"], t["slots"])
    b_o = bound(4 * keys.numel() + 4 * t["total"], 0)
    key_ids = keys >> 1
    b_o["library_ms"] = card.cuda_ms(
        lambda: torch.sort(key_ids.reshape(-1), stable=True), 3)
    log(f"[{kern}] {tag} random ({t['total']} nonzero, {t['pieces']} pieces "
        f"of <= {t['step']}): ordering pass {t['order_ms']:.3f} ms (plain "
        f"{order_plain:.1f} ms, torch.sort stable {b_o['library_ms']:.3f} "
        f"ms, bound {b_o['bound_ms']:.4f} ms); accumulate {t['acc_ms']:.3f} "
        f"ms (plain {plain:.1f} ms; bound {b_['bound_ms']:.3f} ms, "
        f"{b_['bound_by']}); key sums (kernel B) {t['reduce_ms']:.3f} ms; "
        f"bucket sums {t['buckets_ms']:.3f} ms; whole MSM {msm_ms:.3f} ms")

    with msm_census(torch, keep=True) as calls:
        _config(params.device, pk.vk.k).prove(
            pk, [circuit], [inst], random.Random(7), params=params)
    shares = log_census(tag, calls)
    real = {}
    for label, pick in (("sparsest", min), ("densest", max)):
        j = pick((j for j in range(len(calls)) if shares[j] >= 0.01),
                 key=lambda j: shares[j])
        sc = calls[j]["scalars"]
        sc = torch.cat([sc, sc.new_zeros((params.n - sc.shape[0], 8))])
        rkeys = sm.stream_keys(G, sc)
        rt = time_pass(torch, G, rkeys, desc.table, per_window)
        real[label] = dict(share=shares[j], **rt)
        log(f"[{kern}] {tag} real commitment {j} ({label}, nonzero share "
            f"{shares[j]:.4f}): ordering pass {rt['order_ms']:.3f} ms, "
            f"accumulate {rt['acc_ms']:.3f} ms, key sums "
            f"{rt['reduce_ms']:.3f} ms, bucket sums {rt['buckets_ms']:.3f} ms")
    r = results[name]
    r.update(max_abs_err=max(r["max_abs_err"], err_a),
             ms=t["order_ms"] + t["acc_ms"], accumulate_ms=t["acc_ms"],
             order_ms=t["order_ms"], reduce_ms=t["reduce_ms"],
             msm_ms=msm_ms, nonzero=t["total"], plain_ms=order_plain + plain,
             real_commitments=real, **b_)
    o = results["h2_msm_order"]
    o["max_abs_err"] = max(o["max_abs_err"], err_o)
    at = dict(ms=t["order_ms"], plain_ms=order_plain, **b_o)
    if per_window:
        o.setdefault("instances", {})[f"kernel 8's keys, {tag}"] = at
    else:
        o.update(at)


def check_unbaked_vs_baked(torch, params):
    """One k=20 MSM through the unbaked table against the same MSM through
    a baked table built for this check."""
    from halo2_tpu_torch.msm import stream_msm as sm
    from halo2_tpu_torch.tools import card
    G = params.curve
    desc = params.engine.msm_backend.get_base_descriptor(G, params.g_lagrange)
    s = random_elems(torch, G.Fr, params.n, 22, params.device)
    unbaked_ms = card.cuda_ms(lambda: desc(s), 3)
    got = G.to_affine_ints(desc(s)[None])
    t0 = time.time()
    baked = sm.bake_stream_table(G, params.g_lagrange)
    torch.cuda.synchronize()
    t_bake = time.time() - t0
    baked_ms = card.cuda_ms(lambda: sm.msm_stream_baked(G, s, baked), 3)
    want = G.to_affine_ints(sm.msm_stream_baked(G, s, baked)[None])
    log(f"[unbaked vs baked] k={params.k} MSM: unbaked table "
        f"{desc.table.numel() * 4 / 2**20:.1f} MiB, whole MSM "
        f"{unbaked_ms:.3f} ms; baked table {baked.numel() * 4 / 2**30:.2f} "
        f"GiB built in {t_bake:.2f} s, whole MSM {baked_ms:.3f} ms; equal "
        f"{got == want}")
    if got != want:
        raise AssertionError("unbaked and baked k=20 MSMs differ")


# ----------------------------------------------------------------------
# the sorted fixed-base MSM (CachedMSM: the sort, kernel 9, kernel B)
# ----------------------------------------------------------------------

def sorted_msm_steps(torch, desc, s) -> dict:
    """One CachedMSM call split into its steps, each timed by CUDA events
    (the mean of 3 after a warm-up) on the inputs the call gives it and
    summed over its window chunks: the signed digits, the stable sort, the
    row gather, the bucket sums (kernel 9's scan levels with their tails),
    the weighted folds (unbaked: with the Horner chain) and, unbaked, the
    chunks' shift_add; beside the whole call."""
    from halo2_tpu_torch.msm import bucket_scan as bs
    from halo2_tpu_torch.tools import card
    G, c, block = desc.curve, desc.c, desc.block
    nb = (1 << (c - 1)) + 1
    packed = bs.packed_digits(G, s, c)
    t = dict(digits_ms=card.cuda_ms(lambda: bs.packed_digits(G, s, c)),
             sort_ms=0.0, gather_ms=0.0, scan_ms=0.0, fold_ms=0.0,
             combine_ms=0.0)
    part = None
    for i, (w0, w1) in enumerate(desc.bounds):
        wc = w1 - w0
        if desc.baked:
            rows, keys, n_keys = desc.wchunks[i], packed[w0:w1].reshape(
                -1), nb
        else:
            window = torch.arange(wc, dtype=torch.int32,
                                  device=s.device)[:, None]
            rows, n_keys = desc.rows, wc * nb
            keys = (((packed[w0:w1] >> 1) + window * nb) * 2 +
                    (packed[w0:w1] & 1)).reshape(-1)
        keys_s, perm = bs.sort_perm(keys)
        idx = perm if desc.baked else perm % desc.n
        g = rows[idx]
        buckets = bs.bucket_sums(G, keys_s, g, n_keys, block, packed=True)
        if desc.baked:
            def fold():
                return bs.weighted_bucket_fold(G, buckets)
        else:
            def fold():
                return bs.horner_windows(G, bs.weighted_bucket_fold(
                    G, buckets.reshape(wc, nb, 3, 8).transpose(0, 1)), c)
        t["sort_ms"] += card.cuda_ms(lambda: bs.sort_perm(keys))
        t["gather_ms"] += card.cuda_ms(lambda: rows[idx])
        t["scan_ms"] += card.cuda_ms(lambda: bs.bucket_sums(
            G, keys_s, g, n_keys, block, packed=True))
        t["fold_ms"] += card.cuda_ms(fold)
        part = fold()
        if i and not desc.baked:
            t["combine_ms"] += card.cuda_ms(
                lambda: bs.shift_add(G, part, c * wc, part))
    t["msm_ms"] = card.cuda_ms(lambda: desc(s))
    t["steps_ms"] = sum(v for k, v in t.items() if k != "msm_ms")
    return t


def check_sorted_msm(torch, params, results):
    """CachedMSM (the sorted fixed-base MSM of GpuMsmEngine(style=
    "sorted")) on the path's g_lagrange: built (time, table bytes), held
    against the path's StreamMSM as group elements for the five scalar
    kinds of kernel D's checks, kernel 9's calls of one MSM on random
    scalars, the first of each shape, held against its plain version word
    for word, and the MSM timed by steps beside StreamMSM's whole MSM."""
    from halo2_tpu_torch.msm import CachedMSM
    from halo2_tpu_torch.msm import bucket_scan as bs
    from halo2_tpu_torch.tools import card
    G = params.curve
    tag = f"k={params.k}"
    stream = params.engine.msm_backend.get_base_descriptor(
        G, params.g_lagrange)
    desc, t_build = timed(torch, lambda: CachedMSM(G, params.g_lagrange))
    tables = desc.wchunks if desc.baked else [desc.rows]
    nbytes = sum(t.numel() * 4 for t in tables)
    log(f"[sorted MSM] {tag}: CachedMSM c={desc.c}, {desc.n_windows} "
        f"windows, {'baked' if desc.baked else 'unbaked'}, "
        f"{len(desc.bounds)} chunk(s) of <= {desc.window_chunk} windows; "
        f"table {nbytes / 2**20:.1f} MiB built in {t_build:.3f} s")
    for kind in STREAM_CASES:
        s = stream_scalars(torch, G.Fr, params.n, 21, params.device, kind)
        if G.to_affine_ints(desc(s)[None]) != \
                G.to_affine_ints(stream(s)[None]):
            raise AssertionError(f"sorted MSM {tag} {kind}: differs from "
                                 f"StreamMSM")
    log(f"[sorted MSM] {tag}: equal to StreamMSM ("
        f"{'kernel D' if stream.baked else 'kernel 8'}) for "
        f"{', '.join(STREAM_CASES)} scalars")
    s = stream_scalars(torch, G.Fr, params.n, 21, params.device, "random")
    with recording(bs, "scan_level") as scans:
        desc(s)
    torch.cuda.synchronize()
    first = {}
    for call in scans:
        a = call[0]
        first.setdefault((a[1].shape[0], a[3], a[4]), call)
    err = 0
    for args, _, _ in first.values():
        err = max(err, check_scan_call(
            torch, args, bs.scan_level_plain(*args),
            f"sorted MSM {tag} scan mode {args[4]} M={args[1].shape[0]} "
            f"block {args[3]}"))
    big = max(first.values(), key=lambda call: call[0][1].shape[0])[0]
    big_ms = card.cuda_ms(lambda: bs.scan_level(*big))
    n_calls, n_shapes = len(scans), len(first)
    del scans, first
    log(f"[kernel 9] sorted MSM {tag}: the first of its {n_calls} calls of "
        f"each of {n_shapes} shapes equal to plain; the largest "
        f"({big[1].shape[0]} elements, block {big[3]}) {big_ms:.4f} ms")
    steps = sorted_msm_steps(torch, desc, s)
    stream_ms = card.cuda_ms(lambda: stream(s))
    log(f"[sorted MSM] {tag} random scalars: whole MSM "
        f"{steps['msm_ms']:.3f} ms (steps: "
        + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in steps.items()
                    if k != "msm_ms") + f" ms) against StreamMSM "
        f"{stream_ms:.3f} ms")
    r = results["h2_scan_level"]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r.setdefault("sorted_msm", {})[tag] = dict(
        c=desc.c, baked=desc.baked, chunks=len(desc.bounds),
        table_bytes=nbytes, build_s=t_build, scan_calls=n_calls,
        scan_shapes_checked=n_shapes, max_abs_err=err,
        largest_scan_ms=big_ms, stream_msm_ms=stream_ms, **steps)


def run_sorted_path(torch, tag, cfg, params, pk, circuit, inst, first_proof,
                    counts, need, n_steady: int, profile: bool):
    """A path's circuit on its params under GpuMsmEngine(style="sorted"):
    keygen (the VK must equal the path's), the first proof
    (random.Random(1), the path's first proof byte for byte) and, with
    n_steady, steady proves, verify and a tampered proof rejected; with
    profile, one profiled prove.  No kernel D may launch: every
    full-length commitment runs CachedMSM.  The params' engine is restored
    after."""
    from halo2_tpu_torch.api import keygen
    from halo2_tpu_torch.engine import GpuMsmEngine, PlonkEngineConfig

    def body():
        spk, t = timed(torch, lambda: keygen(pk.vk.F, params, pk.vk.k,
                                             circuit))
        if spk.vk.pinned() != pk.vk.pinned():
            raise AssertionError(f"{tag}: VK differs from the path's")
        log(f"[{tag}] keygen {t:.2f} s (the sorted tables built in it); VK "
            f"equals the path's")
        if n_steady:
            proof = prove_verify(torch, tag, cfg, params, spk, circuit, inst,
                                 n_steady)
        else:
            proof, t = timed(torch, lambda: cfg.prove(
                spk, [circuit], [inst], random.Random(1), params=params))
            log(f"[{tag}] prove (first) {t:.3f} s")
        if proof != first_proof:
            raise AssertionError(f"{tag}: the first proof differs from the "
                                 f"stream engine's")
        log(f"[{tag}] the first proof equals the stream engine's byte for "
            f"byte")
        return spk

    saved = params.engine
    params.set_engine(PlonkEngineConfig.set_msm(GpuMsmEngine(style="sorted")))
    try:
        spk = run_path(torch, tag, counts, need, body)
        if counts[tag].get("h2_stream_bucket", 0) or \
                counts[tag].get("h2_msm_order", 0):
            raise AssertionError(f"{tag}: kernel D or the ordering pass ran "
                                 f"under the sorted engine")
        if profile:
            profile_prove(torch, tag, cfg, params, spk, circuit, inst)
    finally:
        params.set_engine(saved)


@contextlib.contextmanager
def msm_census(torch, keep: bool = False):
    """Record every StreamMSM call while the block runs: its table kind,
    its scalars' count and the nonzero signed digits of each window (a
    zero digit adds nothing); with keep, the scalars too."""
    from halo2_tpu_torch.msm import stream_msm as sm
    from halo2_tpu_torch.msm.bucket_scan import _signed_digits
    calls = []
    orig = sm.StreamMSM.__call__

    def wrapper(self, s):
        digits, _ = _signed_digits(self.curve.Fr, s, sm.STREAM_C)
        nz = (digits != 0).sum(dim=1).cpu().tolist()
        calls.append(dict(baked=self.baked, n=s.shape[0], nonzero=nz,
                          scalars=s if keep else None))
        return orig(self, s)

    sm.StreamMSM.__call__ = wrapper
    try:
        yield calls
    finally:
        sm.StreamMSM.__call__ = orig


def log_census(tag: str, calls):
    """Each commitment's nonzero share of its (window, base) digits, and
    its windows with at most 16 nonzero digits (blinding rows only)."""
    shares = [sum(c["nonzero"]) / (len(c["nonzero"]) * c["n"]) for c in calls]
    empty = [sum(v <= 16 for v in c["nonzero"]) for c in calls]
    total = sum(sum(c["nonzero"]) for c in calls) / max(1, sum(
        len(c["nonzero"]) * c["n"] for c in calls))
    log(f"[census] {tag}: {len(calls)} fixed-base MSMs, nonzero share "
        f"{total:.4f} over all; per MSM min {min(shares):.4f}, max "
        f"{max(shares):.4f}; {sum(s < 0.5 for s in shares)} below 0.5")
    log(f"[census] {tag}: per MSM (share, windows with <= 16 nonzero "
        f"digits of {len(calls[0]['nonzero'])}): " + ", ".join(
            f"{s:.3f}/{e}" for s, e in zip(shares, empty)))
    return shares


@contextlib.contextmanager
def recording(module, name: str):
    """Record every call of module.name (arguments, result, host seconds)
    while the block runs; the package looks these functions up by module
    global at each call, so the wrapper sees every one."""
    calls = []
    orig = getattr(module, name)

    def wrapper(*args):
        t0 = time.perf_counter()
        out = orig(*args)
        calls.append((args, out, time.perf_counter() - t0))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def check_ipa_main(torch, params, pk, circuit, inst, bound, results):
    """One more steady IPA prove with every ordering pass, kernel D and
    kernel 9 call and every host blind-term MSM recorded.  The first
    recorded call of each shape is then held against its plain version on
    its own inputs (the main path's shapes: the ordering pass and kernel D
    on g_lagrange's and g's baked tables, and every scan
    level and tail scan of every opening MSM; a round's L and R MSMs repeat
    each other's shapes); kernel 9 is timed at its largest call;
    the host MSMs' share of the prove is printed, and one blind term on the
    card (the reference's one-point device MSM) is timed against the
    host's."""
    from halo2_tpu_torch.api import create_proof
    from halo2_tpu_torch.commit import ipa
    from halo2_tpu_torch.msm import bucket_scan as bs
    from halo2_tpu_torch.msm import naive_msm
    from halo2_tpu_torch.msm import stream_msm as sm
    from halo2_tpu_torch.tools import card
    G = params.curve
    tag = f"IPA plonk_api k={params.k}"
    from halo2_tpu_torch.tools import ec_census
    with recording(bs, "scan_level") as scans, \
            recording(sm, "msm_order") as orders, \
            recording(sm, "stream_bucket") as streams, \
            recording(ipa, "host_msm") as hosts, \
            ec_census.caller_census() as by_caller:
        torch.cuda.synchronize()
        t0 = time.time()
        create_proof(params, pk, [circuit], [inst], random.Random(4))
        torch.cuda.synchronize()
        wall = time.time() - t0
    host_s = sum(c[2] for c in hosts)
    log(f"[{tag}] recorded prove {wall:.3f} s: {len(streams)} kernel D "
        f"calls, {len(scans)} kernel 9 calls, {len(hosts)} host blind-term "
        f"MSMs taking {host_s * 1e3:.1f} ms (share {host_s / wall:.4f}); "
        f"kernel B launches {sum(by_caller.values())} (PR 4's profiled "
        f"prove: 18,788 adds and doublings)")
    for line in ec_census.census_lines(by_caller):
        log(f"[{tag}] one prove's kernel B launches by caller: {line}")

    def first_of_each(calls, key):
        seen = {}
        for call in calls:
            seen.setdefault(key(call[0]), call)
        return list(seen.values())

    # each MSM runs the ordering pass, then kernel D on its order
    if len(orders) != len(streams) or any(
            d[0][1] is not o[1][0] for o, d in zip(orders, streams)):
        raise AssertionError(f"{tag}: ordering passes and kernel D calls "
                             f"do not pair up")
    err_o = err_d = 0
    tables = {}
    for o, d in zip(orders, streams):
        tables.setdefault(d[0][2].data_ptr(), (o, d))
    for ((keys, per_window, pieces), (order, info), _), \
            ((G_, _, table, _, slots), out, _) in tables.values():
        what = f"{tag} table {tuple(table.shape)}"
        err_o = max(err_o, check_order(torch, keys, per_window, pieces,
                                       order, info, what)[0])
        want = sm.accumulate_plain(G_, order, table, info, sm.NB, slots)
        err_d = max(err_d, expect_equal(
            torch, f"{what}: stream buckets", out, want))
    shapes = sorted({tuple(a[2].shape) for a, _, _ in streams})
    log(f"[ordering pass, kernel D] {tag}: the first of the prove's "
        f"{len(streams)} calls on each of its {len(tables)} tables equal to "
        f"plain (tables {shapes})")
    for name, err in (("h2_msm_order", err_o), ("h2_stream_bucket", err_d)):
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r.setdefault("path_checks", {})[tag] = dict(calls=len(tables),
                                                    max_abs_err=err)

    err_9, plain_ms, big = 0, 0.0, None
    scans_1 = first_of_each(scans, lambda a: (a[1].shape[0], a[3], a[4]))
    for args, _, _ in scans_1:
        keys, mode = args[1], args[4]
        want, t = card.timed(lambda: bs.scan_level_plain(*args))
        err_9 = max(err_9, check_scan_call(
            torch, args, want, f"{tag} scan mode {mode} M={keys.shape[0]} "
            f"block {args[3]}"))
        if big is None or keys.shape[0] > big[1].shape[0]:
            big, plain_ms = args, t
    modes = sorted({a[4] for a, _, _ in scans})
    m = big[1].shape[0]
    ms = card.cuda_ms(lambda: bs.scan_level(*big), 5)
    # padding slots (infinity flag set) need no mixed add: count what
    # this call's data needs
    if big[4] == bs.PROJECTIVE:
        work = m
    else:
        work = int(((big[2][:, 2 * 8] & 1) == 0).sum())
    width = 4 * (3 * 8 if big[4] == bs.PROJECTIVE else bs.ROW_WORDS)
    b_ = bound((4 + width) * m + 100 * (m // big[3]),
               work * bound.per_elem("k_scan_levelI", SASS_TAG[G.name],
                                     SCAN_SASS[big[4]]))
    n = params.n // 2
    s = random_elems(torch, G.Fr, n, 23, params.device)
    msm_ms = {}
    for blk in (None, 8, 16, 32, 64):
        msm_ms[blk or "rule"] = card.cuda_ms(
            lambda: bs.msm_variable(G, s, params.g[:n], 8, blk), 3)
    scan_total = sum(card.cuda_ms(lambda: bs.scan_level(*a), 1)
                     for a, _, _ in scans)
    log(f"[kernel 9] {tag}: the first of the prove's {len(scans)} calls of "
        f"each of {len(scans_1)} shapes (modes {modes}, blocks "
        f"{sorted({a[3] for a, _, _ in scans})}) equal to plain; the "
        f"largest ({m} elements, {work} not padding, mode {big[4]}, block "
        f"{big[3]}, {m // big[3]} lanes) {ms:.4f} ms vs plain {plain_ms:.1f} "
        f"ms; "
        f"bound {b_['bound_ms']:.4f} ms ({b_['bound_by']}); the prove's "
        f"{len(scans)} calls run again one by one {scan_total:.2f} ms; whole "
        f"variable-base MSM of {n} points by block: {msm_ms} ms")
    results["h2_scan_level"].update(
        max_abs_err=max(results["h2_scan_level"]["max_abs_err"], err_9),
        ms=ms, M=m, block=big[3], plain_ms=plain_ms, calls_per_prove=len(scans),
        calls_ms=scan_total, msm_ms_by_block=msm_ms, path_checks={
            tag: dict(calls=len(scans_1), max_abs_err=err_9)}, **b_)

    r_blind = random.Random(5).randrange(G.Fr.p)
    w = G.from_affine_ints([params.w_aff], params.device)
    sc = G.Fr.encode_ints([r_blind], params.device)
    naive_msm(G, sc, w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = naive_msm(G, sc, w)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_host = ipa.host_msm(G, [r_blind], [params.w_aff])
    t_host = time.perf_counter() - t0
    if G.to_affine_ints(on_card[None]) != [on_host]:
        raise AssertionError("blind term: card and host differ")
    log(f"[{tag}] one blind term [r]W: host {t_host * 1e3:.2f} ms, on the "
        f"card as a one-point MSM {t_card * 1e3:.2f} ms; equal")


# ----------------------------------------------------------------------
# the port's bench and probes (kernels 10-15)
# ----------------------------------------------------------------------

def run_bench_micro(torch, dev, counts):
    """The port's micro bench, `halo2_tpu_torch.bench.stage_micro`, in this
    process at the reference's sizes (MSM and NTT at 2^18, kernel 10 at
    2^21), with its guards; its result JSON is printed."""
    from halo2_tpu_torch import bench
    tag = f"bench micro k={K_MAIN}"
    res = run_path(torch, tag, counts, (
        "h2_mont_repeat", "h2_stream_bucket", "h2_ntt_base", "h2_field_binop",
        "h2_ec_add"), lambda: bench.stage_micro(dev, k=K_MAIN))
    log(f"[{tag}] {json.dumps(res)}")


def mont_entry(torch, dev, F, tag, seed, bound, u32_rate, reps=64,
               n=1 << 21):
    """Kernel 10 / 11 on n canonical elements of F, `reps` products each:
    equal to its plain version (reps calls of kernel A's plain product), and
    at reps 0, 1 and 7 on a tail (2^12 K + 3 elements, K the elements a
    thread runs) and on fewer elements than one block; timed, with its
    bound at the least multiplies a schoolbook product needs
    (`card.least_multiplies`), its share at the guide's IMAD rate and at
    kernel 12's measured `u32_rate`."""
    from halo2_tpu_torch import _build
    from halo2_tpu_torch.tools import alu_probe as ap
    from halo2_tpu_torch.tools import card
    per_thread = _build.library().h2_mont_elems_per_thread()
    err = 0
    for size, r in ((per_thread * 4096 + 3, 0), (per_thread * 4096 + 3, 1),
                    (per_thread * 4096 + 3, 7), (100, 7)):
        x = random_elems(torch, F, size, seed + 7, dev)
        y = random_elems(torch, F, size, seed + 8, dev)
        err = max(err, expect_equal(
            torch, f"mont_repeat {F.name} x{r} at {size}",
            ap.mont_repeat(F, x, y, r), ap.mont_repeat_plain(F, x, y, r)))
    a = random_elems(torch, F, n, seed, dev)
    b = random_elems(torch, F, n, seed + 1, dev)
    want, plain = card.timed(lambda: ap.mont_repeat_plain(F, a, b, reps))
    err = max(err, expect_equal(torch, f"mont_repeat {F.name} x{reps}",
                                ap.mont_repeat(F, a, b, reps), want))
    del want
    ms = card.cuda_ms(lambda: ap.mont_repeat(F, a, b, reps), 5)
    per_mul = card.mont_repeat_multiplies(tag)
    kinds = {k: v / per_thread for k, v in
             card.loop_multiplies(("k_mont_repeat", tag)).items()}
    least = card.least_multiplies(F)
    b_ = bound(3 * 32 * n, n * reps * least)
    at_u32 = max(b_["bytes_ms"], b_["ops_ms"] * card.IMAD_PER_CLK_SM
                 / u32_rate)
    imad = bound.imad_per_clk_sm(n * reps * per_mul / ms * 1e3)
    regs = [r for fn, r in card.ptxas_report().items()
            if "k_mont_repeat" in fn and tag in fn][0]
    log(f"[kernel 10/11] {F.name} x{reps} at 2^{n.bit_length() - 1}: equal "
        f"(and the tails); {ms:.4f} ms vs plain {plain:.1f} ms; K = "
        f"{per_thread} elements a thread, {regs}; least-multiplies bound "
        f"({least} a product) {b_['bound_ms']:.4f} ms at the guide's "
        f"{card.IMAD_PER_CLK_SM} (share {b_['bound_ms'] / ms:.3f}), "
        f"{at_u32:.4f} ms at kernel 12's {u32_rate:.1f} (share "
        f"{at_u32 / ms:.3f}); its SASS: {per_mul:g} multipliers a product "
        f"({kinds}); "
        f"{n * reps / ms / 1e6:.2f} G products/s: {imad:.1f} IMAD per clock "
        f"per SM")
    return err, dict(ms=ms, plain_ms=plain, reps=reps,
                     elems_per_thread=per_thread, imad_per_product=per_mul,
                     multipliers_by_kind=kinds, products=n * reps,
                     least_imad_per_product=least,
                     imad_per_clk_sm=imad, **regs, **b_)


def check_kernel_10(torch, dev, bound, results) -> dict:
    """Kernel 10 (BN254 Fr) against its plain version at the bench's shape,
    rk = 2^21, with its first reps = 64 (the plain version: 64 products of
    kernel A's plain version at 2^21, about 6 s), and at its tails; shares
    at kernel 12's rate, measured before it."""
    from halo2_tpu_torch.fields import BN254_FR
    err, r = mont_entry(torch, dev, BN254_FR, "Bn254Fr", 61, bound,
                        results["h2_u32_mul_repeat"]["imad_per_clk_sm"])
    return _entry("mont_repeat", "alu.cu", "bench.py:249", err, root=None, **r)


def check_kernel_12(torch, dev, bound) -> dict:
    """Kernel 12, the u32 chain on (8, 2^21) lanes at its deepest probe
    chain (1,024 steps), against its plain version: its IMAD rate is the
    measured yardstick of every kernel's bound.  Its IMAD.WIDE form beside
    it, the same way (an instance of the entry): the rate of the multiply
    most of the carry-chain product's multiplies are, on independent
    chains."""
    from halo2_tpu_torch.tools import alu_probe as ap
    from halo2_tpu_torch.tools import card
    n, reps = 1 << 21, 1024
    a, b = ap.random_u32((8, n), 65, dev), ap.random_u32((8, n), 66, dev)
    err, runs = 0, {}
    for wide in (False, True):
        what = "IMAD.WIDE" if wide else "u32"
        want, plain = card.timed(
            lambda: ap.u32_mul_repeat_plain(a, b, reps, wide))
        err = max(err, expect_equal(torch, f"{what} chain x{reps}",
                                    ap.u32_mul_repeat(a, b, reps, wide), want))
        del want
        ms = card.cuda_ms(lambda: ap.u32_mul_repeat(a, b, reps, wide), 5)
        steps = 8 * n * reps * (ap.WIDE_CHAINS if wide else 1)
        b_ = bound(3 * 4 * 8 * n, steps)
        imad = bound.imad_per_clk_sm(steps / ms * 1e3)
        log(f"[kernel 12] {what} chain x{reps} on (8, 2^21): equal; "
            f"{ms:.3f} ms vs plain {plain:.1f} ms; bound {b_['bound_ms']:.3f} "
            f"ms ({b_['bound_by']}); {imad:.1f} {what} per clock per SM (the "
            f"guide's {card.IMAD_PER_CLK_SM} IMAD)")
        runs[what] = dict(ms=ms, plain_ms=plain, reps=reps,
                          imad_per_clk_sm=imad, **b_)
    return _entry("u32_mul_repeat", "alu.cu", "tools/alu_probe.py:81", err,
                  root=None, instances={"IMAD.WIDE": runs["IMAD.WIDE"]},
                  **runs["u32"])


def run_probes(torch, counts):
    """The three probes' sweeps, `main()` of each module of
    halo2_tpu_torch/tools, as the card's path for kernels 11-15; their own
    kernel-vs-library comparisons must hold."""
    from halo2_tpu_torch.tools import (alu_probe, dma_gather_probe,
                                       transpose_probe)
    out = run_path(torch, "probes", counts, (
        "h2_mont_repeat", "h2_u32_mul_repeat", "h2_gather_rows",
        "h2_limb_T_fwd", "h2_limb_T_bwd"), lambda: dict(
            alu=alu_probe.main(), gather=dma_gather_probe.main(),
            transpose=transpose_probe.main()))
    bad = [f"{probe} {key}" for probe in ("gather", "transpose")
           for key, v in out[probe].items() if not v["equal"]]
    if bad:
        raise AssertionError(f"probes: kernel and library differ: {bad}")


def check_probes(torch, dev, bound, results):
    """Rows 11 and 13-15 at the reference's shapes, each held word for word
    against its plain version and timed by CUDA events beside it and, for
    rows 13-15, beside the PyTorch call that computes the same function
    (`index_select`, `.t().contiguous()`): Montgomery products over BN254
    Fq (2^21 x 64, and its tails), the gather of 20 2^18 rows from a
    2^18-row table at widths 128 and 64, and both transposes at R = 2^21."""
    from halo2_tpu_torch.fields import BN254_FQ
    from halo2_tpu_torch.tools import alu_probe as ap
    from halo2_tpu_torch.tools import card
    from halo2_tpu_torch.tools import dma_gather_probe as dg
    from halo2_tpu_torch.tools import transpose_probe as tp
    err, r = mont_entry(torch, dev, BN254_FQ, "Bn254Fq", 63, bound,
                        results["h2_u32_mul_repeat"]["imad_per_clk_sm"])
    results["h2_mont_repeat"]["max_abs_err"] = max(
        results["h2_mont_repeat"]["max_abs_err"], err)
    results["h2_mont_repeat"]["instances"] = {
        BN254_FQ.name: dict(replaces="tools/alu_probe.py:56", **r)}

    rows = 1 << K_MAIN
    m = 20 * rows
    idx = dg.random_idx(m, rows, 67, dev)
    entry = None
    for width in (128, 64):
        tbl = dg.mk_tbl(rows, width, dev)
        want, plain = card.timed(lambda: dg.gather_rows_plain(idx, tbl))
        err = expect_equal(torch, f"gather_rows width {width}",
                           dg.gather_rows(idx, tbl), want)
        del want
        ms = card.cuda_ms(lambda: dg.gather_rows(idx, tbl), 5)
        b_ = bound(2 * m * width * 4 + 4 * m, 0)
        b_["library_ms"] = card.cuda_ms(lambda: tbl.index_select(0, idx), 5)
        log(f"[kernel 13] gather of {m} rows of {width} words: equal; "
            f"{ms:.3f} ms vs index_select {b_['library_ms']:.3f} ms; bound "
            f"{b_['bound_ms']:.3f} ms ({b_['bound_by']})")
        r = dict(ms=ms, plain_ms=plain, **b_)
        if entry is None:
            entry = _entry("gather_rows", "move.cu",
                           "tools/dma_gather_probe.py:54", err, root=None,
                           width=width, **r)
        else:
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            entry["instances"] = {f"width {width}": r}
    results["h2_gather_rows"] = entry
    del idx, tbl

    x = ap.random_u32((8 << 18, 16), 68, dev)
    xt = tp.transpose_plain(x)
    for name, fn, arg, line in (("fwd", tp.limb_T_fwd, x, 42),
                                ("bwd", tp.limb_T_bwd, xt, 68)):
        want, plain = card.timed(lambda: tp.transpose_plain(arg))
        err = expect_equal(torch, f"limb_T_{name}", fn(arg), want)
        del want
        ms = card.cuda_ms(lambda: fn(arg), 10)
        b_ = bound(2 * arg.numel() * 4, 0)
        b_["library_ms"] = card.cuda_ms(lambda: arg.t().contiguous(), 10)
        log(f"[kernel {14 if name == 'fwd' else 15}] transpose "
            f"{tuple(arg.shape)}: equal; {ms:.4f} ms vs .t().contiguous() "
            f"{b_['library_ms']:.4f} ms; bound {b_['bound_ms']:.4f} ms "
            f"({b_['bound_by']})")
        results[f"h2_limb_T_{name}"] = _entry(
            f"limb_T_{name}", "move.cu", f"tools/transpose_probe.py:{line}",
            err, root=None, ms=ms, plain_ms=plain, **b_)


def shares_at_measured_rates(results):
    """Each kernel's time against its bound at the guide's IMAD rate (the
    `bound_ms` of the kernels line) and against the same bound at kernel
    12's u32 rate, the rate the card reached in this run
    (`bound_ms_measured`), for every kernel.  A chain's critical path does
    not depend on the rate and stays in both; kernel A's bound is bytes at
    either rate.  Kernel 10/11 also gets its own SASS multipliers at each
    kind's measured rate (IMAD.WIDE at kernel 12's wide form's,
    `bound_ms_by_kind`)."""
    from halo2_tpu_torch.tools import card
    u32 = results["h2_u32_mul_repeat"]["imad_per_clk_sm"]
    wide = results["h2_u32_mul_repeat"]["instances"]["IMAD.WIDE"][
        "imad_per_clk_sm"]
    mont = results["h2_mont_repeat"]["imad_per_clk_sm"]
    log(f"[rates] measured IMAD per clock per SM (max SM clock): u32 chain "
        f"(kernel 12) {u32:.1f}, which every bound_ms_measured uses; its "
        f"IMAD.WIDE form {wide:.1f}; carry-chain Montgomery product (kernel "
        f"10) {mont:.1f}; the guide's {card.IMAD_PER_CLK_SM}, which every "
        f"bound_ms uses")
    for r in results.values():
        for label, d in [("", r)] + list(r.get("instances", {}).items()):
            d["bound_ms_measured"] = max(
                d["bytes_ms"], d["ops_ms"] * card.IMAD_PER_CLK_SM / u32,
                d.get("critical_path_ms", 0.0))
            log(f"[share] {r['name']} {label}: {d['ms']:.4f} ms; bound "
                f"{d['bound_ms']:.4f} ms (share {d['bound_ms'] / d['ms']:.3f}); "
                f"at the measured rate {d['bound_ms_measured']:.4f} ms (share "
                f"{d['bound_ms_measured'] / d['ms']:.3f})")
            if "multipliers_by_kind" in d:
                # kernel 10/11: its own SASS at each kind's measured rate
                guide_ms = d["ops_ms"] / (d["products"]
                                          * d["least_imad_per_product"])
                d["bound_ms_by_kind"] = d["products"] * guide_ms * sum(
                    v * card.IMAD_PER_CLK_SM
                    / (wide if k == "IMAD.WIDE" else u32)
                    for k, v in d["multipliers_by_kind"].items())
                log(f"[share] {r['name']} {label}: its SASS at each "
                    f"multiplier's measured rate (IMAD.WIDE {wide:.1f}, the "
                    f"rest {u32:.1f}) {d['bound_ms_by_kind']:.4f} ms (share "
                    f"{d['bound_ms_by_kind'] / d['ms']:.3f})")


if __name__ == "__main__":
    sys.exit(main())
