"""The carry-chain Montgomery product of kernels B, C, D, 8, 9 and 10/11
and kernel C's carry-chain sum and difference (halo2_tpu_torch/csrc/
mont_chain.cuh), kernel 10/11's per-thread body (csrc/mont_repeat.cuh) on
the CPU, and the SASS census of halo2_tpu_torch/tools/card.py.

The primitives carry a host model of the PTX carry flag, so g++ builds the
same chains here; their words are held against python integers for the
four moduli, with 0, 1, p - 1 and random canonical operands.  Kernel
10/11's body runs over a grid of small blocks, built at 1, 2 and 4
elements a thread, held against `alu_probe.mont_repeat_plain` and python
integers on element counts that leave a tail.  The SASS parser is held
against a hand-written listing in cuobjdump's format.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

import torch

from halo2_tpu_torch.fields import BN254_FQ, BN254_FR, PASTA_FP, PASTA_FQ
from halo2_tpu_torch.tools import alu_probe, card

CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "halo2_tpu_torch",
                    "csrc")

HARNESS = r"""
#include <cstdint>
#include <cstdio>
struct Fe { uint32_t w[8]; };
struct Mod {
  static uint32_t P[8], INV;
  static uint32_t p(int i) { return P[i]; }
  static uint32_t inv() { return INV; }
};
uint32_t Mod::P[8], Mod::INV;
#include "mont_chain.cuh"
int main() {
  for (int i = 0; i < 8; i++) scanf("%x", &Mod::P[i]);
  scanf("%x", &Mod::INV);
  int n;
  scanf("%d", &n);
  for (int k = 0; k < n; k++) {
    Fe a, b;
    for (int i = 0; i < 8; i++) scanf("%x", &a.w[i]);
    for (int i = 0; i < 8; i++) scanf("%x", &b.w[i]);
    const Fe r = fe_mul_chain<Mod>(a, b);
    const Fe s = fe_add_chain<Mod>(a, b), d = fe_sub_chain<Mod>(a, b);
    for (int i = 0; i < 8; i++) printf("%x ", r.w[i]);
    for (int i = 0; i < 8; i++) printf("%x ", s.w[i]);
    for (int i = 0; i < 8; i++) printf("%x ", d.w[i]);
    printf("\n");
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def chain_binary(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the host model")
    d = tmp_path_factory.mktemp("mont_chain")
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O2", "-std=c++17", "-I", CSRC, "-o", str(exe),
                    str(src)], check=True, capture_output=True, timeout=120)
    return str(exe)


REPEAT_HARNESS = r"""
#include <cstdint>
#include <cstdio>
#include <vector>
struct Fe { uint32_t w[8]; };
struct Mod {
  static uint32_t P[8], INV;
  static uint32_t p(int i) { return P[i]; }
  static uint32_t inv() { return INV; }
};
uint32_t Mod::P[8], Mod::INV;
#include "mont_repeat.cuh"
// Jobs of (reps, n, n pairs a b) run as alu.cu launches them: blocks of
// `threads`, a tile of K threads' elements each; prints the n results and
// how many words past n were written.
template <int K>
void run(int threads, int jobs) {
  for (int j = 0; j < jobs; j++) {
    int reps;
    long long n;
    scanf("%d %lld", &reps, &n);
    const long long tile = (long long)K * threads;
    const long long blocks = (n + tile - 1) / tile;
    std::vector<Fe> a(n), b(n), out(blocks * tile);
    for (long long e = 0; e < n; e++) {
      for (int i = 0; i < 8; i++) scanf("%x", &a[e].w[i]);
      for (int i = 0; i < 8; i++) scanf("%x", &b[e].w[i]);
    }
    for (auto& o : out)
      for (int i = 0; i < 8; i++) o.w[i] = 0xdeadbeefu;
    for (long long blk = 0; blk < blocks; blk++)
      for (int t = 0; t < threads; t++)
        mont_repeat_elems<Mod, K>(
            n, blk * tile + t, threads, reps,
            [&](long long i, Fe& x, Fe& y) { x = a[i]; y = b[i]; },
            [&](long long i, const Fe& x) { out[i] = x; });
    long long past = 0;
    for (long long e = n; e < blocks * tile; e++)
      for (int i = 0; i < 8; i++) past += out[e].w[i] != 0xdeadbeefu;
    for (long long e = 0; e < n; e++) {
      for (int i = 0; i < 8; i++) printf("%x ", out[e].w[i]);
      printf("\n");
    }
    printf("past %lld\n", past);
  }
}
int main() {
  for (int i = 0; i < 8; i++) scanf("%x", &Mod::P[i]);
  scanf("%x", &Mod::INV);
  int k, threads, jobs;
  scanf("%d %d %d", &k, &threads, &jobs);
  if (k == 1) run<1>(threads, jobs);
  if (k == 2) run<2>(threads, jobs);
  if (k == 4) run<4>(threads, jobs);
  return 0;
}
"""
THREADS = 4            # the harness's block: tails at small counts


@pytest.fixture(scope="module")
def repeat_binary(tmp_path_factory):
    """The harness, with the body at K = 1, 2 and 4 elements a thread."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the host model")
    d = tmp_path_factory.mktemp("mont_repeat")
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(REPEAT_HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-I", CSRC, "-o", str(exe),
                    str(src)], check=True, capture_output=True, timeout=120)
    return str(exe)


@pytest.mark.parametrize("k", [1, 2, 4], ids=lambda k: f"K{k}")
@pytest.mark.parametrize("F", [BN254_FR, BN254_FQ], ids=["fr", "fq"])
def test_mont_repeat_body_matches_plain(repeat_binary, F, k):
    """reps 0, 1, 2 and 7 on 3 K THREADS + 3 elements (a tail: not a
    multiple of K, the last block part full) and on 3 (below one block),
    against reps calls of kernel A's plain product and python integers;
    nothing written past n."""
    exe = repeat_binary
    p = F.p
    inv = (-pow(p, -1, 1 << 32)) % (1 << 32)
    r_inv = pow(1 << 256, -1, p)
    jobs, text = [], []
    for n in (3 * k * THREADS + 3, 3):
        a = alu_probe.random_elems(F, n, 5 + n, "cpu")
        b = alu_probe.random_elems(F, n, 6 + n, "cpu")
        for reps in (0, 1, 2, 7):
            jobs.append((a, b, reps))
            text.append(f"{reps} {n}\n" + "\n".join(
                f"{_words(x)} {_words(y)}"
                for x, y in zip(_ints(a), _ints(b))))
    out = subprocess.run([exe], input=f"{_words(p)} {inv:x}\n{k} {THREADS} "
                         f"{len(jobs)}\n" + "\n".join(text),
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.split("\n")
    for a, b, reps in jobs:
        n = a.shape[0]
        rows, past, out = out[:n], out[n], out[n + 1:]
        assert past == "past 0", (k, F.name, n, reps)
        got = [sum(int(t, 16) << (32 * i) for i, t in enumerate(r.split()))
               for r in rows]
        want = alu_probe.mont_repeat_plain(F, a, b, reps)
        assert got == _ints(want), (k, F.name, n, reps)
        assert got == [x * pow(y * r_inv, reps, p) % p
                       for x, y in zip(_ints(a), _ints(b))]


def _ints(t) -> list:
    """(n, 8) int32 words -> python integers."""
    w = t.to(torch.int64) & 0xFFFFFFFF
    return [sum(int(v) << (32 * i) for i, v in enumerate(r)) for r in w]


def _words(x: int) -> str:
    return " ".join(f"{(x >> (32 * i)) & 0xFFFFFFFF:x}" for i in range(8))


@pytest.mark.parametrize("F", [BN254_FR, BN254_FQ, PASTA_FP, PASTA_FQ],
                         ids=["fr", "fq", "pasta-fp", "pasta-fq"])
def test_chain_product_matches_integers(chain_binary, F):
    """The product, and kernel C's sum and difference, of each pair."""
    p = F.p
    rng = np.random.default_rng(3)
    edge = [0, 1, 2, p - 1, p - 2, (1 << 255) % p]
    rand = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(600)]
    pairs = [(a, b) for a in edge for b in edge] + \
        list(zip(rand[:300], rand[300:])) + [(a, p - 1) for a in rand[:50]]
    inv = (-pow(p, -1, 1 << 32)) % (1 << 32)
    text = f"{_words(p)} {inv:x}\n{len(pairs)}\n" + "\n".join(
        f"{_words(a)} {_words(b)}" for a, b in pairs)
    out = subprocess.run([chain_binary], input=text, capture_output=True,
                         text=True, check=True, timeout=60).stdout.split("\n")
    r_inv = pow(1 << 256, -1, p)
    for (a, b), line in zip(pairs, out):
        w = [int(t, 16) for t in line.split()]
        got = [sum(x << (32 * i) for i, x in enumerate(w[k:k + 8]))
               for k in (0, 8, 16)]
        assert got == [a * b * r_inv % p, (a + b) % p, (a - b) % p], \
            (hex(a), hex(b))


SASS = """
	code for sm_90a
		Function : _Z15k_stream_bucketI7Bn254G1EvPKiPKjS0_iiP5uint4Pi
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
        /*0010*/                   IMAD.MOV.U32 R4, RZ, RZ, 0x1 ;          /* 0x000fe200078e00ff */
        /*0020*/                   IMAD R5, R2, R3, RZ ;                  /* 0x0000000302057224 */
        /*0030*/                   IMAD.WIDE.U32 R6, R2, R3, R4 ;         /* 0x0000000302067225 */
        /*0040*/                   IMAD.HI.U32 R8, R2, R3, RZ ;           /* 0x0000000302087227 */
        /*0050*/               @P0 IMAD.X R9, RZ, RZ, R9, P1 ;            /* 0x000000ffff097224 */
        /*0060*/                   IMAD.SHL.U32 R10, R2, 0x4, RZ ;        /* 0x0000000402107824 */
        /*0070*/              @!P2 BRA 0x30 ;                             /* 0x0000000000007947 */
        /*0080*/                   IMAD.IADD R11, R2, 0x1, R3 ;           /* 0x000000010203b824 */
        /*0090*/                   IMAD R12, R2, R3, RZ ;                 /* 0x000000030205c224 */
        /*00a0*/                   BRA 0xa0 ;                             /* 0xfffffffc00fc7947 */
		Function : _Z16k_u32_mul_repeatPKjS0_Pjxi
        /*0000*/                   IMAD R2, R2, R3, 0x1 ;                 /* 0x0000000102027424 */
        /*0010*/                   EXIT ;                                 /* 0x000000000000794d */
"""


def test_parse_sass_counts_kinds_and_loops():
    """Multiplies by kind per function and per loop (a branch back to an
    earlier address); moves (IMAD.MOV / IADD / SHL) are not multiplies."""
    rep = card.parse_sass(SASS)
    fn = rep["_Z15k_stream_bucketI7Bn254G1EvPKiPKjS0_iiP5uint4Pi"]
    assert fn["kinds"] == {"IMAD": 2, "IMAD.WIDE": 1, "IMAD.HI": 1,
                           "IMAD.X": 1}
    assert fn["loops"] == [dict(start=0x30, end=0x70, kinds={
        "IMAD.WIDE": 1, "IMAD.HI": 1, "IMAD.X": 1})]
    assert rep["_Z16k_u32_mul_repeatPKjS0_Pjxi"] == dict(
        kinds={"IMAD": 1}, loops=[])
    assert [card.imad_kind(op) for op in (
        "IMAD.MOV.U32", "IMAD.WIDE.U32.X", "IMAD.HI.U32", "IADD3", "IMAD")] \
        == [None, "IMAD.WIDE", "IMAD.HI", None, "IMAD"]
