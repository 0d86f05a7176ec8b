// Kernels 10/11 and 12: the integer-ALU rate probes.
//
// Kernel 10/11, k_mont_repeat<M>: `reps` dependent Montgomery products
// a <- a b per element, in registers, inside one kernel.  Replaces the
// JAX reference's bench.py `mul_alu_kernel` (its pallas_call at bench.py:249,
// over BN254 Fr: row 10) and tools/alu_probe.py::mont_repeat (:56, over
// BN254 Fq: row 11).  The product is mont_chain.cuh's carry-chain
// fe_mul_chain (the product of kernels B, C, D, 8 and 9), not the
// reference's 16 x 16-bit body: the two agree on canonical inputs (< p),
// which is all the port feeds it.
//
// Kernel 12, k_u32_mul_repeat: the dependent chain v <- v b + 1 (wrapping
// 32-bit), `reps` times per lane.  Replaces tools/alu_probe.py::
// u32_mul_repeat (:81).  One step is one IMAD, so its rate is the card's
// integer multiply-add issue rate.  Its wide form, k_wide_mul_repeat, runs
// w_j <- lo(w_j) b + w_j on WIDE_CHAINS 64-bit w_j = a + j instead, each
// step the mad.lo.cc / madc.hi pair on the same operands that fe_mul_chain
// is made of and that ptxas issues as one IMAD.WIDE (written as C, the step
// compiles to an IMAD.WIDE and an IMAD.IADD); the chains are independent so
// that the rate is the multiplier's and not one chain's carry latency.  Its
// lane is the xor of every lo(w_j) and hi(w_j).  The two rates side by side
// say what an IMAD.WIDE costs in issue slots.
//
// Bound on the H100: integer multiplies.  Each element is read once and
// written once; for reps >> 1 every cycle goes to the loop in registers.
// Design of kernel 10: each thread runs MONT_K elements (mont_repeat.cuh),
// element k of a block's tile at k blockDim + threadIdx so that each load
// and store is coalesced, and one block per tile (no grid-stride loop), so
// the only loop in its SASS is the rolled reps loop, which holds exactly
// MONT_K products: its multiply count over MONT_K is the count per product.
// MONT_K independent chains give the scheduler another chain's
// multiply-add to issue while one waits on its carries; the loop turns out
// issue-bound at every K.  The u32 loops are unrolled so loop control does
// not take the issue slots the multiplies need.
#include "arith.cuh"
#include "mont_repeat.cuh"

// Elements a thread of kernel 10 runs.  K = 1, 2 and 4 timed within 1.6% of
// each other at 2^21 x 64 products on an H100 (40, 64 and 96 registers, no
// spill): the loop is bound by the multiplier's issue rate, not by one
// chain's carry latency.  2 keeps two chains to interleave at 64 registers.
constexpr int MONT_K = 2;
constexpr int MONT_THREADS = 256;

template <class M>
__global__ void __launch_bounds__(MONT_THREADS)
    k_mont_repeat(const uint4* __restrict__ a, const uint4* __restrict__ b,
                  uint4* __restrict__ out, long long n, int reps) {
  const long long first =
      (long long)blockIdx.x * MONT_K * MONT_THREADS + threadIdx.x;
  mont_repeat_elems<M, MONT_K>(
      n, first, MONT_THREADS, reps,
      [&](long long i, Fe& x, Fe& y) {
        x = fe_load(a, i);
        y = fe_load(b, i);
      },
      [&](long long i, const Fe& x) { fe_store(out, i, x); });
}

__global__ void k_u32_mul_repeat(const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ out, long long n,
                                 int reps) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t v = a[i];
    const uint32_t m = b[i];
#pragma unroll 16
    for (int r = 0; r < reps; r++) v = v * m + 1u;
    out[i] = v;
  }
}

constexpr int WIDE_CHAINS = 4;

__global__ void k_wide_mul_repeat(const uint32_t* __restrict__ a,
                                  const uint32_t* __restrict__ b,
                                  uint32_t* __restrict__ out, long long n,
                                  int reps) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t lo[WIDE_CHAINS], hi[WIDE_CHAINS];
#pragma unroll
    for (int j = 0; j < WIDE_CHAINS; j++) {
      const uint64_t w = (uint64_t)a[i] + j;
      lo[j] = (uint32_t)w;
      hi[j] = (uint32_t)(w >> 32);
    }
    const uint32_t m = b[i];
#pragma unroll 4
    for (int r = 0; r < reps; r++) {
#pragma unroll
      for (int j = 0; j < WIDE_CHAINS; j++) {
        const uint32_t l = mad_lo_cc(lo[j], m, lo[j]);
        hi[j] = madc_hi(lo[j], m, hi[j]);
        lo[j] = l;
      }
    }
    uint32_t o = 0;
#pragma unroll
    for (int j = 0; j < WIDE_CHAINS; j++) o ^= lo[j] ^ hi[j];
    out[i] = o;
  }
}

template <class M>
static void launch_mont_repeat(const uint4* a, const uint4* b, uint4* out,
                               long long n, int reps, cudaStream_t s) {
  const long long tile = (long long)MONT_K * MONT_THREADS;
  k_mont_repeat<M><<<(unsigned int)((n + tile - 1) / tile), MONT_THREADS, 0,
                     s>>>(a, b, out, n, reps);
}

// field: the id of arith.cuh's with_field.  a, b, out: n elements of 8
// words each.  Returns cudaGetLastError().
extern "C" int h2_mont_repeat(int field, const void* a, const void* b,
                              void* out, long long n, int reps, void* stream) {
  if (n > 0) {
    with_field(field, [&](auto m) {
      launch_mont_repeat<decltype(m)>((const uint4*)a, (const uint4*)b,
                                      (uint4*)out, n, reps,
                                      (cudaStream_t)stream);
    });
  }
  return (int)cudaGetLastError();
}

// Elements each thread of k_mont_repeat runs: its SASS loop's multiplies
// over this are the multiplies per product.
extern "C" int h2_mont_elems_per_thread() { return MONT_K; }

// a, b, out: n 32-bit lanes; wide: the IMAD.WIDE chains.  Returns
// cudaGetLastError().
extern "C" int h2_u32_mul_repeat(const void* a, const void* b, void* out,
                                 long long n, int reps, int wide,
                                 void* stream) {
  if (n > 0) {
    const int threads = 256;
    auto k = wide ? k_wide_mul_repeat : k_u32_mul_repeat;
    k<<<h2_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, reps);
  }
  return (int)cudaGetLastError();
}
