// Kernels 10/11 and 12: the integer-ALU rate probes.
//
// Kernel 10/11, k_mont_repeat<M>: `reps` dependent Montgomery products
// a <- a b per element, in registers, inside one kernel.  Replaces the
// JAX reference's bench.py `mul_alu_kernel` (its pallas_call at bench.py:249,
// over BN254 Fr: row 10) and tools/alu_probe.py::mont_repeat (:56, over
// BN254 Fq: row 11).  The product is arith.cuh's 8 x 32-bit CIOS, not the
// reference's 16 x 16-bit body: the two agree on canonical inputs (< p),
// which is all the port feeds it.
//
// Kernel 12, k_u32_mul_repeat: the dependent chain v <- v b + 1 (wrapping
// 32-bit), `reps` times per lane.  Replaces tools/alu_probe.py::
// u32_mul_repeat (:81).  One step is one IMAD, so its rate is the card's
// integer multiply-add issue rate.
//
// Bound on the H100: integer multiplies.  Each element is read once and
// written once; for reps >> 1 every cycle goes to the loop in registers.
// Design: one thread per element with a grid-stride loop; the many resident
// warps hide the latency of each thread's dependent chain.  The Montgomery
// loop is kept rolled so the SASS of k_mont_repeat holds one product (its
// multiply count is the bound's count per product); the u32 loop is unrolled
// so loop control does not take the issue slots the IMADs need.
#include "arith.cuh"

template <class M>
__global__ void k_mont_repeat(const uint4* __restrict__ a,
                              const uint4* __restrict__ b,
                              uint4* __restrict__ out, long long n, int reps) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    Fe x = fe_load(a, i);
    const Fe y = fe_load(b, i);
#pragma unroll 1
    for (int r = 0; r < reps; r++) x = fe_mul<M>(x, y);
    fe_store(out, i, x);
  }
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

template <class M>
static void launch_mont_repeat(const uint4* a, const uint4* b, uint4* out,
                               long long n, int reps, cudaStream_t s) {
  const int threads = 256;
  k_mont_repeat<M><<<h2_blocks(n, threads), threads, 0, s>>>(a, b, out, n,
                                                            reps);
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

// a, b, out: n 32-bit lanes.  Returns cudaGetLastError().
extern "C" int h2_u32_mul_repeat(const void* a, const void* b, void* out,
                                 long long n, int reps, void* stream) {
  if (n > 0) {
    const int threads = 256;
    k_u32_mul_repeat<<<h2_blocks(n, threads), threads, 0,
                       (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, reps);
  }
  return (int)cudaGetLastError();
}
