// Kernel C: base Stockham radix-2 NTT over BN254 Fr, Pasta Fp or Pasta Fq,
// in shared memory.
//
// Replaces the JAX reference's ntt/fused.py::_base_ntt: a self-sorting (Stockham)
// radix-2 transform with natural order in and out and per-stage EXPANDED
// twiddles (row t holds w^(r * floor(j / r)) for j < m/2, r = 2^t).  Per
// stage: split the axis into halves a / b, s = a + b, d = (a - b) * w (the
// last stage's twiddles are all 1), written interleaved as (l, 2, r) -> m.
//
// Layout: x is (outer, m, inner) elements of 8 words; the transform runs
// along the middle axis, so the four-step composition in ntt/fused.py needs
// no transpose before its first pass.  One block per (outer, inner) pair
// with m/2 threads, one butterfly per thread per stage.  The whole
// transform (m <= 1024 elements = 32 KB) sits in shared memory, in place:
// every thread reads its pair, the block synchronises, then every thread
// writes its pair.
//
// Bound on the H100: integer ALU inside the block (one Montgomery multiply
// per butterfly, log m stages) and, across the four-step, the passes over
// device memory that each base call costs (one read and one write of the
// data).  Sizing the base to shared memory (m = 1024, not the TPU's 128)
// halves the number of such passes for 2^18..2^20.  A strided element is 32
// contiguous bytes, i.e. one whole sector, so the strided loads waste no
// DRAM bandwidth.
#include "arith.cuh"

template <class M>
__global__ void k_ntt_base(const uint4* __restrict__ x, uint4* __restrict__ out,
                           const uint4* __restrict__ table, int log_m,
                           long long inner) {
  extern __shared__ uint4 sm[];  // m elements, 2 x uint4 each
  const int m = 1 << log_m;
  const int half = m >> 1;
  const long long blk = blockIdx.x;
  const long long o = blk / inner;
  const long long ii = blk - o * inner;
  const long long base = o * (long long)m * inner + ii;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const long long e = base + (long long)j * inner;
    sm[2 * j] = x[2 * e];
    sm[2 * j + 1] = x[2 * e + 1];
  }
  __syncthreads();
  const int j = threadIdx.x;
  for (int t = 0; t < log_m; t++) {
    Fe a, b;
    a.w[0] = sm[2 * j].x; a.w[1] = sm[2 * j].y; a.w[2] = sm[2 * j].z;
    a.w[3] = sm[2 * j].w; a.w[4] = sm[2 * j + 1].x; a.w[5] = sm[2 * j + 1].y;
    a.w[6] = sm[2 * j + 1].z; a.w[7] = sm[2 * j + 1].w;
    const int k = j + half;
    b.w[0] = sm[2 * k].x; b.w[1] = sm[2 * k].y; b.w[2] = sm[2 * k].z;
    b.w[3] = sm[2 * k].w; b.w[4] = sm[2 * k + 1].x; b.w[5] = sm[2 * k + 1].y;
    b.w[6] = sm[2 * k + 1].z; b.w[7] = sm[2 * k + 1].w;
    const Fe s = fe_add<M>(a, b);
    Fe d = fe_sub<M>(a, b);
    if (t < log_m - 1) {
      d = fe_mul<M>(d, fe_load(table, (long long)t * half + j));
    }
    __syncthreads();
    const int r = 1 << t;
    const int li = j >> t;
    const int ri = j & (r - 1);
    const int ps = li * 2 * r + ri;
    const int pd = ps + r;
    sm[2 * ps] = make_uint4(s.w[0], s.w[1], s.w[2], s.w[3]);
    sm[2 * ps + 1] = make_uint4(s.w[4], s.w[5], s.w[6], s.w[7]);
    sm[2 * pd] = make_uint4(d.w[0], d.w[1], d.w[2], d.w[3]);
    sm[2 * pd + 1] = make_uint4(d.w[4], d.w[5], d.w[6], d.w[7]);
    __syncthreads();
  }
  for (int jj = threadIdx.x; jj < m; jj += blockDim.x) {
    const long long e = base + (long long)jj * inner;
    out[2 * e] = sm[2 * jj];
    out[2 * e + 1] = sm[2 * jj + 1];
  }
}

// x, out: (outer, 2^log_m, inner) elements; table: (max(log_m,1), m/2)
// elements.  1 <= log_m <= 10; field: the id of arith.cuh's with_field.
// Returns cudaGetLastError().
extern "C" int h2_ntt_base(int field, const void* x, void* out,
                           const void* table, int log_m, long long outer,
                           long long inner, void* stream) {
  if (outer > 0 && inner > 0) {
    const int m = 1 << log_m;
    const long long blocks = outer * inner;
    with_field(field, [&](auto f) {
      k_ntt_base<decltype(f)>
          <<<(unsigned int)blocks, m / 2, m * 32, (cudaStream_t)stream>>>(
              (const uint4*)x, (uint4*)out, (const uint4*)table, log_m,
              inner);
    });
  }
  return (int)cudaGetLastError();
}
