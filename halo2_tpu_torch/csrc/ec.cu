// Kernel B: BN254 G1 complete add / mixed add / double, one thread per point.
//
// Replaces halo2_tpu/curves/pallas_ec.py::ec_add (_add_body_ec), ec_madd
// (_madd_body_ec, with the per-lane q_inf pass-through) and ec_double
// (_double_body), whose x3b chain is _mul_b3_body with b3 = 9.
//
// Bound on the H100: integer ALU.  An add is 12 Montgomery multiplies plus
// ~20 adds/subs (~2,000 instructions) against 192-288 bytes moved, far above
// the card's ops-per-byte balance.  Design: the whole formula stays in
// registers in one thread (the formulas are complete, so no lane branches),
// points are loaded and stored as 16-byte vectors, and a grid-stride loop
// covers any batch.  Register pressure, not memory, limits occupancy; the
// multiply itself (bn254.cuh) is the place later work will tune.
#include "bn254.cuh"

__global__ void k_ec_add(const uint4* __restrict__ p, const uint4* __restrict__ q,
                         uint4* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    pt_store(out, i, ec_add_body(pt_load(p, i), pt_load(q, i)));
  }
}

__global__ void k_ec_madd(const uint4* __restrict__ p, const uint4* __restrict__ q,
                          const uint8_t* __restrict__ q_inf,
                          uint4* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const Fe x2 = fe_load(q, 2 * i);
    const Fe y2 = fe_load(q, 2 * i + 1);
    pt_store(out, i, ec_madd_body(pt_load(p, i), x2, y2, q_inf[i] != 0));
  }
}

__global__ void k_ec_double(const uint4* __restrict__ p, uint4* __restrict__ out,
                            long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    pt_store(out, i, ec_double_body(pt_load(p, i)));
  }
}

// op: 0 add (p, q projective), 1 madd (q affine (n, 2, 8) + q_inf bytes),
// 2 double (q, q_inf unused).  Returns cudaGetLastError().
extern "C" int h2_ec_op(int op, const void* p, const void* q,
                        const void* q_inf, void* out, long long n,
                        void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 128;
    const unsigned int blocks = h2_blocks(n, threads);
    if (op == 0) {
      k_ec_add<<<blocks, threads, 0, s>>>((const uint4*)p, (const uint4*)q,
                                          (uint4*)out, n);
    } else if (op == 1) {
      k_ec_madd<<<blocks, threads, 0, s>>>((const uint4*)p, (const uint4*)q,
                                           (const uint8_t*)q_inf, (uint4*)out,
                                           n);
    } else {
      k_ec_double<<<blocks, threads, 0, s>>>((const uint4*)p, (uint4*)out, n);
    }
  }
  return (int)cudaGetLastError();
}
