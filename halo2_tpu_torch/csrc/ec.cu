// Kernel B: complete add / mixed add / double on BN254 G1, Pallas and Vesta,
// one thread per point, and the two serial chains built from them, each in
// one launch: double-and-add scalar multiplication and the Horner combine
// of an MSM's per-window sums.
//
// Replaces the JAX reference's curves/pallas_ec.py::ec_add (_add_body_ec),
// ec_madd (_madd_body_ec, with the per-lane q_inf pass-through) and
// ec_double (_double_body), whose x3b chain is _mul_b3_body (b3 = 9 or 15);
// the chains are the reference's compiled loops around them:
// curves/curve.py::Curve.scalar_mul (a lax.scan over 256 bits) and the
// Horner lax.fori_loop of msm/bucket_scan.py (msm_variable and the unbaked
// fixed-base MSM).
//
// Bound on the H100: integer ALU for a batch of thousands of points or more
// (an add is 12 Montgomery products, about 2,000 multiplier instructions,
// against 192-288 bytes moved); below that, latency: a chain is 256 (or
// nw (c + 1)) dependent steps in one thread, and one launch per step would
// cost a launch and a host dispatch per step.  Design: the formulas stay in
// registers in one thread over the carry-chain product (mont_chain.cuh; the
// formulas are complete, so no lane branches), points move as 16-byte
// vectors, a grid-stride loop covers any batch, and each chain keeps its
// accumulator in registers across all its steps, so the reference's
// compiled loops cost one launch here too.
#include "arith.cuh"

template <class C>
__global__ void k_ec_add(const uint4* __restrict__ p, const uint4* __restrict__ q,
                         uint4* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    pt_store(out, i, ec_add_body<C>(pt_load(p, i), pt_load(q, i)));
  }
}

template <class C>
__global__ void k_ec_madd(const uint4* __restrict__ p, const uint4* __restrict__ q,
                          const uint8_t* __restrict__ q_inf,
                          uint4* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const Fe x2 = fe_load(q, 2 * i);
    const Fe y2 = fe_load(q, 2 * i + 1);
    pt_store(out, i, ec_madd_body<C>(pt_load(p, i), x2, y2, q_inf[i] != 0));
  }
}

template <class C>
__global__ void k_ec_double(const uint4* __restrict__ p, uint4* __restrict__ out,
                            long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    pt_store(out, i, ec_double_body<C>(pt_load(p, i)));
  }
}

// [k]P by double-and-add over the bits of canonical k, least significant
// first, as Curve.scalar_mul_plain: at a set bit acc = acc + base, then base
// doubles.  A clear bit leaves acc's words as they are (the plain version's
// torch.where keeps them), and bits above k's top set bit change nothing but
// base, so the loop ends there.  k holds Montgomery scalars of the curve's
// scalar field, one per point (k_step 1) or one for all (k_step 0: the bit
// tests are then uniform across the warp).
template <class C>
__global__ void k_ec_scalar_mul(const uint4* __restrict__ p,
                                const uint4* __restrict__ k, int k_step,
                                uint4* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    Fe s = fe_load(k, k_step * i);
    Fe one;
#pragma unroll
    for (int j = 0; j < 8; j++) one.w[j] = j == 0;
    s = fe_mul_chain<typename C::R>(s, one);          // out of Montgomery form
    int top = -1;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      if (s.w[j]) top = 32 * j + 31 - __clz(s.w[j]);
    }
    Pt base = pt_load(p, i);
    Pt acc = pt_identity<C>();
    uint32_t bits = s.w[0];
    for (int b = 0; b <= top; b++) {
      if (bits & 1u) acc = ec_add_body<C>(acc, base);
      if (b == top) break;
      base = ec_double_body<C>(base);
      bits >>= 1;
      if ((b & 31) == 31) {                   // the next word, by static moves
#pragma unroll
        for (int j = 0; j < 7; j++) s.w[j] = s.w[j + 1];
        bits = s.w[0];
      }
    }
    pt_store(out, i, acc);
  }
}

// sum_w S[w] 2^(c w) for per-window sums S (nw, n, 3, 8), high window
// first, as horner_windows_plain: from the identity, c doublings and one add
// per window; one thread per sum.
template <class C>
__global__ void k_ec_horner(const uint4* __restrict__ per_window, int nw,
                            int c, uint4* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    Pt acc = pt_identity<C>();
    for (int w = nw - 1; w >= 0; w--) {
      for (int j = 0; j < c; j++) acc = ec_double_body<C>(acc);
      acc = ec_add_body<C>(acc, pt_load(per_window, (long long)w * n + i));
    }
    pt_store(out, i, acc);
  }
}

// op: 0 add (p, q projective), 1 madd (q affine (n, 2, 8) + q_inf bytes),
// 2 double (q, q_inf unused); curve: the id of arith.cuh's with_curve.
// Returns cudaGetLastError().
extern "C" int h2_ec_op(int op, int curve, const void* p, const void* q,
                        const void* q_inf, void* out, long long n,
                        void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 128;
    const unsigned int blocks = h2_blocks(n, threads);
    with_curve(curve, [&](auto c) {
      typedef decltype(c) C;
      if (op == 0) {
        k_ec_add<C><<<blocks, threads, 0, s>>>(
            (const uint4*)p, (const uint4*)q, (uint4*)out, n);
      } else if (op == 1) {
        k_ec_madd<C><<<blocks, threads, 0, s>>>(
            (const uint4*)p, (const uint4*)q, (const uint8_t*)q_inf,
            (uint4*)out, n);
      } else {
        k_ec_double<C><<<blocks, threads, 0, s>>>((const uint4*)p,
                                                  (uint4*)out, n);
      }
    });
  }
  return (int)cudaGetLastError();
}

// The chains run few points for many steps: 64 threads a block spread a
// batch of thousands over all SMs.
static const int CHAIN_THREADS = 64;

// [k]P for n points p (n, 3, 8) and Montgomery scalars k, (n, 8) when
// k_step is 1 or (8,) when it is 0; out (n, 3, 8).
extern "C" int h2_ec_scalar_mul(int curve, const void* p, const void* k,
                                int k_step, void* out, long long n,
                                void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned int blocks = h2_blocks(n, CHAIN_THREADS);
    with_curve(curve, [&](auto c) {
      typedef decltype(c) C;
      k_ec_scalar_mul<C><<<blocks, CHAIN_THREADS, 0, s>>>(
          (const uint4*)p, (const uint4*)k, k_step, (uint4*)out, n);
    });
  }
  return (int)cudaGetLastError();
}

// Horner over windows: per_window (nw, n, 3, 8) -> out (n, 3, 8).
extern "C" int h2_ec_horner(int curve, const void* per_window, int nw, int c,
                            void* out, long long n, void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned int blocks = h2_blocks(n, CHAIN_THREADS);
    with_curve(curve, [&](auto cv) {
      typedef decltype(cv) C;
      k_ec_horner<C><<<blocks, CHAIN_THREADS, 0, s>>>(
          (const uint4*)per_window, nw, c, (uint4*)out, n);
    });
  }
  return (int)cudaGetLastError();
}
