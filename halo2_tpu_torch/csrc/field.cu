// Kernel A: elementwise BN254 field mul / add / sub.
//
// Replaces halo2_tpu/fields/pallas_ops.py::_binop_pallas (and its limb-major
// twin _binop_pallas_lm): the bodies _mont_mul_body, _add_body, _sub_body and
// _cond_sub_p.  On the TPU the limb layout (limb-last vs limb-major) decided
// which wrapper ran; here an element is 8 contiguous 32-bit words, so one
// kernel serves both.
//
// Bound on the H100: memory.  Each op reads two 32-byte elements and writes
// one (96 B), against ~150 integer instructions for a multiply, well under
// the card's ops-per-byte balance; add and sub are a few dozen.  Design: one
// thread per element, 16-byte vector loads so a warp moves whole 32-byte
// sectors, and a grid-stride loop.  Nothing is kept between launches; fusing
// chains of ops into one pass is later work.
#include "bn254.cuh"

template <class M, int MODE>
__global__ void k_field_binop(const uint4* __restrict__ a,
                              const uint4* __restrict__ b,
                              uint4* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const Fe x = fe_load(a, i);
    const Fe y = fe_load(b, i);
    Fe r;
    if (MODE == 0) {
      r = fe_mul<M>(x, y);
    } else if (MODE == 1) {
      r = fe_add<M>(x, y);
    } else {
      r = fe_sub<M>(x, y);
    }
    fe_store(out, i, r);
  }
}

template <class M>
static void launch_binop(int mode, const uint4* a, const uint4* b, uint4* out,
                         long long n, cudaStream_t s) {
  const int threads = 256;
  const unsigned int blocks = h2_blocks(n, threads);
  if (mode == 0) {
    k_field_binop<M, 0><<<blocks, threads, 0, s>>>(a, b, out, n);
  } else if (mode == 1) {
    k_field_binop<M, 1><<<blocks, threads, 0, s>>>(a, b, out, n);
  } else {
    k_field_binop<M, 2><<<blocks, threads, 0, s>>>(a, b, out, n);
  }
}

// mode: 0 mul, 1 add, 2 sub.  field: 0 = BN254 Fr, 1 = BN254 Fq.
// a, b, out: n elements of 8 words each.  Returns cudaGetLastError().
extern "C" int h2_field_binop(int mode, int field, const void* a,
                              const void* b, void* out, long long n,
                              void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0) {
      launch_binop<FrMod>(mode, (const uint4*)a, (const uint4*)b,
                          (uint4*)out, n, s);
    } else {
      launch_binop<FqMod>(mode, (const uint4*)a, (const uint4*)b,
                          (uint4*)out, n, s);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* h2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
