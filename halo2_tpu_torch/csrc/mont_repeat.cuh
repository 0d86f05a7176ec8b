// The per-thread body of kernel 10/11 (alu.cu::k_mont_repeat): `reps`
// dependent Montgomery products x <- x y on each of K elements, the K
// products of one rep written one after the other so that ptxas has K
// independent carry chains to interleave.
//
// The product is mont_chain.cuh's fe_mul_chain, the one kernels B, C, D, 8
// and 9 run, so the rate this kernel measures is the rate of the product
// the port's MSMs and NTT are made of.  Like mont_chain.cuh, the file
// builds with g++ on the host model of the carry flag
// (tests/test_torch_mont_chain.py holds it against python integers).
#pragma once

#include "mont_chain.cuh"

// This thread's elements are i = first + k step, k < K, of n.  load(i, x,
// y) reads element i's operands, store(i, x) writes its result.  Past n a
// chain runs on element n - 1 (loads clamped) and stores nothing, so the
// last block needs no other code path.
template <class M, int K, class Load, class Store>
__device__ __forceinline__ void mont_repeat_elems(long long n, long long first,
                                                  long long step, int reps,
                                                  Load load, Store store) {
  if (first >= n) return;
  Fe x[K], y[K];
#pragma unroll
  for (int k = 0; k < K; k++) {
    const long long i = first + k * step;
    load(i < n ? i : n - 1, x[k], y[k]);
  }
#pragma unroll 1
  for (int r = 0; r < reps; r++) {
#pragma unroll
    for (int k = 0; k < K; k++) x[k] = fe_mul_chain<M>(x[k], y[k]);
  }
#pragma unroll
  for (int k = 0; k < K; k++) {
    const long long i = first + k * step;
    if (i < n) store(i, x[k]);
  }
}
