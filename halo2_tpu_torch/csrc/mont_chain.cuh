// Montgomery product as PTX carry chains: the product of every curve body
// in arith.cuh (kernels B, D, 8 and 9) and of kernel C, whose sums and
// differences are the carry chains at the end of this file.
//
// fe_mul_chain<M>(a, b) = a b 2^-256 mod p for canonical a, b < p, returned
// canonical (< p): the same words as arith.cuh's fe_mul.  It is CIOS over 8
// x 32-bit words with the accumulator split in two, X aligned at word 0 and
// Y at word 1 (value X + 2^32 Y), so that every 32 x 32 product lands as a
// lo / hi pair on two neighbouring words of ONE carry chain:
//
//   X += a_j b_i   (j even: words j, j + 1)    Y += a_j b_i   (j odd)
//   m = X[0] (-p^-1)
//   X += m p_j     (j even)                   Y += m p_j     (j odd)
//   divide by 2^32: X[0] is 0, so the value is X[1..8] + Y; the next row
//   takes Y as its X and X[2..8] as its Y, adding X[1] into its X[0] with a
//   carry into the Y chain, which is rebuilt from X[2..8] while the odd
//   products go in.
//
// Each chain is mad.lo.cc / madc.hi.cc on the same two operands, the pair
// ptxas can issue as one wide multiply-add with carry.  fe_mul's C form
// instead leaves nvcc to build each product and its 64-bit accumulation.
// Bounds: p < 2^255 and V < 2p at the top of a row, so V + a b_i + m p <
// 2^33 p + 2p < 2^288: X fits 9 words and Y (<= V / 2^32) 8, so the Y chain
// never carries out of its top word; after the last row the result X[1..8]
// + Y < 2p and one conditional subtraction ends it.
//
// The file needs `Fe` (8 words) declared before it, and M::p(i), M::inv() as
// in arith.cuh.  Each primitive also has a host model of the carry flag, so
// that g++ can build the same chain on the CPU (tests/test_torch_mont_chain.py
// holds it against python integers).
#pragma once

#include <cstdint>

#ifndef __CUDACC__
#define __device__
#define __forceinline__ inline
#endif
#ifndef __CUDA_ARCH__
static uint32_t h2_host_cf;   // the carry flag of the host model
#endif

// d = lo(a b) + c, carry out.
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t d;
#ifdef __CUDA_ARCH__
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b),
               "r"(c));
#else
  const uint64_t s = (uint64_t)(uint32_t)(a * b) + c;
  d = (uint32_t)s;
  h2_host_cf = (uint32_t)(s >> 32);
#endif
  return d;
}

// d = lo(a b) + c + carry, carry out.
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
#ifdef __CUDA_ARCH__
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b),
               "r"(c));
#else
  const uint64_t s = (uint64_t)(uint32_t)(a * b) + c + h2_host_cf;
  d = (uint32_t)s;
  h2_host_cf = (uint32_t)(s >> 32);
#endif
  return d;
}

// d = hi(a b) + c, carry out.
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t d;
#ifdef __CUDA_ARCH__
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b),
               "r"(c));
#else
  const uint64_t s = (((uint64_t)a * b) >> 32) + c;
  d = (uint32_t)s;
  h2_host_cf = (uint32_t)(s >> 32);
#endif
  return d;
}

// d = hi(a b) + c + carry, carry out.
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
#ifdef __CUDA_ARCH__
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b),
               "r"(c));
#else
  const uint64_t s = (((uint64_t)a * b) >> 32) + c + h2_host_cf;
  d = (uint32_t)s;
  h2_host_cf = (uint32_t)(s >> 32);
#endif
  return d;
}

// d = hi(a b) + c + carry, no carry out.
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
#ifdef __CUDA_ARCH__
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b),
               "r"(c));
#else
  d = (uint32_t)((((uint64_t)a * b) >> 32) + c + h2_host_cf);
#endif
  return d;
}

// d = a + b, carry out.
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t d;
#ifdef __CUDA_ARCH__
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
#else
  const uint64_t s = (uint64_t)a + b;
  d = (uint32_t)s;
  h2_host_cf = (uint32_t)(s >> 32);
#endif
  return d;
}

// d = a + b + carry, no carry out.
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t d;
#ifdef __CUDA_ARCH__
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
#else
  d = (uint32_t)((uint64_t)a + b + h2_host_cf);
#endif
  return d;
}

// d = a + b + carry, carry out.
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t d;
#ifdef __CUDA_ARCH__
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
#else
  const uint64_t s = (uint64_t)a + b + h2_host_cf;
  d = (uint32_t)s;
  h2_host_cf = (uint32_t)(s >> 32);
#endif
  return d;
}

// d = a - b, borrow out.
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t d;
#ifdef __CUDA_ARCH__
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
#else
  d = a - b;
  h2_host_cf = a < b;
#endif
  return d;
}

// d = a - b - borrow, borrow out.
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t d;
#ifdef __CUDA_ARCH__
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
#else
  const uint64_t s = (uint64_t)a - b - h2_host_cf;
  d = (uint32_t)s;
  h2_host_cf = (uint32_t)(s >> 63);
#endif
  return d;
}

// d = a - b - borrow, no borrow out.
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t d;
#ifdef __CUDA_ARCH__
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
#else
  d = (uint32_t)((uint64_t)a - b - h2_host_cf);
#endif
  return d;
}

// t[0..7] += the products c w[j] for j = first, first + 2, ... as lo / hi
// pairs on words (j - first, j - first + 1), carry out left in the flag.
template <int FIRST>
__device__ __forceinline__ void mad_pairs(uint32_t t[8], const uint32_t w[8],
                                          uint32_t c) {
  t[0] = mad_lo_cc(w[FIRST], c, t[0]);
  t[1] = madc_hi_cc(w[FIRST], c, t[1]);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    t[j] = madc_lo_cc(w[FIRST + j], c, t[j]);
    t[j + 1] = madc_hi_cc(w[FIRST + j], c, t[j + 1]);
  }
}

template <class M>
__device__ __forceinline__ Fe fe_mul_chain(const Fe& a, const Fe& b) {
  uint32_t p[8];
#pragma unroll
  for (int j = 0; j < 8; j++) p[j] = M::p(j);
  uint32_t x[8], y[8], x8 = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) x[j] = y[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint32_t bi = b.w[i];
    // the shift of the previous row, fused with the odd products
    uint32_t nx[8], ny[8];
#pragma unroll
    for (int j = 0; j < 8; j++) nx[j] = y[j];
    nx[0] = add_cc(nx[0], x[1]);
#pragma unroll
    for (int j = 0; j < 6; j += 2) {
      ny[j] = madc_lo_cc(a.w[j + 1], bi, x[j + 2]);
      ny[j + 1] = madc_hi_cc(a.w[j + 1], bi, x[j + 3]);
    }
    ny[6] = madc_lo_cc(a.w[7], bi, x8);
    ny[7] = madc_hi(a.w[7], bi, 0);
    mad_pairs<0>(nx, a.w, bi);
    x8 = addc(0, 0);
    const uint32_t m = nx[0] * M::inv();
    mad_pairs<0>(nx, p, m);
    x8 = addc(x8, 0);
    mad_pairs<1>(ny, p, m);
#pragma unroll
    for (int j = 0; j < 8; j++) {
      x[j] = nx[j];
      y[j] = ny[j];
    }
  }
  // X[1..8] + Y, then subtract p unless that borrows.
  uint32_t t[8];
  t[0] = add_cc(y[0], x[1]);
#pragma unroll
  for (int j = 1; j < 7; j++) t[j] = addc_cc(y[j], x[j + 1]);
  t[7] = addc(y[7], x8);
  Fe d;
  d.w[0] = sub_cc(t[0], M::p(0));
#pragma unroll
  for (int j = 1; j < 8; j++) d.w[j] = subc_cc(t[j], M::p(j));
  const uint32_t keep = subc(0, 0);      // all ones when t < p
#pragma unroll
  for (int j = 0; j < 8; j++) d.w[j] = keep ? t[j] : d.w[j];
  return d;
}

// a + b mod p and a - b mod p for canonical a, b < p < 2^255 as carry
// chains: the sum or difference, then p subtracted (kept unless that
// borrows) or added back (when the difference borrowed).
template <class M>
__device__ __forceinline__ Fe fe_add_chain(const Fe& a, const Fe& b) {
  uint32_t s[8];
  s[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < 7; j++) s[j] = addc_cc(a.w[j], b.w[j]);
  s[7] = addc(a.w[7], b.w[7]);
  Fe d;
  d.w[0] = sub_cc(s[0], M::p(0));
#pragma unroll
  for (int j = 1; j < 8; j++) d.w[j] = subc_cc(s[j], M::p(j));
  const uint32_t keep = subc(0, 0);      // all ones when s < p
#pragma unroll
  for (int j = 0; j < 8; j++) d.w[j] = keep ? s[j] : d.w[j];
  return d;
}

template <class M>
__device__ __forceinline__ Fe fe_sub_chain(const Fe& a, const Fe& b) {
  Fe d;
  d.w[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < 8; j++) d.w[j] = subc_cc(a.w[j], b.w[j]);
  const uint32_t back = subc(0, 0);      // all ones when a < b
  d.w[0] = add_cc(d.w[0], M::p(0) & back);
#pragma unroll
  for (int j = 1; j < 7; j++) d.w[j] = addc_cc(d.w[j], M::p(j) & back);
  d.w[7] = addc(d.w[7], M::p(7) & back);
  return d;
}
