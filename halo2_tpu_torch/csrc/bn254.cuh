// Shared BN254 arithmetic for the port's Hopper kernels.
//
// Element format: 8 little-endian 32-bit words holding the Montgomery value
// a * 2^256 mod p (the same R = 2^256 as the JAX reference), canonical < p.
// Field ops are CIOS Montgomery multiplication over 8 x 32-bit limbs with
// 64-bit products (IMAD.WIDE on Hopper), modular add and sub; the curve
// bodies are the Renes-Costello-Batina complete formulas (eprint 2015/1060,
// Algs 7-9, a = 0, b3 = 9 for BN254 G1) in exactly the operation order of
// halo2_tpu/curves/pallas_ec.py, so a kernel and its plain PyTorch version
// produce identical projective coordinates.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct Fe {
  uint32_t w[8];
};

// Moduli as functions of a constant index: after unrolling, every word is an
// immediate operand.
struct FrMod {
  static __device__ __forceinline__ uint32_t p(int i) {
    switch (i) {
      case 0: return 0xf0000001u; case 1: return 0x43e1f593u;
      case 2: return 0x79b97091u; case 3: return 0x2833e848u;
      case 4: return 0x8181585du; case 5: return 0xb85045b6u;
      case 6: return 0xe131a029u; default: return 0x30644e72u;
    }
  }
  static __device__ __forceinline__ uint32_t inv() { return 0xefffffffu; }
};

struct FqMod {
  static __device__ __forceinline__ uint32_t p(int i) {
    switch (i) {
      case 0: return 0xd87cfd47u; case 1: return 0x3c208c16u;
      case 2: return 0x6871ca8du; case 3: return 0x97816a91u;
      case 4: return 0x8181585du; case 5: return 0xb85045b6u;
      case 6: return 0xe131a029u; default: return 0x30644e72u;
    }
  }
  static __device__ __forceinline__ uint32_t inv() { return 0xe4866389u; }
  // R mod q: the Montgomery form of 1 (the identity's Y coordinate).
  static __device__ __forceinline__ uint32_t one(int i) {
    switch (i) {
      case 0: return 0xc58f0d9du; case 1: return 0xd35d438du;
      case 2: return 0xf5c70b3du; case 3: return 0x0a78eb28u;
      case 4: return 0x7879462cu; case 5: return 0x666ea36fu;
      case 6: return 0x9a07df2fu; default: return 0x0e0a77c1u;
    }
  }
};

// t (8 words) plus hi * 2^256, known < 2p: subtract p once if t >= p.
template <class M>
__device__ __forceinline__ Fe fe_cond_sub(const uint32_t t[8], uint32_t hi) {
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t v = (uint64_t)t[i] - M::p(i) - borrow;
    d.w[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  const bool take = (hi != 0) || (borrow == 0);
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = take ? d.w[i] : t[i];
  return r;
}

template <class M>
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)t[j] + (uint64_t)a.w[j] * b.w[i];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * M::inv();
    c = ((uint64_t)t[0] + (uint64_t)m * M::p(0)) >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      c += (uint64_t)t[j] + (uint64_t)m * M::p(j);
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  return fe_cond_sub<M>(t, t[8]);
}

template <class M>
__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  uint32_t s[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.w[i] + b.w[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  return fe_cond_sub<M>(s, (uint32_t)c);
}

template <class M>
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe d, f;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t v = (uint64_t)a.w[i] - b.w[i] - borrow;
    d.w[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)d.w[i] + M::p(i);
    f.w[i] = (uint32_t)c;
    c >>= 32;
  }
#pragma unroll
  for (int i = 0; i < 8; i++) d.w[i] = borrow ? f.w[i] : d.w[i];
  return d;
}

__device__ __forceinline__ Fe fe_load(const uint4* base, long long i) {
  const uint4 lo = base[2 * i], hi = base[2 * i + 1];
  Fe r;
  r.w[0] = lo.x; r.w[1] = lo.y; r.w[2] = lo.z; r.w[3] = lo.w;
  r.w[4] = hi.x; r.w[5] = hi.y; r.w[6] = hi.z; r.w[7] = hi.w;
  return r;
}

__device__ __forceinline__ void fe_store(uint4* base, long long i, const Fe& v) {
  base[2 * i] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  base[2 * i + 1] = make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
}

// ---------------------------------------------------------------------------
// BN254 G1, homogeneous projective (X : Y : Z), identity (0 : 1 : 0).
// ---------------------------------------------------------------------------

struct Pt {
  Fe x, y, z;
};

typedef FqMod Q;

// 3b = 9: 9x = 8x + x, the reference's addition chain.
__device__ __forceinline__ Fe mul_b3(const Fe& x) {
  const Fe x2 = fe_add<Q>(x, x);
  const Fe x4 = fe_add<Q>(x2, x2);
  const Fe x8 = fe_add<Q>(x4, x4);
  return fe_add<Q>(x8, x);
}

// Complete addition, RC15 Alg 7 (pallas_ec._add_body_ec).
__device__ __forceinline__ Pt ec_add_body(const Pt& P, const Pt& R) {
  Fe t0 = fe_mul<Q>(P.x, R.x);
  Fe t1 = fe_mul<Q>(P.y, R.y);
  Fe t2 = fe_mul<Q>(P.z, R.z);
  Fe t3 = fe_mul<Q>(fe_add<Q>(P.x, P.y), fe_add<Q>(R.x, R.y));
  t3 = fe_sub<Q>(t3, fe_add<Q>(t0, t1));
  Fe t4 = fe_mul<Q>(fe_add<Q>(P.y, P.z), fe_add<Q>(R.y, R.z));
  t4 = fe_sub<Q>(t4, fe_add<Q>(t1, t2));
  Fe y3 = fe_mul<Q>(fe_add<Q>(P.x, P.z), fe_add<Q>(R.x, R.z));
  y3 = fe_sub<Q>(y3, fe_add<Q>(t0, t2));
  t0 = fe_add<Q>(fe_add<Q>(t0, t0), t0);
  t2 = mul_b3(t2);
  Fe z3 = fe_add<Q>(t1, t2);
  t1 = fe_sub<Q>(t1, t2);
  y3 = mul_b3(y3);
  Pt out;
  out.x = fe_sub<Q>(fe_mul<Q>(t3, t1), fe_mul<Q>(t4, y3));
  out.y = fe_add<Q>(fe_mul<Q>(y3, t0), fe_mul<Q>(t1, z3));
  out.z = fe_add<Q>(fe_mul<Q>(z3, t4), fe_mul<Q>(t0, t3));
  return out;
}

// Complete mixed addition, RC15 Alg 8 (pallas_ec._madd_body_ec): P plus the
// affine (x2, y2); lanes with q_inf pass P through.
__device__ __forceinline__ Pt ec_madd_body(const Pt& P, const Fe& x2,
                                           const Fe& y2, bool q_inf) {
  Fe t0 = fe_mul<Q>(P.x, x2);
  Fe t1 = fe_mul<Q>(P.y, y2);
  Fe t3 = fe_mul<Q>(fe_add<Q>(x2, y2), fe_add<Q>(P.x, P.y));
  t3 = fe_sub<Q>(t3, fe_add<Q>(t0, t1));
  Fe t4 = fe_add<Q>(fe_mul<Q>(y2, P.z), P.y);
  Fe y3 = fe_add<Q>(fe_mul<Q>(x2, P.z), P.x);
  t0 = fe_add<Q>(fe_add<Q>(t0, t0), t0);
  Fe t2 = mul_b3(P.z);
  Fe z3 = fe_add<Q>(t1, t2);
  t1 = fe_sub<Q>(t1, t2);
  y3 = mul_b3(y3);
  Pt out;
  out.x = fe_sub<Q>(fe_mul<Q>(t3, t1), fe_mul<Q>(t4, y3));
  out.y = fe_add<Q>(fe_mul<Q>(y3, t0), fe_mul<Q>(t1, z3));
  out.z = fe_add<Q>(fe_mul<Q>(z3, t4), fe_mul<Q>(t0, t3));
  return q_inf ? P : out;
}

// Complete doubling, RC15 Alg 9 (pallas_ec._double_body).
__device__ __forceinline__ Pt ec_double_body(const Pt& P) {
  Fe t0 = fe_mul<Q>(P.y, P.y);
  Fe z3 = fe_add<Q>(t0, t0);
  z3 = fe_add<Q>(z3, z3);
  z3 = fe_add<Q>(z3, z3);
  Fe t1 = fe_mul<Q>(P.y, P.z);
  Fe t2 = fe_mul<Q>(P.z, P.z);
  t2 = mul_b3(t2);
  Fe x3 = fe_mul<Q>(t2, z3);
  Fe y3 = fe_add<Q>(t0, t2);
  z3 = fe_mul<Q>(t1, z3);
  t1 = fe_add<Q>(t2, t2);
  t2 = fe_add<Q>(t1, t2);
  t0 = fe_sub<Q>(t0, t2);
  y3 = fe_add<Q>(x3, fe_mul<Q>(t0, y3));
  t1 = fe_mul<Q>(P.x, P.y);
  x3 = fe_mul<Q>(t0, t1);
  x3 = fe_add<Q>(x3, x3);
  Pt out;
  out.x = x3;
  out.y = y3;
  out.z = z3;
  return out;
}

__device__ __forceinline__ Pt pt_load(const uint4* base, long long i) {
  Pt r;
  r.x = fe_load(base, 3 * i);
  r.y = fe_load(base, 3 * i + 1);
  r.z = fe_load(base, 3 * i + 2);
  return r;
}

__device__ __forceinline__ void pt_store(uint4* base, long long i, const Pt& v) {
  fe_store(base, 3 * i, v.x);
  fe_store(base, 3 * i + 1, v.y);
  fe_store(base, 3 * i + 2, v.z);
}

// Grid for an elementwise launch: enough blocks to cover n, capped so a
// grid-stride loop covers the rest.
static inline unsigned int h2_blocks(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  if (b < 1) b = 1;
  if (b > 132LL * 64) b = 132LL * 64;
  return (unsigned int)b;
}
