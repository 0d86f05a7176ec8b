// Kernel C: one pass of the four-step NTT over BN254 Fr, Pasta Fp or Pasta
// Fq: a natural-order transform of m = 2^log_m <= 1024 points per column,
// in shared memory, with the four-step's element-wise factors folded into
// its loads and stores.
//
// Replaces the JAX reference's ntt/fused.py::_base_ntt (a Stockham radix-2
// transform with natural order in and out) and the XLA passes around it:
// the mid twiddle, the transpose between the two halves of a split, the
// zeta coset pattern and the zero padding of coeff_to_extended, and 1/n
// with the inverse coset pattern and the truncation of extended_to_coeff.
//
// A pass reads column c (a point of up to four batch dims) element j from
// src at  sum_d idx_d src_s[d] + j j_src_s  and writes it to dst at the same
// form over dst_s; the "row" of an element, the same form over src_r / dst_r,
// is its index in the whole transform's input or output:
//   load:  rows >= src_rows read as zero; optionally times load_c[row % 3];
//   store: rows >= dst_rows are not written; optionally times
//          store_c[row % 3], and the mid twiddle w^(j idx_tw mod N) built
//          from two small tables, tw_lo[e mod 2^s] tw_hi[e >> s].
// With those strides the second pass of a split reads its rows of
// (outer, n1, m, inner) and writes the transposed (outer, m, n1, inner)
// itself, so the four-step in ntt/fused.py issues only launches of this
// kernel.  Every factor is a
// product by a fixed element and every product returns canonical words, so
// the output equals the reference's word for word.
//
// Inside a block: C <= min(128, 1024 / m) adjacent columns (fewer when the
// pass has too few columns to give every SM two blocks), C m / 4 threads
// (at least 32, at most 256): one radix-4 step each a round.
// The data sits in shared memory as 8 word planes (plane w holds word w of
// every element), each element at a swizzled index e ^ h(e >> 5), where h
// is a linear map of the 32-element group chosen so that the loads, the
// stores and every radix-4 round's reads and writes are free of bank
// conflicts (checked by simulation for m = 1 .. 1024).  The m/2 compact
// twiddle powers W^e are staged once per block in planes beside them; stage
// t of the Stockham schedule reads W^(r floor(j / r)), r = 2^t.  Each thread
// does one radix-4 step a round: two Stockham stages in registers (four
// elements, at most four products, none where the twiddle is 1), then one
// shared-memory round trip; an odd log_m ends with a radix-2 stage whose
// twiddles are all 1.  Products, sums and differences are mont_chain.cuh's
// carry chains (fewer registers and instructions than arith.cuh's C forms:
// 3 blocks of 256 threads fit an SM).
//
// Bound on the H100: the multiplier (about log2(m) / 2 products per element
// a pass, plus the folded factors), not the bytes: a pass reads and writes
// each element once, 32 contiguous bytes, one sector.  Measured on one
// H100 (700 W) it runs at about a quarter of that bound: a radix-4 round
// is about 1,500 SASS instructions for 558 multiplies, and a thread's
// products follow one another on the one carry flag.
#include "arith.cuh"

#define NTT_THREADS 256
#define NTT_ELEMS 1024   // elements a block holds
#define NTT_MAX_COLS 128
#define NTT_MAX_DIMS 4

// Every field 8 bytes: the ctypes mirror in ntt/fused.py has the same layout.
struct NttArgs {
  const uint4* src;
  uint4* dst;
  const uint4* pw;        // W^e for e < max(m / 2, 1)
  const uint4* load_c;    // 3 elements, or null
  const uint4* store_c;   // 3 elements, or null
  const uint4* tw_lo;     // mid twiddle tables, or null
  const uint4* tw_hi;
  long long log_m, ndims;
  long long size[NTT_MAX_DIMS];
  long long src_s[NTT_MAX_DIMS], src_r[NTT_MAX_DIMS];
  long long dst_s[NTT_MAX_DIMS], dst_r[NTT_MAX_DIMS];
  long long j_src_s, j_src_r, j_dst_s, j_dst_r;
  long long src_rows, dst_rows;
  long long tw_dim, tw_log_lo, tw_mask;
  long long cols, log_cols_per_block, load_cols_fast, store_cols_fast;
};

__device__ __forceinline__ int ntt_swz(int e) {
  const int b = (e >> 5) & 31;
  return e ^ ((b & 28) ^ ((b & 1) ? 21 : 0) ^ ((b & 2) ? 27 : 0));
}

__device__ __forceinline__ Fe plane_get(const uint32_t* s, int stride, int i) {
  Fe r;
#pragma unroll
  for (int w = 0; w < 8; w++) r.w[w] = s[w * stride + i];
  return r;
}

__device__ __forceinline__ void plane_put(uint32_t* s, int stride, int i,
                                          const Fe& v) {
#pragma unroll
  for (int w = 0; w < 8; w++) s[w * stride + i] = v.w[w];
}

template <class M>
__global__ void __launch_bounds__(NTT_THREADS, 3) k_ntt(const NttArgs a) {
  extern __shared__ __align__(16) unsigned char ntt_smem[];
  const int log_m = (int)a.log_m;
  const int m = 1 << log_m;
  const int log_c = (int)a.log_cols_per_block;
  const int C = 1 << log_c;
  const int E = C << log_m;
  const int H = m > 1 ? m >> 1 : 1;
  long long* c_src = (long long*)ntt_smem;
  long long* c_srow = c_src + C;
  long long* c_dst = c_srow + C;
  long long* c_drow = c_dst + C;
  long long* c_tw = c_drow + C;
  uint32_t* sm = (uint32_t*)(c_tw + C);   // 8 planes of E words
  uint32_t* tw = sm + 8 * E;              // 8 planes of H words
  const int tid = threadIdx.x;
  const long long col0 = (long long)blockIdx.x << log_c;
  const long long left = a.cols - col0;
  const int ncols = left < C ? (int)left : C;

  for (int c = tid; c < ncols; c += blockDim.x) {
    unsigned int idx = (unsigned int)(col0 + c);   // cols < 2^31
    long long so = 0, sr = 0, dof = 0, dr = 0, ti = 0;
#pragma unroll
    for (int d = 0; d < NTT_MAX_DIMS; d++) {
      if (d >= (int)a.ndims) break;
      const unsigned int size = (unsigned int)a.size[d];
      const long long i = idx % size;
      idx /= size;
      so += i * a.src_s[d];
      sr += i * a.src_r[d];
      dof += i * a.dst_s[d];
      dr += i * a.dst_r[d];
      if (d == (int)a.tw_dim) ti = i;
    }
    c_src[c] = so;
    c_srow[c] = sr;
    c_dst[c] = dof;
    c_drow[c] = dr;
    c_tw[c] = ti;
  }
  for (int e = tid; e < H; e += blockDim.x) plane_put(tw, H, e, fe_load(a.pw, e));
  __syncthreads();

  for (int t = tid; t < E; t += blockDim.x) {
    int c, j;
    if (a.load_cols_fast) {
      c = t & (C - 1);
      j = t >> log_c;
    } else {
      c = t >> log_m;
      j = t & (m - 1);
    }
    if (c >= ncols) continue;
    const long long row = c_srow[c] + j * a.j_src_r;
    Fe v;
    if (row < a.src_rows) {
      v = fe_load(a.src, c_src[c] + j * a.j_src_s);
      if (a.load_c != nullptr)
        v = fe_mul_chain<M>(v, fe_load(a.load_c, (long long)((unsigned long long)row % 3)));
    } else {
#pragma unroll
      for (int w = 0; w < 8; w++) v.w[w] = 0;
    }
    plane_put(sm, E, ntt_swz((c << log_m) + j), v);
  }
  __syncthreads();

  // Radix-4 rounds: Stockham stages t and t + 1 on the four elements
  // j0 + k m/4 (j0 < m/4), written to 4 r l + q + k r (j0 = r l + q).
  int t = 0;
  for (; t + 1 < log_m; t += 2) {
    const int q4 = m >> 2;
    const int r = 1 << t;
    const bool act = tid < (E >> 2);
    const int c = tid >> (log_m - 2);
    const int j0 = tid & (q4 - 1);
    const int l = j0 >> t;
    const int base = c << log_m;
    Fe o0, o1, o2, o3;
    if (act) {
      const Fe a0 = plane_get(sm, E, ntt_swz(base + j0));
      const Fe a1 = plane_get(sm, E, ntt_swz(base + j0 + q4));
      const Fe a2 = plane_get(sm, E, ntt_swz(base + j0 + 2 * q4));
      const Fe a3 = plane_get(sm, E, ntt_swz(base + j0 + 3 * q4));
      const Fe s0 = fe_add_chain<M>(a0, a2);
      Fe d0 = fe_sub_chain<M>(a0, a2);
      const Fe s1 = fe_add_chain<M>(a1, a3);
      Fe d1 = fe_sub_chain<M>(a1, a3);
      if (l != 0) d0 = fe_mul_chain<M>(d0, plane_get(tw, H, r * l));
      d1 = fe_mul_chain<M>(d1, plane_get(tw, H, r * l + q4));
      o0 = fe_add_chain<M>(s0, s1);
      o1 = fe_add_chain<M>(d0, d1);
      o2 = fe_sub_chain<M>(s0, s1);
      o3 = fe_sub_chain<M>(d0, d1);
      if (l != 0) {
        const Fe w2 = plane_get(tw, H, 2 * r * l);
        o2 = fe_mul_chain<M>(o2, w2);
        o3 = fe_mul_chain<M>(o3, w2);
      }
    }
    __syncthreads();
    if (act) {
      const int pos = base + 4 * r * l + (j0 & (r - 1));
      plane_put(sm, E, ntt_swz(pos), o0);
      plane_put(sm, E, ntt_swz(pos + r), o1);
      plane_put(sm, E, ntt_swz(pos + 2 * r), o2);
      plane_put(sm, E, ntt_swz(pos + 3 * r), o3);
    }
    __syncthreads();
  }
  // Odd log_m: the last Stockham stage (r = m / 2, twiddles all 1) maps
  // j, j + m/2 onto themselves.
  if (t == log_m - 1) {
    const int h = m >> 1;
    for (int it = tid; it < (E >> 1); it += blockDim.x) {
      const int p0 = ((it >> (log_m - 1)) << log_m) + (it & (h - 1));
      const Fe x = plane_get(sm, E, ntt_swz(p0));
      const Fe y = plane_get(sm, E, ntt_swz(p0 + h));
      plane_put(sm, E, ntt_swz(p0), fe_add_chain<M>(x, y));
      plane_put(sm, E, ntt_swz(p0 + h), fe_sub_chain<M>(x, y));
    }
    __syncthreads();
  }

  const long long lo_mask = (1LL << a.tw_log_lo) - 1;
  for (int u = tid; u < E; u += blockDim.x) {
    int c, j;
    if (a.store_cols_fast) {
      c = u & (C - 1);
      j = u >> log_c;
    } else {
      c = u >> log_m;
      j = u & (m - 1);
    }
    if (c >= ncols) continue;
    const long long row = c_drow[c] + j * a.j_dst_r;
    if (row >= a.dst_rows) continue;
    Fe v = plane_get(sm, E, ntt_swz((c << log_m) + j));
    if (a.store_c != nullptr)
      v = fe_mul_chain<M>(v, fe_load(a.store_c, (long long)((unsigned long long)row % 3)));
    if (a.tw_lo != nullptr) {
      const long long e = ((long long)j * c_tw[c]) & a.tw_mask;
      if (e != 0) {
        const long long lo = e & lo_mask, hi = e >> a.tw_log_lo;
        Fe w;
        if (hi == 0) {
          w = fe_load(a.tw_lo, lo);
        } else if (lo == 0) {
          w = fe_load(a.tw_hi, hi);
        } else {
          w = fe_mul_chain<M>(fe_load(a.tw_lo, lo), fe_load(a.tw_hi, hi));
        }
        v = fe_mul_chain<M>(v, w);
      }
    }
    fe_store(a.dst, c_dst[c] + j * a.j_dst_s, v);
  }
}

// Dynamic shared memory of a pass: column offsets, data planes, twiddles.
static inline size_t ntt_smem_bytes(int log_m, int log_c) {
  const size_t m = (size_t)1 << log_m;
  const size_t C = (size_t)1 << log_c;
  return 40 * C + 32 * (C * m) + 32 * (m > 1 ? m / 2 : 1);
}

// One pass; args as in NttArgs, with 0 <= log_m <= 10, (1 << log_c) m <=
// 1024, 1 << log_c <= 128, ndims <= 4 and cols < 2^31.  field: the id of
// arith.cuh's with_field.  Returns cudaGetLastError() (a refused launch
// included).
extern "C" int h2_ntt_base(int field, const NttArgs* args, void* stream) {
  const NttArgs a = *args;
  if (a.log_m < 0 || a.log_m > 10 || a.log_cols_per_block < 0 ||
      (1LL << a.log_cols_per_block) > NTT_MAX_COLS ||
      (1LL << (a.log_m + a.log_cols_per_block)) > NTT_ELEMS ||
      a.ndims < 1 || a.ndims > NTT_MAX_DIMS || a.cols >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (a.cols + (1LL << a.log_cols_per_block) - 1) >> a.log_cols_per_block;
  if (blocks > 0) {
    const size_t smem = ntt_smem_bytes((int)a.log_m, (int)a.log_cols_per_block);
    const int quarter = (1 << (a.log_m + a.log_cols_per_block)) / 4;
    const int threads = quarter < 32 ? 32 : quarter;
    with_field(field, [&](auto f) {
      auto kern = k_ntt<decltype(f)>;
      if (smem > 48 * 1024)
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
      kern<<<(unsigned int)blocks, threads, smem, (cudaStream_t)stream>>>(a);
    });
  }
  return (int)cudaGetLastError();
}
