// Kernels D and 8: fixed-base MSM bucket sums over a table of affine rows,
// on BN254 G1, Pallas and Vesta, as sorted runs summed in registers.
//
// Replaces the JAX reference's msm/stream_msm.py::_stream_bucket_pallas
// (kernel D, the BAKED table: row w n + i holds [2^(c w)] P_i, all windows
// sharing one space of 32 nonzero buckets) and ::_stream_bucket_windows_pallas
// (kernel 8, the UNBAKED table: row i holds P_i, and the key space is the
// 43 x 32 pairs (window, bucket)).  Rows are 18 words (8 x, 8 y, infinity
// flag, pad), 72 bytes, row-major; keys are (windows, n) int32 signed digits
// |d| * 2 + sign.
//
// What bounds them on the H100: the complete mixed add, one per element
// with a nonzero digit (11 Montgomery products and two multiplications by
// 3b), i.e. integer multiplies; the bytes (4 per key, 72 per row read once,
// 96 per partial sum) take a small share of the time at 3.35 TB/s.  The
// TPU's design, one thread per lane streaming a column of the table into a
// private bucket array, made every element wait on a load of its own
// bucket from device memory (207 MB of buckets for D at k = 18, 139 MB for
// kernel 8 at k = 20, beyond the 50 MB L2) and added zero digits into a
// bucket of weight 0.  This design:
//
// 1. The ordering pass (h2_msm_order): a counting sort of the element
//    indices by bucket key, dropping zero digits (bucket 0 has weight 0, so
//    that is exact).  A warp counts a chunk of ORDER_CHUNK keys per bucket
//    (k_order_hist), one block turns the counts into offsets and the split
//    below (k_order_scan), and each warp scatters its chunk stably
//    (k_order_scatter).  The ordered list holds row * 2 + sign.  It reads
//    the keys twice and writes 4 bytes per nonzero element.
// 2. The split: with T nonzero elements and `pieces` threads wanted, every
//    key's run is cut into pieces of at most P = ceil(T / pieces) elements.
//    It depends only on the counts, so it is the same on every run and the
//    plain version follows it word for word; no atomics touch points.
// 3. The accumulate pass (k_stream_bucket = kernel D, k_stream_bucket_
//    windows = kernel 8): one thread per piece sums its run in registers
//    with the mixed add over the carry-chain product (mont_chain.cuh),
//    fetching each row by index with cp.async into a ring of two
//    shared-memory stages, so the next row arrives while this one is added.
//    It writes one projective partial sum per piece, a key's pieces side by
//    side; slots past the last piece get the identity.
//
// The partial sums (about pieces + keys of them) are summed per key by a
// prefix sum over kernel B (msm/stream_msm.py::key_sums).
#include "arith.cuh"

constexpr int NB = 32;               // nonzero buckets per window (c = 6)
constexpr int ORDER_CHUNK = 8192;    // keys per warp in the ordering pass
constexpr int ORDER_WARPS = 8;       // warps per block in the ordering pass
constexpr int ORDER_UNROLL = 4;      // tiles of 32 keys loaded at once
constexpr int SCAN_THREADS = 1024;
constexpr int ACC_THREADS = 128;
constexpr int ROW_U2 = 9;            // a 72-byte row as 8-byte pieces

// The ordering pass's counters: key (w, b) of a chunk c of window w counts at
// key_index * spaced + chunk_index, so that one exclusive scan over them
// gives every chunk's offset in the ordered list.  Kernel 8 (per_window): a
// key per (window, bucket), chunks of its own window; kernel D: a key per
// bucket, every window's chunks.
struct OrderShape {
  int per_window, windows, n, cpw;   // cpw: chunks per window
  __device__ __forceinline__ int counter(int w, int c, int b) const {
    return per_window ? ((w * NB + b - 1) * cpw + c)
                      : ((b - 1) * windows * cpw + w * cpw + c);
  }
};

// Warp g takes chunk g % cpw of window g / cpw.
__device__ __forceinline__ void chunk_of(const OrderShape& s, int g, int& w,
                                         int& c, int& i0, int& i1) {
  w = g / s.cpw;
  c = g % s.cpw;
  i0 = c * ORDER_CHUNK;
  i1 = min(i0 + ORDER_CHUNK, s.n);
}

// Keys i + 32 u + lane of ORDER_UNROLL tiles, 0 past i1: all loads in
// flight before any is used.
__device__ __forceinline__ void load_tiles(const int* __restrict__ kw, int i,
                                           int i1, int lane,
                                           int k[ORDER_UNROLL]) {
#pragma unroll
  for (int u = 0; u < ORDER_UNROLL; u++) {
    const int e = i + 32 * u + lane;
    k[u] = e < i1 ? kw[e] : 0;
  }
}

// Per warp, 32 counters in shared memory, one per nonzero bucket.  In a
// tile of 32 keys the lanes holding one bucket find each other with
// __match_any_sync, and the lowest of them (the leader) updates the
// bucket's counter: no atomics, since every leader owns another counter.
__device__ __forceinline__ int* warp_counters() {
  __shared__ int counters[ORDER_WARPS][NB];
  return counters[threadIdx.x >> 5];
}

__global__ void k_order_hist(const int* __restrict__ keys, OrderShape s,
                             int* __restrict__ hist) {
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= s.windows * s.cpw) return;
  int w, c, i0, i1;
  chunk_of(s, g, w, c, i0, i1);
  const int* kw = keys + (long long)w * s.n;
  int* cnt = warp_counters();
  cnt[lane] = 0;
  __syncwarp();
  for (int i = i0; i < i1; i += ORDER_UNROLL * 32) {
    int k[ORDER_UNROLL];
    load_tiles(kw, i, i1, lane, k);
#pragma unroll
    for (int u = 0; u < ORDER_UNROLL; u++) {
      const int b = k[u] >> 1;
      const unsigned same = __match_any_sync(0xffffffffu, b);
      if (b != 0 && lane == __ffs(same) - 1) cnt[b - 1] += __popc(same);
      __syncwarp();
    }
  }
  hist[s.counter(w, c, lane + 1)] = cnt[lane];
}

__global__ void k_order_scatter(const int* __restrict__ keys, OrderShape s,
                                const int* __restrict__ offsets,
                                int* __restrict__ order) {
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= s.windows * s.cpw) return;
  int w, c, i0, i1;
  chunk_of(s, g, w, c, i0, i1);
  const int* kw = keys + (long long)w * s.n;
  int* next = warp_counters();      // each bucket's next slot in the order
  next[lane] = offsets[s.counter(w, c, lane + 1)];
  __syncwarp();
  const unsigned below = (1u << lane) - 1;
  for (int i = i0; i < i1; i += ORDER_UNROLL * 32) {
    int k[ORDER_UNROLL];
    load_tiles(kw, i, i1, lane, k);
#pragma unroll
    for (int u = 0; u < ORDER_UNROLL; u++) {
      const int b = k[u] >> 1;
      const unsigned same = __match_any_sync(0xffffffffu, b);
      const int base = b != 0 ? next[b - 1] : 0;
      if (b != 0) {
        const int e = i + 32 * u + lane;
        const int row = s.per_window ? e : w * s.n + e;
        order[base + __popc(same & below)] = row * 2 + (k[u] & 1);
      }
      __syncwarp();
      if (b != 0 && lane == __ffs(same) - 1)
        next[b - 1] = base + __popc(same);
      __syncwarp();
    }
  }
}

// Exclusive prefix of v over the block (blockDim.x a multiple of 32);
// *total gets the block's sum.
__device__ int block_excl_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    warp_sums[lane] = t;
  }
  __syncthreads();
  const int before = (wid > 0 ? warp_sums[wid - 1] : 0) + x - v;
  *total = warp_sums[nwarps - 1];
  __syncthreads();
  return before;
}

// One block.  hist (n_ctr counters) becomes its exclusive prefix (every
// chunk's first slot per bucket).  info: [T, P, NS, 0], key_start (nkeys +
// 1: where each key's run starts in the ordered list, then T), seg_base
// (nkeys + 1: each key's first piece, then NS).  Piece j of key k covers
// ordered positions [key_start[k] + j P, min(that + P, key_start[k + 1])).
__global__ void k_order_scan(int* __restrict__ hist, int n_ctr, int nkeys,
                             int spaced, int pieces, int* __restrict__ info) {
  int* key_start = info + 4;
  int* seg_base = key_start + nkeys + 1;
  const int per = (n_ctr + blockDim.x - 1) / blockDim.x;
  const int a0 = min(n_ctr, (int)threadIdx.x * per);
  const int a1 = min(n_ctr, a0 + per);
  int sum = 0;
  for (int i = a0; i < a1; i++) sum += hist[i];
  int total;
  int run = block_excl_scan(sum, &total);
  for (int i = a0; i < a1; i++) {
    const int v = hist[i];
    hist[i] = run;
    run += v;
  }
  __syncthreads();
  const int P = max(1, (total + pieces - 1) / pieces);
  const int kper = (nkeys + blockDim.x - 1) / blockDim.x;
  const int k0 = min(nkeys, (int)threadIdx.x * kper);
  const int k1 = min(nkeys, k0 + kper);
  int segs = 0;
  for (int k = k0; k < k1; k++) {
    const int end = k + 1 < nkeys ? hist[(k + 1) * spaced] : total;
    segs += (end - hist[k * spaced] + P - 1) / P;
  }
  int ns;
  int seg = block_excl_scan(segs, &ns);
  for (int k = k0; k < k1; k++) {
    const int start = hist[k * spaced];
    const int end = k + 1 < nkeys ? hist[(k + 1) * spaced] : total;
    key_start[k] = start;
    seg_base[k] = seg;
    seg += (end - start + P - 1) / P;
  }
  if (threadIdx.x == 0) {
    key_start[nkeys] = total;
    seg_base[nkeys] = ns;
    info[0] = total;
    info[1] = P;
    info[2] = ns;
    info[3] = 0;
  }
}

// keys: (windows, n) int32; hist: 32 windows cpw int32 of scratch, cpw =
// ceil(n / ORDER_CHUNK); order: windows n int32, the first T written; info:
// 4 + 2 (nkeys + 1) int32, nkeys = 32 windows (per_window) or 32.
extern "C" int h2_msm_order(int per_window, const void* keys, int windows,
                            int n, void* hist, void* order, void* info,
                            int pieces, void* stream) {
  if (windows > 0 && n > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    OrderShape s{per_window, windows, n,
                 (n + ORDER_CHUNK - 1) / ORDER_CHUNK};
    const int warps = windows * s.cpw;
    const int blocks = (warps + ORDER_WARPS - 1) / ORDER_WARPS;
    const int nkeys = per_window ? NB * windows : NB;
    k_order_hist<<<blocks, ORDER_WARPS * 32, 0, st>>>((const int*)keys, s,
                                                      (int*)hist);
    k_order_scan<<<1, SCAN_THREADS, 0, st>>>(
        (int*)hist, NB * warps, nkeys, per_window ? s.cpw : warps, pieces,
        (int*)info);
    k_order_scatter<<<blocks, ORDER_WARPS * 32, 0, st>>>(
        (const int*)keys, s, (const int*)hist, (int*)order);
  }
  return (int)cudaGetLastError();
}

__device__ __forceinline__ void fetch_row(const uint2* __restrict__ rows,
                                          int v, uint2* dst) {
  const uint2* src = rows + (long long)(v >> 1) * ROW_U2;
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
#pragma unroll
  for (int u = 0; u < ROW_U2; u++)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d + 8 * u),
                 "l"(src + u)
                 : "memory");
}

__device__ __forceinline__ void commit_rows() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Every group but the newest has landed.
__device__ __forceinline__ void wait_rows() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Thread g sums piece g (see k_order_scan) into partials[g]; the slots from
// NS to `slots` get the identity.
template <class C>
__device__ __forceinline__ void accumulate(const int* __restrict__ order,
                                           const uint32_t* __restrict__ table,
                                           const int* __restrict__ info,
                                           int nkeys, int slots,
                                           uint4* __restrict__ partials) {
  extern __shared__ uint2 ring[];   // 2 stages x blockDim x 9
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= slots) return;
  const int ns = info[2];
  if (g >= ns) {
    pt_store(partials, g, pt_identity<C>());
    return;
  }
  const int* key_start = info + 4;
  const int* seg_base = key_start + nkeys + 1;
  // the key k with seg_base[k] <= g < seg_base[k + 1]
  int lo = 0, hi = nkeys;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (seg_base[mid] <= g) lo = mid;
    else hi = mid;
  }
  const int begin = key_start[lo] + (g - seg_base[lo]) * info[1];
  const int end = min(begin + info[1], key_start[lo + 1]);
  const uint2* rows = (const uint2*)table;
  uint2* stage[2] = {ring + threadIdx.x * ROW_U2,
                     ring + (blockDim.x + threadIdx.x) * ROW_U2};
  Pt acc = pt_identity<C>();
  int cur = order[begin];
  fetch_row(rows, cur, stage[0]);
  commit_rows();
  int nxt = begin + 1 < end ? order[begin + 1] : 0;
  for (int q = begin; q < end; q++) {
    const int s = (q - begin) & 1;
    if (q + 1 < end) fetch_row(rows, nxt, stage[s ^ 1]);
    commit_rows();
    const int after = q + 2 < end ? order[q + 2] : 0;
    wait_rows();
    Fe x, y;
    bool inf;
    row_load<C>((const uint32_t*)stage[s], 1, (cur & 1) != 0, x, y, inf);
    acc = ec_madd_body<C>(acc, x, y, inf);
    cur = nxt;
    nxt = after;
  }
  pt_store(partials, g, acc);
}

template <class C>
__global__ void __launch_bounds__(ACC_THREADS)
    k_stream_bucket(const int* __restrict__ order,
                    const uint32_t* __restrict__ table,
                    const int* __restrict__ info, int nkeys, int slots,
                    uint4* __restrict__ partials) {
  accumulate<C>(order, table, info, nkeys, slots, partials);
}

template <class C>
__global__ void __launch_bounds__(ACC_THREADS)
    k_stream_bucket_windows(const int* __restrict__ order,
                            const uint32_t* __restrict__ table,
                            const int* __restrict__ info, int nkeys,
                            int slots, uint4* __restrict__ partials) {
  accumulate<C>(order, table, info, nkeys, slots, partials);
}

template <class C>
static const void* accumulate_fn(bool per_window) {
  return per_window ? (const void*)k_stream_bucket_windows<C>
                    : (const void*)k_stream_bucket<C>;
}

static const int ring_bytes = 2 * ACC_THREADS * ROW_U2 * 8;

// order, info: the ordering pass's; table: (rows, 18) words; partials:
// (slots, 3, 8) words, written in full.  Kernel D
// (h2_stream_bucket) and kernel 8 (h2_stream_bucket_windows) differ in the
// key space they are given (nkeys = 32 or 32 windows) and the table.
static int accumulate_launch(bool per_window, int curve, const void* order,
                             const void* table, const void* info, int nkeys,
                             void* partials, int slots, void* stream) {
  if (slots > 0) {
    const int blocks = (slots + ACC_THREADS - 1) / ACC_THREADS;
    const cudaStream_t st = (cudaStream_t)stream;
    with_curve(curve, [&](auto c) {
      typedef decltype(c) C;
      if (per_window) {
        k_stream_bucket_windows<C><<<blocks, ACC_THREADS, ring_bytes, st>>>(
            (const int*)order, (const uint32_t*)table, (const int*)info,
            nkeys, slots, (uint4*)partials);
      } else {
        k_stream_bucket<C><<<blocks, ACC_THREADS, ring_bytes, st>>>(
            (const int*)order, (const uint32_t*)table, (const int*)info,
            nkeys, slots, (uint4*)partials);
      }
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int h2_stream_bucket(int curve, const void* order,
                                const void* table, const void* info,
                                int nkeys, void* partials, int slots,
                                void* stream) {
  return accumulate_launch(false, curve, order, table, info, nkeys, partials,
                           slots, stream);
}

extern "C" int h2_stream_bucket_windows(int curve, const void* order,
                                        const void* table, const void* info,
                                        int nkeys, void* partials, int slots,
                                        void* stream) {
  return accumulate_launch(true, curve, order, table, info, nkeys, partials,
                           slots, stream);
}

// The accumulate pass as launched: out[0] resident blocks per SM, out[1]
// registers per thread, out[2] local (spill) bytes per thread, out[3]
// threads per block, out[4] dynamic shared bytes per block.  which: 0
// kernel D, 1 kernel 8.
extern "C" int h2_stream_occupancy(int which, int curve, int* out) {
  with_curve(curve, [&](auto c) {
    typedef decltype(c) C;
    const void* fn = accumulate_fn<C>(which != 0);
    cudaFuncAttributes a;
    cudaFuncGetAttributes(&a, fn);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, ACC_THREADS,
                                                  ring_bytes);
    out[1] = a.numRegs;
    out[2] = (int)a.localSizeBytes;
    out[3] = ACC_THREADS;
    out[4] = ring_bytes;
  });
  return (int)cudaGetLastError();
}
