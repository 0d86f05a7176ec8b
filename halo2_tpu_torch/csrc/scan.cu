// Kernel 9: one level of the segmented scan over a key-sorted point stream,
// on BN254 G1, Pallas and Vesta.
//
// Replaces the JAX reference's msm/bucket_scan.py::_scan_level_pallas, the
// kernel under the variable-base MSM (msm_variable), which IPA's opening
// argument runs 2k times per proof.  The stream is M = lanes * block
// elements sorted by key; lane j owns the `block` consecutive elements
// [j block, (j + 1) block).  Each lane keeps a running sum that restarts
// at every key change: a fresh key starts the sum at the element, an equal
// key adds the element (complete mixed add for affine elements, complete add
// for projective ones).  Output: each lane's final partial sum (lanes, 3, 8)
// and the key it belongs to (lanes,).  Affine elements are 18-word rows (x,
// y, infinity flag, pad); in packed mode the key is 2 * bucket + sign and y
// is negated on an odd key, as in the reference.  Padding elements carry
// SENTINEL_KEY (msm/bucket_scan.py), which sorts after every bucket, so
// their lanes add nothing the caller keeps.
//
// Bound on the H100: integer ALU, one ~11-product mixed add (12 for the
// projective add) per element, against 72-96 B read per element; at the IPA
// sizes (a few hundred thousand elements) the card is not full, and each
// lane's `block` steps are serial.  Design: one thread per lane walking its
// chunk in registers (the TPU kept the accumulator in VMEM scratch across a
// sequential grid; here the loop inside the thread takes that place), over
// the carry-chain product (mont_chain.cuh).  The callers choose `block` per
// level (bucket_scan.block_for): lanes for one wave of the card, but no
// fewer than MIN_BLOCK elements a lane, the whole MSM's fastest.  An affine
// element with its infinity flag set passes the sum through without a mixed
// add, the same words as the formula's q_inf pass-through: most slots of a
// tails call are such padding.  Neighbouring lanes read rows `block` apart;
// every 32-byte sector a thread touches is used whole, and staging a warp's
// rows through shared memory with coalesced loads ran 8-9% slower at the
// IPA prove's largest call (PERF.md), so each thread reads its own rows.
#include "arith.cuh"

static const int SCAN_THREADS = 128;

// One element into a lane's running sum.  e: the element's words, an
// 18-word affine row or a 24-word projective point.
template <class C, bool AFFINE, bool PACKED>
__device__ __forceinline__ void scan_elem(int k, const uint32_t* e, Pt& acc,
                                          int& seg) {
  typedef typename C::Q Q;
  bool neg = false;
  if (PACKED) {
    neg = (k & 1) != 0;
    k >>= 1;
  }
  const bool fresh = k != seg;
  seg = k;
  if (AFFINE) {
    Fe x, y;
    bool inf;
    row_load<C>(e, 1, neg, x, y, inf);
    if (fresh) {
#pragma unroll
      for (int i = 0; i < 8; i++) {
        acc.x.w[i] = inf ? 0u : x.w[i];
        acc.y.w[i] = inf ? Q::one(i) : y.w[i];
        acc.z.w[i] = inf ? 0u : Q::one(i);
      }
    } else if (!inf) {
      acc = ec_madd_body<C>(acc, x, y, false);
    }
  } else {
    const Pt p = pt_load((const uint4*)e, 0);
    acc = fresh ? p : ec_add_body<C>(acc, p);
  }
}

template <class C, bool AFFINE, bool PACKED>
__global__ void __launch_bounds__(SCAN_THREADS)
    k_scan_level(const int* __restrict__ keys, const uint32_t* __restrict__ elems,
                 uint4* __restrict__ finals, int* __restrict__ lane_keys,
                 int block, long long lanes) {
  constexpr int W = AFFINE ? 18 : 24;          // words per element
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  int seg = -2;
  Pt acc = pt_identity<C>();
  for (int t = 0; t < block; t++) {
    const long long e = lane * block + t;
    scan_elem<C, AFFINE, PACKED>(keys[e], elems + e * W, acc, seg);
  }
  pt_store(finals, lane, acc);
  lane_keys[lane] = seg;
}

// mode: 0 projective points (M, 3, 8); 1 affine rows (M, 18); 2 affine rows
// with packed signed keys.  keys (M,) int32 with M = lanes * block; finals
// (lanes, 3, 8) and lane_keys (lanes,) are written in full.  curve: the id
// of arith.cuh's with_curve.  Returns cudaGetLastError().
extern "C" int h2_scan_level(int curve, int mode, const void* keys,
                             const void* pts, void* finals, void* lane_keys,
                             int block, long long lanes, void* stream) {
  if (lanes > 0) {
    const unsigned int blocks =
        (unsigned int)((lanes + SCAN_THREADS - 1) / SCAN_THREADS);
    cudaStream_t s = (cudaStream_t)stream;
    const int* k = (const int*)keys;
    const uint32_t* e = (const uint32_t*)pts;
    uint4* f = (uint4*)finals;
    int* lk = (int*)lane_keys;
    auto launch = [&](auto kernel) {
      kernel<<<blocks, SCAN_THREADS, 0, s>>>(k, e, f, lk, block, lanes);
    };
    with_curve(curve, [&](auto c) {
      typedef decltype(c) C;
      if (mode == 0) launch(k_scan_level<C, false, false>);
      else if (mode == 1) launch(k_scan_level<C, true, false>);
      else launch(k_scan_level<C, true, true>);
    });
  }
  return (int)cudaGetLastError();
}
