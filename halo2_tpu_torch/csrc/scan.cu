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
// Bound on the H100: integer ALU, one ~11-multiply mixed add (12 for the
// projective add) per element, against 72-96 B read per element.  Design:
// the simple one, one thread per lane walking its chunk in registers (the
// TPU kept the accumulator in VMEM scratch across a sequential grid; here
// the loop inside the thread takes that place).  Neighbouring threads read
// rows `block` elements apart, so a warp's loads are not contiguous, but
// every 32-byte sector a thread touches is used whole, so no DRAM bandwidth
// is wasted.  A lane count in the thousands fills few of the 132 SMs at the
// IPA sizes (4,224 lanes for the first level of an 8,192-point MSM: 0.76 ms
// on one H100 against an ALU bound of 0.04 ms, chip_smoke.py); more lanes
// per level is later work.
#include "arith.cuh"

template <class C, bool AFFINE, bool PACKED>
__global__ void k_scan_level(const int* __restrict__ keys,
                             const uint32_t* __restrict__ rows,
                             const uint4* __restrict__ pts,
                             uint4* __restrict__ finals,
                             int* __restrict__ lane_keys, int block,
                             long long lanes) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  typedef typename C::Q Q;
  int seg = -2;
  Pt acc = pt_identity<C>();
  for (int t = 0; t < block; t++) {
    const long long e = lane * block + t;
    int k = keys[e];
    bool neg = false;
    if (PACKED) {
      neg = (k & 1) != 0;
      k >>= 1;
    }
    const bool fresh = k != seg;
    if (AFFINE) {
      Fe x, y;
      bool inf;
      row_load<C>(rows + e * 18, 1, neg, x, y, inf);
      if (fresh) {
#pragma unroll
        for (int i = 0; i < 8; i++) {
          acc.x.w[i] = inf ? 0u : x.w[i];
          acc.y.w[i] = inf ? Q::one(i) : y.w[i];
          acc.z.w[i] = inf ? 0u : Q::one(i);
        }
      } else {
        acc = ec_madd_body<C>(acc, x, y, inf);
      }
    } else {
      const Pt p = pt_load(pts, e);
      acc = fresh ? p : ec_add_body<C>(acc, p);
    }
    seg = k;
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
    const int threads = 128;
    const unsigned int blocks =
        (unsigned int)((lanes + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    const int* k = (const int*)keys;
    uint4* f = (uint4*)finals;
    int* lk = (int*)lane_keys;
    with_curve(curve, [&](auto c) {
      typedef decltype(c) C;
      if (mode == 0) {
        k_scan_level<C, false, false><<<blocks, threads, 0, s>>>(
            k, nullptr, (const uint4*)pts, f, lk, block, lanes);
      } else if (mode == 1) {
        k_scan_level<C, true, false><<<blocks, threads, 0, s>>>(
            k, (const uint32_t*)pts, nullptr, f, lk, block, lanes);
      } else {
        k_scan_level<C, true, true><<<blocks, threads, 0, s>>>(
            k, (const uint32_t*)pts, nullptr, f, lk, block, lanes);
      }
    });
  }
  return (int)cudaGetLastError();
}
