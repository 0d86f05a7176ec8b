// Kernel D: baked fixed-base MSM bucket accumulation over BN254 G1.
//
// Replaces halo2_tpu/msm/stream_msm.py::_stream_bucket_pallas.  The stream
// holds, for every (window w, base i), the affine point [2^(c w)] P_i packed
// as 18 words (8 x, 8 y, infinity flag, pad); keys hold the matching signed
// digit as |d| * 2 + sign.  Per element: negate y on an odd key, then a
// complete mixed addition into bucket key >> 1.  The result is every lane's
// private bucket array; the cross-lane tree sum and the weighted bucket fold
// stay in PyTorch over kernel B (msm/stream_msm.py).
//
// Design: the TPU's own, one thread per lane, each thread walking its
// column of the (S, 18, lanes) stream (coalesced: neighbouring lanes read
// neighbouring words) and owning a private (nb, 3, 8) bucket array in device
// memory laid out lane-major, so a bucket read-modify-write is 96
// contiguous bytes (whole sectors) per thread.  The port takes up to 64K
// lanes, not the TPU's 1,024, so that 132 SMs have enough threads.
//
// Bound on the H100: integer ALU (one ~11-multiply mixed add per element);
// the bucket traffic is ~2 x 96 B and the stream 72 B per element, which
// the L2 and HBM absorb.  Later work: shared-memory buckets or a
// sort-by-bucket schedule to cut the bucket round trips.
#include "bn254.cuh"

__global__ void k_stream_bucket(const int* __restrict__ keys,
                                const uint32_t* __restrict__ table,
                                uint4* __restrict__ buckets, int steps,
                                int lanes, int nb) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const long long own = (long long)lane * nb;
  Pt ident;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    ident.x.w[i] = 0;
    ident.y.w[i] = FqMod::one(i);
    ident.z.w[i] = 0;
  }
  for (int b = 0; b < nb; b++) pt_store(buckets, own + b, ident);
  Fe zero;
#pragma unroll
  for (int i = 0; i < 8; i++) zero.w[i] = 0;

  for (int s = 0; s < steps; s++) {
    const int k = keys[(long long)s * lanes + lane];
    const uint32_t* row = table + (long long)s * 18 * lanes + lane;
    Fe x, y;
#pragma unroll
    for (int q = 0; q < 8; q++) {
      x.w[q] = row[(long long)q * lanes];
      y.w[q] = row[(long long)(8 + q) * lanes];
    }
    const bool inf = (row[16LL * lanes] & 1u) != 0;
    if (k & 1) y = fe_sub<Q>(zero, y);
    const long long slot = own + (k >> 1);
    pt_store(buckets, slot, ec_madd_body(pt_load(buckets, slot), x, y, inf));
  }
}

// keys: (steps, lanes) int32; table: (steps, 18, lanes) words;
// buckets: (lanes, nb, 3, 8) words, written in full.  Returns
// cudaGetLastError().
extern "C" int h2_stream_bucket(const void* keys, const void* table,
                                void* buckets, int steps, int lanes, int nb,
                                void* stream) {
  if (lanes > 0) {
    const int threads = 128;
    const int blocks = (lanes + threads - 1) / threads;
    k_stream_bucket<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)keys, (const uint32_t*)table, (uint4*)buckets, steps,
        lanes, nb);
  }
  return (int)cudaGetLastError();
}
