// Kernels D and 8: fixed-base MSM bucket accumulation over a stream table,
// on BN254 G1, Pallas and Vesta.
//
// Kernel D replaces the JAX reference's msm/stream_msm.py::
// _stream_bucket_pallas (the BAKED table).  The stream holds, for every
// (window w, base i), the affine point [2^(c w)] P_i packed as 18 words
// (8 x, 8 y, infinity flag, pad); keys hold the matching signed digit as
// |d| * 2 + sign.  Per element: negate y on an odd key, then a complete
// mixed addition into bucket key >> 1.  The result is every lane's private
// bucket array; the cross-lane tree sum and the weighted bucket fold stay in
// PyTorch over kernel B (msm/stream_msm.py).
//
// Kernel 8 replaces msm/stream_msm.py::_stream_bucket_windows_pallas (the
// UNBAKED table, k >= 19).  The table holds the n bases once, (S, 18, lanes)
// with the window factor not applied; keys are window-aligned, (nw * S,
// lanes), window w in rows [w S, (w + 1) S).  Thread (w, lane) walks the
// same table column as every other window against its own digit row and
// owns its own buckets: out (nw, lanes, nb, 3, 8).  Per-window folds and the
// Horner combine over windows run in PyTorch.
//
// Design (both): the TPU's own, one thread per lane, each thread walking its
// column of the (S, 18, lanes) stream (coalesced: neighbouring lanes read
// neighbouring words) and owning a private (nb, 3, 8) bucket array in device
// memory laid out lane-major, so a bucket read-modify-write is 96
// contiguous bytes (whole sectors) per thread.  Kernel D takes up to 64K
// lanes, not the TPU's 1,024, so that 132 SMs have enough threads.  Kernel
// 8 must not: nw windows x 64K lanes x 33 buckets x 96 B would be 8.9 GB of
// buckets at k = 20; it takes lanes so that nw x lanes stays near one wave
// of resident threads (43 x 1,024 = 44K at k = 20, 139 MB of buckets).
//
// Table reuse in kernel 8: the nw windows of one lane read the same table
// words at about the same time, because all nw x lanes threads are resident
// in one wave and advance in step; the rows in flight (a few x 72 KB) sit
// far inside the 50 MB L2.  Whether L2 catches the reuse is not measured
// (the kernel is timed with CUDA events only), and it does not bound the
// kernel: were every window to re-read the 72 MiB table from HBM, the 3 GiB
// would take about 1 ms at 3.35 TB/s, against the 28 ms the k = 20 pass
// takes on one H100 (chip_smoke.py), and kernel 8 does more mixed adds per
// second than kernel D.
//
// Bound on the H100: integer ALU (one ~11-multiply mixed add per element);
// the bucket traffic is ~2 x 96 B and the stream 72 B per element, which
// the L2 and HBM absorb.  Later work: shared-memory buckets or a
// sort-by-bucket schedule to cut the bucket round trips.
#include "arith.cuh"

template <class C>
__device__ __forceinline__ void bucket_walk(const int* __restrict__ keys,
                                            const uint32_t* __restrict__ table,
                                            uint4* __restrict__ buckets,
                                            int steps, int lanes, int nb,
                                            int lane, long long own) {
  const Pt ident = pt_identity<C>();
  for (int b = 0; b < nb; b++) pt_store(buckets, own + b, ident);
  for (int s = 0; s < steps; s++) {
    const int k = keys[(long long)s * lanes + lane];
    Fe x, y;
    bool inf;
    row_load<C>(table + (long long)s * 18 * lanes + lane, lanes, (k & 1) != 0,
                x, y, inf);
    const long long slot = own + (k >> 1);
    pt_store(buckets, slot,
             ec_madd_body<C>(pt_load(buckets, slot), x, y, inf));
  }
}

template <class C>
__global__ void k_stream_bucket(const int* __restrict__ keys,
                                const uint32_t* __restrict__ table,
                                uint4* __restrict__ buckets, int steps,
                                int lanes, int nb) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  bucket_walk<C>(keys, table, buckets, steps, lanes, nb, lane,
                 (long long)lane * nb);
}

// blockIdx.y is the window.
template <class C>
__global__ void k_stream_bucket_windows(const int* __restrict__ keys,
                                        const uint32_t* __restrict__ table,
                                        uint4* __restrict__ buckets,
                                        int steps, int lanes, int nb) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const long long w = blockIdx.y;
  bucket_walk<C>(keys + w * steps * lanes, table, buckets, steps, lanes, nb,
                 lane, (w * lanes + lane) * nb);
}

// keys: (windows * steps, lanes) int32; table: (steps, 18, lanes) words;
// buckets: (windows, lanes, nb, 3, 8) words, written in full.  windows = 1
// with a baked table is kernel D (h2_stream_bucket); windows > 1 with an
// unbaked table is kernel 8 (h2_stream_bucket_windows).  curve: the id of
// arith.cuh's with_curve.  Returns cudaGetLastError().
static int stream_launch(bool per_window, int curve, const void* keys,
                         const void* table, void* buckets, int windows,
                         int steps, int lanes, int nb, void* stream) {
  if (lanes > 0 && windows > 0) {
    const int threads = 128;
    const dim3 grid((lanes + threads - 1) / threads, windows);
    with_curve(curve, [&](auto c) {
      typedef decltype(c) C;
      if (per_window) {
        k_stream_bucket_windows<C><<<grid, threads, 0, (cudaStream_t)stream>>>(
            (const int*)keys, (const uint32_t*)table, (uint4*)buckets, steps,
            lanes, nb);
      } else {
        k_stream_bucket<C><<<grid.x, threads, 0, (cudaStream_t)stream>>>(
            (const int*)keys, (const uint32_t*)table, (uint4*)buckets, steps,
            lanes, nb);
      }
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int h2_stream_bucket(int curve, const void* keys,
                                const void* table, void* buckets, int steps,
                                int lanes, int nb, void* stream) {
  return stream_launch(false, curve, keys, table, buckets, 1, steps, lanes,
                       nb, stream);
}

extern "C" int h2_stream_bucket_windows(int curve, const void* keys,
                                        const void* table, void* buckets,
                                        int windows, int steps, int lanes,
                                        int nb, void* stream) {
  return stream_launch(true, curve, keys, table, buckets, windows, steps,
                       lanes, nb, stream);
}
