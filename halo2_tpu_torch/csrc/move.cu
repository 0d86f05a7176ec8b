// Kernels 13 and 14/15: the memory-move probes.
//
// Kernel 13, k_gather_rows: out[i] = tbl[idx[i]] for rows of `width` 32-bit
// words.  Replaces the JAX reference's tools/dma_gather_probe.py::dma_gather
// (its pallas_call at :54), which pipelined one DMA per row from HBM into
// VMEM.  Here every thread moves one 16-byte piece of a row; consecutive
// threads walk consecutive pieces, so one warp moves a whole 512-byte row at
// width 128 (two rows at 64) with 16-byte loads and stores, and the row's
// index is one load that the warp's lanes share.  An index outside the
// table writes all-ones words (the plain version, index_select, raises).
//
// Kernels 14/15, k_transpose: out = x^T for a (rows, cols) matrix of 32-bit
// words.  Replaces tools/transpose_probe.py::limb_T_fwd ((R, 16) -> (16, R),
// :42) and limb_T_bwd ((16, R) -> (R, 16), :68); one C entry point, bound
// twice so each direction has its own launch count.  The TPU's view of
// (R, 16) as (R/8, 128) fits its VMEM lanes and has no counterpart here: a
// block stages a tile of 2,048 words in shared memory (rows padded by one
// word against bank conflicts), reading rows of the input and writing rows
// of the output.  The tile keeps a narrow side whole, 128 x 16 for (R, 16)
// and 16 x 128 for (16, R), so that both its reads and its writes are
// contiguous runs of at least 512 bytes; other shapes take 64 x 32.
//
#include "arith.cuh"

#define T_THREADS 256

__global__ void k_gather_rows(const int* __restrict__ idx,
                              const uint4* __restrict__ tbl,
                              uint4* __restrict__ out, long long m,
                              int log_vecs, long long rows) {
  const long long total = m << log_vecs;
  const long long vmask = (1LL << log_vecs) - 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int r = __ldg(idx + (e >> log_vecs));
    uint4 v;
    if ((unsigned long long)(long long)r < (unsigned long long)rows) {
      v = __ldg(tbl + (((long long)r << log_vecs) | (e & vmask)));
    } else {
      v = make_uint4(~0u, ~0u, ~0u, ~0u);
    }
    out[e] = v;
  }
}

template <int TR, int TC>
__global__ void __launch_bounds__(T_THREADS)
    k_transpose(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                long long rows, long long cols, long long tiles_c) {
  static_assert(TR * TC % T_THREADS == 0, "whole tile per pass");
  __shared__ uint32_t tile[TR * (TC + 1)];
  const long long r0 = (long long)(blockIdx.x / tiles_c) * TR;
  const long long c0 = (long long)(blockIdx.x % tiles_c) * TC;
#pragma unroll
  for (int k = 0; k < TR * TC / T_THREADS; k++) {
    const int e = k * T_THREADS + threadIdx.x, r = e / TC, c = e % TC;
    if (r0 + r < rows && c0 + c < cols)
      tile[r * (TC + 1) + c] = x[(r0 + r) * cols + c0 + c];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < TR * TC / T_THREADS; k++) {
    const int e = k * T_THREADS + threadIdx.x, c = e / TR, r = e % TR;
    if (r0 + r < rows && c0 + c < cols)
      out[(c0 + c) * rows + r0 + r] = tile[r * (TC + 1) + c];
  }
}

template <int TR, int TC>
static void launch_transpose(const uint32_t* x, uint32_t* out, long long rows,
                             long long cols, cudaStream_t s) {
  const long long tiles_c = (cols + TC - 1) / TC;
  const long long tiles = ((rows + TR - 1) / TR) * tiles_c;
  k_transpose<TR, TC><<<(unsigned int)tiles, T_THREADS, 0, s>>>(
      x, out, rows, cols, tiles_c);
}

// idx: m int32 row indices; tbl: (rows, 4 << log_vecs) words; out:
// (m, 4 << log_vecs) words.  Returns cudaGetLastError().
extern "C" int h2_gather_rows(const void* idx, const void* tbl, void* out,
                              long long m, int log_vecs, long long rows,
                              void* stream) {
  if (m > 0) {
    k_gather_rows<<<h2_blocks(m << log_vecs, T_THREADS), T_THREADS, 0,
                    (cudaStream_t)stream>>>(
        (const int*)idx, (const uint4*)tbl, (uint4*)out, m, log_vecs, rows);
  }
  return (int)cudaGetLastError();
}

// x: (rows, cols) words; out: (cols, rows) words.  Returns
// cudaGetLastError().
extern "C" int h2_limb_T(const void* x, void* out, long long rows,
                         long long cols, void* stream) {
  if (rows > 0 && cols > 0) {
    const uint32_t* in = (const uint32_t*)x;
    uint32_t* o = (uint32_t*)out;
    cudaStream_t s = (cudaStream_t)stream;
    if (cols <= 16) {
      launch_transpose<128, 16>(in, o, rows, cols, s);
    } else if (rows <= 16) {
      launch_transpose<16, 128>(in, o, rows, cols, s);
    } else {
      launch_transpose<64, 32>(in, o, rows, cols, s);
    }
  }
  return (int)cudaGetLastError();
}
