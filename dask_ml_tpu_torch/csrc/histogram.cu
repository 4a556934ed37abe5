// K12 for Hopper (sm_90a), plain C ABI: one pass of the refining histogram
// sketch of per-feature quantiles.
//
// Replaces: dask_ml_tpu/preprocessing/data.py:94 hist_pass (the bin index
// and the below sum at :97-101, the bucket_sum into d·4096 segments at
// :106-109), under :60 _hist_quantiles.  What it computes, per feature j of
// x (n, d), over the rows whose mask is > 0:
//   below_j  = #{x < lo_j}
//   counts_j = histogram over 4096 bins of the rows with lo_j <= x <= hi_j,
//              bin clip(int((x − lo_j) / width_j · 4096), 0, 4095).
// lo, hi and width (the caller's max(hi − lo, 1e-30)) are read from device
// memory, so the sketch's passes need no host read between them.  The bin
// index rounds as the reference's float32 subtract, divide and multiply
// (__fsub_rn, __fdiv_rn, __fmul_rn: no contraction, no fast division), so
// the bins equal the plain version's.  The mask is a 0/1 row flag (the
// ingest mask); the reference weights by it, which is the same for 0 and 1.
//
// Bound on an H100: at 11M x 28 a pass reads x and the mask once (1.28 GB,
// 0.38 ms at 3.35 TB/s) and writes d·4097 counts; it does a few operations
// an element, so the bytes bound it.  The design:
//   - hist_kernel: a block takes a chunk of at most MAX_F features and a
//     range of rows.  It keeps the chunk's 4096-bin counts in shared memory
//     as uint32 (16 KB a feature) and adds to them with shared atomics;
//     threads are laid out feature-fastest (thread t: feature t mod F of row
//     t / F), so a warp reads a few whole row segments; a thread issues the
//     loads of U rows before it bins any of them.  Each thread counts
//     its below in a register and adds it to the block's once.  The chunks
//     of one row range are neighbours in the grid, so they read x through
//     L2 together.  The block then adds its non-zero bins into a global
//     uint32 (d, 4096) buffer with integer atomics: exact in any order, so
//     repeat launches give the same bits.
//   - to_float_kernel: the counts and below as float32 for the caller's
//     cumsum (exact up to 2^24 rows; the uint32 counts up to 2^32).
// What holds it back: every feature chunk reads its columns of the rows
// from memory apart (about twice x's bytes in sectors at d = 28 where L2
// does not join them), a constant column sends every row to one shared
// address, and each block's flush is d·4096/chunks global atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BINS = 4096;
constexpr int T = 512;
constexpr int MAX_F = 6;  // features a block: 96 KB of counts, two blocks a SM
constexpr int MIN_ROWS = 2048;  // rows a block at least
constexpr int U = 8;  // rows a thread loads before it bins them

__global__ void __launch_bounds__(T, 2)
hist_kernel(const float* __restrict__ x, const float* __restrict__ mask, long long n, int d,
            const float* __restrict__ lo, const float* __restrict__ hi,
            const float* __restrict__ width, int F, long long rows_per_block,
            unsigned* __restrict__ counts, unsigned* __restrict__ below) {
  extern __shared__ unsigned s_hist[];  // F x BINS counts, then F below counts
  unsigned* s_below = s_hist + F * BINS;
  const int f0 = blockIdx.x * F;
  const int nf = min(F, d - f0);
  for (int i = threadIdx.x; i < F * BINS + F; i += T) s_hist[i] = 0u;
  __syncthreads();

  const int R = T / nf;  // rows an iteration
  const int fl = threadIdx.x % nf;
  const int rl = threadIdx.x / nf;
  const long long r0 = (long long)blockIdx.y * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  if (rl < R) {
    const int f = f0 + fl;
    const float l = lo[f], h = hi[f], w = width[f];
    unsigned* hist = s_hist + fl * BINS;
    unsigned nbelow = 0;
    for (long long r = r0 + rl; r < r1; r += (long long)R * U) {
      float v[U], m[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {  // U rows' loads in flight before any is used
        const long long ru = r + (long long)u * R;
        m[u] = ru < r1 ? mask[ru] : 0.0f;
        v[u] = ru < r1 ? x[ru * d + f] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!(m[u] > 0.0f)) continue;
        if (v[u] < l) {
          ++nbelow;
        } else if (v[u] >= l && v[u] <= h) {
          const float pos = __fmul_rn(__fdiv_rn(__fsub_rn(v[u], l), w), (float)BINS);
          const int b = pos >= (float)(BINS - 1) ? BINS - 1 : (pos > 0.0f ? (int)pos : 0);
          atomicAdd(hist + b, 1u);
        }
      }
    }
    if (nbelow) atomicAdd(s_below + fl, nbelow);
  }
  __syncthreads();

  // the chunk's features are contiguous rows of the (d, BINS) buffer
  unsigned* out = counts + (long long)f0 * BINS;
  for (int i = threadIdx.x; i < nf * BINS; i += T) {
    const unsigned c = s_hist[i];
    if (c) atomicAdd(out + i, c);
  }
  if (threadIdx.x < nf && s_below[threadIdx.x]) atomicAdd(below + f0 + threadIdx.x,
                                                          s_below[threadIdx.x]);
}

__global__ void to_float_kernel(const unsigned* __restrict__ u, float* __restrict__ counts,
                                float* __restrict__ below, long long n_counts, int d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_counts) counts[i] = (float)u[i];
  else if (i < n_counts + d) below[i - n_counts] = (float)u[i];
}

}  // namespace

extern "C" {

const char* histogram_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x (n, d) and mask (n,) float32, contiguous; lo, hi, width (d,) float32;
// scratch: d·(4096 + 1) uint32 (the counts, then below); out: counts
// (d, 4096) and below (d,) float32.  All on one device, on `stream`.
int hist_pass(const float* x, const float* mask, long long n, int d, const float* lo,
              const float* hi, const float* width, unsigned* scratch, float* counts,
              float* below, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_counts = (long long)d * BINS;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)(n_counts + d) * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (d + MAX_F - 1) / MAX_F;
  const int F = (d + chunks - 1) / chunks;
  const size_t smem = (size_t)(F * BINS + F) * sizeof(unsigned);
  err = cudaFuncSetAttribute(hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)((MAX_F * BINS + MAX_F) * sizeof(unsigned)));
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hist_kernel, T, smem);
  if (err != cudaSuccess) return (int)err;
  long long row_blocks = (long long)sms * (per_sm > 0 ? per_sm : 1) / chunks;
  row_blocks = row_blocks < 1 ? 1 : row_blocks;
  const long long most = (n + MIN_ROWS - 1) / MIN_ROWS;
  if (row_blocks > most) row_blocks = most < 1 ? 1 : most;
  const long long rows_per_block = (n + row_blocks - 1) / row_blocks;
  if (n > 0) {
    hist_kernel<<<dim3(chunks, (unsigned)row_blocks), T, smem, s>>>(
        x, mask, n, d, lo, hi, width, F, rows_per_block, scratch, scratch + n_counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const long long total = n_counts + d;
  to_float_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(scratch, counts, below,
                                                                    n_counts, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
