// K10 for Hopper (sm_90a), plain C ABI: cancellation-guarded pairwise
// squared distances with a fused epilogue (d², √d² or exp(−γd²)).
//
// Replaces: dask_ml_tpu/metrics/pairwise.py:153 _sq_euclidean_safe, with
// :142 _exact_sq_chunked and :120 _row_chunked, under :209 _euclid_tile,
// :376 _rbf_tile and :344 _SelfTile.  What it computes, as the reference:
//   a  = 0.5 (mean_rows x + mean_rows y), and x, y centred on it;
//   d² = max((|x|² + |y|²) − 2 x·y, 0) in float32;
//   where d² < TAU (|x|² + |y|²) (TAU = 1e-2, :117) the expansion has lost
//   its digits to cancellation, and d² is recomputed exactly as Σ(x−y)²;
//   self_pairs: the global diagonal (row0 + i == col0 + j) is 0, unflagged.
// Every sum is a float32 fmaf chain in feature order, on the CUDA cores
// (no TF32: the reference's Precision.HIGHEST).
//
// Bound on an H100: at x (2^20, 50) against y (1024, 50) the call writes
// 4.29 GB of output and reads 0.21 GB (1.35 ms at 3.35 TB/s) and does
// 2·n·m·d = 107 GFLOP of products (1.6 ms at 67 TFLOP/s float32): the
// products bound it, and the output must stream out under them.  At x
// (10M, 50) against a Nyström sample of 100 rows it is the bytes (2 GB in,
// 4 GB out).  The design:
//   - colsum_kernel: per-block column sums of x and of y (one read each, a
//     fixed order), then anchor_kernel sums them in block order into a.
//   - tile_kernel: an SGEMM-style 128 x 128 output tile a block, 256
//     threads each owning an 8 x 8 micro-tile (8 + 8 shared loads, as
//     float4s, for 64 FMAs a feature).  x and y are centred while they are
//     staged feature-major into shared memory, 64 features at a time; the
//     row norms come from the same staged chunks.  With d <= 64 the whole
//     centred tile stays in shared memory, so a flagged entry's exact
//     recompute reads it there (near-duplicate rows are the only case that
//     flags); past 64 features the recompute reads the rows again from
//     global memory.  The epilogue applies the self-pair rule, the flag,
//     the exact recompute and the output function, and streams the tile
//     out as float4s where the output rows allow.  The output may be a
//     column block of a wider matrix (ldo), so a ring step writes its
//     block in place.
//   - The flagged entries are counted (one integer atomic a warp).
// No float atomics: the same input gives the same bits.  Row indices are
// 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 256;               // threads per block (every kernel)
constexpr int TX = 16, TY = 16;      // tile_kernel's thread grid
constexpr int TM = 8, TN = 8;        // a thread's micro-tile
constexpr int BM = TM * TY;          // 128 x rows a tile
constexpr int BN = TN * TX;          // 128 y rows a tile
constexpr int DCH = 64;              // features staged at a time
constexpr int XP = BM + 4;           // feature stride of a staged chunk
constexpr float TAU = 1e-2f;         // the reference's _SAFE_TAU
constexpr int MAX_SUM_BLOCKS = 1024;
static_assert(BM == BN && BM + BN == T, "a thread computes one row or column norm");

// Blocks of colsum_kernel for n rows.
__host__ __device__ __forceinline__ long long sum_blocks(long long n) {
  const long long b = (n + T - 1) / T;
  return b < 1 ? 1 : b > MAX_SUM_BLOCKS ? MAX_SUM_BLOCKS : b;
}

// part[b*d + j] = Σ x[r][j] over block b's rows: a thread sums its group's
// rows in order, then the groups are added in order.
__global__ void colsum_kernel(const float* __restrict__ x, long long n, int d,
                              long long per_block, float* __restrict__ part) {
  __shared__ float red[T];
  const int t = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * per_block;
  const long long r1 = r0 + per_block < n ? r0 + per_block : n;
  const int W = d < T ? d : T;  // columns a pass
  const int G = T / W;          // row groups
  for (int j0 = 0; j0 < d; j0 += W) {
    const int g = t / W, j = j0 + t % W;
    float s = 0.f;
    if (g < G && j < d)
      for (long long r = r0 + g; r < r1; r += G) s += x[r * d + j];
    red[t] = s;
    __syncthreads();
    if (t < W && j0 + t < d) {
      float tot = 0.f;
      for (int gg = 0; gg < G; ++gg) tot += red[gg * W + t];
      part[(size_t)blockIdx.x * d + j0 + t] = tot;
    }
    __syncthreads();
  }
}

// anchor[j] = 0.5 (Σ_b px[b][j] / n + Σ_b py[b][j] / m), blocks in order.
__global__ void anchor_kernel(const float* __restrict__ px, int bx, long long n,
                              const float* __restrict__ py, int by, long long m, int d,
                              float* __restrict__ anchor) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < d; j += gridDim.x * blockDim.x) {
    float sx = 0.f, sy = 0.f;
    for (int b = 0; b < bx; ++b) sx += px[(size_t)b * d + j];
    for (int b = 0; b < by; ++b) sy += py[(size_t)b * d + j];
    anchor[j] = 0.5f * (sx / (float)n + sy / (float)m);
  }
}

struct Args {
  const float* x;
  const float* y;
  const float* anchor;
  long long n, m;
  int d;
  int self_pairs;
  long long row0, col0;  // global offsets of x's row 0 and y's row 0
  int kind;              // 0: d², 1: √d², 2: exp(neg_gamma·d²)
  float neg_gamma;
  float* out;
  long long ldo;         // out's row stride, in floats
  int vec;               // out rows take 16-byte stores
  long long nct;         // column tiles
  unsigned long long* flagged;
};

// The micro-tile's rows and columns: TM/4 runs of 4 rows, TY*4 apart, and
// likewise for the columns, so that a thread reads its 8 of a feature as
// two float4s and a warp's stores of a row are contiguous 16-byte runs.
__device__ __forceinline__ int row_of(int i, int ty) { return (i / 4) * (TY * 4) + ty * 4 + i % 4; }
__device__ __forceinline__ int col_of(int c, int tx) { return (c / 4) * (TX * 4) + tx * 4 + c % 4; }

__device__ __forceinline__ float finish(float d2, int kind, float neg_gamma) {
  return kind == 0 ? d2 : kind == 1 ? sqrtf(d2) : expf(neg_gamma * d2);
}

// Stages features [j0, j0 + wc) of rows [r0, r0 + BM) of v, centred, into
// vs[j*XP + r]; rows past `rows` are zero.  Element e = r*wc + j walks the
// rows in memory order, so a warp's loads are contiguous.
__device__ __forceinline__ void stage(float* vs, const float* __restrict__ v,
                                      const float* __restrict__ anchor, long long rows,
                                      long long r0, int d, int j0, int wc) {
  for (int e = threadIdx.x; e < BM * wc; e += T) {
    const int r = e / wc, j = e - r * wc;
    const long long g = r0 + r;
    vs[j * XP + r] = g < rows ? v[g * d + j0 + j] - anchor[j0 + j] : 0.f;
  }
}

__global__ void __launch_bounds__(T, 2) tile_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int d = a.d;
  const int w = d < DCH ? d : DCH;
  float* xs = smem;           // w x XP, feature-major, centred
  float* ys = xs + w * XP;    // likewise for y
  float* xn_s = ys + w * XP;  // BM row norms
  float* yn_s = xn_s + BM;    // BN column norms
  const int t = threadIdx.x, tx = t % TX, ty = t / TX;
  const long long tile = blockIdx.x;
  const long long r0 = (tile / a.nct) * BM, c0 = (tile % a.nct) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;

  for (int j0 = 0; j0 < d; j0 += w) {
    const int wc = min(w, d - j0);
    if (j0 > 0) __syncthreads();  // the last chunk's reads are done
    stage(xs, a.x, a.anchor, a.n, r0, d, j0, wc);
    stage(ys, a.y, a.anchor, a.m, c0, d, j0, wc);
    __syncthreads();
    {  // thread t < BM: row t's norm; else column t - BM's
      const float* v = t < BM ? xs + t : ys + (t - BM);
      float* nrm = t < BM ? xn_s + t : yn_s + (t - BM);
      float s = j0 == 0 ? 0.f : *nrm;
      for (int j = 0; j < wc; ++j) s = fmaf(v[j * XP], v[j * XP], s);
      *nrm = s;
    }
#pragma unroll 2
    for (int j = 0; j < wc; ++j) {
      float av[TM], bv[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 u = *reinterpret_cast<const float4*>(xs + j * XP + row_of(4 * h, ty));
        av[4 * h] = u.x; av[4 * h + 1] = u.y; av[4 * h + 2] = u.z; av[4 * h + 3] = u.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 u = *reinterpret_cast<const float4*>(ys + j * XP + col_of(4 * h, tx));
        bv[4 * h] = u.x; bv[4 * h + 1] = u.y; bv[4 * h + 2] = u.z; bv[4 * h + 3] = u.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
  }
  __syncthreads();  // every norm is written

  const bool whole = d <= DCH;  // the centred tile is still in shared memory
  unsigned int nflag = 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row_of(i, ty);
    const long long gr = r0 + r;
    if (gr >= a.n) continue;
    const float xn = xn_s[r];
    float* orow = a.out + gr * a.ldo;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int cc0 = col_of(4 * q, tx);
      const long long gc0 = c0 + cc0;
      if (gc0 >= a.m) continue;
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int cc = cc0 + u;
        const long long gc = gc0 + u;
        const float scale = xn + yn_s[cc];
        float d2 = fmaxf(scale - 2.f * acc[i][4 * q + u], 0.f);
        bool flag = d2 < TAU * scale;
        if (a.self_pairs && a.row0 + gr == a.col0 + gc) {
          d2 = 0.f;
          flag = false;
        }
        if (flag && gc < a.m) {
          ++nflag;
          float s = 0.f;
          if (whole) {
            for (int j = 0; j < d; ++j) {
              const float e = xs[j * XP + r] - ys[j * XP + cc];
              s = fmaf(e, e, s);
            }
          } else {
            const float* xr = a.x + gr * d;
            const float* yr = a.y + gc * d;
            for (int j = 0; j < d; ++j) {
              const float e = (xr[j] - a.anchor[j]) - (yr[j] - a.anchor[j]);
              s = fmaf(e, e, s);
            }
          }
          d2 = s;
        }
        v[u] = finish(d2, a.kind, a.neg_gamma);
      }
      if (a.vec && gc0 + 3 < a.m) {
        __stcs(reinterpret_cast<float4*>(orow + gc0), make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (gc0 + u < a.m) __stcs(orow + gc0 + u, v[u]);
      }
    }
  }
  const unsigned int warp_flags = __reduce_add_sync(0xffffffffu, nflag);
  if ((t & 31) == 0 && warp_flags) atomicAdd(a.flagged, (unsigned long long)warp_flags);
}

size_t tile_smem(int d) {
  const int w = d < DCH ? d : DCH;
  return (size_t)(2 * w * XP + BM + BN) * sizeof(float);
}

}  // namespace

extern "C" {

const char* pairwise_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Floats of scratch a call needs: the column-sum records of x and y, and
// the anchor.
long long pairwise_scratch_floats(long long n, long long m, int d) {
  return (sum_blocks(n) + sum_blocks(m) + 1) * (long long)d;
}

// x (n, d), y (m, d): float32, contiguous, on one device.  out: n rows of
// m floats, ldo apart (a column block of a wider matrix, or the whole of an
// (n, m) one).  kind 0 writes d², 1 √d², 2 exp(−gamma·d²).  self_pairs:
// x and y are row blocks of one matrix at global offsets row0 and col0.
// flagged: one uint64, to which the count of recomputed entries is added.
int sq_euclidean_safe(const void* x, long long n, const void* y, long long m, int d,
                      long long row0, long long col0, int self_pairs, int kind, float gamma,
                      void* out, long long ldo, void* scratch, void* flagged, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* yf = (const float*)y;
  float* part_x = (float*)scratch;
  const long long bx = sum_blocks(n), by = sum_blocks(m);
  float* part_y = part_x + bx * d;
  float* anchor = part_y + by * d;
  colsum_kernel<<<(int)bx, T, 0, s>>>(xf, n, d, (n + bx - 1) / bx, part_x);
  const bool same = yf == xf && m == n;
  if (!same) colsum_kernel<<<(int)by, T, 0, s>>>(yf, m, d, (m + by - 1) / by, part_y);
  anchor_kernel<<<(d + T - 1) / T, T, 0, s>>>(part_x, (int)bx, n, same ? part_x : part_y,
                                              (int)(same ? bx : by), m, d, anchor);
  Args a;
  a.x = xf; a.y = yf; a.anchor = anchor;
  a.n = n; a.m = m; a.d = d;
  a.self_pairs = self_pairs; a.row0 = row0; a.col0 = col0;
  a.kind = kind; a.neg_gamma = -gamma;
  a.out = (float*)out; a.ldo = ldo;
  a.vec = ((uintptr_t)out % 16 == 0) && (ldo % 4 == 0);
  a.nct = (m + BN - 1) / BN;
  a.flagged = (unsigned long long*)flagged;
  const long long tiles = (n + BM - 1) / BM * a.nct;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = tile_smem(d);
  cudaError_t err = cudaFuncSetAttribute(tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  tile_kernel<<<(unsigned)tiles, T, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
