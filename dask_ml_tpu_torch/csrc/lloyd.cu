// The Lloyd kernels for Hopper (sm_90a), plain C ABI: a fused assign +
// cluster reduce, and a register-tiled assign.
//
// Replaces: dask_ml_tpu/cluster/k_means.py :: _lloyd_step_fn (distances,
// argmin, masked inertia, per-cluster sums and counts) and _assign_fn /
// _phi_and_mind2 / _valid_d2 and the k-means|| `closest` argmin
// (distances, argmin, min), and with them the Pallas kernel that ebad2d0
// deleted (dask_ml_tpu/ops/lloyd.py :: lloyd_assign_reduce).  The n x k
// distance matrix is never written.  Both run in plain float32 FMA on the
// CUDA cores (no TF32, no tensor cores), so the argmin sees the same
// arithmetic as the reference's Precision.HIGHEST:
// d2 = max((|x|^2 + |c|^2) - 2 x.c, 0), each sum an fmaf chain in feature
// order.  No float atomics anywhere: the same input gives the same bits on
// the same card from run to run.  Every row index is 64-bit (row*d passes
// 2^31 at row 42.9M for d=50).
//
// reduce_kernel (lloyd_assign_reduce).  Bound on an H100: at k=8 one round
// reads n*d*4 + n*4 bytes and does n*k*d FMAs; at 100M x 50 that is
// 20.4 GB (6.1 ms at 3.35 TB/s) against 40 G FMAs (1.2 ms at 67 TFLOP/s),
// so the round is memory-bound.  A block stages a 256-row tile through
// shared memory once and keeps it there for both the distances and the
// reduce; one thread owns one row, centers pass through shared memory CT
// at a time and features DCH at a time.  The reduce gives each thread one
// feature column of one row group and walks the tile's rows in order into
// a (groups, k, d) partial in shared memory; where that does not fit, one
// group accumulates straight into the block's record in global scratch.
// A second kernel adds the per-block records in block order.
//
// assign_kernel (lloyd_assign).  Its largest caller is k-means||: every
// round is a pass over all n rows against the valid candidate slots so
// far (502 at the last round of a 100M x 50 fit), 2*n*k*d flops that put
// it far past the memory bound (100M x 50 x 502: 5.0 TFLOP, 75 ms at
// 67 TFLOP/s, against 21 GB, 6.4 ms).  The wrapper drops the invalid
// slots before the launch and passes the centers feature-major (d, k);
// the kernel maps each label back through `slot`.  The design is an
// SGEMM-style register tile with the argmin fused into its epilogue:
//   - A block owns BM rows at a time (grid-stride) and walks every BN-wide
//     center tile for them, so x is read from memory once per call (for
//     d <= DCH; past that, feature chunks are staged again per center tile)
//     and the running min/argmin stays in registers.
//   - x and the centers sit in shared memory feature-major; each thread
//     owns a TM x TN micro-tile, so one feature costs TM + TN shared loads
//     (float4 where TM, TN are multiples of 4) for TM*TN FMAs.
//   - The threads sharing a row merge (value, index) by warp shuffles; the
//     lower index wins on equal values, which is the first-index rule of
//     jnp.argmin since each thread walks its slots in increasing order.
//   - Two instances: 128 x 128 with 8 x 8 micro-tiles for many centers,
//     and 256 x 8 (one row a thread) for k <= SMALL_K, where the pass is
//     memory-bound and a wide center tile would compute mostly padding.
//   - Per-block inertia records, added in block order by finalize_kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 256;       // threads per block (both kernels)
constexpr int CT = 8;        // reduce: centers per register tile
constexpr int DCH = 64;      // features per staged chunk (both kernels)
constexpr int GMAX = 8;      // reduce: row groups
constexpr size_t SMEM_BUDGET = 200 * 1024;
constexpr int MAX_BLOCKS_PER_SM = 4;

// A reduce launch's plan: made once per call by lloyd_plan, which hands it
// to the caller as 8 int64s to size the scratch, and passed back to the
// launch.
struct Plan {
  long long w;          // staged chunk width, min(d, DCH)
  long long dp;         // row stride of the staged tile, odd: no bank conflicts
  long long groups;     // row groups in the reduce
  long long p_in_smem;  // the (groups, k*d + k) partial lives in shared memory;
                        // else groups == 1 and it is the block's own record
  long long smem;       // dynamic shared bytes per block
  long long blocks;
  long long rec;        // floats per block record: k*d + k + 1
  long long scratch;    // floats of scratch the call needs
};
static_assert(sizeof(Plan) == 8 * sizeof(long long), "Plan is 8 int64s");

__device__ __forceinline__ void stage_x(float* x_s, const float* __restrict__ x,
                                        long long r0, int rows, int d, int j0,
                                        int wc, int dp) {
  const int total = rows * wc;
  int r = threadIdx.x / wc, j = threadIdx.x % wc;
  const int dr = T / wc, dj = T % wc;
  if (wc == d) {  // the tile is one contiguous run of rows*d floats
    const float* src = x + r0 * d;
    for (int i = threadIdx.x; i < total; i += T) {
      x_s[r * dp + j] = __ldcs(src + i);
      r += dr; j += dj;
      if (j >= wc) { j -= wc; ++r; }
    }
  } else {
    for (int i = threadIdx.x; i < total; i += T) {
      x_s[r * dp + j] = __ldcs(x + (r0 + r) * d + j0 + j);
      r += dr; j += dj;
      if (j >= wc) { j -= wc; ++r; }
    }
  }
}

// c_s[j*CT + c] = centers[ct*CT + c][j0 + j]; slots past k are zero.
__device__ __forceinline__ void stage_c(float* c_s, const float* __restrict__ centers,
                                        int k, int d, int ct, int j0, int wc) {
  for (int i = threadIdx.x; i < CT * wc; i += T) {
    const int j = i / CT, c = i - j * CT;
    const int cc = ct * CT + c;
    c_s[i] = cc < k ? centers[(size_t)cc * d + j0 + j] : 0.f;
  }
}

// cn[i] = sum_j c(i, j)^2 with c(i, j) = c[i*si + j*sj], in feature order.
__global__ void cnorm_kernel(const float* __restrict__ c, int k, int d,
                             long long si, long long sj, float* __restrict__ cn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < k) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) {
      const float v = c[i * si + j * sj];
      s = fmaf(v, v, s);
    }
    cn[i] = s;
  }
}

__global__ void __launch_bounds__(T)
reduce_kernel(const float* __restrict__ x, const float* __restrict__ mask,
              const float* __restrict__ centers, const float* __restrict__ cn,
              long long n, int d, int k, Plan p, float* __restrict__ bpart) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int w = (int)p.w, dp = (int)p.dp, G = (int)p.groups;
  float* x_s = smem;
  float* c_s = x_s + T * dp;
  int* lab_s = reinterpret_cast<int*>(c_s + CT * w);
  float* w_s = reinterpret_cast<float*>(lab_s + T);
  float* r_s = w_s + T;
  const size_t kd = (size_t)k * d;
  float* out = bpart + (size_t)blockIdx.x * p.rec;
  float* P = p.p_in_smem ? r_s + T : out;
  float* Pc = P + G * kd;

  const long long ntiles = (n + T - 1) / T;
  const int nch = (d + w - 1) / w;
  const int nct = (k + CT - 1) / CT;

  for (size_t e = t; e < G * (kd + k); e += T) P[e] = 0.f;
  float inert = 0.f;
  long long c_staged = -1;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long r0 = tile * T;
    const int rows = (int)min((long long)T, n - r0);
    const bool live = t < rows;
    int x_staged = -1;
    float xn = 0.f, best = INFINITY;
    int bidx = 0;
    for (int ct = 0; ct < nct; ++ct) {
      float acc[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[c] = 0.f;
      for (int ch = 0; ch < nch; ++ch) {
        const int j0 = ch * w, wc = min(w, d - j0);
        const long long cid = (long long)ct * nch + ch;
        const bool need_x = x_staged != ch, need_c = c_staged != cid;
        if (need_x || need_c) {
          __syncthreads();  // all readers of the old contents are done
          if (need_x) { stage_x(x_s, x, r0, rows, d, j0, wc, dp); x_staged = ch; }
          if (need_c) { stage_c(c_s, centers, k, d, ct, j0, wc); c_staged = cid; }
          __syncthreads();
        }
        if (live) {
          const float* xr = x_s + t * dp;
#pragma unroll 2
          for (int j = 0; j < wc; ++j) {
            const float xj = xr[j];
            if (ct == 0) xn = fmaf(xj, xj, xn);
            const float4 a = *reinterpret_cast<const float4*>(c_s + j * CT);
            const float4 b = *reinterpret_cast<const float4*>(c_s + j * CT + 4);
            acc[0] = fmaf(xj, a.x, acc[0]);
            acc[1] = fmaf(xj, a.y, acc[1]);
            acc[2] = fmaf(xj, a.z, acc[2]);
            acc[3] = fmaf(xj, a.w, acc[3]);
            acc[4] = fmaf(xj, b.x, acc[4]);
            acc[5] = fmaf(xj, b.y, acc[5]);
            acc[6] = fmaf(xj, b.z, acc[6]);
            acc[7] = fmaf(xj, b.w, acc[7]);
          }
        }
      }
      if (live) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int cc = ct * CT + c;
          if (cc < k) {
            const float dd = fmaxf((xn + cn[cc]) - 2.f * acc[c], 0.f);
            if (dd < best) { best = dd; bidx = cc; }
          }
        }
      }
    }
    const float wgt = live ? mask[r0 + t] : 0.f;
    if (live) inert += wgt * best;
    lab_s[t] = bidx;
    w_s[t] = wgt;
    const int g = t / w, jj = t % w;
    for (int ch = 0; ch < nch; ++ch) {
      const int j0 = ch * w, wc = min(w, d - j0);
      __syncthreads();  // lab_s/w_s written; old x_s readers done
      if (x_staged != ch) {
        stage_x(x_s, x, r0, rows, d, j0, wc, dp);
        x_staged = ch;
        __syncthreads();
      }
      if (g < G && jj < wc) {
        float* Pg = P + g * kd + j0 + jj;
        for (int r = g; r < rows; r += G)
          Pg[(size_t)lab_s[r] * d] += w_s[r] * x_s[r * dp + jj];
        if (ch == 0 && jj == 0) {
          float* Pcg = Pc + (size_t)g * k;
          for (int r = g; r < rows; r += G) Pcg[lab_s[r]] += w_s[r];
        }
      }
    }
  }

  // per-block record, in a fixed order
  r_s[t] = inert;
  __syncthreads();
  for (int s = T / 2; s > 0; s >>= 1) {
    if (t < s) r_s[t] += r_s[t + s];
    __syncthreads();
  }
  if (p.p_in_smem) {
    for (size_t e = t; e < kd + k; e += T) {
      const float* src = e < kd ? P + e : Pc + (e - kd);
      const size_t stride = e < kd ? kd : (size_t)k;
      float s = 0.f;
      for (int g = 0; g < G; ++g) s += src[g * stride];
      out[e] = s;
    }
  }
  if (t == 0) out[p.rec - 1] = r_s[0];
}

// out[e] = sum over blocks b, in order, of bpart[b*rec + e]
__global__ void finalize_kernel(const float* __restrict__ bpart, int blocks,
                                long long rec, float* __restrict__ out) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < rec;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += bpart[(size_t)b * rec + e];
    out[e] = s;
  }
}

cudaError_t make_plan(long long n, int d, int k, Plan* p) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  p->w = d < DCH ? d : DCH;
  p->dp = p->w | 1;
  p->groups = T / p->w < GMAX ? T / p->w : GMAX;
  const size_t base = (size_t)(T * p->dp + CT * p->w + 3 * T) * sizeof(float);
  const size_t part = (size_t)p->groups * ((size_t)k * d + k) * sizeof(float);
  p->p_in_smem = base + part <= SMEM_BUDGET;
  if (!p->p_in_smem) p->groups = 1;
  p->smem = (long long)(base + (p->p_in_smem ? part : 0));
  err = cudaFuncSetAttribute(reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p->smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reduce_kernel, T,
                                                      (size_t)p->smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  if (per_sm > MAX_BLOCKS_PER_SM) per_sm = MAX_BLOCKS_PER_SM;
  // a record of k*d + k + 1 floats a block: keep large ones few
  if (!p->p_in_smem) per_sm = 1;
  const long long ntiles = (n + T - 1) / T;
  const long long most = (long long)sms * per_sm;
  p->blocks = ntiles < most ? ntiles : most;
  p->rec = (long long)k * d + k + 1;
  p->scratch = k + (long long)p->blocks * p->rec;
  return cudaSuccess;
}

// ---------------------------------------------------------------- assign

constexpr int SMALL_K = 64;  // k at or under this takes the one-row-a-thread instance

// Row stride in shared memory of a row-major x chunk of wc of d features,
// chosen so that 16-byte copies land aligned and a warp reading one
// feature of 32 rows meets at most 4-way bank conflicts:
//   - whole rows, and d % 4 != 0 or (d/4) odd: d, one flat copy of the tile;
//   - d % 4 == 0: wc or wc + 4, whichever is 4 x odd, 16 bytes at a time;
//   - else (d > DCH, d % 4 != 0): odd, 4 bytes at a time.
__host__ __device__ __forceinline__ int row_stride(int d, int wc) {
  if (wc == d && (d % 4 != 0 || (d / 4) % 2 == 1)) return d;
  if (d % 4 == 0) return (wc / 4) % 2 == 1 ? wc : wc + 4;
  return wc | 1;
}

// A block's tile: TY x TX threads, each owning TM rows x TN centers.  With
// TM == 1 (one row a thread) x sits in shared memory row-major, copied 16
// bytes at a time, and |x|^2 is a register of the row's thread; else x is
// feature-major, so that a thread reads its TM rows of a feature as float4s.
template <int TM_, int TN_, int TX_>
struct Tile {
  static constexpr int TM = TM_, TN = TN_, TX = TX_, TY = T / TX_;
  static constexpr int BM = TM * TY, BN = TN * TX;
  static constexpr bool ROWS = TM == 1;
  static constexpr int XP = BM + 4;  // feature stride of a feature-major x chunk
  static_assert(TN % 4 == 0 && (ROWS || TM % 4 == 0), "rows and centers are read as float4");
  static_assert(32 % TX == 0 && TM <= TX, "a row's TX threads share a warp; TM of them write");
  // floats of one x buffer and one center buffer for chunks of w of d features
  __host__ __device__ static int xbuf(int d, int w) {
    return ROWS ? (BM * row_stride(d, w) + 3) / 4 * 4 : w * XP;
  }
  __host__ __device__ static int cbuf(int w) { return w * BN; }
  // two of each, two cn buffers, xn, the inertia reduce
  static size_t smem(int d, int w) {
    return (size_t)(2 * xbuf(d, w) + 2 * cbuf(w) + 2 * BN + BM + T) * sizeof(float);
  }
};
using Wide = Tile<8, 8, 16>;   // 128 rows x 128 centers
using Narrow = Tile<1, 8, 1>;  // 256 rows x 8 centers

// The row of a block tile that micro-tile row i of thread row ty is: TM/4
// runs of 4 rows, TY*4 apart (or the thread's own row).
template <class S>
__device__ __forceinline__ int row_of(int i, int ty) {
  if constexpr (S::ROWS) return ty;
  else return (i / 4) * (S::TY * 4) + ty * 4 + i % 4;
}

// The center of a tile that micro-tile column c of thread column tx is.
template <class S>
__device__ __forceinline__ int col_of(int c, int tx) {
  return (c / 4) * (S::TX * 4) + tx * 4 + c % 4;
}

// Asynchronous copies from global to shared memory: 4 or 16 bytes, of
// which the first `bytes` are read and the rest are zero.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(a), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits for all but the newest group of this thread's copies
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// x[r0 + r][j0 + j] for r < BM, j < wc into a buffer; rows past n are zero.
// Row-major: xs[r*row_stride + j].  Feature-major: xs[j*XP + r], one
// element per copy, elements e = r*wc + j = t, t + T, ... (coalesced).
// x and r0*d are 16-byte aligned (the wrapper checks x; BM % 4 == 0).
template <class S>
__device__ __forceinline__ void copy_x(float* xs, const float* __restrict__ x, long long n,
                                       int d, long long r0, int j0, int wc) {
  const int rows = (int)min((long long)S::BM, n - r0);
  const float* src = x + r0 * d + j0;
  if constexpr (S::ROWS) {
    const int xp = row_stride(d, wc);
    if (wc == d && xp == d) {  // the tile is one contiguous run, copied as it lies
      const int live = rows * d;
      for (int e = 4 * threadIdx.x; e < S::BM * d; e += 4 * T) {
        const int b = 4 * min(max(live - e, 0), 4);
        cp_async16(xs + e, b ? src + e : x, b);
      }
      return;
    }
    if (d % 4 == 0) {  // wc/4 aligned 16-byte pieces a row
      const int q4 = wc / 4;
      for (int e = threadIdx.x; e < S::BM * q4; e += T) {
        const int r = e / q4, j = 4 * (e - r * q4);
        const bool in = r < rows;
        cp_async16(xs + r * xp + j, in ? src + (long long)r * d + j : x, in ? 16 : 0);
      }
      return;
    }
  }
  const int xp = S::ROWS ? row_stride(d, wc) : 0;
  int r = threadIdx.x / wc;
  int j = threadIdx.x - r * wc;
  const int dr = T / wc, dj = T - dr * wc;
  for (int e = threadIdx.x; e < S::BM * wc; e += T) {
    const bool in = r < rows;
    cp_async4(S::ROWS ? xs + r * xp + j : xs + j * S::XP + r,
              in ? src + (long long)r * d + j : x, in ? 4 : 0);
    r += dr; j += dj;
    if (j >= wc) { j -= wc; ++r; }
  }
}

// cs[j*BN + c] <- cT[(j0 + j)*ldc + c0 + c], cn_s[c] <- cn[c0 + c]; centers
// past k are zero.  cT is (d, ldc) with ldc % 4 == 0 and zeros past k, so
// the copies are 16-byte and coalesced.
template <class S>
__device__ __forceinline__ void copy_c(float* cs, float* cn_s, const float* __restrict__ cT,
                                       int ldc, const float* __restrict__ cn, int k, int c0,
                                       int j0, int wc) {
  constexpr int Q = S::BN / 4;
  for (int e = threadIdx.x; e < Q * wc; e += T) {
    const int j = e / Q, c = 4 * (e % Q);
    const bool in = c0 + c < ldc;
    cp_async16(cs + j * S::BN + c, in ? cT + (size_t)(j0 + j) * ldc + c0 + c : cT, in ? 16 : 0);
  }
  for (int c = threadIdx.x; c < S::BN; c += T)
    cp_async4(cn_s + c, c0 + c < k ? cn + c0 + c : cn, c0 + c < k ? 4 : 0);
}

// acc += x·c over the wc features of a chunk; XN: also xn += x·x (one row
// a thread).
template <class S, bool XN>
__device__ __forceinline__ void dot_chunk(const float* xb, const float* cb, int xp, int wc,
                                          int tx, int ty, float (&acc)[S::TM][S::TN],
                                          float& xn) {
  constexpr int TM = S::TM, TN = S::TN;
  const float* xr = xb + ty * xp;  // the thread's row (row-major)
#pragma unroll 2
  for (int j = 0; j < wc; ++j) {
    const float* cj = cb + j * S::BN;
    float a[TM], b[TN];
    if constexpr (S::ROWS) {
      a[0] = xr[j];
      if (XN) xn = fmaf(a[0], a[0], xn);
    } else {
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(xb + j * S::XP + row_of<S>(4 * h, ty));
        a[4 * h] = v.x; a[4 * h + 1] = v.y; a[4 * h + 2] = v.z; a[4 * h + 3] = v.w;
      }
    }
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(cj + col_of<S>(4 * q, tx));
      b[4 * q] = v.x; b[4 * q + 1] = v.y; b[4 * q + 2] = v.z; b[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
  }
}

// Folds a center tile into the running argmin (slots in increasing order,
// so strict < keeps the first of equal values) and clears acc.  CHECK:
// the tile runs past k.
template <class S, bool CHECK>
__device__ __forceinline__ void fold_tile(float (&acc)[S::TM][S::TN], const float (&xn)[S::TM],
                                          const float* cnb, int c0, int k, int tx,
                                          float (&best)[S::TM], int (&bidx)[S::TM]) {
#pragma unroll
  for (int i = 0; i < S::TM; ++i)
#pragma unroll
    for (int c = 0; c < S::TN; ++c) {
      const int col = col_of<S>(c, tx), cc = c0 + col;
      if (!CHECK || cc < k) {
        const float dd = fmaxf((xn[i] + cnb[col]) - 2.f * acc[i][c], 0.f);
        if (dd < best[i]) { best[i] = dd; bidx[i] = cc; }
      }
      acc[i][c] = 0.f;
    }
}

// A block walks steps (row tile, center tile, feature chunk), its row
// tiles grid-stride.  The copies of step s+1 are in flight while step s
// computes: x and the centers each have two buffers, and a buffer is
// refilled only when its step's data changes (x once per row tile for
// d <= DCH; the centers never, when they fit one tile and one chunk).
template <class S>
__global__ void __launch_bounds__(T, 2)
assign_kernel(const float* __restrict__ x, const float* __restrict__ mask,
              const float* __restrict__ cT, int ldc, const float* __restrict__ cn,
              const long long* __restrict__ slot, long long n, int d, int k,
              int64_t* __restrict__ labels, float* __restrict__ mind2,
              float* __restrict__ bpart) {
  constexpr int TM = S::TM, TX = S::TX, BM = S::BM, BN = S::BN;
  extern __shared__ __align__(16) float smem[];
  const int w = d < DCH ? d : DCH;
  const int XB = S::xbuf(d, w), CB = S::cbuf(w);
  float* xs = smem;               // 2 x buffers
  float* cs = xs + 2 * XB;        // 2 x (w x BN), feature-major
  float* cn_s = cs + 2 * CB;      // 2 x BN
  float* xn_s = cn_s + 2 * BN;    // BM (feature-major x only)
  float* r_s = xn_s + BM;         // T
  const int t = threadIdx.x, tx = t % TX, ty = t / TX;
  const int nch = (d + w - 1) / w, nct = (k + BN - 1) / BN;
  const long long ntiles = (n + BM - 1) / BM;

  long long tile = blockIdx.x;
  int ct = 0, ch = 0, px = 0, pc = 0;  // this step, and its x and center buffers
  bool x_new = true;
  copy_x<S>(xs, x, n, d, tile * BM, 0, w);
  copy_c<S>(cs, cn_s, cT, ldc, cn, k, 0, 0, w);
  cp_async_commit();

  float inert = 0.f;
  float best[TM], xn[TM], acc[TM][S::TN];
  int bidx[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = INFINITY;
    bidx[i] = 0;
    xn[i] = 0.f;
#pragma unroll
    for (int c = 0; c < S::TN; ++c) acc[i][c] = 0.f;
  }

  while (true) {
    long long tile2 = tile;
    int ct2 = ct, ch2 = ch + 1;
    if (ch2 == nch) {
      ch2 = 0;
      if (++ct2 == nct) { ct2 = 0; tile2 += gridDim.x; }
    }
    const bool more = tile2 < ntiles;
    const bool x2 = more && (tile2 != tile || ch2 != ch);
    const bool c2 = more && (ct2 != ct || ch2 != ch);
    const int wc2 = min(w, d - ch2 * w);
    if (x2) copy_x<S>(xs + (px ^ 1) * XB, x, n, d, tile2 * BM, ch2 * w, wc2);
    if (c2) copy_c<S>(cs + (pc ^ 1) * CB, cn_s + (pc ^ 1) * BN, cT, ldc, cn, k, ct2 * BN,
                      ch2 * w, wc2);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();  // this step's x and centers have landed, from every thread

    const long long r0 = tile * BM;
    const int wc = min(w, d - ch * w);
    const float* xb = xs + px * XB;
    const float* cb = cs + pc * CB;
    if constexpr (S::ROWS) {
      if (ct == 0) dot_chunk<S, true>(xb, cb, row_stride(d, wc), wc, tx, ty, acc, xn[0]);
      else dot_chunk<S, false>(xb, cb, row_stride(d, wc), wc, tx, ty, acc, xn[0]);
    } else {
      if (x_new && ct == 0) {  // |x|^2 once a row, in feature order
        for (int r = t; r < BM; r += T) {
          float s = ch == 0 ? 0.f : xn_s[r];
          for (int j = 0; j < wc; ++j) s = fmaf(xb[j * S::XP + r], xb[j * S::XP + r], s);
          xn_s[r] = s;
        }
      }
      dot_chunk<S, false>(xb, cb, 0, wc, tx, ty, acc, xn[0]);
    }

    if (ch == nch - 1) {  // the center tile is done: fold it into the argmin
      if constexpr (!S::ROWS) {
        if (ct == 0) __syncthreads();  // xn_s is written
#pragma unroll
        for (int i = 0; i < TM; ++i) xn[i] = xn_s[row_of<S>(i, ty)];
      }
      const float* cnb = cn_s + pc * BN;
      if ((ct + 1) * BN <= k) fold_tile<S, false>(acc, xn, cnb, ct * BN, k, tx, best, bidx);
      else fold_tile<S, true>(acc, xn, cnb, ct * BN, k, tx, best, bidx);
      if (ct == nct - 1) {  // the row tile is done: merge the TX threads of each
        const int rows = (int)min((long long)BM, n - r0);  // row, least (d2, index) wins
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float v = best[i];
          int ix = bidx[i];
#pragma unroll
          for (int off = TX / 2; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, v, off);
            const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
            if (ov < v || (ov == v && oi < ix)) { v = ov; ix = oi; }
          }
          const int row = row_of<S>(i, ty);
          if (tx == i && row < rows) {
            const long long g = r0 + row;
            labels[g] = slot != nullptr ? slot[ix] : (long long)ix;
            mind2[g] = v;
            inert += mask[g] * v;
          }
          best[i] = INFINITY;
          bidx[i] = 0;
          xn[i] = 0.f;
        }
      }
    }
    __syncthreads();  // this step's buffers may be refilled by the next step's copies
    if (!more) break;
    if (x2) px ^= 1;
    if (c2) pc ^= 1;
    x_new = x2;
    tile = tile2; ct = ct2; ch = ch2;
  }

  // per-block record, in a fixed order
  r_s[t] = inert;
  __syncthreads();
  for (int s = T / 2; s > 0; s >>= 1) {
    if (t < s) r_s[t] += r_s[t + s];
    __syncthreads();
  }
  if (t == 0) bpart[blockIdx.x] = r_s[0];
}

// An assign launch's plan, 4 int64s: which instance, blocks, dynamic
// shared bytes, floats of scratch.
struct AssignPlan {
  long long wide;
  long long blocks;
  long long smem;
  long long scratch;
};
static_assert(sizeof(AssignPlan) == 4 * sizeof(long long), "AssignPlan is 4 int64s");

template <class S>
cudaError_t plan_for(long long n, int d, int k, AssignPlan* p) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t smem = S::smem(d, d < DCH ? d : DCH);
  err = cudaFuncSetAttribute(assign_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, assign_kernel<S>, T, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const long long ntiles = (n + S::BM - 1) / S::BM;
  const long long most = (long long)sms * per_sm;
  p->blocks = ntiles < most ? ntiles : most;
  p->smem = (long long)smem;
  p->scratch = k + p->blocks;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* lloyd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Plans a lloyd_assign_reduce call with these sizes into plan (8 int64s;
// plan[7] is the floats of scratch it needs), to be passed back to it.
int lloyd_plan(long long n, int d, int k, void* plan) {
  return (int)make_plan(n, d, k, (Plan*)plan);
}

// x (n,d), mask (n,), centers (k,d): float32, contiguous, on one device.
// out: k*d sums, then k counts, then the inertia (k*d + k + 1 floats).
int lloyd_assign_reduce(const void* x, const void* mask, const void* centers,
                        long long n, int d, int k, const void* plan,
                        void* scratch, void* out, void* stream) {
  const Plan p = *(const Plan*)plan;
  cudaStream_t s = (cudaStream_t)stream;
  float* cn = (float*)scratch;
  float* bpart = cn + k;
  cnorm_kernel<<<(k + 127) / 128, 128, 0, s>>>((const float*)centers, k, d, d, 1, cn);
  reduce_kernel<<<(int)p.blocks, T, (size_t)p.smem, s>>>(
      (const float*)x, (const float*)mask, (const float*)centers, cn, n, d, k, p, bpart);
  const long long fb = (p.rec + 255) / 256;
  finalize_kernel<<<(int)(fb < 1024 ? fb : 1024), 256, 0, s>>>(
      bpart, (int)p.blocks, p.rec, (float*)out);
  return (int)cudaGetLastError();
}

// Plans a lloyd_assign call against k centers into plan (4 int64s;
// plan[3] is the floats of scratch it needs).
int assign_plan(long long n, int d, int k, void* plan) {
  AssignPlan* p = (AssignPlan*)plan;
  p->wide = k > SMALL_K;
  return (int)(p->wide ? plan_for<Wide>(n, d, k, p) : plan_for<Narrow>(n, d, k, p));
}

// x (n,d), mask (n,): float32, x 16-byte aligned; centers_t (d,ldc) float32,
// the k centers feature-major, ldc % 4 == 0, zeros past k; slot (k,) int64
// or null: the label of center i is slot[i] (else i).  labels (n,) int64,
// mind2 (n,) float32, inertia (1,).
int lloyd_assign(const void* x, const void* mask, const void* centers_t, int ldc,
                 const void* slot, long long n, int d, int k, const void* plan,
                 void* labels, void* mind2, void* scratch, void* inertia,
                 void* stream) {
  const AssignPlan p = *(const AssignPlan*)plan;
  cudaStream_t s = (cudaStream_t)stream;
  float* cn = (float*)scratch;
  float* bpart = cn + k;
  const float *xf = (const float*)x, *mf = (const float*)mask, *cf = (const float*)centers_t;
  const long long* sl = (const long long*)slot;
  cnorm_kernel<<<(k + 127) / 128, 128, 0, s>>>(cf, k, d, 1, ldc, cn);
  if (p.wide)
    assign_kernel<Wide><<<(int)p.blocks, T, (size_t)p.smem, s>>>(
        xf, mf, cf, ldc, cn, sl, n, d, k, (int64_t*)labels, (float*)mind2, bpart);
  else
    assign_kernel<Narrow><<<(int)p.blocks, T, (size_t)p.smem, s>>>(
        xf, mf, cf, ldc, cn, sl, n, d, k, (int64_t*)labels, (float*)mind2, bpart);
  finalize_kernel<<<1, 32, 0, s>>>(bpart, (int)p.blocks, 1, (float*)inertia);
  return (int)cudaGetLastError();
}

}  // extern "C"
