// K2: the logistic loss and its gradient over row shards, for Hopper
// (sm_90a), plain C ABI.
//
// Replaces: dask_ml_tpu/solvers/families.py :: Logistic.loss (:34) under
// jax.value_and_grad in dask_ml_tpu/solvers/lbfgs_core.py ::
// lbfgs_minimize (:248), which runs per row shard inside
// solvers/algorithms.py :: _admm_run.one_shard (one lane per shard), and
// the value-only probes of the line search (lbfgs_core.py:98, :112, :124,
// :130).  For every active lane p of x (P, m, d):
//   eta_i = x_i . beta_p
//   f_p   = sum_i mask_i * (softplus(eta_i) - y_i * eta_i)
//   g_p   = sum_i mask_i * (sigmoid(eta_i) - y_i) * x_i      (GRAD only)
// with softplus(e) = max(e, 0) + log1p(exp(-|e|)) and the sigmoid from
// the same exp(-|e|).  Inactive lanes are not read and their f, g are not
// written.
//
// Bound on an H100: one evaluation reads x once (n*d*4 bytes) plus y and
// the mask (n*8) and does 4*n*d flops (a dot and an axpy per row); at
// 11M x 29 that is 1.364 GB, 0.41 ms at 3.35 TB/s, against 1.3 GFLOP,
// 0.02 ms at 67 TFLOP/s: memory-bound by ~20x.  The reference reads x
// twice (forward matvec, transposed matvec).  The design:
//   - One read of x.  A block stages a tile of R whole rows (R*d
//     contiguous floats) in shared memory with 16-byte cp.async copies
//     (scalar copies only for the unaligned head and tail, so rows need no
//     alignment: d = 29 with the intercept), the next tile in flight while
//     this one is used.  The forward dot and the gradient's accumulate
//     both read the staged rows.
//   - Forward: S = 256/R threads a row, each summing the features
//     j = s, s+S, ... (an fmaf chain), joined by a fixed xor-shuffle tree.
//     At d = 29, R = 256 and each thread owns a row.
//   - Gradient: each thread owns a (row group, feature) slot and keeps its
//     tile's sum in a register, added once a tile to the slot's
//     shared-memory total (no other thread touches it).
//   - Deterministic: per-block records (f, then g) summed in block order by
//     finalize_kernel; no float atomics.  f is computed the same way with
//     and without the gradient, so both variants give the same f bits.
//   - Past d = 1536 a tile of 8 rows no longer fits; row_kernel then reads
//     each row from global memory, dots it with a block reduction, and
//     reads it again (from L1/L2) for the gradient, which it accumulates
//     in the block's record in global memory.
// Row indices are 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 256;               // threads per block
constexpr int TILE_FLOATS = 12288;   // most floats of one staged tile (48 KB)
constexpr int MIN_R = 8;             // fewest rows a tile (S = 32: a warp a row)

struct Plan {
  long long path;      // 0: tiled_kernel, 1: row_kernel
  long long R;         // rows a tile
  long long G;         // row groups of the gradient
  long long blocks;    // blocks a lane
  long long smem;      // dynamic shared memory, bytes
  long long rec;       // floats of a block record: 1 + d
  long long scratch;   // floats of scratch: P * blocks * rec
  long long pad;
};
static_assert(sizeof(Plan) == 8 * sizeof(long long), "Plan is 8 int64s");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(a), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(a), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits for all but the newest group of this thread's copies
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Floats that src lies past a 16-byte boundary.
__device__ __forceinline__ int misalign(const float* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// cnt contiguous floats from src into buf + misalign(src), so that source
// and destination agree modulo 16 bytes: scalar copies up to the first
// 16-byte boundary and after the last, 16-byte copies between.
__device__ __forceinline__ void copy_tile(float* buf, const float* src, int cnt) {
  float* dst = buf + misalign(src);
  const int head = min((4 - misalign(src)) & 3, cnt);
  const int body = (cnt - head) & ~3;
  for (int e = threadIdx.x; e < head; e += T) cp_async4(dst + e, src + e);
  for (int e = head + 4 * threadIdx.x; e < head + body; e += 4 * T) cp_async16(dst + e, src + e);
  for (int e = head + body + threadIdx.x; e < cnt; e += T) cp_async4(dst + e, src + e);
}

struct RowTerms {
  float loss;  // softplus(eta) - y*eta, times the mask
  float w;     // (sigmoid(eta) - y), times the mask
};

__device__ __forceinline__ RowTerms row_terms(float eta, float y, float m) {
  const float e = expf(-fabsf(eta));
  const float sp = fmaxf(eta, 0.f) + log1pf(e);
  const float sig = eta >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);
  return {m * (sp - y * eta), m * (sig - y)};
}

// Sum of v over the block, in a fixed order; every thread gets it.  red
// holds T/32 floats and is free again on return.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < T / 32; ++w) s += red[w];
  return s;
}

// Grid (blocks, P).  Block b of lane p takes the lane's row tiles b,
// b + blocks, ... and writes its record bpart[(p*blocks + b)*(1 + d)]: its
// f, then (GRAD) its g.
template <bool GRAD>
__global__ void __launch_bounds__(T) tiled_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ mask,
    const float* __restrict__ beta, const unsigned char* __restrict__ active, long long m,
    int d, int R, int G, float* __restrict__ bpart) {
  const int p = blockIdx.y;
  if (!active[p]) return;
  extern __shared__ __align__(16) float smem[];
  const int tile_floats = R * d + 4;
  float* beta_s = smem + 2 * tile_floats;
  float* w_s = beta_s + d;
  float* gacc = w_s + R;  // G*d slot totals (GRAD)
  __shared__ float red[T / 32];

  const int S = T / R, r_own = threadIdx.x / S, s_own = threadIdx.x - r_own * S;
  const int slots = G * d;
  for (int j = threadIdx.x; j < d; j += T) beta_s[j] = beta[(long long)p * d + j];
  if (GRAD)
    for (int e = threadIdx.x; e < slots; e += T) gacc[e] = 0.f;

  const float* xl = x + (long long)p * m * d;
  const float* yl = y + (long long)p * m;
  const float* ml = mask + (long long)p * m;
  const long long ntiles = (m + R - 1) / R;
  const long long step = gridDim.x;
  float floss = 0.f;

  long long t0 = blockIdx.x;
  if (t0 < ntiles) copy_tile(smem, xl + t0 * R * d, (int)min((long long)R, m - t0 * R) * d);
  cp_async_commit();
  int cur = 0;
  for (long long t = t0; t < ntiles; t += step, cur ^= 1) {
    const long long next = t + step;
    if (next < ntiles)
      copy_tile(smem + (cur ^ 1) * tile_floats, xl + next * R * d, (int)min((long long)R, m - next * R) * d);
    cp_async_commit();
    const long long r0 = t * R;
    const int rows = (int)min((long long)R, m - r0);
    float yv = 0.f, mv = 0.f;
    if (s_own == 0 && r_own < rows) {
      yv = yl[r0 + r_own];
      mv = ml[r0 + r_own];
    }
    cp_async_wait_prior();
    __syncthreads();
    const float* xs = smem + cur * tile_floats + misalign(xl + r0 * d);
    // forward: S threads a row, a fixed shuffle tree between them
    float eta = 0.f;
    if (r_own < rows) {
      const float* xr = xs + r_own * d;
      for (int j = s_own; j < d; j += S) eta = fmaf(xr[j], beta_s[j], eta);
    }
    for (int o = S >> 1; o > 0; o >>= 1) eta += __shfl_xor_sync(0xffffffffu, eta, o);
    if (s_own == 0 && r_own < rows) {
      const RowTerms rt = row_terms(eta, yv, mv);
      floss += rt.loss;
      if (GRAD) w_s[r_own] = rt.w;
    }
    if (GRAD) {
      __syncthreads();
      for (int e = threadIdx.x; e < slots; e += T) {
        const int q = e / d, j = e - q * d;
        float acc = 0.f;
        for (int r = q; r < rows; r += G) acc = fmaf(w_s[r], xs[r * d + j], acc);
        gacc[e] += acc;
      }
    }
    __syncthreads();  // this tile's buffer and w_s are free for the next tile
  }

  float* rec = bpart + ((long long)p * gridDim.x + blockIdx.x) * (1 + d);
  const float f = block_sum(floss, red);
  if (threadIdx.x == 0) rec[0] = f;
  if (GRAD) {
    __syncthreads();
    for (int j = threadIdx.x; j < d; j += T) {
      float s = 0.f;
      for (int q = 0; q < G; ++q) s += gacc[q * d + j];
      rec[1 + j] = s;
    }
  }
}

// Rows too wide for a staged tile: block b of lane p takes rows b,
// b + blocks, ...; each is dotted by the whole block and read again for
// the gradient, accumulated in the block's record (each element by one
// thread).
template <bool GRAD>
__global__ void __launch_bounds__(T) row_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ mask,
    const float* __restrict__ beta, const unsigned char* __restrict__ active, long long m,
    int d, float* __restrict__ bpart) {
  const int p = blockIdx.y;
  if (!active[p]) return;
  __shared__ float red[T / 32];
  float* rec = bpart + ((long long)p * gridDim.x + blockIdx.x) * (1 + d);
  float* g = rec + 1;
  const float* bl = beta + (long long)p * d;
  if (GRAD)
    for (int j = threadIdx.x; j < d; j += T) g[j] = 0.f;
  float floss = 0.f;
  for (long long r = blockIdx.x; r < m; r += gridDim.x) {
    const long long row = (long long)p * m + r;
    const float* xr = x + row * d;
    float part = 0.f;
    for (int j = threadIdx.x; j < d; j += T) part = fmaf(xr[j], bl[j], part);
    const float eta = block_sum(part, red);
    const RowTerms rt = row_terms(eta, y[row], mask[row]);
    floss += rt.loss;  // the same value in every thread; thread 0's counts
    if (GRAD)
      for (int j = threadIdx.x; j < d; j += T) g[j] = fmaf(rt.w, xr[j], g[j]);
  }
  if (threadIdx.x == 0) rec[0] = floss;
}

// For each active lane p: f[p] = sum over blocks b, in order, of record
// element 0, and (GRAD) g[p][j] of element 1 + j.
__global__ void finalize_kernel(const float* __restrict__ bpart, const unsigned char* __restrict__ active,
                                int blocks, int d, int grad, float* __restrict__ f,
                                float* __restrict__ g) {
  const int p = blockIdx.y;
  if (!active[p]) return;
  const int rec = 1 + d, used = grad ? rec : 1;
  const float* lane = bpart + (long long)p * blocks * rec;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < used; e += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += lane[(long long)b * rec + e];
    if (e == 0)
      f[p] = s;
    else
      g[(long long)p * d + e - 1] = s;
  }
}

// Rows a tile for d (a power of two from 256 down to MIN_R), or 0 when
// even MIN_R rows do not fit.
int tile_rows(int d) {
  for (int R = T; R >= MIN_R; R >>= 1)
    if ((long long)R * d <= TILE_FLOATS) return R;
  return 0;
}

// Lets tiled_kernel<GRAD> take all the dynamic shared memory a block may
// have beside its static array (so that a plan made for one shape stays valid after another shape's
// plan), and says how many blocks of smem bytes fit a SM.
template <bool GRAD>
cudaError_t occupancy(int dev, size_t smem, int* per_sm) {
  int most = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&attr, tiled_kernel<GRAD>);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tiled_kernel<GRAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most - (int)attr.sharedSizeBytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, tiled_kernel<GRAD>, T, smem);
}

}  // namespace

extern "C" {

const char* logistic_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Plans a call over P lanes of m rows and d features into plan (8 int64s;
// plan[6] is the floats of scratch it needs), to be passed back to
// logistic_value_and_grad.  The plan depends only on (P, m, d) and the
// card, so a lane's sums are taken in the same order whatever the other
// lanes do.
int logistic_plan(long long P, long long m, int d, void* plan) {
  Plan* p = (Plan*)plan;
  int dev = 0, sms = 0, per_sm = 1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int R = tile_rows(d);
  long long units;  // tiles (or rows) of a lane
  if (R > 0) {
    const int G = d <= T ? (T / d < R ? T / d : R) : 1;
    const size_t smem = sizeof(float) * ((size_t)2 * (R * d + 4) + d + R + (size_t)G * d);
    int ps_grad = 0, ps_value = 0;
    if ((err = occupancy<true>(dev, smem, &ps_grad)) != cudaSuccess) return (int)err;
    if ((err = occupancy<false>(dev, smem, &ps_value)) != cudaSuccess) return (int)err;
    per_sm = ps_grad < ps_value ? ps_grad : ps_value;
    p->path = 0;
    p->R = R;
    p->G = G;
    p->smem = (long long)smem;
    units = (m + R - 1) / R;
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_kernel<true>, T, 0);
    if (err != cudaSuccess) return (int)err;
    p->path = 1;
    p->R = 1;
    p->G = 1;
    p->smem = 0;
    units = m;
  }
  if (per_sm < 1) per_sm = 1;
  // one wave over all lanes, split evenly between them
  long long blocks = (long long)sms * per_sm / P;
  if (blocks < 1) blocks = 1;
  if (blocks > units) blocks = units;
  p->blocks = blocks;
  p->rec = 1 + d;
  p->scratch = P * blocks * p->rec;
  p->pad = 0;
  return (int)cudaSuccess;
}

// x (P, m, d), y (P, m), mask (P, m), beta (P, d): float32, contiguous, on
// one device; active (P,) bool.  f (P,), g (P, d) float32: written only
// for active lanes, g only when grad != 0.  scratch: plan[6] floats.
int logistic_value_and_grad(const void* x, const void* y, const void* mask, const void* beta,
                            const void* active, long long P, long long m, int d, int grad,
                            const void* plan, void* scratch, void* f, void* g, void* stream) {
  const Plan p = *(const Plan*)plan;
  cudaStream_t s = (cudaStream_t)stream;
  const float *xf = (const float*)x, *yf = (const float*)y, *mf = (const float*)mask,
              *bf = (const float*)beta;
  const unsigned char* act = (const unsigned char*)active;
  float* bpart = (float*)scratch;
  const dim3 grid((unsigned)p.blocks, (unsigned)P);
  if (p.path == 0) {
    if (grad)
      tiled_kernel<true><<<grid, T, (size_t)p.smem, s>>>(xf, yf, mf, bf, act, m, d, (int)p.R,
                                                         (int)p.G, bpart);
    else
      tiled_kernel<false><<<grid, T, (size_t)p.smem, s>>>(xf, yf, mf, bf, act, m, d, (int)p.R,
                                                          (int)p.G, bpart);
  } else {
    if (grad)
      row_kernel<true><<<grid, T, 0, s>>>(xf, yf, mf, bf, act, m, d, bpart);
    else
      row_kernel<false><<<grid, T, 0, s>>>(xf, yf, mf, bf, act, m, d, bpart);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int used = grad ? d + 1 : 1;
  const dim3 fgrid((unsigned)((used + 255) / 256), (unsigned)P);
  finalize_kernel<<<fgrid, 256, 0, s>>>(bpart, act, (int)p.blocks, d, grad, (float*)f, (float*)g);
  return (int)cudaGetLastError();
}

}  // extern "C"
