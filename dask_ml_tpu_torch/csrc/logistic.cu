// K2: a GLM family's loss and its gradient over row shards, for Hopper
// (sm_90a), plain C ABI.  One template, three families, two design types.
//
// Replaces: dask_ml_tpu/solvers/families.py :: Logistic.loss (:34),
// Normal.loss (:53) and Poisson.loss (:111) under jax.value_and_grad in
// dask_ml_tpu/solvers/lbfgs_core.py :: lbfgs_minimize (:248), which runs
// per row shard inside solvers/algorithms.py :: _admm_run.one_shard (one
// lane per shard), in _lbfgs_run, _gd_run, _pg_run and _newton_run (one
// lane over all rows), and the value-only probes of the line searches
// (lbfgs_core.py:98, :112, :124, :130; algorithms.py:259).  For every
// active lane p of x (P, m, d):
//   eta_i = x_i . beta_p
//   f_p   = sum_i mask_i * loss(eta_i, y_i)
//   g_p   = sum_i mask_i * w(eta_i, y_i) * x_i                (GRAD only)
// with, by family (a functor below):
//   Logistic  loss = softplus(eta) - y*eta   w = sigmoid(eta) - y
//   Normal    loss = (y - eta)^2 / 2         w = eta - y
//   Poisson   loss = exp(eta) - y*eta        w = exp(eta) - y
// softplus(e) = max(e, 0) + log1p(exp(-|e|)) and the sigmoid from the same
// exp(-|e|).  x is float32 or bfloat16 (the reference's mixed precision:
// bf16 X, float32 parameters); a bf16 element is widened to float32 in
// registers and every product and sum is float32.  y, mask, beta, f and g
// are float32.  Inactive lanes are not read and their f, g are not
// written.  The mask is a weight (sample weights scale it), so the half of
// the Normal loss is a factor of every row's term.
//
// Bound on an H100: one evaluation reads x once (n*d*e bytes, e = 4 for
// float32 and 2 for bf16) plus y and the mask (n*8) and does 4*n*d flops
// (a dot and an axpy per row).  At the ADMM shape (8, 1.375M, 29), n = 11M:
//   float32  1.276 GB of x + 0.088 GB = 1.364 GB, 0.4072 ms at 3.35 TB/s
//   bf16     0.638 GB of x + 0.088 GB = 0.726 GB, 0.2167 ms
// against 1.276 GFLOP, 0.019 ms at 67 TFLOP/s (the exp and log of a row
// are per row, not per element): memory-bound by ~20x (float32) and ~11x
// (bf16).  The reference reads x twice (forward matvec, transposed
// matvec).  The design:
//   - One read of x.  A block stages a tile of R whole rows (R*d
//     contiguous elements) in shared memory with 16-byte cp.async copies
//     (single-element copies only for the unaligned head and tail, so rows
//     need no alignment: d = 29 with the intercept, 58-byte bf16 rows), the
//     next tile in flight while this one is used.  The forward dot and the
//     gradient's accumulate both read the staged rows.
//   - Forward: S = 256/R threads a row, each summing the features
//     j = s, s+S, ... (an fmaf chain), joined by a fixed xor-shuffle tree.
//     At d = 29, R = 256 and each thread owns a row.
//   - Gradient: each thread owns a (row group, feature) slot and keeps its
//     tile's sum in a register, added once a tile to the slot's
//     shared-memory total (no other thread touches it).
//   - Deterministic: per-block records (f, then g) summed in block order by
//     finalize_kernel; no float atomics.  f is computed the same way with
//     and without the gradient, so both variants give the same f bits.
//     The Logistic functor is the first design's arithmetic, so float32
//     logistic keeps its bits.
//   - Past d = 1536 a tile of 8 rows no longer fits (the tile's element
//     count is capped for both types, so a shape takes the same path in
//     either); row_kernel then reads each row from global memory, dots it
//     with a block reduction, and reads it again (from L1/L2) for the
//     gradient, which it accumulates in the block's record in global
//     memory.
// Row indices are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 256;               // threads per block
constexpr int TILE_ELEMS = 12288;    // most elements of one staged tile (48 KB of float32)
constexpr int MIN_R = 8;             // fewest rows a tile (S = 32: a warp a row)

struct Plan {
  long long path;      // 0: tiled_kernel, 1: row_kernel
  long long R;         // rows a tile
  long long G;         // row groups of the gradient
  long long blocks;    // blocks a lane
  long long smem;      // dynamic shared memory, bytes
  long long rec;       // floats of a block record: 1 + d
  long long scratch;   // floats of scratch: P * blocks * rec
  long long esize;     // bytes of an element of x: 4 (float32) or 2 (bf16)
};
static_assert(sizeof(Plan) == 8 * sizeof(long long), "Plan is 8 int64s");

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(a), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
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

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// One element of a tile's unaligned head or tail: asynchronously where it
// is 4 bytes; a bf16 element (2-byte aligned only, below cp.async's
// least size) by a plain load and store, made visible by the barrier that
// follows the wait for the tile.
__device__ __forceinline__ void copy1(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void copy1(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *dst = *src;
}

// Elements that src lies past a 16-byte boundary.
template <typename E>
__device__ __forceinline__ int misalign(const E* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(E));
}

// cnt contiguous elements from src into buf + misalign(src), so that
// source and destination agree modulo 16 bytes: single-element copies up
// to the first 16-byte boundary and after the last, 16-byte copies
// between.
template <typename E>
__device__ __forceinline__ void copy_tile(E* buf, const E* src, int cnt) {
  constexpr int V = 16 / sizeof(E);  // elements of a 16-byte copy
  const int mis = misalign(src);
  E* dst = buf + mis;
  const int head = min((V - mis) & (V - 1), cnt);
  const int body = (cnt - head) & ~(V - 1);
  for (int e = threadIdx.x; e < head; e += T) copy1(dst + e, src + e);
  for (int e = head + V * threadIdx.x; e < head + body; e += V * T) cp_async16(dst + e, src + e);
  for (int e = head + body + threadIdx.x; e < cnt; e += T) copy1(dst + e, src + e);
}

struct RowTerms {
  float loss;  // the row's loss term, times the mask
  float w;     // d loss / d eta, times the mask
};

// The families: a row's terms from eta, y and the mask.
struct Logistic {
  __device__ __forceinline__ static RowTerms terms(float eta, float y, float m) {
    const float e = expf(-fabsf(eta));
    const float sp = fmaxf(eta, 0.f) + log1pf(e);
    const float sig = eta >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);
    return {m * (sp - y * eta), m * (sig - y)};
  }
};
struct Normal {
  __device__ __forceinline__ static RowTerms terms(float eta, float y, float m) {
    const float r = y - eta;
    return {m * (0.5f * r * r), m * (eta - y)};
  }
};
struct Poisson {
  // exp overflows past eta ~ 88.7: the terms are then inf (and NaN where
  // the mask is 0), as the reference's and the plain version's are
  __device__ __forceinline__ static RowTerms terms(float eta, float y, float m) {
    const float mu = expf(eta);
    return {m * (mu - y * eta), m * (mu - y)};
  }
};

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
// f, then (GRAD) its g.  Shared memory: two tile buffers of R*d + V
// elements of E (V = 16/sizeof(E), room for the source's offset mod 16
// bytes), then beta, the row weights and the gradient slots as floats.
template <typename F, typename E, bool GRAD>
__global__ void __launch_bounds__(T) tiled_kernel(
    const E* __restrict__ x, const float* __restrict__ y, const float* __restrict__ mask,
    const float* __restrict__ beta, const unsigned char* __restrict__ active, long long m,
    int d, int R, int G, float* __restrict__ bpart) {
  const int p = blockIdx.y;
  if (!active[p]) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* tiles = reinterpret_cast<E*>(smem_raw);
  const int tile_elems = R * d + 16 / (int)sizeof(E);
  float* beta_s = reinterpret_cast<float*>(tiles + 2 * tile_elems);
  float* w_s = beta_s + d;
  float* gacc = w_s + R;  // G*d slot totals (GRAD)
  __shared__ float red[T / 32];

  const int S = T / R, r_own = threadIdx.x / S, s_own = threadIdx.x - r_own * S;
  const int slots = G * d;
  for (int j = threadIdx.x; j < d; j += T) beta_s[j] = beta[(long long)p * d + j];
  if (GRAD)
    for (int e = threadIdx.x; e < slots; e += T) gacc[e] = 0.f;

  const E* xl = x + (long long)p * m * d;
  const float* yl = y + (long long)p * m;
  const float* ml = mask + (long long)p * m;
  const long long ntiles = (m + R - 1) / R;
  const long long step = gridDim.x;
  float floss = 0.f;

  long long t0 = blockIdx.x;
  if (t0 < ntiles) copy_tile(tiles, xl + t0 * R * d, (int)min((long long)R, m - t0 * R) * d);
  cp_async_commit();
  int cur = 0;
  for (long long t = t0; t < ntiles; t += step, cur ^= 1) {
    const long long next = t + step;
    if (next < ntiles)
      copy_tile(tiles + (cur ^ 1) * tile_elems, xl + next * R * d,
                (int)min((long long)R, m - next * R) * d);
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
    const E* xs = tiles + cur * tile_elems + misalign(xl + r0 * d);
    // forward: S threads a row, a fixed shuffle tree between them
    float eta = 0.f;
    if (r_own < rows) {
      const E* xr = xs + r_own * d;
      for (int j = s_own; j < d; j += S) eta = fmaf(widen(xr[j]), beta_s[j], eta);
    }
    for (int o = S >> 1; o > 0; o >>= 1) eta += __shfl_xor_sync(0xffffffffu, eta, o);
    if (s_own == 0 && r_own < rows) {
      const RowTerms rt = F::terms(eta, yv, mv);
      floss += rt.loss;
      if (GRAD) w_s[r_own] = rt.w;
    }
    if (GRAD) {
      __syncthreads();
      for (int e = threadIdx.x; e < slots; e += T) {
        const int q = e / d, j = e - q * d;
        float acc = 0.f;
        for (int r = q; r < rows; r += G) acc = fmaf(w_s[r], widen(xs[r * d + j]), acc);
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
template <typename F, typename E, bool GRAD>
__global__ void __launch_bounds__(T) row_kernel(
    const E* __restrict__ x, const float* __restrict__ y, const float* __restrict__ mask,
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
    const E* xr = x + row * d;
    float part = 0.f;
    for (int j = threadIdx.x; j < d; j += T) part = fmaf(widen(xr[j]), bl[j], part);
    const float eta = block_sum(part, red);
    const RowTerms rt = F::terms(eta, y[row], mask[row]);
    floss += rt.loss;  // the same value in every thread; thread 0's counts
    if (GRAD)
      for (int j = threadIdx.x; j < d; j += T) g[j] = fmaf(rt.w, widen(xr[j]), g[j]);
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
    if ((long long)R * d <= TILE_ELEMS) return R;
  return 0;
}

// Lets tiled_kernel<F, E, GRAD> take all the dynamic shared memory a block
// may have beside its static array (so that a plan made for one shape
// stays valid after another shape's plan), and says how many blocks of
// smem bytes fit a SM.
template <typename F, typename E, bool GRAD>
cudaError_t occupancy(int dev, size_t smem, int* per_sm) {
  int most = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&attr, tiled_kernel<F, E, GRAD>);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tiled_kernel<F, E, GRAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most - (int)attr.sharedSizeBytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, tiled_kernel<F, E, GRAD>, T, smem);
}

// Blocks of the family's tiled kernels (both variants) that fit a SM, or
// of its row kernel.
template <typename F, typename E>
cudaError_t blocks_per_sm(int dev, bool tiled, size_t smem, int* per_sm) {
  if (!tiled) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, row_kernel<F, E, true>, T, 0);
  int ps_grad = 0, ps_value = 0;
  cudaError_t err = occupancy<F, E, true>(dev, smem, &ps_grad);
  if (err != cudaSuccess) return err;
  if ((err = occupancy<F, E, false>(dev, smem, &ps_value)) != cudaSuccess) return err;
  *per_sm = ps_grad < ps_value ? ps_grad : ps_value;
  return cudaSuccess;
}

template <typename E>
cudaError_t family_blocks_per_sm(int family, int dev, bool tiled, size_t smem, int* per_sm) {
  switch (family) {
    case 0: return blocks_per_sm<Logistic, E>(dev, tiled, smem, per_sm);
    case 1: return blocks_per_sm<Normal, E>(dev, tiled, smem, per_sm);
    case 2: return blocks_per_sm<Poisson, E>(dev, tiled, smem, per_sm);
  }
  return cudaErrorInvalidValue;
}

template <typename F, typename E>
void launch(const Plan& p, const void* x, const float* y, const float* mask, const float* beta,
            const unsigned char* act, long long P, long long m, int d, int grad, float* bpart,
            cudaStream_t s) {
  const E* xe = (const E*)x;
  const dim3 grid((unsigned)p.blocks, (unsigned)P);
  if (p.path == 0) {
    if (grad)
      tiled_kernel<F, E, true><<<grid, T, (size_t)p.smem, s>>>(xe, y, mask, beta, act, m, d,
                                                               (int)p.R, (int)p.G, bpart);
    else
      tiled_kernel<F, E, false><<<grid, T, (size_t)p.smem, s>>>(xe, y, mask, beta, act, m, d,
                                                                (int)p.R, (int)p.G, bpart);
  } else {
    if (grad)
      row_kernel<F, E, true><<<grid, T, 0, s>>>(xe, y, mask, beta, act, m, d, bpart);
    else
      row_kernel<F, E, false><<<grid, T, 0, s>>>(xe, y, mask, beta, act, m, d, bpart);
  }
}

template <typename E>
bool launch_family(int family, const Plan& p, const void* x, const float* y, const float* mask,
            const float* beta, const unsigned char* act, long long P, long long m, int d, int grad,
            float* bpart, cudaStream_t s) {
  switch (family) {
    case 0: launch<Logistic, E>(p, x, y, mask, beta, act, P, m, d, grad, bpart, s); return true;
    case 1: launch<Normal, E>(p, x, y, mask, beta, act, P, m, d, grad, bpart, s); return true;
    case 2: launch<Poisson, E>(p, x, y, mask, beta, act, P, m, d, grad, bpart, s); return true;
  }
  return false;
}

}  // namespace

extern "C" {

const char* logistic_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Plans a call of family (0 Logistic, 1 Normal, 2 Poisson) over P lanes of
// m rows and d features of esize-byte elements (4 float32, 2 bf16) into
// plan (8 int64s; plan[6] is the floats of scratch it needs), to be passed
// back to logistic_value_and_grad with the same family.  The plan depends
// only on (family, esize, P, m, d) and the card, so a lane's sums are
// taken in the same order whatever the other lanes do.
int logistic_plan(int family, long long P, long long m, int d, int esize, void* plan) {
  Plan* p = (Plan*)plan;
  if (esize != 4 && esize != 2) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int R = tile_rows(d);
  long long units;  // tiles (or rows) of a lane
  size_t smem = 0;
  if (R > 0) {
    const int G = d <= T ? (T / d < R ? T / d : R) : 1;
    smem = (size_t)esize * 2 * ((size_t)R * d + 16 / esize) +
           sizeof(float) * ((size_t)d + R + (size_t)G * d);
    p->path = 0;
    p->R = R;
    p->G = G;
    units = (m + R - 1) / R;
  } else {
    p->path = 1;
    p->R = 1;
    p->G = 1;
    units = m;
  }
  err = esize == 4 ? family_blocks_per_sm<float>(family, dev, R > 0, smem, &per_sm)
                   : family_blocks_per_sm<__nv_bfloat16>(family, dev, R > 0, smem, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  // one wave over all lanes, split evenly between them
  long long blocks = (long long)sms * per_sm / P;
  if (blocks < 1) blocks = 1;
  if (blocks > units) blocks = units;
  p->blocks = blocks;
  p->smem = (long long)smem;
  p->rec = 1 + d;
  p->scratch = P * blocks * p->rec;
  p->esize = esize;
  return (int)cudaSuccess;
}

// x (P, m, d) of the plan's element type, y (P, m), mask (P, m), beta
// (P, d) float32, contiguous, on one device; active (P,) bool.  f (P,),
// g (P, d) float32: written only for active lanes, g only when grad != 0.
// scratch: plan[6] floats.
int logistic_value_and_grad(int family, const void* x, const void* y, const void* mask,
                            const void* beta, const void* active, long long P, long long m, int d,
                            int grad, const void* plan, void* scratch, void* f, void* g,
                            void* stream) {
  const Plan p = *(const Plan*)plan;
  cudaStream_t s = (cudaStream_t)stream;
  const float *yf = (const float*)y, *mf = (const float*)mask, *bf = (const float*)beta;
  const unsigned char* act = (const unsigned char*)active;
  float* bpart = (float*)scratch;
  const bool known =
      p.esize == 4 ? launch_family<float>(family, p, x, yf, mf, bf, act, P, m, d, grad, bpart, s)
                   : launch_family<__nv_bfloat16>(family, p, x, yf, mf, bf, act, P, m, d, grad, bpart, s);
  if (!known) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int used = grad ? d + 1 : 1;
  const dim3 fgrid((unsigned)((used + 255) / 256), (unsigned)P);
  finalize_kernel<<<fgrid, 256, 0, s>>>(bpart, act, (int)p.blocks, d, grad, (float*)f, (float*)g);
  return (int)cudaGetLastError();
}

}  // extern "C"
