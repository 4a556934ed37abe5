// K5: one SGD step of M linear models that share a block, for Hopper
// (sm_90a), plain C ABI.
//
// Replaces: dask_ml_tpu/model_selection/_packing.py :: _packed_step_impl
// (:117, jax.vmap of linear_model/_sgd.py :: sgd_step over a stacked model
// axis).  For one block x [B, d] float32 and targets y [B, K] shared by the
// cohort, masks [M, B] (lane m's row weights: a stride-0 broadcast of one
// mask unless a member has class weights) and the stacked state coef
// [M, d, K], intercept [M, K], t [M], hyper [M, 7], lane m takes K4's step
// (csrc/sgd.cu) on its own state, mask and hyperparameters:
//   margin_mik = x_i . coef_m[:, k] + intercept_mk
//   (l, dl) = loss(margin_mik, y_ik)            six losses, functors below
//   count_m = sum_i mask_mi (1 where that is 0)
//   mean_loss_m = sum_ik mask_mi l_mik / count_m
//   gcoef_mjk = sum_i mask_mi dl_mik x_ij / count_m, gint_mk likewise
//   penalty, schedule (from t_m and hyper_m), update in place, t_m += 1
// with (mean_loss_m, sum_i mask_mi) written to out [M, 2] and no host read.
// The loss, penalty, schedule and fit_intercept are one per cohort (the
// reference's pack key); hyperparameters are alpha, eta0, power_t, t0,
// l1_ratio, epsilon, eta_scale, a row a lane.  As in K4 the sums are divided
// by the count once at the end, which differs from the reference's order
// only by rounding.
//
// Bound on an H100: a step reads x once (B*d*4 bytes), y (B*K*4) and one
// mask row (B*4, or M*B*4 for per-lane masks), and does 4*B*d*M*K flops
// (the forward product and the gradient's).  At the search's block (2^20 x
// 64, K = 1) the bytes take 0.083 ms at 3.35 TB/s and the flops 0.004*M ms
// at 67 TFLOP/s: bound by operations from M ~ 21 up (0.325 ms at M = 81).
//
// The design (a simple kernel that is right; its speed is later work):
//   - Columns are the M*K pairs (lane, class), c = m*K + k.  A block takes
//     tiles of R rows in turn (tile blockIdx.x, + gridDim.x, ...), and for
//     each tile every column, CT columns at a time, so every row of x is
//     read from device memory once for all M*K columns; a tile's feature
//     chunks (DC = 64 features) are staged in shared memory, transposed,
//     and read again from L2 only where d > DC.  A tile is R = 256 rows by
//     CT = 16 columns, 64 x 4 threads of 4 x 4 register tiles: narrow
//     columns, since a padded column costs as much as a real one and the
//     search's cohorts are mostly a few models (a first design's 64 x 64
//     tile was slower at every cohort size, up to M*K = 810).
//   - Forward: the (R x CT) margins of a column tile, a 4 x 4 register tile
//     a thread, over the feature chunks (each chunk of coef staged in shared
//     memory); then each (row, column)'s loss on its lane's mask, target
//     and epsilon; mask*dl goes to a (R x CT) table in shared memory.
//   - Gradient: G (DC x CT) += x_chunk^T . table, a 4 x 4 register tile a
//     thread over a slice of 64 rows, the four slices summed in shared
//     memory in slice order and added to the block's record in global
//     memory, each element always by the same thread: no atomics.
//   - Each block's record holds, per column, its loss sum, its gint and its
//     mask sum, then its gradient in coef's layout.  Two small kernels sum
//     the records in block order (so a shape's bits do not depend on
//     timing): lanes_kernel (a warp a lane: the mean loss, the count, eta
//     from t, t += 1), then update_kernel (a thread an element of coef and
//     intercept: the penalty and the update).
//   - Any M*K (columns are tiled), any d (features are chunked), any B.
//   - Registers capped at 128, two blocks a SM (their shared memory allows
//     two): uncapped, the batched loads took 190 and one block a SM ran
//     ~20% slower (cohort_variants.py).
// Row indices are 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 256;   // threads of the record kernel
constexpr int DC = 64;   // features a chunk
constexpr int NH = 7;    // hyperparameters a lane
constexpr int UT = 256;  // threads of update_kernel
constexpr int LW = 8;    // warps (lanes) a block of lanes_kernel
constexpr unsigned FULL = 0xffffffffu;
constexpr long long SCRATCH_FLOATS = 1ll << 23;  // most floats of block records a call

// The record kernel's tile: NTX x NTY threads, each a 4 x 4 register tile
// of the margins (rows ty*4.., columns tx*4..) and of the gradient.
constexpr int NTX = 4, NTY = T / NTX;
constexpr int CT = 4 * NTX;   // columns a tile
constexpr int R = 4 * NTY;    // rows a tile
constexpr int SL = R / 64;    // row slices of 64 rows in the gradient
constexpr int LDX = R + 4;    // xT's leading dimension (16-byte rows)
constexpr int LDC = CT + 4;   // cs's and w's
constexpr int AUX = SL * DC * CT;  // the column sums (3*NTY*CT), then the slices' G
constexpr int SMEM = (int)sizeof(float) * (DC * LDX + DC * LDC + R * LDC + AUX);
static_assert(16 * NTX * SL == T && 3 * NTY * CT <= AUX && DC * CT % T == 0, "tile shape");

enum { ALPHA = 0, ETA0, POWER_T, T0, L1_RATIO, EPSILON, ETA_SCALE };

struct Plan {
  long long blocks;   // blocks of the record kernel
  long long smem;     // its dynamic shared memory, bytes
  long long rec;      // floats of a block record: 3*M*K + M*d*K
  long long scratch;  // floats of scratch: blocks*rec records, then 2*M of lanes
};
static_assert(sizeof(Plan) == 4 * sizeof(long long), "Plan is 4 int64s");

struct Terms {
  float l;   // the loss
  float dl;  // d loss / d margin
};

// The losses, as K4's (csrc/sgd.cu).  Classifier targets are +-1 (one-vs-all
// columns); the comparisons at the kinks are the reference's (z < 1 for
// hinge, z >= -1 for modified_huber, |r| <= epsilon for huber).
struct LogLoss {
  __device__ __forceinline__ static Terms terms(float m, float y, float) {
    const float z = y * m;
    const float e = expf(-fabsf(z));
    const float l = fmaxf(-z, 0.f) + log1pf(e);                 // logaddexp(0, -z)
    const float s = z >= 0.f ? e / (1.f + e) : 1.f / (1.f + e);  // sigmoid(-z)
    return {l, -s * y};
  }
};
struct Hinge {
  __device__ __forceinline__ static Terms terms(float m, float y, float) {
    const float z = y * m;
    return {fmaxf(0.f, 1.f - z), z < 1.f ? -y : 0.f};
  }
};
struct SquaredHinge {
  __device__ __forceinline__ static Terms terms(float m, float y, float) {
    const float z = y * m;
    const float h = fmaxf(0.f, 1.f - z);
    return {h * h, -2.f * h * y};
  }
};
struct ModifiedHuber {
  __device__ __forceinline__ static Terms terms(float m, float y, float) {
    const float z = y * m;
    const float h = fmaxf(0.f, 1.f - z);
    if (z >= -1.f) return {h * h, -2.f * h * y};
    return {-4.f * z, -4.f * y};
  }
};
struct SquaredError {
  __device__ __forceinline__ static Terms terms(float m, float y, float) {
    const float r = m - y;
    return {0.5f * r * r, r};
  }
};
struct Huber {
  __device__ __forceinline__ static Terms terms(float m, float y, float eps) {
    const float r = m - y;
    const float a = fabsf(r);
    if (a <= eps) return {0.5f * r * r, r};
    return {eps * (a - 0.5f * eps), r > 0.f ? eps : (r < 0.f ? -eps : 0.f)};
  }
};

struct Args {
  const float* x;          // (B, d), rows xs apart
  long long xs;
  const float* y;          // (B, K), rows ys apart
  long long ys;
  const float* mask;       // (M, B): lane m's row i at m*mm + i*mb (mm = 0: one row)
  long long mm, mb;
  const float* coef;       // (M, d, K)
  const float* intercept;  // (M, K)
  const float* hyper;      // (M, 7)
  long long B;
  int d, K, M;
  long long rec;
  float* part;             // blocks * rec floats
};

// x's features [j0, j0 + DC) of rows [r0, r0 + R) into xT[j][r], zeros past
// B and past d.  Thread t takes feature t % DC of rows t / DC + 4k (a warp
// reads 32 features of one row); its loads are issued XB at a time before
// any is stored, so a tile waits out a few memory latencies, not 64.
__device__ __forceinline__ void stage_x(const Args& a, long long r0, int j0, float* xT) {
  constexpr int PER = R * DC / T, XB = 16;
  static_assert(PER % XB == 0 && T % DC == 0, "staging shape");
  const int j = threadIdx.x % DC, rr = threadIdx.x / DC;
  const bool jok = j0 + j < a.d;
  const float* src = a.x + j0 + j;
#pragma unroll
  for (int k0 = 0; k0 < PER; k0 += XB) {
    float v[XB];
#pragma unroll
    for (int k = 0; k < XB; ++k) {
      const long long row = r0 + rr + (T / DC) * (k0 + k);
      v[k] = jok && row < a.B ? __ldg(src + row * a.xs) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < XB; ++k) xT[j * LDX + rr + (T / DC) * (k0 + k)] = v[k];
  }
}

// coef's features [j0, j0 + DC) of columns [c0, c0 + CT) into cs[j][c],
// zeros past d and past M*K
__device__ __forceinline__ void stage_coef(const Args& a, int c0, int j0, float* cs) {
  const int C = a.M * a.K;
  for (int e = threadIdx.x; e < DC * CT; e += T) {
    const int j = e / CT, c = e % CT;
    float v = 0.f;
    if (c0 + c < C && j0 + j < a.d) {
      const int m = (c0 + c) / a.K, k = (c0 + c) % a.K;
      v = a.coef[((long long)m * a.d + j0 + j) * a.K + k];
    }
    cs[j * LDC + c] = v;
  }
}

// the record's address of gradient element (feature j, column c), in
// coef's layout, or null where either is out of range
__device__ __forceinline__ float* grad_at(const Args& a, float* gout, int j, int c) {
  if (j >= a.d || c >= a.M * a.K) return nullptr;
  const int m = c / a.K, k = c % a.K;
  return gout + ((long long)m * a.d + j) * a.K + k;
}

template <typename L>
__global__ void __launch_bounds__(T, 2) record_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  float* xT = sm;             // (DC, LDX): x chunk, transposed
  float* cs = xT + DC * LDX;  // (DC, LDC): coef chunk
  float* w = cs + DC * LDC;   // (R, LDC): mask * dl
  float* aux = w + R * LDC;   // (3, NTY, CT) column sums; then (SL, DC, CT) slices' G
  const int C = a.M * a.K;
  float* out = a.part + (long long)blockIdx.x * a.rec;
  for (long long e = threadIdx.x; e < a.rec; e += T) out[e] = 0.f;
  __syncthreads();
  const int ty = threadIdx.x / NTX, tx = threadIdx.x % NTX;
  // the gradient's thread: row slice sl, features gy + 16u, columns gx*4 + v
  const int sl = threadIdx.x / (16 * NTX), gy = (threadIdx.x % (16 * NTX)) / NTX, gx = tx;
  const long long tiles = (a.B + R - 1) / R;
  const int chunks = (a.d + DC - 1) / DC;
  float* gout = out + 3ll * C;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = tile * R;
    for (int c0 = 0; c0 < C; c0 += CT) {
      // forward: margins of rows ty*4 + i, columns tx*4 + v
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][v] = 0.f;
      for (int ch = 0; ch < chunks; ++ch) {
        if (chunks > 1 || c0 == 0) stage_x(a, r0, ch * DC, xT);
        stage_coef(a, c0, ch * DC, cs);
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < DC; ++j) {
          const float4 xv = *reinterpret_cast<const float4*>(xT + j * LDX + ty * 4);
          const float4 cv = *reinterpret_cast<const float4*>(cs + j * LDC + tx * 4);
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[i][v] = fmaf(xr[i], cr[v], acc[i][v]);
        }
        __syncthreads();
      }
      // the loss terms: each (row, column) on its lane's mask and epsilon
      float ls[4], gs[4], cn[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        ls[v] = gs[v] = cn[v] = 0.f;
        const int c = c0 + tx * 4 + v;
        const bool ok = c < C;
        const int m = ok ? c / a.K : 0, k = ok ? c % a.K : 0;
        const float b = ok ? a.intercept[c] : 0.f;
        const float eps = ok ? a.hyper[m * NH + EPSILON] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const long long row = r0 + ty * 4 + i;
          float wv = 0.f;
          if (ok && row < a.B) {
            const float mk = __ldg(a.mask + m * a.mm + row * a.mb);
            const Terms tr = L::terms(acc[i][v] + b, __ldg(a.y + row * a.ys + k), eps);
            ls[v] += mk * tr.l;
            wv = mk * tr.dl;
            if (k == 0) cn[v] += mk;
          }
          gs[v] += wv;
          w[(ty * 4 + i) * LDC + tx * 4 + v] = wv;
        }
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        aux[(0 * NTY + ty) * CT + tx * 4 + v] = ls[v];
        aux[(1 * NTY + ty) * CT + tx * 4 + v] = gs[v];
        aux[(2 * NTY + ty) * CT + tx * 4 + v] = cn[v];
      }
      __syncthreads();
      if (threadIdx.x < 3 * CT) {
        const int q = threadIdx.x / CT, cl = threadIdx.x % CT;
        if (c0 + cl < C) {
          float s = 0.f;
          for (int g = 0; g < NTY; ++g) s += aux[(q * NTY + g) * CT + cl];
          out[(long long)q * C + c0 + cl] += s;
        }
      }
      // gradient: features j0 + gy + 16u, columns c0 + gx*4 + v, rows of slice sl
      for (int ch = 0; ch < chunks; ++ch) {
        const int j0 = ch * DC;
        if (chunks > 1) {
          __syncthreads();
          stage_x(a, r0, j0, xT);
        }
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) g[u][v] = 0.f;
#pragma unroll 4
        for (int r = sl * 64; r < sl * 64 + 64; ++r) {
          const float4 wv = *reinterpret_cast<const float4*>(w + r * LDC + gx * 4);
          const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float xv = xT[(gy + 16 * u) * LDX + r];
#pragma unroll
            for (int v = 0; v < 4; ++v) g[u][v] = fmaf(xv, wr[v], g[u][v]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) aux[(sl * DC + gy + 16 * u) * CT + gx * 4 + v] = g[u][v];
        __syncthreads();
        // the slices summed in order, then this thread's elements of the
        // record read, all of them before any is written back
        constexpr int PE = DC * CT / T;
        float sum[PE], old[PE];
        float* dst[PE];
#pragma unroll
        for (int k = 0; k < PE; ++k) {
          const int e = threadIdx.x + k * T;
          sum[k] = 0.f;
#pragma unroll
          for (int q = 0; q < SL; ++q) sum[k] += aux[q * DC * CT + e];
          dst[k] = grad_at(a, gout, j0 + e / CT, c0 + e % CT);
        }
#pragma unroll
        for (int k = 0; k < PE; ++k) old[k] = dst[k] ? *dst[k] : 0.f;
#pragma unroll
        for (int k = 0; k < PE; ++k)
          if (dst[k]) *dst[k] = old[k] + sum[k];
      }
      __syncthreads();  // w, aux and the tiles are rewritten by the next column tile
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// element e of the records summed over the blocks, lanes over the blocks
__device__ __forceinline__ float lane_sum(const float* part, int blocks, long long rec,
                                          long long e) {
  float s = 0.f;
  for (int b = threadIdx.x & 31; b < blocks; b += 32) s += part[b * rec + e];
  return warp_sum(s);
}

// eta at step tv by the reference's float32 expression
__device__ __forceinline__ float eta_at(int schedule, const float* __restrict__ h, float tv) {
  switch (schedule) {
    case 0: return h[ETA0];
    case 1: return 1.f / (h[ALPHA] * (h[T0] + tv));
    case 2: return h[ETA0] / powf(tv + 1.f, h[POWER_T]);
    default: return h[ETA0] * h[ETA_SCALE];
  }
}

// A warp a lane m: its loss and mask sums over the blocks (the loss over its
// K columns in order), out[m] = (mean loss, sum of the mask), and into
// lanes[m] (eta at t_m, the count); t_m += 1.
__global__ void __launch_bounds__(LW * 32) lanes_kernel(
    const float* __restrict__ part, int blocks, long long rec, int M, int K, int schedule,
    const float* __restrict__ hyper, float* __restrict__ t, float* __restrict__ lanes,
    float* __restrict__ out) {
  const int m = blockIdx.x * LW + (threadIdx.x >> 5);
  if (m >= M) return;
  const long long C = (long long)M * K;
  float l = 0.f;
  for (int k = 0; k < K; ++k) l += lane_sum(part, blocks, rec, (long long)m * K + k);
  const float cnt = lane_sum(part, blocks, rec, 2 * C + (long long)m * K);
  if ((threadIdx.x & 31) != 0) return;
  const float count = cnt > 0.f ? cnt : 1.f;
  out[2 * m] = l / count;
  out[2 * m + 1] = cnt;
  const float tv = t[m];
  lanes[2 * m] = eta_at(schedule, hyper + (long long)m * NH, tv);
  lanes[2 * m + 1] = count;
  t[m] = tv + 1.f;
}

// A thread an element: coef (M*d*K, then intercept M*K) from its gradient
// summed over the blocks in order, with the lane's penalty and eta.
__global__ void __launch_bounds__(UT) update_kernel(
    const float* __restrict__ part, int blocks, long long rec, int M, int d, int K, int penalty,
    int fit_intercept, const float* __restrict__ hyper, const float* __restrict__ lanes,
    float* __restrict__ coef, float* __restrict__ intercept) {
  const long long e = (long long)blockIdx.x * UT + threadIdx.x;
  const long long C = (long long)M * K, n = C * d;
  if (e >= n + C) return;
  const bool is_coef = e < n;
  const long long off = is_coef ? 3 * C + e : C + (e - n);
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[b * rec + off];
  const int m = (int)(is_coef ? e / ((long long)d * K) : (e - n) / K);
  const float eta = lanes[2 * m], g0 = s / lanes[2 * m + 1];
  if (!is_coef) {
    if (fit_intercept) intercept[e - n] = intercept[e - n] - eta * g0;
    return;
  }
  const float alpha = hyper[(long long)m * NH + ALPHA], l1r = hyper[(long long)m * NH + L1_RATIO];
  const float c = coef[e];
  const float sg = c > 0.f ? 1.f : (c < 0.f ? -1.f : 0.f);
  float g = g0;
  if (penalty == 1)
    g = g + alpha * c;
  else if (penalty == 2)
    g = g + alpha * sg;
  else if (penalty == 3)
    g = g + alpha * (l1r * sg + (1.f - l1r) * c);
  coef[e] = c - eta * g;
}

const void* select_kernel(int loss) {
  switch (loss) {
    case 0: return (const void*)record_kernel<LogLoss>;
    case 1: return (const void*)record_kernel<Hinge>;
    case 2: return (const void*)record_kernel<SquaredHinge>;
    case 3: return (const void*)record_kernel<ModifiedHuber>;
    case 4: return (const void*)record_kernel<SquaredError>;
    case 5: return (const void*)record_kernel<Huber>;
  }
  return nullptr;
}

}  // namespace

extern "C" {

const char* cohort_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Plans a step of M lanes of loss (0 log_loss, 1 hinge, 2 squared_hinge, 3
// modified_huber, 4 squared_error, 5 huber) over B rows, d features and K
// target columns into plan (4 int64s; plan[3] is the floats of scratch it
// needs).  The plan depends only on (loss, B, d, K, M) and the card, so a
// shape's sums are taken in the same order every time.
int cohort_plan(int loss, long long B, int d, int K, int M, void* plan) {
  Plan* p = (Plan*)plan;
  if (loss < 0 || loss > 5 || d < 1 || K < 1 || M < 1 || B < 1 || (loss >= 4 && K != 1))
    return (int)cudaErrorInvalidValue;
  const long long C = (long long)M * K;
  const long long rec = C * (3 + (long long)d);
  if (rec >= (1ll << 31) || C >= (1ll << 31) / 4) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const void* fn = select_kernel(loss);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, T, (size_t)SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (B + R - 1) / R;
  long long blocks = (long long)sms * (per_sm < 1 ? 1 : per_sm);
  if (blocks > tiles) blocks = tiles;
  if (blocks > SCRATCH_FLOATS / rec) blocks = SCRATCH_FLOATS / rec;
  if (blocks < 1) blocks = 1;
  p->blocks = blocks;
  p->smem = SMEM;
  p->rec = rec;
  p->scratch = blocks * rec + 2 * (long long)M;
  return (int)cudaSuccess;
}

// One step of M lanes of plan's shape.  x (B, d) and y (B, K) float32 with
// row strides xs, ys (elements) and contiguous rows; mask (M, B) float32,
// lane m's row i at m*mm + i*mb (mm = 0 for one mask shared by the lanes);
// coef (M, d, K), intercept (M, K), t (M,), hyper (M, 7) and out (M, 2)
// float32, contiguous, on one device.  coef, intercept (if fit_intercept)
// and t are updated in place; out[m] = (mean loss, sum of lane m's mask).
// scratch: plan[3] floats.  Three launches: the records, the lanes, the
// update.
int cohort_step(const void* plan, int loss, int penalty, int schedule, int fit_intercept,
                const void* x, long long xs, const void* y, long long ys, const void* mask,
                long long mm, long long mb, void* coef, void* intercept, void* t,
                const void* hyper, long long B, int d, int K, int M, void* scratch, void* out,
                void* stream) {
  const Plan p = *(const Plan*)plan;
  const void* fn = select_kernel(loss);
  if (fn == nullptr || penalty < 0 || penalty > 3 || schedule < 0 || schedule > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Args a;
  a.x = (const float*)x;
  a.xs = xs;
  a.y = (const float*)y;
  a.ys = ys;
  a.mask = (const float*)mask;
  a.mm = mm;
  a.mb = mb;
  a.coef = (const float*)coef;
  a.intercept = (const float*)intercept;
  a.hyper = (const float*)hyper;
  a.B = B;
  a.d = d;
  a.K = K;
  a.M = M;
  a.rec = p.rec;
  a.part = (float*)scratch;
  void* args[] = {(void*)&a};
  cudaError_t err = cudaLaunchKernel(fn, dim3((unsigned)p.blocks), dim3(T), args,
                                     (size_t)p.smem, s);
  if (err != cudaSuccess) return (int)err;
  float* lanes = (float*)scratch + p.blocks * p.rec;
  lanes_kernel<<<(M + LW - 1) / LW, LW * 32, 0, s>>>(
      (const float*)scratch, (int)p.blocks, p.rec, M, K, schedule, (const float*)hyper,
      (float*)t, lanes, (float*)out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)M * K * (d + 1);
  update_kernel<<<(unsigned)((n + UT - 1) / UT), UT, 0, s>>>(
      (const float*)scratch, (int)p.blocks, p.rec, M, d, K, penalty, fit_intercept,
      (const float*)hyper, lanes, (float*)coef, (float*)intercept);
  return (int)cudaGetLastError();
}

}  // extern "C"
