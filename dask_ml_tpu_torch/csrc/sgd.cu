// K4: one minibatch SGD step of a linear model, for Hopper (sm_90a), plain
// C ABI.
//
// Replaces: dask_ml_tpu/linear_model/_sgd.py :: sgd_step (:146; the step of
// partial_fit, and of each minibatch in sgd_epoch's scan, :203) and ::
// _eval_loss_fn (:241, the value only).  For one block x [B, d] float32,
// targets y [B, K], mask [B] and the state coef [d, K], intercept [K], t:
//   margin_ik = x_i . coef_k + intercept_k
//   (l_ik, dl_ik) = loss(margin_ik, y_ik)       six losses, functors below
//   count = sum_i mask_i (1 where that is 0)
//   mean_loss = sum_ik mask_i l_ik / count
//   gcoef_jk = sum_i mask_i dl_ik x_ij / count,  gint_k = sum_i mask_i dl_ik / count
//   gcoef += penalty'(coef)    (l2, l1 by sign with sign(0) = 0, elasticnet)
//   eta = schedule(t)          (constant, optimal, invscaling, adaptive)
//   coef -= eta gcoef; intercept -= eta gint (fit_intercept); t += 1
// all in place, with (mean_loss, sum mask) written to a device pair and no
// host read.  Hyperparameters come as one device array: alpha, eta0,
// power_t, t0, l1_ratio, epsilon, eta_scale.  eta is computed in float32 by
// the reference's expression, from t before the update.  The reference
// divides each row's dl by the count before its product; here the sums are
// divided once at the end, which differs only by rounding.
//
// Bound on an H100: a step reads x once (B*d*4 bytes) plus y and the mask
// ((K + 1)*B*4) and does 4*B*d*K flops (the forward dot and the gradient's
// axpy).  At the stream's block (2^20 x 64, K = 1) that is 0.2768 GB,
// 0.0826 ms at 3.35 TB/s, against 0.268 GFLOP, 0.004 ms at 67 TFLOP/s:
// memory-bound by ~20x.  The reference reads x twice (xb @ coef, then
// xb.T @ dmarg).  The design:
//   - One read of x.  A warp takes U rows at a time (U = 8 at K = 1,
//     fewer where the accumulators are many), its lanes over the features:
//     lane l reads x_ij for j = l, l + 32, ... into registers, every load
//     of a row one coalesced 128-byte line, the U rows' loads issued before
//     any use.  The forward dot and the gradient's accumulate both use
//     those registers, so x is read from device memory once.  Where K > 1
//     the registers leave few warps a SM, so each warp also has the next
//     group's rows in flight while it computes this one's.
//   - coef's column slices and the gradient's accumulators live in
//     registers (lane l owns features l + 32 i of every class).  The K
//     partial dots of a row are joined by one transposed xor-shuffle tree
//     (16 shuffles for 16 classes, not 16 trees of 5), which leaves each
//     class's dot in 32/K lanes; those lanes take the loss terms of the
//     group's rows side by side (one exp and log a lane, not one a row),
//     and broadcast each mask*dl by one shuffle.
//   - Minibatch views are strided: minibatch i of sgd_epoch is the rows
//     i::n_mb of the padded block (the reference's free reshape).  The
//     kernel takes a row stride for x, y and the mask and reads each row
//     where it lies, so no copy of X is made, a fit or a step.
//   - Deterministic: every block writes a record (loss, count, gint,
//     gcoef) in a fixed order of its warps; finalize_kernel, one block,
//     sums the records in a fixed order (a warp an element, lanes over the
//     blocks, where the elements are few), then applies the penalty, the
//     schedule and the update.  No float atomics.
//   - The register path takes K = 1 with d <= 256, K <= 4 with d <= 256 and
//     K <= 16 with d <= 64.  Wider shapes take row_kernel: a block a row
//     at a time (the row staged in shared memory, a warp per class's dot,
//     a thread per gradient element), with its accumulators in shared
//     memory where they fit and in its record in global memory beyond.
// Row indices are 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 256;  // threads a block of the step kernels
constexpr int WARPS = T / 32;
constexpr int FT = 1024;  // threads of finalize_kernel
constexpr unsigned FULL = 0xffffffffu;
constexpr long long SCRATCH_FLOATS = 1ll << 22;  // most floats of block records a call
constexpr int SMEM_LIMIT = 200 * 1024;           // most dynamic shared memory a row block takes

enum { ALPHA = 0, ETA0, POWER_T, T0, L1_RATIO, EPSILON, ETA_SCALE };

struct Plan {
  long long path;     // 0: warp_kernel, 1: row_kernel
  long long nj;       // feature slices a lane (warp path)
  long long kt;       // most classes of the instantiation (warp path)
  long long blocks;   // blocks of the step kernel
  long long smem;     // dynamic shared memory, bytes
  long long rec;      // floats of a block record: 2 + K + d*K
  long long scratch;  // floats of scratch: blocks * rec
  long long sacc;     // row path: accumulators in shared memory
};
static_assert(sizeof(Plan) == 8 * sizeof(long long), "Plan is 8 int64s");

// Rows a warp takes at a time: at most the replicas of a class (32 / kt),
// fewer where the registers are many.
__host__ __device__ constexpr int rows_a_group(int nj, int kt) {
  return kt == 1 ? (nj <= 2 ? 8 : 4) : (kt == 4 ? (nj <= 2 ? 4 : 2) : 2);
}

struct Terms {
  float l;   // the loss
  float dl;  // d loss / d margin
};

// The losses.  Classifier targets are +-1 (one-vs-all columns); the
// comparisons at the kinks are the reference's (z < 1 for hinge, z >= -1
// for modified_huber, |r| <= epsilon for huber).
struct LogLoss {
  static constexpr bool kClassifier = true;
  __device__ __forceinline__ static Terms terms(float m, float y, float) {
    const float z = y * m;
    const float e = expf(-fabsf(z));
    const float l = fmaxf(-z, 0.f) + log1pf(e);                 // logaddexp(0, -z)
    const float s = z >= 0.f ? e / (1.f + e) : 1.f / (1.f + e);  // sigmoid(-z)
    return {l, -s * y};
  }
};
struct Hinge {
  static constexpr bool kClassifier = true;
  __device__ __forceinline__ static Terms terms(float m, float y, float) {
    const float z = y * m;
    return {fmaxf(0.f, 1.f - z), z < 1.f ? -y : 0.f};
  }
};
struct SquaredHinge {
  static constexpr bool kClassifier = true;
  __device__ __forceinline__ static Terms terms(float m, float y, float) {
    const float z = y * m;
    const float h = fmaxf(0.f, 1.f - z);
    return {h * h, -2.f * h * y};
  }
};
struct ModifiedHuber {
  static constexpr bool kClassifier = true;
  __device__ __forceinline__ static Terms terms(float m, float y, float) {
    const float z = y * m;
    const float h = fmaxf(0.f, 1.f - z);
    if (z >= -1.f) return {h * h, -2.f * h * y};
    return {-4.f * z, -4.f * y};
  }
};
struct SquaredError {
  static constexpr bool kClassifier = false;
  __device__ __forceinline__ static Terms terms(float m, float y, float) {
    const float r = m - y;
    return {0.5f * r * r, r};
  }
};
struct Huber {
  static constexpr bool kClassifier = false;
  __device__ __forceinline__ static Terms terms(float m, float y, float eps) {
    const float r = m - y;
    const float a = fabsf(r);
    if (a <= eps) return {0.5f * r * r, r};
    return {eps * (a - 0.5f * eps), r > 0.f ? eps : (r < 0.f ? -eps : 0.f)};
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// One halving step of the transposed tree and the ones after it: lanes
// with bit `off` set keep classes [HALF, 2 HALF) of p and send [0, HALF),
// the others the reverse, and each adds what it receives (p[u][k] then
// holds the kept class HALF + k or k).  A template, so that every index
// into p is known when it compiles and p stays in registers.
template <int U, int KT, int HALF>
__device__ __forceinline__ void halve(float (&p)[U][KT], int lane) {
  if constexpr (HALF >= 1) {
    constexpr int off = 32 * HALF / KT;
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < HALF; ++k) {
        const float send = upper ? p[u][k] : p[u][k + HALF];
        const float keep = upper ? p[u][k + HALF] : p[u][k];
        p[u][k] = keep + __shfl_xor_sync(FULL, send, off);
      }
    }
    halve<U, KT, HALF / 2>(p, lane);
  }
}

// The register path.  Grid (blocks); warp w of block b takes the row groups
// g = b*WARPS + w, + blocks*WARPS, ..., each of U rows.  Lane l owns the
// features j = l + 32 i (i < NJ) of every class k < K <= KT: coef in cf,
// the gradient's sums in acc.  A row's KT partial dots are joined by a
// transposed xor tree (log2 KT halving steps, each lane keeping half of its
// classes and sending the other half, then plain xor steps), after which
// lane l holds the whole dot of class l >> SH for every row of the group,
// in each of its REP = 32/KT replicas.  Replica u of class k (lane
// (k << SH) | u) takes the loss terms of row u, so the U*K terms of a group
// run side by side; its mask*dl is broadcast by one shuffle a (row, class).
// Shared memory: WARPS records for the combine.  The record (floats): loss,
// count, gint[K], gcoef[d*K] (j*K + k).
template <typename L, int NJ, int KT, bool GRAD>
__global__ void __launch_bounds__(T) warp_kernel(
    const float* __restrict__ x, long long xs, const float* __restrict__ y, long long ys,
    const float* __restrict__ mask, long long ms, const float* __restrict__ coef,
    const float* __restrict__ intercept, const float* __restrict__ hyper, long long B, int d,
    int K, float* __restrict__ bpart) {
  static_assert(KT == 1 || KT == 4 || KT == 16, "KT is 1, 4 or 16");
  constexpr int U = rows_a_group(NJ, KT);
  // prefetch the next group where the registers leave few warps a SM
  constexpr bool PF = KT > 1;
  constexpr int SH = KT == 1 ? 5 : (KT == 4 ? 3 : 1);  // a lane's class is lane >> SH
  constexpr int REP = 32 / KT;   // lanes holding each class's dot
  static_assert(U <= REP, "a group's rows must fit the replicas");
  extern __shared__ float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int my_k = lane >> SH, my_u = lane & (REP - 1);
  const bool active = my_k < K && my_u < U;
  const int rec = 2 + K + d * K;
  const float eps = hyper[EPSILON];

  float cf[NJ][KT], acc[NJ][KT];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    const int j = lane + 32 * i;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      cf[i][k] = (j < d && k < K) ? coef[(long long)j * K + k] : 0.f;
      acc[i][k] = 0.f;
    }
  }
  const float b_own = my_k < K ? intercept[my_k] : 0.f;
  float loss_own = 0.f, gint_own = 0.f, cnt_own = 0.f;

  const long long groups = (B + U - 1) / U;
  const long long stride = (long long)gridDim.x * WARPS;
  // group g's rows, and this lane's own row's mask and target
  auto load = [&](long long g, float (&xv)[U][NJ], float& m_own, float& y_own) {
    const long long r0 = g * U;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = r0 + u;
      const float* xr = x + r * xs;
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int j = lane + 32 * i;
        xv[u][i] = (g < groups && r < B && j < d) ? xr[j] : 0.f;
      }
    }
    const long long r_own = r0 + my_u;
    const bool row_ok = active && g < groups && r_own < B;
    m_own = row_ok ? mask[r_own * ms] : 0.f;
    y_own = row_ok ? y[r_own * ys + my_k] : 0.f;
  };
  float xv[U][NJ], m_own, y_own;
  long long g = (long long)blockIdx.x * WARPS + warp;
  load(g, xv, m_own, y_own);
  for (; g < groups; g += stride) {
    // the next group's loads in flight while this one computes (PF)
    float xn[U][NJ], m_next = 0.f, y_next = 0.f;
    if (PF) load(g + stride, xn, m_next, y_next);
    // partial dots, then the transposed tree
    float p[U][KT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < NJ; ++i) s = fmaf(xv[u][i], cf[i][k], s);
        p[u][k] = s;
      }
    }
    halve<U, KT, KT / 2>(p, lane);
#pragma unroll
    for (int off = REP / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) p[u][0] += __shfl_xor_sync(FULL, p[u][0], off);
    }
    // the loss terms of (row my_u, class my_k)
    float m = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u == my_u) m = p[u][0];
    float w = 0.f;
    if (active) {
      const Terms tr = L::terms(m + b_own, y_own, eps);
      loss_own += m_own * tr.l;
      w = m_own * tr.dl;
      gint_own += w;
      if (my_k == 0) cnt_own += m_own;
    }
    if (GRAD) {
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        if (k < K) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float wk = __shfl_sync(FULL, w, (k << SH) | u);
#pragma unroll
            for (int i = 0; i < NJ; ++i) acc[i][k] = fmaf(wk, xv[u][i], acc[i][k]);
          }
        }
      }
    }
    if (PF) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < NJ; ++i) xv[u][i] = xn[u][i];
      m_own = m_next;
      y_own = y_next;
    } else if (g + stride < groups) {
      load(g + stride, xv, m_own, y_own);
    }
  }

  // the block's record: its warps' records summed in warp order
  float* mine = sm + warp * rec;
  const float l = warp_sum(loss_own);
  const float c = warp_sum(cnt_own);
  if (lane == 0) {
    mine[0] = l;
    mine[1] = c;
  }
  if (GRAD) {
#pragma unroll
    for (int off = REP / 2; off > 0; off >>= 1) gint_own += __shfl_xor_sync(FULL, gint_own, off);
    if (my_u == 0 && my_k < K) mine[2 + my_k] = gint_own;
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int j = lane + 32 * i;
#pragma unroll
      for (int k = 0; k < KT; ++k)
        if (j < d && k < K) mine[2 + K + j * K + k] = acc[i][k];
    }
  }
  __syncthreads();
  const int used = GRAD ? rec : 2;
  float* out = bpart + (long long)blockIdx.x * rec;
  for (int e = threadIdx.x; e < used; e += T) {
    float s = 0.f;
    for (int v = 0; v < WARPS; ++v) s += sm[v * rec + e];
    out[e] = s;
  }
}

// Sum of v over the block, in a fixed order; every thread gets it.  red
// holds WARPS floats and is free again on return.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

// The wide path: block b takes rows b, b + blocks, ...  The row goes to
// shared memory, warp w computes the margins of classes w, w + WARPS, ...,
// thread t the loss terms of classes t, t + T, ... and the gradient
// elements t, t + T, ... (each element owned by one thread, so the sums
// need no atomics).  Accumulators: in shared memory (SACC) and copied to
// the block's record at the end, or in the record itself.  Shared memory:
// the row (d), the margins then mask*dl (K), the accumulators (SACC: rec).
template <typename L, bool GRAD, bool SACC>
__global__ void __launch_bounds__(T) row_kernel(
    const float* __restrict__ x, long long xs, const float* __restrict__ y, long long ys,
    const float* __restrict__ mask, long long ms, const float* __restrict__ coef,
    const float* __restrict__ intercept, const float* __restrict__ hyper, long long B, int d,
    int K, float* __restrict__ bpart) {
  extern __shared__ float sm[];
  __shared__ float red[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rec = 2 + K + d * K;
  const int used = GRAD ? rec : 2;
  float* xrow = sm;
  float* wk = xrow + d;
  float* out = bpart + (long long)blockIdx.x * rec;
  float* acc = SACC ? wk + K : out;
  const float eps = hyper[EPSILON];
  for (int e = threadIdx.x; e < used; e += T) acc[e] = 0.f;
  float loss_t = 0.f, cnt = 0.f;
  __syncthreads();
  for (long long r = blockIdx.x; r < B; r += gridDim.x) {
    const float* xr = x + r * xs;
    for (int j = threadIdx.x; j < d; j += T) xrow[j] = xr[j];
    const float mv = mask[r * ms];
    __syncthreads();
    for (int k = warp; k < K; k += WARPS) {
      float p = 0.f;
      for (int j = lane; j < d; j += 32) p = fmaf(xrow[j], coef[(long long)j * K + k], p);
      p = warp_sum(p);
      if (lane == 0) wk[k] = p;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += T) {
      const Terms tr = L::terms(wk[k] + intercept[k], y[r * ys + k], eps);
      loss_t += mv * tr.l;
      const float w = mv * tr.dl;
      wk[k] = w;
      if (GRAD) acc[2 + k] += w;
    }
    cnt += mv;
    __syncthreads();
    if (GRAD) {
      const int n = d * K;
      for (int e = threadIdx.x; e < n; e += T) {
        const int j = e / K, k = e - j * K;
        acc[2 + K + e] = fmaf(wk[k], xrow[j], acc[2 + K + e]);
      }
    }
    __syncthreads();  // xrow and wk are free for the next row
  }
  const float l = block_sum(loss_t, red);
  if (threadIdx.x == 0) {
    acc[0] = l;
    acc[1] = cnt;
  }
  if (SACC) {
    __syncthreads();
    for (int e = threadIdx.x; e < used; e += T) out[e] = acc[e];
  }
}

// Sum over the blocks' records of element e, lanes over the blocks (lane
// l takes blocks l, l + 32, ...) joined by the xor tree: a fixed order.
__device__ __forceinline__ float lane_sum(const float* __restrict__ bpart, int blocks,
                                          long long rec, long long e) {
  float s = 0.f;
  for (int b = threadIdx.x & 31; b < blocks; b += 32) s += bpart[b * rec + e];
  return warp_sum(s);
}

// One block.  Sums the block records: (mean loss, count) into out; with
// grad, the gradient, its penalty, eta and the update of coef, intercept
// and t in place (t read by every thread before it is written).  An
// element's sum over the blocks is taken by a warp, lanes over the blocks
// (a few elements, as at K = 1), or by a thread in block order (many
// elements: coalesced across the threads); which one depends only on the
// shape, so a shape's sums are always taken in the same order.
__global__ void __launch_bounds__(FT) finalize_kernel(
    const float* __restrict__ bpart, int blocks, int d, int K, int grad, int penalty,
    int schedule, int fit_intercept, const float* __restrict__ hyper, float* __restrict__ coef,
    float* __restrict__ intercept, float* __restrict__ t, float* __restrict__ out) {
  constexpr int NW = FT / 32;
  __shared__ float lc[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long rec = 2 + K + (long long)d * K;
  if (warp < 2) {
    const float s = lane_sum(bpart, blocks, rec, warp);
    if (lane == 0) lc[warp] = s;
  }
  __syncthreads();
  const float cnt = lc[1];
  const float count = cnt > 0.f ? cnt : 1.f;
  if (threadIdx.x == 0) {
    out[0] = lc[0] / count;
    out[1] = cnt;
  }
  if (!grad) return;
  const float alpha = hyper[ALPHA], eta0 = hyper[ETA0], tv = *t;
  float eta;
  switch (schedule) {
    case 0: eta = eta0; break;
    case 1: eta = 1.f / (alpha * (hyper[T0] + tv)); break;
    case 2: eta = eta0 / powf(tv + 1.f, hyper[POWER_T]); break;
    default: eta = eta0 * hyper[ETA_SCALE]; break;
  }
  const float l1r = hyper[L1_RATIO];
  __syncthreads();  // every thread has read t
  const long long n = K + (long long)d * K;  // gint then gcoef, from record element 2
  const bool by_warp = n < 4 * FT;
  const long long first = by_warp ? warp : threadIdx.x, step = by_warp ? NW : FT;
  for (long long e = first; e < n; e += step) {
    float s;
    if (by_warp) {
      s = lane_sum(bpart, blocks, rec, 2 + e);
      if (lane != 0) continue;
    } else {
      s = 0.f;
      for (int b = 0; b < blocks; ++b) s += bpart[b * rec + 2 + e];
    }
    const float g0 = s / count;
    if (e < K) {
      if (fit_intercept) intercept[e] = intercept[e] - eta * g0;
      continue;
    }
    const long long j = e - K;
    const float c = coef[j];
    const float sg = c > 0.f ? 1.f : (c < 0.f ? -1.f : 0.f);
    float g = g0;
    if (penalty == 1)
      g = g + alpha * c;
    else if (penalty == 2)
      g = g + alpha * sg;
    else if (penalty == 3)
      g = g + alpha * (l1r * sg + (1.f - l1r) * c);
    coef[j] = c - eta * g;
  }
  if (threadIdx.x == 0) *t = tv + 1.f;
}

template <typename L, bool GRAD>
const void* warp_fn(int nj, int kt) {
  if (kt == 1) return nj == 2 ? (const void*)warp_kernel<L, 2, 1, GRAD>
                              : (const void*)warp_kernel<L, 8, 1, GRAD>;
  if constexpr (L::kClassifier) {
    if (kt == 4) return nj == 2 ? (const void*)warp_kernel<L, 2, 4, GRAD>
                                : (const void*)warp_kernel<L, 8, 4, GRAD>;
    if (kt == 16 && nj == 2) return (const void*)warp_kernel<L, 2, 16, GRAD>;
  }
  return nullptr;
}

template <typename L>
const void* kernel_for(const Plan& p, bool grad) {
  if (p.path == 0) return grad ? warp_fn<L, true>((int)p.nj, (int)p.kt)
                               : warp_fn<L, false>((int)p.nj, (int)p.kt);
  if (p.sacc) return grad ? (const void*)row_kernel<L, true, true>
                          : (const void*)row_kernel<L, false, true>;
  return grad ? (const void*)row_kernel<L, true, false> : (const void*)row_kernel<L, false, false>;
}

const void* select_kernel(int loss, const Plan& p, bool grad) {
  switch (loss) {
    case 0: return kernel_for<LogLoss>(p, grad);
    case 1: return kernel_for<Hinge>(p, grad);
    case 2: return kernel_for<SquaredHinge>(p, grad);
    case 3: return kernel_for<ModifiedHuber>(p, grad);
    case 4: return kernel_for<SquaredError>(p, grad);
    case 5: return kernel_for<Huber>(p, grad);
  }
  return nullptr;
}

}  // namespace

extern "C" {

const char* sgd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Plans a step of loss (0 log_loss, 1 hinge, 2 squared_hinge, 3
// modified_huber, 4 squared_error, 5 huber) over B rows, d features and K
// target columns into plan (8 int64s; plan[6] is the floats of scratch it
// needs).  The plan depends only on (loss, B, d, K) and the card, so a
// step's sums are taken in the same order every time.
int sgd_plan(int loss, long long B, int d, int K, void* plan) {
  Plan* p = (Plan*)plan;
  if (loss < 0 || loss > 5 || d < 1 || K < 1 || (loss >= 4 && K != 1))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long rec = 2 + K + (long long)d * K;
  p->rec = rec;
  long long units;
  if (K <= 4 && d <= 256) {
    p->path = 0;
    p->kt = K == 1 ? 1 : 4;
    p->nj = d <= 64 ? 2 : 8;
  } else if (K <= 16 && d <= 64) {
    p->path = 0;
    p->kt = 16;
    p->nj = 2;
  } else {
    p->path = 1;
    p->kt = 0;
    p->nj = 0;
  }
  if (p->path == 0) {
    p->sacc = 0;
    p->smem = (long long)sizeof(float) * WARPS * rec;
    const long long groups = (B + rows_a_group((int)p->nj, (int)p->kt) - 1) /
                             rows_a_group((int)p->nj, (int)p->kt);
    units = (groups + WARPS - 1) / WARPS;
  } else {
    const long long sacc_bytes = (long long)sizeof(float) * (d + K + rec);
    p->sacc = sacc_bytes <= SMEM_LIMIT;
    p->smem = p->sacc ? sacc_bytes : (long long)sizeof(float) * (d + K);
    units = B;
  }
  int per_sm = 1 << 30;
  for (int grad = 0; grad < 2; ++grad) {
    const void* fn = select_kernel(loss, *p, grad != 0);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    if (p->smem > 48 * 1024) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem);
      if (err != cudaSuccess) return (int)err;
    }
    int ps = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ps, fn, T, (size_t)p->smem);
    if (err != cudaSuccess) return (int)err;
    if (ps < per_sm) per_sm = ps;
  }
  if (per_sm < 1) per_sm = 1;
  long long blocks = (long long)sms * per_sm;
  if (blocks > units) blocks = units;
  if (blocks > SCRATCH_FLOATS / rec) blocks = SCRATCH_FLOATS / rec;
  if (blocks < 1) blocks = 1;
  p->blocks = blocks;
  p->scratch = blocks * rec;
  return (int)cudaSuccess;
}

// One step (grad != 0) or the loss alone (grad == 0) of plan's shape.  x
// (B, d), y (B, K) and mask (B,) float32 with row strides xs, ys, ms
// (elements) and contiguous rows; coef (d, K), intercept (K,), t (), hyper
// (7,) and out (2,) float32, contiguous, on one device.  With grad: coef,
// intercept (if fit_intercept) and t updated in place.  out = (mean loss,
// sum of the mask).  scratch: plan[6] floats.
int sgd_step(const void* plan, int loss, int grad, int penalty, int schedule, int fit_intercept,
             const void* x, long long xs, const void* y, long long ys, const void* mask,
             long long ms, void* coef, void* intercept, void* t, const void* hyper, long long B,
             int d, int K, void* scratch, void* out, void* stream) {
  const Plan p = *(const Plan*)plan;
  cudaStream_t s = (cudaStream_t)stream;
  const void* fn = select_kernel(loss, p, grad != 0);
  if (fn == nullptr || penalty < 0 || penalty > 3 || schedule < 0 || schedule > 3)
    return (int)cudaErrorInvalidValue;
  const float *xf = (const float*)x, *yf = (const float*)y, *mf = (const float*)mask;
  const float *cf = (const float*)coef, *bf = (const float*)intercept, *hf = (const float*)hyper;
  float* part = (float*)scratch;
  void* args[] = {(void*)&xf, (void*)&xs, (void*)&yf, (void*)&ys, (void*)&mf, (void*)&ms,
                  (void*)&cf, (void*)&bf, (void*)&hf, (void*)&B, (void*)&d, (void*)&K,
                  (void*)&part};
  cudaError_t err = cudaLaunchKernel(fn, dim3((unsigned)p.blocks), dim3(T), args,
                                     (size_t)p.smem, s);
  if (err != cudaSuccess) return (int)err;
  finalize_kernel<<<1, FT, 0, s>>>(part, (int)p.blocks, d, K, grad, penalty, schedule,
                                   fit_intercept, hf, (float*)coef, (float*)intercept,
                                   (float*)t, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
