// K2-OvR and K2-MN: the multi-class logistic losses and their gradients
// over row shards, for Hopper (sm_90a), plain C ABI.
//
// K2-OvR (mode 0) replaces dask_ml_tpu/solvers/families.py :: Logistic.loss
// (:34) under jax.vmap of solvers/algorithms.py :: packed_solve's `one`
// (:757-800): K one-vs-rest problems that share x.  For every active lane
// l = k*P + p (class k, shard p) of B (K*P, d):
//   eta_i = x_pi . B_l
//   f_l   = sum_i mask_pi * (softplus(eta_i) - Y_kpi * eta_i)
//   g_l   = sum_i mask_pi * (sigmoid(eta_i) - Y_kpi) * x_pi     (GRAD only)
// with x (P, m, d), Y (K, P, m), mask (P, m).
//
// K2-MN (mode 1) replaces families.py :: multinomial's _Multinomial.loss
// (:85-96) under jax.value_and_grad (lbfgs_core.py:248) and the line
// search's value probes.  For every active lane p of B (P, d*K), read as
// (d, K) row-major:
//   eta_ik = sum_j x_pij B_p[j, k]
//   f_p    = sum_i mask_pi * (logsumexp_k(eta_ik) - eta_i,y_i)
//   g_p[j, k] = sum_i mask_pi * (softmax_k(eta_i) - [k = y_i]) * x_pij
// with y (P, m) holding class indices as floats (truncated to int; an index
// outside [0, K) picks no class, as jax.nn.one_hot does).
//
// Bound on an H100: like K2, one evaluation must read x once (n*d*4
// bytes) plus the targets and the mask (OvR: n*(K + 1)*4, MN: n*8), and
// does 4*n*d*K flops (K dots and K axpys per row).  At the packed fit's
// shape (P = 8, m = 1.375M, d = 29, K = 4) that is 1.496 GB, 0.447 ms at
// 3.35 TB/s, against 5.1 GFLOP, 0.076 ms at 67 TFLOP/s: memory-bound.
// Through K2 each class would read x again (K launches, 5.456 GB).  The
// design:
//   - One read of x for all K classes.  A block stages a tile of R whole
//     rows in shared memory with K2's 16-byte cp.async copies (no row
//     alignment needed), the next tile in flight while this one is used,
//     and applies all K columns of beta to it.  beta and the (row, class)
//     tables are staged with the classes padded to a multiple of 4, so
//     that 4 classes are one 16-byte shared-memory load (the tables' row
//     stride an odd number of float4s, against bank conflicts).
//   - Forward: S = 256/R threads a row; KC = 4 classes at a time, each a
//     fmaf chain in a register over the features j = s, s+S, ..., sharing
//     each staged x value, joined by a fixed xor-shuffle tree, into a
//     (row, class) table in shared memory.
//   - Row terms from that table: per (row, class) for OvR; per row for MN
//     (max, sum of exps, logsumexp, then the softmax weights).
//   - Gradient: each thread owns a (row group, feature) pair and runs KC
//     classes at a time in registers over its rows of the tile, one read
//     of x[r, j] for the KC of them, adding them once a tile to the pair's
//     shared-memory totals.  Loss: each thread owns a (row group, class)
//     pair (MN: a row group), with as many groups as fill the block; the
//     value-only variant runs it alone, the same way, so f has the same
//     bits with and without the gradient.
//   - Deterministic: per-block records summed in block order by
//     finalize_kernel; no float atomics.  Inactive lanes (OvR: a class of
//     a shard; MN: a shard) are not read and their f, g not written, and a
//     lane's sums never depend on which other lanes are active.
//   - Past what one staged tile holds beside beta, the (row, class) tables
//     and the slots (large d*K), row_kernel takes over: a block a row at a
//     time, a warp a class's dot, the gradient accumulated in the block's
//     record in global memory.
// Row indices are 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 256;                     // threads per block
constexpr int NW = T / 32;                 // warps per block
constexpr int MIN_R = 8;                   // fewest rows a tile (S = 32)
constexpr int KC = 4;                      // classes a pass of register accumulators
constexpr long long SMEM_BUDGET = 100 << 10;  // staged bytes a block: two blocks a SM
constexpr long long SCRATCH_CAP = 1LL << 26;  // floats of block records

enum { OVR = 0, MN = 1 };

struct Plan {
  long long path;      // 0: tiled_kernel, 1: row_kernel
  long long R;         // rows a tile
  long long G;         // row groups of the gradient
  long long blocks;    // blocks a shard
  long long smem;      // dynamic shared memory, bytes
  long long rec;       // floats of a block record: K * (d + 1)
  long long scratch;   // floats of scratch: P * blocks * rec
  long long GL;        // row groups of the loss
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

// cnt contiguous floats from src into buf + misalign(src) (K2's staging).
__device__ __forceinline__ void copy_tile(float* buf, const float* src, int cnt) {
  float* dst = buf + misalign(src);
  const int head = min((4 - misalign(src)) & 3, cnt);
  const int body = (cnt - head) & ~3;
  for (int e = threadIdx.x; e < head; e += T) cp_async4(dst + e, src + e);
  for (int e = head + 4 * threadIdx.x; e < head + body; e += 4 * T) cp_async16(dst + e, src + e);
  for (int e = head + body + threadIdx.x; e < cnt; e += T) cp_async4(dst + e, src + e);
}

// Whether class k of shard p is computed: OvR lane k*P + p, MN lane p
// (the caller has returned already when that is off).
template <int MODE>
__device__ __forceinline__ bool class_on(const unsigned char* active, long long P, int p, int k) {
  return MODE == MN || active[(long long)k * P + p];
}

template <int MODE>
__device__ __forceinline__ bool shard_on(const unsigned char* active, long long P, int p, int K) {
  if (MODE == MN) return active[p];
  for (int k = 0; k < K; ++k)
    if (active[(long long)k * P + p]) return true;
  return false;
}

// B_l[j] of class k on shard p: OvR lane rows (K*P, d), MN (P, d, K).
template <int MODE>
__device__ __forceinline__ long long beta_at(long long P, int p, int d, int K, int k, int j) {
  return MODE == OVR ? ((long long)k * P + p) * d + j : ((long long)p * d + j) * K + k;
}

struct RowTerms {
  float loss;  // softplus(eta) - y*eta, times the mask
  float w;     // (sigmoid(eta) - y), times the mask
};

__device__ __forceinline__ RowTerms logistic_terms(float eta, float y, float m) {
  const float e = expf(-fabsf(eta));
  const float sp = fmaxf(eta, 0.f) + log1pf(e);
  const float sig = eta >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);
  return {m * (sp - y * eta), m * (sig - y)};
}

// The class y picks, or -1 outside [0, K).
__device__ __forceinline__ int class_index(float y, int K) {
  const int c = (int)y;
  return (c >= 0 && c < K) ? c : -1;
}

// One row of MN: e holds the K logits and is overwritten by the weights
// mask*(softmax - onehot); returns mask*(logsumexp - picked logit).
__device__ __forceinline__ float softmax_terms(float* e, int K, float yv, float mv) {
  float mx = -INFINITY;
  for (int k = 0; k < K; ++k) mx = fmaxf(mx, e[k]);
  float s = 0.f;
  for (int k = 0; k < K; ++k) s += expf(e[k] - mx);
  const float lse = mx + logf(s);
  const int c = class_index(yv, K);
  const float loss = mv * (lse - (c >= 0 ? e[c] : 0.f));
  for (int k = 0; k < K; ++k) e[k] = mv * (expf(e[k] - lse) - (k == c ? 1.f : 0.f));
  return loss;
}

// K rounded up to whole float4s: the class stride of beta_s.
__host__ __device__ __forceinline__ int padded(int K) { return (K + KC - 1) / KC * KC; }

// The row stride of the (row, class) tables: whole float4s, an odd number
// of them, so that a warp's threads, a row each, meet at most 4-way bank
// conflicts (a stride of 16 floats would be 16-way).
__host__ __device__ __forceinline__ int row_stride(int K) {
  const int s = padded(K);
  return (s / KC) % 2 ? s : s + KC;
}

// Floats of tiled_kernel's dynamic shared memory, in the order laid out.
long long staged_floats(int mode, int d, int K, int R, int G, int GL) {
  const long long KL = mode == OVR ? K : 1, KP = padded(K), KS = row_stride(K);
  return 2LL * (R * (long long)d + 4) + d * KP + 2LL * R * KS + R + (long long)G * K * d +
         GL * KL + K;
}

// Row groups: of the gradient, so that (group, feature) pairs fill a
// block, and of the loss, so that (group, loss column) pairs do.
int row_groups(int cols, int R) {
  const int g = T / cols;
  return g < 1 ? 1 : (g > R ? R : g);
}

// Grid (blocks, P).  Block b of shard p takes the shard's row tiles b,
// b + blocks, ... and writes its record bpart[(p*blocks + b)*K*(d + 1)]:
// for each class k, (GRAD) its g at k*(d+1) + j and its f at k*(d+1) + d
// (MN: the lane's f at d).  The classes go KC at a time through register
// accumulators, which share each staged x value between them.
template <int MODE, bool GRAD>
__global__ void __launch_bounds__(T) tiled_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ mask,
    const float* __restrict__ beta, const unsigned char* __restrict__ active, long long P,
    long long m, int d, int K, int R, int G, int GL, float* __restrict__ bpart) {
  const int p = blockIdx.y;
  if (!shard_on<MODE>(active, P, p, K)) return;
  extern __shared__ __align__(16) float smem[];
  const int C = d + 1, KL = MODE == OVR ? K : 1, KP = padded(K), KS = row_stride(K);
  const int tile_floats = R * d + 4;
  // beta_s and the (row, class) tables keep KP and KS floats a feature or
  // row, so that KC classes are one 16-byte load (every offset here is a
  // multiple of 4 floats)
  float* beta_s = smem + 2 * tile_floats;  // (d, KP)
  float* w_s = beta_s + d * KP;            // (R, KS): the logits, then the weights
  float* ly_s = w_s + R * KS;              // (R, KS) OvR, (R,) MN: targets, then losses
  float* m_s = ly_s + R * KS;              // R
  float* gacc = m_s + R;                   // (G, K, d) gradient totals
  float* lacc = gacc + G * K * d;          // (GL, KL) loss totals
  float* on_s = lacc + GL * KL;            // K: 1 where the class is computed

  const int S = T / R, r_own = threadIdx.x / S, s_own = threadIdx.x - r_own * S;
  for (int k = threadIdx.x; k < K; k += T) on_s[k] = class_on<MODE>(active, P, p, k) ? 1.f : 0.f;
  for (int e = threadIdx.x; e < KP * d; e += T) {
    const int k = MODE == OVR ? e / d : e % KP;
    const int j = MODE == OVR ? e - k * d : e / KP;
    const bool on = k < K && class_on<MODE>(active, P, p, k);
    beta_s[j * KP + k] = on ? beta[beta_at<MODE>(P, p, d, K, k, j)] : 0.f;
  }
  if (GRAD)
    for (int e = threadIdx.x; e < G * K * d; e += T) gacc[e] = 0.f;
  for (int e = threadIdx.x; e < GL * KL; e += T) lacc[e] = 0.f;
  __syncthreads();

  const float* xl = x + (long long)p * m * d;
  const float* ml = mask + (long long)p * m;
  const long long ntiles = (m + R - 1) / R;
  const long long step = gridDim.x;

  long long t0 = blockIdx.x;
  if (t0 < ntiles) copy_tile(smem, xl + t0 * R * d, (int)min((long long)R, m - t0 * R) * d);
  cp_async_commit();
  int cur = 0;
  for (long long t = t0; t < ntiles; t += step, cur ^= 1) {
    const long long next = t + step;
    if (next < ntiles)
      copy_tile(smem + (cur ^ 1) * tile_floats, xl + next * R * d,
                (int)min((long long)R, m - next * R) * d);
    cp_async_commit();
    const long long r0 = t * R;
    const int rows = (int)min((long long)R, m - r0);
    if (MODE == OVR) {
      for (int e = threadIdx.x; e < K * R; e += T) {
        const int k = e / R, r = e - k * R;
        if (r < rows && on_s[k] != 0.f) ly_s[r * KS + k] = y[((long long)k * P + p) * m + r0 + r];
      }
    } else {
      for (int r = threadIdx.x; r < rows; r += T) ly_s[r] = y[(long long)p * m + r0 + r];
    }
    for (int r = threadIdx.x; r < rows; r += T) m_s[r] = ml[r0 + r];
    cp_async_wait_prior();
    __syncthreads();
    const float* xs = smem + cur * tile_floats + misalign(xl + r0 * d);

    // forward: the (row, class) logits, S threads a row, KC classes at a
    // time (a class that is off has zero beta and is not used)
    for (int k0 = 0; k0 < K; k0 += KC) {
      float acc[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) acc[c] = 0.f;
      if (r_own < rows) {
        const float* xr = xs + r_own * d;
#pragma unroll 4
        for (int j = s_own; j < d; j += S) {
          const float xv = xr[j];
          const float4 b = *reinterpret_cast<const float4*>(beta_s + j * KP + k0);
          acc[0] = fmaf(xv, b.x, acc[0]);
          acc[1] = fmaf(xv, b.y, acc[1]);
          acc[2] = fmaf(xv, b.z, acc[2]);
          acc[3] = fmaf(xv, b.w, acc[3]);
        }
      }
#pragma unroll
      for (int c = 0; c < KC; ++c)
        for (int o = S >> 1; o > 0; o >>= 1) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
      if (s_own == 0 && r_own < rows) {
#pragma unroll
        for (int c = 0; c < KC; ++c)
          if (k0 + c < K) w_s[r_own * KS + k0 + c] = acc[c];
      }
    }
    __syncthreads();

    // row terms: loss and weight of each (row, class)
    if (MODE == OVR) {
      for (int e = threadIdx.x; e < rows * K; e += T) {
        const int r = e / K, k = e - r * K, i = r * KS + k;
        if (on_s[k] == 0.f) continue;
        const RowTerms rt = logistic_terms(w_s[i], ly_s[i], m_s[r]);
        ly_s[i] = rt.loss;
        w_s[i] = rt.w;
      }
    } else {
      for (int r = threadIdx.x; r < rows; r += T)
        ly_s[r] = softmax_terms(w_s + r * KS, K, ly_s[r], m_s[r]);
    }
    __syncthreads();

    // gradient: thread (group q, feature j) over rows q, q + G, ..., KC
    // classes at a time
    if (GRAD) {
      for (int e = threadIdx.x; e < G * d; e += T) {
        const int q = e / d, j = e - q * d;
        for (int k0 = 0; k0 < K; k0 += KC) {
          float acc[KC];
#pragma unroll
          for (int c = 0; c < KC; ++c) acc[c] = 0.f;
#pragma unroll 4
          for (int r = q; r < rows; r += G) {
            const float xv = xs[r * d + j];
            const float4 w = *reinterpret_cast<const float4*>(w_s + r * KS + k0);
            acc[0] = fmaf(w.x, xv, acc[0]);
            acc[1] = fmaf(w.y, xv, acc[1]);
            acc[2] = fmaf(w.z, xv, acc[2]);
            acc[3] = fmaf(w.w, xv, acc[3]);
          }
#pragma unroll
          for (int c = 0; c < KC; ++c)
            if (k0 + c < K) gacc[(q * K + k0 + c) * d + j] += acc[c];
        }
      }
    }
    // loss: thread (group q, loss column) over rows q, q + GL, ...; the
    // same in both variants, so f has the same bits
    for (int e = threadIdx.x; e < GL * KL; e += T) {
      const int q = e / KL, k = e - q * KL;
      if (on_s[k] == 0.f) continue;
      float acc = 0.f;
      for (int r = q; r < rows; r += GL) acc += ly_s[MODE == OVR ? r * KS + k : r];
      lacc[e] += acc;
    }
    __syncthreads();  // this tile's buffer and tables are free for the next tile
  }

  float* rec = bpart + ((long long)p * gridDim.x + blockIdx.x) * ((long long)K * C);
  if (GRAD) {
    for (int e = threadIdx.x; e < K * d; e += T) {
      const int k = e / d, j = e - k * d;
      float s = 0.f;
      for (int q = 0; q < G; ++q) s += gacc[(q * K + k) * d + j];
      rec[k * C + j] = s;
    }
  }
  for (int k = threadIdx.x; k < KL; k += T) {
    float s = 0.f;
    for (int q = 0; q < GL; ++q) s += lacc[q * KL + k];
    rec[k * C + d] = s;
  }
}

// Large d*K: block b of shard p takes rows b, b + blocks, ...; each row's
// logits are dotted a warp a class, its terms computed, and its
// contribution added to the block's record in global memory (each element
// by one thread, in row order).  Dynamic shared memory: 3*K floats.
template <int MODE, bool GRAD>
__global__ void __launch_bounds__(T) row_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ mask,
    const float* __restrict__ beta, const unsigned char* __restrict__ active, long long P,
    long long m, int d, int K, float* __restrict__ bpart) {
  const int p = blockIdx.y;
  if (!shard_on<MODE>(active, P, p, K)) return;
  extern __shared__ float rsm[];
  float* e_s = rsm;          // K logits, then weights
  float* l_s = rsm + K;      // K losses (MN: class 0)
  float* y_s = rsm + 2 * K;  // K targets (OvR)
  __shared__ float lse_s;
  const int C = d + 1, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* rec = bpart + ((long long)p * gridDim.x + blockIdx.x) * ((long long)K * C);
  if (GRAD)
    for (int e = threadIdx.x; e < K * C; e += T) rec[e] = 0.f;
  else
    for (int k = threadIdx.x; k < K; k += T) rec[k * C + d] = 0.f;

  for (long long r = blockIdx.x; r < m; r += gridDim.x) {
    const long long row = (long long)p * m + r;
    const float* xr = x + row * d;
    const float mv = mask[row];
    const float yv = MODE == MN ? y[row] : 0.f;
    if (MODE == OVR)
      for (int k = threadIdx.x; k < K; k += T)
        if (class_on<MODE>(active, P, p, k)) y_s[k] = y[((long long)k * P + p) * m + r];
    for (int k = warp; k < K; k += NW) {
      if (!class_on<MODE>(active, P, p, k)) continue;
      float part = 0.f;
      for (int j = lane; j < d; j += 32)
        part = fmaf(xr[j], beta[beta_at<MODE>(P, p, d, K, k, j)], part);
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) e_s[k] = part;
    }
    __syncthreads();
    if (MODE == OVR) {
      for (int k = threadIdx.x; k < K; k += T) {
        if (!class_on<MODE>(active, P, p, k)) continue;
        const RowTerms rt = logistic_terms(e_s[k], y_s[k], mv);
        l_s[k] = rt.loss;
        e_s[k] = rt.w;
      }
    } else {
      if (warp == 0) {
        float mx = -INFINITY;
        for (int k = lane; k < K; k += 32) mx = fmaxf(mx, e_s[k]);
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float s = 0.f;
        for (int k = lane; k < K; k += 32) s += expf(e_s[k] - mx);
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) {
          const float lse = mx + logf(s);
          const int c = class_index(yv, K);
          l_s[0] = mv * (lse - (c >= 0 ? e_s[c] : 0.f));
          lse_s = lse;
        }
      }
      __syncthreads();
      const int c = class_index(yv, K);
      for (int k = threadIdx.x; k < K; k += T)
        e_s[k] = mv * (expf(e_s[k] - lse_s) - (k == c ? 1.f : 0.f));
    }
    __syncthreads();
    if (GRAD) {
      for (int e = threadIdx.x; e < K * C; e += T) {
        const int k = e / C, j = e - k * C;
        if (!class_on<MODE>(active, P, p, k)) continue;
        if (j < d)
          rec[e] = fmaf(e_s[k], xr[j], rec[e]);
        else if (MODE == OVR || k == 0)
          rec[e] += l_s[k];
      }
    } else {
      for (int k = threadIdx.x; k < K; k += T)
        if (class_on<MODE>(active, P, p, k) && (MODE == OVR || k == 0)) rec[k * C + d] += l_s[k];
    }
    __syncthreads();  // e_s, l_s and y_s are free for the next row
  }
}

// For each active lane: f and (grad) g summed over the shard's block
// records, in block order.  Grid (ceil(K*(d+1)/256), P).
template <int MODE>
__global__ void finalize_kernel(const float* __restrict__ bpart,
                                const unsigned char* __restrict__ active, long long P, int blocks,
                                int d, int K, int grad, float* __restrict__ f,
                                float* __restrict__ g) {
  const int p = blockIdx.y, C = d + 1;
  const long long rec = (long long)K * C;
  const float* shard = bpart + (long long)p * blocks * rec;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < K * C; e += gridDim.x * blockDim.x) {
    const int k = e / C, j = e - k * C;
    const long long l = MODE == OVR ? (long long)k * P + p : p;
    if (!active[l]) continue;
    if (j == d ? (MODE == MN && k > 0) : !grad) continue;
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += shard[(long long)b * rec + e];
    if (j == d)
      f[l] = s;
    else
      g[MODE == OVR ? l * d + j : ((long long)p * d + j) * K + k] = s;
  }
}

// Lets kern take all the dynamic shared memory a block may have beside
// its static arrays (so that a plan made for one shape stays valid after
// another shape's plan), and says how many blocks of smem bytes fit a SM.
template <typename Kern>
cudaError_t occupancy(Kern kern, int dev, size_t smem, int* per_sm) {
  int most = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most - (int)attr.sharedSizeBytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, T, smem);
}

template <int MODE>
cudaError_t plan_mode(int dev, long long m, int d, int K, Plan* p, long long* units,
                      int* per_sm) {
  int R = 0, G = 1, GL = 1;
  for (int r = T; r >= MIN_R; r >>= 1) {
    const int g = row_groups(d, r), gl = row_groups(MODE == OVR ? K : 1, r);
    if (4 * staged_floats(MODE, d, K, r, g, gl) <= SMEM_BUDGET) {
      R = r;
      G = g;
      GL = gl;
      break;
    }
  }
  cudaError_t err;
  if (R > 0) {
    const size_t smem = 4 * (size_t)staged_floats(MODE, d, K, R, G, GL);
    int ps_grad = 0, ps_value = 0;
    if ((err = occupancy(tiled_kernel<MODE, true>, dev, smem, &ps_grad)) != cudaSuccess) return err;
    if ((err = occupancy(tiled_kernel<MODE, false>, dev, smem, &ps_value)) != cudaSuccess) return err;
    *per_sm = ps_grad < ps_value ? ps_grad : ps_value;
    p->path = 0;
    p->R = R;
    p->G = G;
    p->GL = GL;
    p->smem = (long long)smem;
    *units = (m + R - 1) / R;
  } else {
    const size_t smem = 3 * sizeof(float) * (size_t)K;
    int ps_grad = 0, ps_value = 0;
    if ((err = occupancy(row_kernel<MODE, true>, dev, smem, &ps_grad)) != cudaSuccess) return err;
    if ((err = occupancy(row_kernel<MODE, false>, dev, smem, &ps_value)) != cudaSuccess) return err;
    *per_sm = ps_grad < ps_value ? ps_grad : ps_value;
    p->path = 1;
    p->R = 1;
    p->G = 1;
    p->GL = 1;
    p->smem = (long long)smem;
    *units = m;
  }
  return cudaSuccess;
}

template <int MODE>
void launch(const Plan& p, const float* x, const float* y, const float* mask, const float* beta,
            const unsigned char* act, long long P, long long m, int d, int K, int grad,
            float* bpart, cudaStream_t s) {
  const dim3 grid((unsigned)p.blocks, (unsigned)P);
  const size_t smem = (size_t)p.smem;
  if (p.path == 0) {
    if (grad)
      tiled_kernel<MODE, true><<<grid, T, smem, s>>>(x, y, mask, beta, act, P, m, d, K, (int)p.R,
                                                     (int)p.G, (int)p.GL, bpart);
    else
      tiled_kernel<MODE, false><<<grid, T, smem, s>>>(x, y, mask, beta, act, P, m, d, K, (int)p.R,
                                                      (int)p.G, (int)p.GL, bpart);
  } else {
    if (grad)
      row_kernel<MODE, true><<<grid, T, smem, s>>>(x, y, mask, beta, act, P, m, d, K, bpart);
    else
      row_kernel<MODE, false><<<grid, T, smem, s>>>(x, y, mask, beta, act, P, m, d, K, bpart);
  }
}

}  // namespace

extern "C" {

const char* multiclass_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Plans a call of mode (0 OvR, 1 MN) over P shards of m rows, d features
// and K classes into plan (8 int64s; plan[6] is the floats of scratch it
// needs), to be passed back to multiclass_value_and_grad.  The plan
// depends only on (mode, P, m, d, K) and the card, so a lane's sums are
// taken in the same order whatever the other lanes do.
int multiclass_plan(int mode, long long P, long long m, int d, int K, void* plan) {
  Plan* p = (Plan*)plan;
  int dev = 0, sms = 0, per_sm = 1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long units = 1;
  err = mode == OVR ? plan_mode<OVR>(dev, m, d, K, p, &units, &per_sm)
                    : plan_mode<MN>(dev, m, d, K, p, &units, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  p->rec = (long long)K * (d + 1);
  // one wave over all shards, split evenly between them, and records
  // that fit the scratch cap
  long long blocks = (long long)sms * per_sm / P;
  const long long cap = SCRATCH_CAP / (P * p->rec);
  if (blocks > cap) blocks = cap;
  if (blocks > units) blocks = units;
  if (blocks < 1) blocks = 1;
  p->blocks = blocks;
  p->scratch = P * blocks * p->rec;
  return (int)cudaSuccess;
}

// x (P, m, d), mask (P, m): float32, contiguous, on one device.  Mode 0:
// y (K, P, m), beta (K*P, d), active (K*P,), f (K*P,), g (K*P, d).  Mode 1:
// y (P, m) class indices, beta (P, d*K), active (P,), f (P,), g (P, d*K).
// f and g are written only for active lanes, g only when grad != 0.
// scratch: plan[6] floats.
int multiclass_value_and_grad(int mode, const void* x, const void* y, const void* mask,
                              const void* beta, const void* active, long long P, long long m,
                              int d, int K, int grad, const void* plan, void* scratch, void* f,
                              void* g, void* stream) {
  const Plan p = *(const Plan*)plan;
  cudaStream_t s = (cudaStream_t)stream;
  const float *xf = (const float*)x, *yf = (const float*)y, *mf = (const float*)mask,
              *bf = (const float*)beta;
  const unsigned char* act = (const unsigned char*)active;
  float* bpart = (float*)scratch;
  if (mode == OVR)
    launch<OVR>(p, xf, yf, mf, bf, act, P, m, d, K, grad, bpart, s);
  else
    launch<MN>(p, xf, yf, mf, bf, act, P, m, d, K, grad, bpart, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cols = K * (d + 1);
  const dim3 fgrid((unsigned)((cols + 255) / 256), (unsigned)P);
  if (mode == OVR)
    finalize_kernel<OVR><<<fgrid, 256, 0, s>>>(bpart, act, P, (int)p.blocks, d, K, grad,
                                               (float*)f, (float*)g);
  else
    finalize_kernel<MN><<<fgrid, 256, 0, s>>>(bpart, act, P, (int)p.blocks, d, K, grad,
                                              (float*)f, (float*)g);
  return (int)cudaGetLastError();
}

}  // extern "C"
