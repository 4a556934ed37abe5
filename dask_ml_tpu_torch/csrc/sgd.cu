// K4: minibatch SGD steps of a linear model, for Hopper (sm_90a), plain C
// ABI.
//
// Replaces: dask_ml_tpu/linear_model/_sgd.py :: sgd_step (:146; the step of
// partial_fit), :: sgd_epoch (:203, a lax.scan of sgd_step over the
// minibatches) and :: _eval_loss_fn (:241, the value only).  For one block
// x [B, d] float32, targets y [B, K], mask [B] and the state coef [d, K],
// intercept [K], t:
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
// memory-bound by ~20x; at K = 10, 0.3146 GB (0.0939 ms) against 2.7 GFLOP.
// A fit's minibatch step (65,536 rows of 2^20) has a bound of ~5 us, less
// than two launches and a host call cost.  The reference reads x twice
// (xb @ coef, then xb.T @ dmarg).  The design:
//   - One read of x, every block taking its own rows; each block writes a
//     record (loss, count, gint, gcoef) and the records are summed in a
//     fixed order: no float atomics, and a shape's bits do not depend on
//     timing.  Minibatch views are strided: minibatch i of sgd_epoch is the
//     rows i::n_mb of the padded block (the reference's free reshape), read
//     where it lies (row strides for x, y and the mask), never copied.
//   - K = 1, d <= 256: a warp takes U rows at a time (U = 8, or 4 where
//     d > 64), its lanes over the features: lane l holds x_ij for j = l,
//     l + 32, ... in registers.  The dot (an xor tree) and the gradient's
//     accumulate use those registers; the U rows' loss terms run side by
//     side, one lane a row, and each mask*dl is broadcast by one shuffle.
//     In an epoch (warp_record) each load of a row is one coalesced line
//     from global memory, the U rows' loads issued before any use.
//   - A step at K = 1, d <= 256 (step_kernel) is one launch.  A
//     persistent grid, one block a SM; block b takes tiles b, b + nb, ...
//     of R = 128 rows (32 past d = 64) through a ring of four shared-memory
//     stages, the next three in flight: x by one bulk copy (TMA) a tile
//     where the tile is one run of bytes, by 16-byte cp.async where a
//     minibatch view strides its rows (a bulk copy a row took twice as
//     long), by 4-byte cp.async where rows are off a 16-byte boundary; y
//     and the mask by cp.async.  The record stays in registers across the
//     tiles.  Then the finish, in the same launch: each block writes its
//     record and takes a ticket (a release fence, then atomicInc, which the
//     last block wraps back to 0); the last block copies the records into
//     its shared memory and sums them in a fixed order, and applies the
//     update with the state, eta and coef read at its start.  Measured on
//     an H100 (sgd_variants.py --k1): the ring alone streams 2^20 x 64 in
//     ~93 us (~3.0 TB/s); the finish takes ~3.5 us after the last block's
//     rows (the ticket ~1.3, the records' copy and sums ~2); the blocks end
//     their rows up to ~6 us apart; and the stages must start on a 128-byte
//     boundary (16 bytes of static shared memory ahead of them cost ~4%).
//   - K in 2..16, d <= 256 (tc_record): the two class products on TF32
//     tensor cores, mma.sync m16n8k8 with a hi/lo 3-pass split (lo*hi +
//     hi*lo + hi*hi, the split of K2-MN, csrc/multiclass.cu), at float32
//     accuracy (each product within ~2^-20 of its value).  A block stages
//     tiles of R rows (64, or 32 where d > 96) of x, y and the mask in
//     shared memory by cp.async, two stages, the next tile in flight while
//     this one computes.  Forward: margins (16 rows x 8 classes) = x . coef,
//     a warp a (16-row group, n-tile of 8 classes), with coef's B
//     fragments split once a launch (once a step in the epoch) into shared
//     memory; the loss terms run on the accumulator fragments in registers
//     (no shuffle trees), and mask*dl goes to a (R, 8*NN) table.
//     Gradient: G (d x 8*NN) += x^T . W, a warp a (16-feature, n-tile)
//     block of G, which it alone owns, so a block's gcoef needs no cross-warp
//     sum.  Each gradient mma starts from zero and is added on the CUDA
//     cores: the tensor cores round their float32 sums toward zero, a bias
//     that builds up over many rows into one accumulator (as in K2-MN); a
//     margin sums only d products, in three accumulators (one a pass) on
//     the tensor cores.  Padded classes get coef 0 and weight 0; features
//     past d read zeros.
//   - Wider shapes (row_kernel): a block a row at a time (the row staged in
//     shared memory, a warp per class's dot, a thread per gradient
//     element), with its accumulators in shared memory where they fit and
//     in its record in global memory beyond.
//   - A step on the row path (sgd_step): the block kernel, then
//     finalize_kernel, one block, which sums the records (a warp an
//     element, lanes over the blocks, where the elements are few) and
//     applies the penalty, the schedule and the update.  On the tensor-core
//     path a step is an epoch of one minibatch instead: its K + d*K sums
//     spread over the blocks, where one block summing hundreds of records
//     of K + d*K floats took longer than the products.
//   - An epoch (sgd_epoch_run): all n_mb steps in one cooperative launch of
//     epoch_kernel, every block resident.  A step: each block writes its
//     record over its share of minibatch i (the same cores); a grid sync;
//     block b sums a fixed slice of the record's elements over the blocks
//     (a warp an element, lanes over the blocks, as finalize_kernel) and
//     writes their updated coef and intercept (each element one owner);
//     a grid sync.  Every block keeps t in a register and counts it up;
//     every block sums the count itself, in the same order.  Where the
//     epoch's grid equals the step's, a step's sums are taken in the same
//     order as sgd_step's.  Records and the state written inside the
//     launch are read through L2 (__ldcg), never from a block's L1.
// Row indices are 64-bit.
//
// K5' (sgd_group_step): an ensemble's epoch, M members each taking one step
// on its own window of x.  Replaces dask_ml_tpu/ensemble/_blockwise.py ::
// _ensemble_epoch (:64, jax.vmap of sgd_step over (state, own block, own
// mask, hyperparameters)).  Member m reads rows st[m] .. st[m] + B of x and
// y in place (the reference stacks copies of the windows: at 8 x 2^20 x 64
// a second X, twice the step's own traffic); windows may overlap, so an
// offset a member, not a uniform stride.  Bound on an H100: the windows'
// rows once, M*B*(d + K + 1)*4 bytes (8 x 2^20 x 64, K = 1: 2.215 GB,
// 0.661 ms at 3.35 TB/s; K = 10: 2.517 GB, 0.751 ms), against 4*M*B*d*K
// flops: memory-bound.  One launch an epoch: grid row blockIdx.y is a
// member, its gridDim.x blocks (the card's resident blocks shared out
// over the members) take its tiles with K4's pieces: at K = 1, d <= 256
// step_kernel itself (its TMA ring and its ticketed finish, GROUP: the
// member's window, state, records and ticket); at K in 2..16, d <= 256
// tc_record, else row_record, then group_kernel's finish: a ticket a
// member, its last block summing the member's records in block order and
// updating its state.  No float atomics, so a shape's bits do not depend on
// timing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int T = 256;  // threads a block of the step kernels
constexpr int WARPS = T / 32;
constexpr int FT = 1024;  // threads of finalize_kernel
constexpr unsigned FULL = 0xffffffffu;
constexpr long long SCRATCH_FLOATS = 1ll << 22;  // most floats of block records a call
constexpr int SMEM_LIMIT = 200 * 1024;           // most dynamic shared memory a row block takes
constexpr int TC_MAX_D = 256;                    // tensor-core path: d <= 256, 2 <= K <= 16
constexpr int RED = 20;                          // floats a warp of tc_record's block sums

enum { ALPHA = 0, ETA0, POWER_T, T0, L1_RATIO, EPSILON, ETA_SCALE };
enum { WARP_PATH = 0, ROW_PATH = 1, TC_PATH = 2, STEP_PATH = 3 };

struct Plan {
  long long path;         // WARP_PATH (an epoch at K = 1), STEP_PATH (a step at K = 1), ROW_PATH
                          // or TC_PATH
  long long nj;           // warp and step paths: feature slices a lane; tc path: n-tiles of 8
                          // classes
  long long wide;         // tc path: d > 64 (a warp owns up to 4 gradient blocks, not 1)
  long long blocks;       // blocks of the step (or epoch) kernel
  long long smem;         // dynamic shared memory, bytes
  long long rec;          // floats of a block record: 2 + K + d*K
  long long scratch;      // floats of scratch: the larger grid's records
  long long sacc;         // row path: accumulators in shared memory
  long long loss_blocks;  // blocks of the loss kernel (the tc path's step kernel differs)
};
static_assert(sizeof(Plan) == 9 * sizeof(long long), "Plan is 9 int64s");

// Rows a warp of the K = 1 register path takes at a time.
__host__ __device__ constexpr int rows_a_group(int nj) { return nj <= 2 ? 8 : 4; }

// A value of the state, read as the epoch kernel reads it: through L2,
// since other blocks wrote it inside the launch.
template <bool COHERENT>
__device__ __forceinline__ float state_at(const float* p) {
  if constexpr (COHERENT) return __ldcg(p);
  return *p;
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


// ------------------------------------------------------- K = 1: registers

// One block's record on the register path (K = 1): the block takes row
// groups g = bid*WARPS + w, + nb*WARPS, ... (warp w), each of U rows.  Lane
// l owns the features j = l + 32 i (i < NJ): coef in cf, the gradient's
// sums in acc.  A row's partial dots are joined by an xor tree; lane u < U
// then takes the loss terms of row u of the group, and its mask*dl is
// broadcast by one shuffle a row.  sm: WARPS records for the combine.  The
// record (floats): loss, count, gint, gcoef[d].
template <typename L, int NJ, bool GRAD, bool COHERENT>
__device__ __forceinline__ void warp_record(
    const float* __restrict__ x, long long xs, const float* __restrict__ y, long long ys,
    const float* __restrict__ mask, long long ms, const float* coef, const float* intercept,
    const float* __restrict__ hyper, long long B, int d, int K, float* __restrict__ out,
    int bid, int nb, float* sm) {
  constexpr int U = rows_a_group(NJ);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool active = lane < U;
  const int rec = 2 + K + d * K;
  const float eps = hyper[EPSILON];

  float cf[NJ], acc[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    const int j = lane + 32 * i;
    cf[i] = j < d ? state_at<COHERENT>(coef + (long long)j * K) : 0.f;
    acc[i] = 0.f;
  }
  const float b_own = state_at<COHERENT>(intercept);
  float loss_own = 0.f, gint_own = 0.f, cnt_own = 0.f;

  const long long groups = (B + U - 1) / U;
  const long long stride = (long long)nb * WARPS;
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
    const long long r_own = r0 + lane;
    const bool row_ok = active && g < groups && r_own < B;
    m_own = row_ok ? mask[r_own * ms] : 0.f;
    y_own = row_ok ? y[r_own * ys] : 0.f;
  };
  float xv[U][NJ], m_own, y_own;
  long long g = (long long)bid * WARPS + warp;
  load(g, xv, m_own, y_own);
  for (; g < groups; g += stride) {
    float p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NJ; ++i) s = fmaf(xv[u][i], cf[i], s);
      p[u] = s;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) p[u] += __shfl_xor_sync(FULL, p[u], off);
    }
    // the loss terms of row `lane`
    float m = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u == lane) m = p[u];
    float w = 0.f;
    if (active) {
      const Terms tr = L::terms(m + b_own, y_own, eps);
      loss_own += m_own * tr.l;
      w = m_own * tr.dl;
      gint_own += w;
      cnt_own += m_own;
    }
    if (GRAD) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float wk = __shfl_sync(FULL, w, u);
#pragma unroll
        for (int i = 0; i < NJ; ++i) acc[i] = fmaf(wk, xv[u][i], acc[i]);
      }
    }
    if (g + stride < groups) load(g + stride, xv, m_own, y_own);
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
    gint_own = warp_sum(gint_own);
    if (lane == 0) mine[2] = gint_own;
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int j = lane + 32 * i;
      if (j < d) mine[2 + K + j * K] = acc[i];
    }
  }
  __syncthreads();
  const int used = GRAD ? rec : 2;
  for (int e = threadIdx.x; e < used; e += T) {
    float s = 0.f;
    for (int v = 0; v < WARPS; ++v) s += sm[v * rec + e];
    out[e] = s;
  }
}

// -------------------------------------------------------- wide: row path

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

// One block's record on the wide path: block bid takes rows bid, bid + nb,
// ...  The row goes to shared memory, warp w computes the margins of
// classes w, w + WARPS, ..., thread t the loss terms of classes t, t + T,
// ... and the gradient elements t, t + T, ... (each element owned by one
// thread, so the sums need no atomics).  Accumulators: in shared memory
// (SACC) and copied to the block's record at the end, or in the record
// itself.  sm: the row (d), the margins then mask*dl (K), the accumulators
// (SACC: rec).
template <typename L, bool GRAD, bool SACC, bool COHERENT>
__device__ __forceinline__ void row_record(
    const float* __restrict__ x, long long xs, const float* __restrict__ y, long long ys,
    const float* __restrict__ mask, long long ms, const float* coef, const float* intercept,
    const float* __restrict__ hyper, long long B, int d, int K, float* __restrict__ out,
    int bid, int nb, float* sm) {
  __shared__ float red[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rec = 2 + K + d * K;
  const int used = GRAD ? rec : 2;
  float* xrow = sm;
  float* wk = xrow + d;
  float* acc = SACC ? wk + K : out;
  const float eps = hyper[EPSILON];
  for (int e = threadIdx.x; e < used; e += T) acc[e] = 0.f;
  float loss_t = 0.f, cnt = 0.f;
  __syncthreads();
  for (long long r = bid; r < B; r += nb) {
    const float* xr = x + r * xs;
    for (int j = threadIdx.x; j < d; j += T) xrow[j] = xr[j];
    const float mv = mask[r * ms];
    __syncthreads();
    for (int k = warp; k < K; k += WARPS) {
      float p = 0.f;
      for (int j = lane; j < d; j += 32)
        p = fmaf(xrow[j], state_at<COHERENT>(coef + (long long)j * K + k), p);
      p = warp_sum(p);
      if (lane == 0) wk[k] = p;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += T) {
      const Terms tr = L::terms(wk[k] + state_at<COHERENT>(intercept + k), y[r * ys + k], eps);
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

template <typename L, bool GRAD, bool SACC>
__global__ void __launch_bounds__(T) row_kernel(
    const float* __restrict__ x, long long xs, const float* __restrict__ y, long long ys,
    const float* __restrict__ mask, long long ms, const float* __restrict__ coef,
    const float* __restrict__ intercept, const float* __restrict__ hyper, long long B, int d,
    int K, float* __restrict__ bpart) {
  extern __shared__ __align__(16) float sm[];
  row_record<L, GRAD, SACC, false>(x, xs, y, ys, mask, ms, coef, intercept, hyper, B, d, K,
                                   bpart + (long long)blockIdx.x * (2 + K + d * K), blockIdx.x,
                                   gridDim.x, sm);
}

// -------------------------------------------- K in 2..16: TF32 tensor cores

// v rounded to TF32 (round to nearest, ties away from zero), in a 32-bit
// register as the tensor cores read it
__device__ __forceinline__ unsigned to_tf32(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo: hi is v rounded to TF32, lo = v - hi exactly (float32),
// which the tensor cores read truncated to TF32 (its low 13 bits dropped)
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = to_tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// c += a*b, one m16n8k8 TF32 product with float32 sums
__device__ __forceinline__ void mma8(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                     unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a*b by the 3-pass split (a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, the small
// terms first; a_lo*b_lo, below 2^-22 |a||b|, is left out), from zero, and
// added to acc on the CUDA cores: a gradient sums over many rows, and the
// tensor cores round their float32 sums toward zero
__device__ __forceinline__ void mma3_add(float (&acc)[4], const unsigned (&ah)[4],
                                         const unsigned (&al)[4], unsigned bh0, unsigned bh1,
                                         unsigned bl0, unsigned bl1) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma8(c, al, bh0, bh1);
  mma8(c, ah, bl0, bl1);
  mma8(c, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += c[i];
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits for all but the newest group of this thread's copies
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// waits until at most N of this thread's newest groups of copies are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The mbarriers and bulk copies (TMA) of the K = 1 step's ring, as K5's
// ring path has them (csrc/cohort.cu).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
// orders this thread's memory operations, and those its block's barrier
// made visible to it, against its later ones, for the whole card
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}
// waits for the phase of the given parity; a copy that never lands traps
// (the launch fails) after ~2^24 polls instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (spin == (1u << 24)) __trap();
  }
}

// tc_record's shared memory, in floats: coef's B fragments (ks k-steps of
// 8 features, nn n-tiles, a uint4 {hi0, hi1, lo0, lo1} a lane), the
// intercept padded to 16, two stages of x (R rows at stride ds: ks*8
// features, zeros past d, and 4 more, so that the forward's fragment loads
// fall on 32 banks), y (R*K) and the mask (R), the weights mask*dl (R rows
// of 8*nn classes at stride sw), and WARPS*RED floats of block sums.
struct TcLayout {
  int R, ks, ds, sw, cf, bias, x0, x1, y0, y1, m0, m1, w, red, total;
};
__host__ __device__ inline TcLayout tc_layout(int d, int K, int nn) {
  TcLayout s;
  s.R = d <= 96 ? 64 : 32;
  s.ks = (d + 7) / 8;
  s.ds = 8 * s.ks + 4;
  s.sw = nn == 1 ? 8 : 24;  // t*sw + g on 32 distinct banks
  const int ys = (s.R * K + 3) & ~3;
  int off = 0;
  s.cf = off;
  off += s.ks * nn * 128;
  s.bias = off;
  off += 16;
  s.x0 = off;
  off += s.R * s.ds;
  s.x1 = off;
  off += s.R * s.ds;
  s.y0 = off;
  off += ys;
  s.y1 = off;
  off += ys;
  s.m0 = off;
  off += s.R;
  s.m1 = off;
  off += s.R;
  s.w = off;
  off += s.R * s.sw;
  s.red = off;
  off += WARPS * RED;
  s.total = off;
  return s;
}

// coef's B fragments, split, and the intercept, into shared memory: B(k, n)
// of k-step s and n-tile n holds coef[8s + k][8n + n'] (zeros past d and
// K); lane (g, t) of the mma reads (t, g) and (t + 4, g).
template <int NN>
__device__ __forceinline__ void tc_load_state(float* sm, const TcLayout& s, const float* coef,
                                              const float* intercept, int d, int K) {
  uint4* cf = reinterpret_cast<uint4*>(sm + s.cf);
  for (int idx = threadIdx.x; idx < s.ks * NN * 32; idx += T) {
    const int st = idx / (NN * 32), n = (idx / 32) % NN, ln = idx & 31;
    const int j0 = 8 * st + (ln & 3), j1 = j0 + 4, k = 8 * n + (ln >> 2);
    const float v0 = j0 < d && k < K ? __ldcg(coef + (long long)j0 * K + k) : 0.f;
    const float v1 = j1 < d && k < K ? __ldcg(coef + (long long)j1 * K + k) : 0.f;
    uint4 f;
    split_tf32(v0, f.x, f.z);
    split_tf32(v1, f.y, f.w);
    cf[idx] = f;
  }
  const int k = threadIdx.x;
  if (k < 16) sm[s.bias + k] = k < K ? __ldcg(intercept + k) : 0.f;
}

// The rows [r0, r0 + nrows) of x, y and the mask into a stage, by cp.async
// (16-byte copies where x's rows allow them); rows past nrows keep what an
// earlier tile left there (finite: the memory starts zeroed), and their
// mask is never read.
__device__ __forceinline__ void tc_stage(float* xs_, float* ys_, float* ms_, const TcLayout& s,
                                         const float* x, long long xs, const float* y,
                                         long long ys, const float* mask, long long ms,
                                         long long r0, int nrows, int d, int K, bool vec4) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nrows; r += WARPS) {
    const float* src = x + (r0 + r) * xs;
    float* dst = xs_ + r * s.ds;
    if (vec4) {
      for (int c = 4 * lane; c < d; c += 128) cp_async16(dst + c, src + c);
    } else {
      for (int j = lane; j < d; j += 32) cp_async4(dst + j, src + j);
    }
  }
  for (int e = threadIdx.x; e < nrows * K; e += T) {
    const int r = e / K;
    cp_async4(ys_ + e, y + (r0 + r) * ys + (e - r * K));
  }
  for (int r = threadIdx.x; r < nrows; r += T) cp_async4(ms_ + r, mask + (r0 + r) * ms);
}

// One block's record on the tensor-core path: block bid takes the tiles
// bid, bid + nb, ... of R rows.  NN n-tiles of 8 classes (K <= 8*NN);
// UPW: the most (16-feature, n-tile) blocks of G a warp owns (1 where
// d <= 64).  sm: tc_layout's, with coef's fragments and the intercept
// loaded.  The record as warp_record's: loss, count, gint[K], gcoef[d*K]
// (j*K + k).
template <typename L, int NN, int UPW, bool GRAD>
__device__ __forceinline__ void tc_record(
    const float* __restrict__ x, long long xs, const float* __restrict__ y, long long ys,
    const float* __restrict__ mask, long long ms, const float* __restrict__ hyper, long long B,
    int d, int K, float* __restrict__ out, int bid, int nb, float* sm) {
  const TcLayout s = tc_layout(d, K, NN);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int R = s.R, DS = s.ds, SW = s.sw;
  const uint4* cf = reinterpret_cast<const uint4*>(sm + s.cf);
  const float* bias = sm + s.bias;
  float* W = sm + s.w;
  const float eps = hyper[EPSILON];
  const bool vec4 = (d & 3) == 0 && ((reinterpret_cast<uintptr_t>(x) | (uintptr_t)xs * 4) & 15) == 0;
  const long long ntiles = (B + R - 1) / R;
  // the forward: warp w takes 16-row group w / NN, n-tile w % NN
  const bool fwd = warp < (R / 16) * NN;
  const int q = warp / NN, n = warp % NN;
  const int ra = 16 * q + g, rb = ra + 8;
  // the gradient: warp w owns the blocks u = w, w + WARPS, ... of
  // 16 features (u / NN) by one n-tile (u % NN)
  const int units_g = (d + 15) / 16 * NN;

  float loss_own = 0.f, cnt_own = 0.f, gi[2] = {0.f, 0.f};
  float G[UPW][4];
#pragma unroll
  for (int u = 0; u < UPW; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) G[u][c] = 0.f;

  long long tile = bid;
  if (tile < ntiles)
    tc_stage(sm + s.x0, sm + s.y0, sm + s.m0, s, x, xs, y, ys, mask, ms, tile * R,
             (int)min((long long)R, B - tile * R), d, K, vec4);
  cp_async_commit();
  for (int it = 0; tile < ntiles; ++it, tile += nb) {
    const int cur = it & 1;
    const long long next = tile + nb;
    if (next < ntiles)
      tc_stage(sm + (cur ? s.x0 : s.x1), sm + (cur ? s.y0 : s.y1), sm + (cur ? s.m0 : s.m1), s,
               x, xs, y, ys, mask, ms, next * R, (int)min((long long)R, B - next * R), d, K,
               vec4);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();  // this tile's copies, every thread's, have landed
    const int nrows = (int)min((long long)R, B - tile * R);
    const float* xt = sm + (cur ? s.x1 : s.x0);
    const float* yt = sm + (cur ? s.y1 : s.y0);
    const float* mt = sm + (cur ? s.m1 : s.m0);
    if (fwd) {
      // margins: rows (ra, rb) x classes 8n + 2t (+1) of the accumulator
      // (the three passes into three accumulators, so that no product waits
      // on another; a margin sums only d products, so the tensor cores'
      // rounding toward zero stays at a few ulps of them)
      const float* xa = xt + ra * DS + t;
      const float* xb = xa + 8 * DS;
      float mg[4] = {0.f, 0.f, 0.f, 0.f}, m_hl[4] = {0.f, 0.f, 0.f, 0.f},
            m_lh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int st = 0; st < s.ks; ++st) {
        unsigned ah[4], al[4];
        split_tf32(xa[8 * st], ah[0], al[0]);
        split_tf32(xb[8 * st], ah[1], al[1]);
        split_tf32(xa[8 * st + 4], ah[2], al[2]);
        split_tf32(xb[8 * st + 4], ah[3], al[3]);
        const uint4 b = cf[(st * NN + n) * 32 + lane];
        mma8(m_lh, al, b.x, b.y);
        mma8(m_hl, ah, b.z, b.w);
        mma8(mg, ah, b.x, b.y);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) mg[c] += m_lh[c] + m_hl[c];
      // the loss terms, in the accumulator's registers
      float wv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c < 2 ? ra : rb, k = 8 * n + 2 * t + (c & 1);
        wv[c] = 0.f;
        if (r < nrows && k < K) {
          const float mv = mt[r];
          const Terms tr = L::terms(mg[c] + bias[k], yt[r * K + k], eps);
          loss_own += mv * tr.l;
          wv[c] = mv * tr.dl;
          gi[c & 1] += wv[c];
        }
      }
      if (n == 0 && t == 0)
        cnt_own += (ra < nrows ? mt[ra] : 0.f) + (rb < nrows ? mt[rb] : 0.f);
      if (GRAD) {
        *reinterpret_cast<float2*>(W + ra * SW + 8 * n + 2 * t) = make_float2(wv[0], wv[1]);
        *reinterpret_cast<float2*>(W + rb * SW + 8 * n + 2 * t) = make_float2(wv[2], wv[3]);
      }
    }
    if (GRAD) {
      __syncthreads();  // the tile's weights are in W
#pragma unroll
      for (int ui = 0; ui < UPW; ++ui) {
        const int u = warp + ui * WARPS;
        if (u < units_g) {
          const int f0 = 16 * (u / NN), un = u % NN;
          // features past d repeat feature d - 1: they land in G's rows past
          // d, which are never written out
          const int fa = min(f0 + g, d - 1), fb = min(f0 + g + 8, d - 1);
#pragma unroll 2
          for (int ks = 0; ks < R / 8; ++ks) {
            const float* x0 = xt + (8 * ks + t) * DS;
            const float* x1 = x0 + 4 * DS;
            unsigned ah[4], al[4], bh[2], bl[2];
            split_tf32(x0[fa], ah[0], al[0]);
            split_tf32(x0[fb], ah[1], al[1]);
            split_tf32(x1[fa], ah[2], al[2]);
            split_tf32(x1[fb], ah[3], al[3]);
            split_tf32(W[(8 * ks + t) * SW + 8 * un + g], bh[0], bl[0]);
            split_tf32(W[(8 * ks + t + 4) * SW + 8 * un + g], bh[1], bl[1]);
            mma3_add(G[ui], ah, al, bh[0], bh[1], bl[0], bl[1]);
          }
        }
      }
    }
    __syncthreads();  // the stage and W are free for the tile after next
  }
  cp_async_wait_all();

  // the record: loss, count and gint summed over the warps in warp order;
  // gcoef from the warp that owns each element
  float* red = sm + s.red + warp * RED;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) gi[c] += __shfl_xor_sync(FULL, gi[c], off);
  const float lw = warp_sum(loss_own), cw = warp_sum(cnt_own);
  if (lane < RED) red[lane] = 0.f;
  __syncwarp();
  if (lane == 0) {
    red[0] = lw;
    red[1] = cw;
  }
  if (GRAD && fwd && g == 0) {
    red[2 + 8 * n + 2 * t] = gi[0];
    red[3 + 8 * n + 2 * t] = gi[1];
  }
  if (GRAD) {
#pragma unroll
    for (int ui = 0; ui < UPW; ++ui) {
      const int u = warp + ui * WARPS;
      if (u < units_g) {
        const int f0 = 16 * (u / NN), un = u % NN;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = f0 + g + 8 * (c >> 1), k = 8 * un + 2 * t + (c & 1);
          if (j < d && k < K) out[2 + K + j * K + k] = G[ui][c];
        }
      }
    }
  }
  __syncthreads();
  const int head = GRAD ? 2 + K : 2;
  for (int e = threadIdx.x; e < head; e += T) {
    float v = 0.f;
    for (int w = 0; w < WARPS; ++w) v += sm[s.red + w * RED + e];
    out[e] = v;
  }
}

// The loss alone on the tensor-core path (a step there is a one-minibatch
// epoch_kernel, whose update needs no finalize_kernel).
template <typename L, int NN>
__global__ void __launch_bounds__(T) tc_kernel(
    const float* __restrict__ x, long long xs, const float* __restrict__ y, long long ys,
    const float* __restrict__ mask, long long ms, const float* __restrict__ coef,
    const float* __restrict__ intercept, const float* __restrict__ hyper, long long B, int d,
    int K, float* __restrict__ bpart) {
  extern __shared__ __align__(16) float sm[];
  const TcLayout s = tc_layout(d, K, NN);
  for (int e = threadIdx.x; e < s.total; e += T) sm[e] = 0.f;
  __syncthreads();
  tc_load_state<NN>(sm, s, coef, intercept, d, K);
  __syncthreads();
  tc_record<L, NN, 1, false>(x, xs, y, ys, mask, ms, hyper, B, d, K,
                              bpart + (long long)blockIdx.x * (2 + K + d * K), blockIdx.x,
                              gridDim.x, sm);
}

// ------------------------------------------------------- sums and update

// Sum over the blocks' records of element e, lanes over the blocks (lane
// l takes blocks l, l + 32, ...) joined by the xor tree: a fixed order.
// COHERENT: the records were written inside this launch by other blocks.
template <bool COHERENT>
__device__ __forceinline__ float lane_sum(const float* bpart, int blocks, long long rec,
                                          long long e) {
  float s = 0.f;
#pragma unroll 8  // the loads of 8 blocks in flight at once; the sum's order stays
  for (int b = threadIdx.x & 31; b < blocks; b += 32) s += state_at<COHERENT>(bpart + b * rec + e);
  return warp_sum(s);
}

// eta at step tv by the reference's float32 expression
__device__ __forceinline__ float eta_at(int schedule, const float* __restrict__ hyper, float tv) {
  switch (schedule) {
    case 0: return hyper[ETA0];
    case 1: return 1.f / (hyper[ALPHA] * (hyper[T0] + tv));
    case 2: return hyper[ETA0] / powf(tv + 1.f, hyper[POWER_T]);
    default: return hyper[ETA0] * hyper[ETA_SCALE];
  }
}

// c after the step, from its gradient g0 (the sum over the count)
__device__ __forceinline__ float stepped(float c, float g0, int penalty, float alpha, float l1r,
                                         float eta) {
  const float sg = c > 0.f ? 1.f : (c < 0.f ? -1.f : 0.f);
  float g = g0;
  if (penalty == 1)
    g = g + alpha * c;
  else if (penalty == 2)
    g = g + alpha * sg;
  else if (penalty == 3)
    g = g + alpha * (l1r * sg + (1.f - l1r) * c);
  return c - eta * g;
}

// ------------------------------------------- K = 1: the step in one launch

constexpr int SK_STAGES = 4;  // tiles in the ring: one computed, three in flight
constexpr int SK_PER_SM = 1;  // blocks a SM of the persistent grid
constexpr int ST = 256;       // threads a block
constexpr int SWARPS = ST / 32;
enum { X_TILE = 0, X_ROWS = 1, X_FLOATS = 2 };  // how x's rows are staged

// The ring's shared memory, in floats: SK_STAGES stages of x (R rows at
// stride ds, the row's d floats padded to 16 bytes; in the last block,
// then, the blocks' records), of y (R) and of the mask (R); SWARPS records
// of 3 + d floats (the block's sums; in the last block, then, the totals);
// the stages' mbarriers; the last block's flag.  R: 128 rows at d <= 64,
// 32 past (a stage of at most 32 KB).  The step kernel has no static shared
// memory, so that the stages start on a 128-byte boundary.
struct StepLayout {
  int R, ds, x, y, m, red, bar, flag, total;
};
__host__ __device__ inline StepLayout step_layout(int d) {
  StepLayout s;
  s.R = d <= 64 ? 128 : 32;
  s.ds = (d + 3) & ~3;
  int off = 0;
  s.x = off;
  off += SK_STAGES * s.R * s.ds;
  s.y = off;
  off += SK_STAGES * s.R;
  s.m = off;
  off += SK_STAGES * s.R;
  s.red = off;
  off += SWARPS * (3 + d);
  s.bar = (off + 1) & ~1;  // 8-byte mbarriers
  s.flag = s.bar + 2 * SK_STAGES;
  s.total = s.flag + 1;
  return s;
}

struct StepArgs {
  const float* x;
  long long xs;
  const float* y;
  long long ys;
  const float* mask;
  long long ms;
  float* coef;
  float* intercept;
  float* t;
  const float* hyper;
  long long B;
  int d, penalty, schedule, fit_intercept;
  int xmode;         // X_TILE: a tile is one run of bytes; X_ROWS: 16-byte rows; X_FLOATS
  float* part;       // gridDim.x records of 3 + d floats, (3 + d) rounded up to 4 apart
  unsigned* ticket;  // 0 between launches; counts the blocks whose record is written
  float* out;        // (mean loss, sum of the mask)
  // K5' (a member a grid row, blockIdx.y): member m's window starts at row
  // st[m] of x and y, its mask is row m of a (M, B) array mrow floats
  // apart; its state, hyperparameters, records, ticket and pair follow
  // member 0's (to_member)
  const long long* st;
  long long mrow;
};

// K5': the arguments of member blockIdx.y, from those of the whole group
// (K = 1: coef (M, d), intercept and t (M,), hyper (M, 7), out (M, 2); the
// records of a member gridDim.x apart, rec floats each)
__device__ __forceinline__ void to_member(StepArgs& a, int rec) {
  const int m = blockIdx.y;
  const long long s0 = a.st[m];
  a.x += s0 * a.xs;
  a.y += s0 * a.ys;
  a.mask += m * a.mrow;
  a.coef += (long long)m * a.d;
  a.intercept += m;
  a.t += m;
  a.hyper += 7 * m;
  a.part += (long long)m * gridDim.x * rec;
  a.ticket += m;
  a.out += 2 * m;
}

// The copies of tile `tile` (rows tile*R ..) into stage st: x by one bulk
// copy on the stage's mbarrier where the tile is one run of bytes, by
// 16-byte cp.async where a strided view's rows are 16-byte aligned, else
// by 4-byte cp.async; y and the mask by 4-byte cp.async.
__device__ __forceinline__ void step_issue(const StepArgs& a, const StepLayout& s, float* sm,
                                           long long tile, int st) {
  const int d = a.d, R = s.R;
  const long long r0 = tile * R;
  const int nrows = (int)min((long long)R, a.B - r0);
  float* xs = sm + s.x + st * R * s.ds;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + s.bar) + st;
  if (a.xmode == X_TILE) {
    if (threadIdx.x == 0) {
      mbar_expect(bar, (unsigned)(nrows * d * 4));
      bulk_copy(xs, a.x + r0 * d, (unsigned)(nrows * d * 4), bar);
    }
  } else if (a.xmode == X_ROWS) {
    const int q4 = d / 4;
    for (int e = threadIdx.x; e < nrows * q4; e += ST) {
      const int r = e / q4, j = 4 * (e - r * q4);
      cp_async16(xs + r * s.ds + j, a.x + (r0 + r) * a.xs + j);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * d; e += ST) {
      const int r = e / d, j = e - r * d;
      cp_async4(xs + r * s.ds + j, a.x + (r0 + r) * a.xs + j);
    }
  }
  for (int r = threadIdx.x; r < nrows; r += ST) {
    cp_async4(sm + s.y + st * R + r, a.y + (r0 + r) * a.ys);
    cp_async4(sm + s.m + st * R + r, a.mask + (r0 + r) * a.ms);
  }
}

// One step (GRAD) or the loss alone at K = 1, d <= 256, in one launch.  A
// persistent grid (SK_PER_SM blocks a SM); block b takes tiles b, b + nb,
// ... through a ring of SK_STAGES stages, the next ones in flight while one is computed,
// one barrier a tile.  A warp takes groups of U rows of the staged tile as
// warp_record does (lane l the features l + 32 i, the dot by an xor tree,
// lane u < U the loss terms of row u, mask*dl broadcast by a shuffle a
// row); the record (loss, count, gint, gcoef) stays in registers across
// the tiles and is summed over the block's warps in warp order.  Then the
// finish, inside the launch: each block writes its record, and its thread
// 0, after the block's barrier, fences and takes a ticket (atomicInc wraps
// it back to 0 at the last block); the last block sums the records in a
// fixed order and applies the penalty, the schedule and the update as
// finalize_kernel.  No float atomics: a shape's bits do not depend on
// timing.  GROUP (K5'): grid row blockIdx.y is member m of an ensemble,
// stepping on its own window of x with its own state, records and ticket
// (to_member); gridDim.x blocks a member.
template <typename L, int NJ, bool GRAD, bool GROUP = false>
__global__ void __launch_bounds__(ST, SK_PER_SM) step_kernel(StepArgs a) {
  constexpr int U = rows_a_group(NJ);
  extern __shared__ __align__(128) float sm[];
  if constexpr (GROUP) to_member(a, (3 + a.d + 3) & ~3);
  const int d = a.d, rec = 3 + d, used = GRAD ? rec : 2;
  const StepLayout s = step_layout(d);
  const int R = s.R, DS = s.ds;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool active = lane < U;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + s.bar);
  if (threadIdx.x < SK_STAGES) mbar_init(bars + threadIdx.x);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  float cf[NJ], acc[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    const int j = lane + 32 * i;
    cf[i] = j < d ? a.coef[j] : 0.f;
    acc[i] = 0.f;
  }
  const float b_own = a.intercept[0], eps = a.hyper[EPSILON];
  float loss_own = 0.f, gint_own = 0.f, cnt_own = 0.f;
  // what the last block's update reads, read now (every block reads the
  // state before its ticket; the last block writes it after every ticket)
  float tv = 0.f, eta = 0.f, alpha = 0.f, l1r = 0.f, c_own = 0.f;
  if (GRAD) {
    tv = *a.t;
    alpha = a.hyper[ALPHA];
    l1r = a.hyper[L1_RATIO];
    eta = eta_at(a.schedule, a.hyper, tv);
    if ((int)threadIdx.x < d) c_own = a.coef[threadIdx.x];
  }
  __syncthreads();  // the mbarriers are initialized

  const long long tiles = (a.B + R - 1) / R;
  // local tile n is tile first + n*step
  const long long first = blockIdx.x, step = gridDim.x;
  const long long nloc = (tiles - 1 - blockIdx.x) / gridDim.x + 1;
#pragma unroll
  for (int p = 0; p < SK_STAGES - 1; ++p) {
    if (p < nloc) step_issue(a, s, sm, first + p * step, p);
    cp_async_commit();
  }
  for (long long n = 0; n < nloc; ++n) {
    cp_async_wait<SK_STAGES - 2>();
    __syncthreads();  // tile n's cp.async copies, every thread's, have landed; tile n - 1's
                      // stage is free
    if (n + SK_STAGES - 1 < nloc)
      step_issue(a, s, sm, first + (n + SK_STAGES - 1) * step,
                 (int)((n + SK_STAGES - 1) % SK_STAGES));
    cp_async_commit();
    const int st = (int)(n % SK_STAGES);
    if (a.xmode == X_TILE) mbar_wait(bars + st, (unsigned)((n / SK_STAGES) & 1));
    const int nrows = (int)min((long long)R, a.B - (first + n * step) * R);
    const float* xt = sm + s.x + st * R * DS;
    const float* yt = sm + s.y + st * R;
    const float* mt = sm + s.m + st * R;
    for (int g = warp; g * U < nrows; g += SWARPS) {
      float xv[U][NJ], p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = g * U + u;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
          const int j = lane + 32 * i;
          xv[u][i] = r < nrows && j < d ? xt[r * DS + j] : 0.f;
          sum = fmaf(xv[u][i], cf[i], sum);
        }
        p[u] = sum;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < U; ++u) p[u] += __shfl_xor_sync(FULL, p[u], off);
      }
      float m = 0.f;  // the margin of row `lane` of the group
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u == lane) m = p[u];
      float w = 0.f;
      if (active) {
        const int r = g * U + lane;
        const bool row_ok = r < nrows;
        const float m_own = row_ok ? mt[r] : 0.f, y_own = row_ok ? yt[r] : 0.f;
        const Terms tr = L::terms(m + b_own, y_own, eps);
        loss_own += m_own * tr.l;
        w = m_own * tr.dl;
        gint_own += w;
        cnt_own += m_own;
      }
      if (GRAD) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float wk = __shfl_sync(FULL, w, u);
#pragma unroll
          for (int i = 0; i < NJ; ++i) acc[i] = fmaf(wk, xv[u][i], acc[i]);
        }
      }
    }
  }
  cp_async_wait_all();

  // the block's record: its warps' records summed in warp order
  float* red = sm + s.red;
  float* mine = red + warp * rec;
  const float l = warp_sum(loss_own), c = warp_sum(cnt_own);
  if (lane == 0) {
    mine[0] = l;
    mine[1] = c;
  }
  if (GRAD) {
    gint_own = warp_sum(gint_own);
    if (lane == 0) mine[2] = gint_own;
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int j = lane + 32 * i;
      if (j < d) mine[3 + j] = acc[i];
    }
  }
  __syncthreads();
  const int recp = (rec + 3) & ~3;  // records 16 bytes apart
  float* part = a.part + (long long)blockIdx.x * recp;
  for (int e = threadIdx.x; e < used; e += ST) {
    float v = 0.f;
    for (int w = 0; w < SWARPS; ++w) v += red[w * rec + e];
    part[e] = v;
  }
  __syncthreads();  // the block's record is written; its ticket, with a release fence
  int* flag = reinterpret_cast<int*>(sm + s.flag);
  if (threadIdx.x == 0) {
    fence_acq_rel_gpu();
    *flag = atomicInc(a.ticket, gridDim.x - 1) == gridDim.x - 1;
    if (*flag) fence_acq_rel_gpu();
  }
  __syncthreads();
  if (!*flag) return;

  // The last block: the records into the stages' shared memory (16-byte
  // copies through L2), CB records at a time.  Where a record has at most
  // ST/2 elements, G = ST/used groups of threads each sum a contiguous range
  // of a chunk's records, in block order, and the groups' sums are added in
  // group order; else thread e sums element e (and e + ST) over the blocks.
  float* buf = sm + s.x;
  const int CB = SK_STAGES * R * DS / recp, nb = (int)gridDim.x, t = threadIdx.x;
  const int G = used <= ST / 2 ? ST / used : 1, g = t / used, e = t - g * used;
  float tot0 = 0.f, tot1 = 0.f;
  for (int b0 = 0; b0 < nb; b0 += CB) {
    const int nbc = min(CB, nb - b0);
    const float* src = a.part + (long long)b0 * recp;
    for (int q = t; q < nbc * recp / 4; q += ST) cp_async16(buf + 4 * q, src + 4 * q);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (g < G) {
      for (int b = g * nbc / G; b < (g + 1) * nbc / G; ++b) {
        tot0 += buf[b * recp + e];
        if (e + ST < used) tot1 += buf[b * recp + e + ST];
      }
    }
    __syncthreads();  // buf is refilled by the next chunk
  }
  if (g < G) {
    buf[g * used + e] = tot0;
    if (e + ST < used) buf[e + ST] = tot1;
  }
  __syncthreads();
  for (int i = t; i < used; i += ST) {
    float v = 0.f;
    for (int h = 0; h < G; ++h) v += buf[h * used + i];
    red[i] = v;
  }
  __syncthreads();
  const float cnt = red[1];
  const float count = cnt > 0.f ? cnt : 1.f;
  if (t == 0) {
    a.out[0] = red[0] / count;
    a.out[1] = cnt;
  }
  if (!GRAD) return;
  if (t < d) a.coef[t] = stepped(c_own, red[3 + t] / count, a.penalty, alpha, l1r, eta);
  if (t == 0) {
    if (a.fit_intercept) a.intercept[0] = b_own - eta * (red[2] / count);
    *a.t = tv + 1.f;
  }
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
    const float s = lane_sum<false>(bpart, blocks, rec, warp);
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
  const float tv = *t;
  const float alpha = hyper[ALPHA], eta = eta_at(schedule, hyper, tv), l1r = hyper[L1_RATIO];
  __syncthreads();  // every thread has read t
  const long long n = K + (long long)d * K;  // gint then gcoef, from record element 2
  const bool by_warp = n < 4 * FT;
  const long long first = by_warp ? warp : threadIdx.x, step = by_warp ? NW : FT;
  for (long long e = first; e < n; e += step) {
    float s;
    if (by_warp) {
      s = lane_sum<false>(bpart, blocks, rec, 2 + e);
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
    coef[e - K] = stepped(coef[e - K], g0, penalty, alpha, l1r, eta);
  }
  if (threadIdx.x == 0) *t = tv + 1.f;
}

// ------------------------------------------------------------- the epoch

struct EpochArgs {
  const float* x;     // stacks (B, n_mb, ...): minibatch i at x + i*xs1, rows xs0 apart
  long long xs0, xs1;
  const float* y;
  long long ys0, ys1;
  const float* mask;
  long long ms0, ms1;
  float* coef;
  float* intercept;
  float* t;
  const float* hyper;
  long long B;        // rows a minibatch
  int n_mb, d, K, penalty, schedule, fit_intercept;
  float* part;        // blocks * rec floats of records
  float* out;         // (n_mb, 2): each step's (mean loss, sum of the mask)
};

// The second half of an epoch's step i, after its grid sync: block bid sums
// its slice of the record's elements (gint then gcoef, a fixed range) over
// the blocks' records and writes their new values; every block sums the
// count itself, in the same order; block 0 writes the step's (mean loss,
// count).  Everything here is computed afresh each step, so that none of
// it stays live across the record's registers.
__device__ __forceinline__ void epoch_update(const EpochArgs& a, int i, float tv, float* s_cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, bid = blockIdx.x, nb = gridDim.x;
  const int K = a.K;
  const long long rec = 2 + K + (long long)a.d * K;
  if (warp == 0) {
    const float c = lane_sum<true>(a.part, nb, rec, 1);
    if (lane == 0) *s_cnt = c;
  }
  __syncthreads();
  const float cnt = *s_cnt;
  const float count = cnt > 0.f ? cnt : 1.f;
  if (bid == 0 && warp == 1) {
    const float l = lane_sum<true>(a.part, nb, rec, 0);
    if (lane == 0) {
      a.out[2 * i] = l / count;
      a.out[2 * i + 1] = cnt;
    }
  }
  const float alpha = a.hyper[ALPHA], l1r = a.hyper[L1_RATIO];
  const float eta = eta_at(a.schedule, a.hyper, tv);
  const long long n = rec - 2, chunk = (n + nb - 1) / nb;
  const long long first = bid * chunk, last = min(n, first + chunk);
  for (long long e = first + warp; e < last; e += WARPS) {
    const float g0 = lane_sum<true>(a.part, nb, rec, 2 + e) / count;
    if (lane != 0) continue;
    if (e < K) {
      if (a.fit_intercept) a.intercept[e] = __ldcg(a.intercept + e) - eta * g0;
    } else {
      a.coef[e - K] = stepped(__ldcg(a.coef + e - K), g0, a.penalty, alpha, l1r, eta);
    }
  }
}

// All n_mb steps of sgd_epoch, every block resident (a cooperative launch).
// PATH and its parameters pick the core: WARP_PATH (P1 = NJ), TC_PATH (P1 =
// NN, P2 = UPW), ROW_PATH (P1 = SACC).  The register cap keeps 4 blocks a
// SM, as the step kernels get (3 on the tensor-core path, where a cap of 64
// spilled more and ran slower); unbounded, the step loop's live values took
// 125-128 registers: 2 blocks a SM.
template <typename L, int PATH, int P1, int P2>
__global__ void __launch_bounds__(T, PATH == TC_PATH ? 3 : 4) epoch_kernel(EpochArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float s_cnt;
  cg::grid_group grid = cg::this_grid();
  if constexpr (PATH == TC_PATH) {
    const TcLayout s = tc_layout(a.d, a.K, P1);
    for (int e = threadIdx.x; e < s.total; e += T) sm[e] = 0.f;
    __syncthreads();
  }
  float tv = __ldcg(a.t);
  for (int i = 0; i < a.n_mb; ++i) {
    const int bid = blockIdx.x, nb = gridDim.x, d = a.d, K = a.K;
    float* mine = a.part + bid * (2 + K + (long long)d * K);
    const float* x = a.x + i * a.xs1;
    const float* y = a.y + i * a.ys1;
    const float* m = a.mask + i * a.ms1;
    if constexpr (PATH == WARP_PATH) {
      warp_record<L, P1, true, true>(x, a.xs0, y, a.ys0, m, a.ms0, a.coef, a.intercept, a.hyper,
                                     a.B, d, K, mine, bid, nb, sm);
    } else if constexpr (PATH == TC_PATH) {
      const TcLayout s = tc_layout(d, K, P1);
      tc_load_state<P1>(sm, s, a.coef, a.intercept, d, K);
      __syncthreads();
      tc_record<L, P1, P2, true>(x, a.xs0, y, a.ys0, m, a.ms0, a.hyper, a.B, d, K, mine, bid, nb,
                                 sm);
    } else {
      row_record<L, true, P1 != 0, true>(x, a.xs0, y, a.ys0, m, a.ms0, a.coef, a.intercept,
                                         a.hyper, a.B, d, K, mine, bid, nb, sm);
    }
    grid.sync();  // every record of step i is written
    epoch_update(a, i, tv, &s_cnt);
    tv = tv + 1.f;
    grid.sync();  // the state of step i + 1 is written; the records are free
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.t = tv;
}

// ---------------------------------------- K5': an ensemble epoch, one launch

struct GroupArgs {
  const float* x;      // (n, d), rows xs apart
  long long xs;
  const float* y;      // (n, K), rows ys apart
  long long ys;
  const float* mask;   // (M, B): member m's row mrow apart, elements ms apart
  long long mrow, ms;
  const long long* st; // (M,): member m's window is rows st[m] .. st[m] + B of x and y
  float* coef;         // (M, d, K)
  float* intercept;    // (M, K)
  float* t;            // (M,)
  const float* hyper;  // (M, 7)
  long long B;         // rows a window
  int d, K, penalty, schedule, fit_intercept;
  float* part;         // M * gridDim.x records of 2 + K + d*K floats, member-major
  unsigned* ticket;    // (M,), 0 between launches
  float* out;          // (M, 2): each member's (mean loss, sum of its mask)
};

// One ensemble epoch off the K = 1 register path: grid row blockIdx.y is
// member m, its gridDim.x blocks take the tiles of its window as the
// tensor-core path (PATH = TC_PATH, P1 = NN, P2 = UPW) or the row path
// (ROW_PATH, P1 = SACC) takes a block's, and write their records.  Then the
// member's finish, in the same launch: each block takes a ticket of its
// member's (a release fence, then atomicInc, which the last block wraps
// back to 0), and the member's last block sums its records in block order
// (thread e the element e, e + T, ...) and applies the penalty, the schedule
// and the update as finalize_kernel.  No float atomics.
template <typename L, int PATH, int P1, int P2>
__global__ void __launch_bounds__(T) group_kernel(GroupArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int last;
  const int m = blockIdx.y, bid = blockIdx.x, nb = gridDim.x, d = a.d, K = a.K;
  const long long rec = 2 + K + (long long)d * K, s0 = a.st[m];
  const float* x = a.x + s0 * a.xs;
  const float* y = a.y + s0 * a.ys;
  const float* mask = a.mask + m * a.mrow;
  float* coef = a.coef + (long long)m * d * K;
  float* intercept = a.intercept + (long long)m * K;
  const float* hyper = a.hyper + 7 * m;
  float* recs = a.part + (long long)m * nb * rec;
  if constexpr (PATH == TC_PATH) {
    const TcLayout s = tc_layout(d, K, P1);
    for (int e = threadIdx.x; e < s.total; e += T) sm[e] = 0.f;
    __syncthreads();
    tc_load_state<P1>(sm, s, coef, intercept, d, K);
    __syncthreads();
    tc_record<L, P1, P2, true>(x, a.xs, y, a.ys, mask, a.ms, hyper, a.B, d, K, recs + bid * rec,
                               bid, nb, sm);
  } else {
    row_record<L, true, P1 != 0, true>(x, a.xs, y, a.ys, mask, a.ms, coef, intercept, hyper,
                                       a.B, d, K, recs + bid * rec, bid, nb, sm);
  }
  __syncthreads();  // the block's record is written; its ticket, with a release fence
  if (threadIdx.x == 0) {
    fence_acq_rel_gpu();
    last = atomicInc(a.ticket + m, nb - 1) == (unsigned)(nb - 1);
    if (last) fence_acq_rel_gpu();
  }
  __syncthreads();
  if (!last) return;

  // the member's last block: every thread sums the count itself, in block order
  float cnt = 0.f;
  for (int b = 0; b < nb; ++b) cnt += __ldcg(recs + b * rec + 1);
  const float count = cnt > 0.f ? cnt : 1.f;
  const float tv = __ldcg(a.t + m);
  const float alpha = hyper[ALPHA], l1r = hyper[L1_RATIO], eta = eta_at(a.schedule, hyper, tv);
  __syncthreads();  // every thread has read t
  if (threadIdx.x == 0) {
    float l = 0.f;
    for (int b = 0; b < nb; ++b) l += __ldcg(recs + b * rec);
    a.out[2 * m] = l / count;
    a.out[2 * m + 1] = cnt;
    a.t[m] = tv + 1.f;
  }
  for (long long e = threadIdx.x; e < rec - 2; e += T) {
    float s = 0.f;
    for (int b = 0; b < nb; ++b) s += __ldcg(recs + b * rec + 2 + e);
    const float g0 = s / count;
    if (e < K) {
      if (a.fit_intercept) intercept[e] = __ldcg(intercept + e) - eta * g0;
    } else {
      coef[e - K] = stepped(__ldcg(coef + e - K), g0, a.penalty, alpha, l1r, eta);
    }
  }
}

// --------------------------------------------------------------- choice

template <typename L, bool GRAD>
const void* step_fn(const Plan& p) {
  if (p.path == STEP_PATH)
    return p.nj == 2 ? (const void*)step_kernel<L, 2, GRAD> : (const void*)step_kernel<L, 8, GRAD>;
  if (p.path == ROW_PATH)
    return p.sacc ? (const void*)row_kernel<L, GRAD, true> : (const void*)row_kernel<L, GRAD, false>;
  if constexpr (L::kClassifier && !GRAD)
    return p.nj == 1 ? (const void*)tc_kernel<L, 1> : (const void*)tc_kernel<L, 2>;
  return nullptr;
}

template <typename L>
const void* epoch_fn(const Plan& p) {
  if (p.path == WARP_PATH)
    return p.nj == 2 ? (const void*)epoch_kernel<L, WARP_PATH, 2, 0>
                     : (const void*)epoch_kernel<L, WARP_PATH, 8, 0>;
  if (p.path == ROW_PATH)
    return p.sacc ? (const void*)epoch_kernel<L, ROW_PATH, 1, 0>
                  : (const void*)epoch_kernel<L, ROW_PATH, 0, 0>;
  if constexpr (L::kClassifier) {
    if (p.nj == 1)
      return p.wide ? (const void*)epoch_kernel<L, TC_PATH, 1, 2>
                    : (const void*)epoch_kernel<L, TC_PATH, 1, 1>;
    return p.wide ? (const void*)epoch_kernel<L, TC_PATH, 2, 4>
                  : (const void*)epoch_kernel<L, TC_PATH, 2, 1>;
  }
  return nullptr;
}

// kind: 0 the loss alone, 1 the step (on the tensor-core path a
// one-minibatch epoch), 2 the epoch
template <typename L>
const void* kernel_for(const Plan& p, int kind) {
  if (kind == 2 || (kind == 1 && p.path == TC_PATH)) return epoch_fn<L>(p);
  return kind ? step_fn<L, true>(p) : step_fn<L, false>(p);
}

const void* select_kernel(int loss, const Plan& p, int kind) {
  switch (loss) {
    case 0: return kernel_for<LogLoss>(p, kind);
    case 1: return kernel_for<Hinge>(p, kind);
    case 2: return kernel_for<SquaredHinge>(p, kind);
    case 3: return kernel_for<ModifiedHuber>(p, kind);
    case 4: return kernel_for<SquaredError>(p, kind);
    case 5: return kernel_for<Huber>(p, kind);
  }
  return nullptr;
}

// K5': the kernel of a group plan (STEP_PATH, TC_PATH or ROW_PATH)
template <typename L>
const void* group_fn(const Plan& p) {
  if (p.path == STEP_PATH)
    return p.nj == 2 ? (const void*)step_kernel<L, 2, true, true>
                     : (const void*)step_kernel<L, 8, true, true>;
  if (p.path == ROW_PATH)
    return p.sacc ? (const void*)group_kernel<L, ROW_PATH, 1, 0>
                  : (const void*)group_kernel<L, ROW_PATH, 0, 0>;
  if constexpr (L::kClassifier) {
    if (p.nj == 1)
      return p.wide ? (const void*)group_kernel<L, TC_PATH, 1, 2>
                    : (const void*)group_kernel<L, TC_PATH, 1, 1>;
    return p.wide ? (const void*)group_kernel<L, TC_PATH, 2, 4>
                  : (const void*)group_kernel<L, TC_PATH, 2, 1>;
  }
  return nullptr;
}

const void* select_group(int loss, const Plan& p) {
  switch (loss) {
    case 0: return group_fn<LogLoss>(p);
    case 1: return group_fn<Hinge>(p);
    case 2: return group_fn<SquaredHinge>(p);
    case 3: return group_fn<ModifiedHuber>(p);
    case 4: return group_fn<SquaredError>(p);
    case 5: return group_fn<Huber>(p);
  }
  return nullptr;
}

}  // namespace

extern "C" {

const char* sgd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Plans a step (epoch = 0) or an epoch's steps (epoch = 1) of loss (0
// log_loss, 1 hinge, 2 squared_hinge, 3 modified_huber, 4 squared_error, 5
// huber) over B rows (an epoch: the rows of one minibatch), d features and
// K target columns into plan (9 int64s; plan[6] is the floats of scratch it
// needs).  The plan depends only on (loss, B, d, K, epoch) and the card,
// so a shape's sums are taken in the same order every time.  An epoch's
// grid is every block the card holds at once, at most one a unit of work;
// it fails with cudaErrorCooperativeLaunchTooLarge where none fits.
int sgd_plan(int loss, long long B, int d, int K, int epoch, void* plan) {
  Plan* p = (Plan*)plan;
  if (loss < 0 || loss > 5 || d < 1 || K < 1 || B < 1 || (loss >= 4 && K != 1))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long rec = 2 + K + (long long)d * K;
  p->rec = rec;
  p->wide = 0;
  p->sacc = 0;
  long long units;
  if (K == 1 && d <= 256 && !epoch) {
    p->path = STEP_PATH;
    p->nj = d <= 64 ? 2 : 8;
    const StepLayout s = step_layout(d);
    p->smem = (long long)sizeof(float) * s.total;
    units = (B + s.R - 1) / s.R;
  } else if (K == 1 && d <= 256) {
    p->path = WARP_PATH;
    p->nj = d <= 64 ? 2 : 8;
    p->smem = (long long)sizeof(float) * WARPS * rec;
    const long long groups = (B + rows_a_group((int)p->nj) - 1) / rows_a_group((int)p->nj);
    units = (groups + WARPS - 1) / WARPS;
  } else if (K <= 16 && d <= TC_MAX_D) {
    p->path = TC_PATH;
    p->nj = K <= 8 ? 1 : 2;
    p->wide = d > 64;
    const TcLayout s = tc_layout(d, K, (int)p->nj);
    p->smem = (long long)sizeof(float) * s.total;
    units = (B + s.R - 1) / s.R;
  } else {
    p->path = ROW_PATH;
    p->nj = 0;
    const long long sacc_bytes = (long long)sizeof(float) * (d + K + rec);
    p->sacc = sacc_bytes <= SMEM_LIMIT;
    p->smem = p->sacc ? sacc_bytes : (long long)sizeof(float) * (d + K);
    units = B;
  }
  // blocks a SM of each kind's kernel: the loss alone, the step, the epoch
  int per_sm[3] = {0, 0, 0};
  for (int kind = epoch ? 2 : 0; kind < (epoch ? 3 : 2); ++kind) {
    const void* fn = select_kernel(loss, *p, kind);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    if (p->smem > 48 * 1024) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem);
      if (err != cudaSuccess) return (int)err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[kind], fn,
                                                        p->path == STEP_PATH ? ST : T,
                                                        (size_t)p->smem);
    if (err != cudaSuccess) return (int)err;
    if (p->path == STEP_PATH && per_sm[kind] > SK_PER_SM) per_sm[kind] = SK_PER_SM;
  }
  // a cooperative launch (the epoch, and the step on the tensor-core path)
  // needs every block resident; the other launches take at least one a SM
  const bool coop = epoch || p->path == TC_PATH;
  const int step_sm = epoch ? per_sm[2] : per_sm[1];
  if (coop && step_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  auto grid = [&](int ps) {
    long long blocks = (long long)sms * (ps < 1 ? 1 : ps);
    if (blocks > units) blocks = units;
    if (blocks > SCRATCH_FLOATS / rec) blocks = SCRATCH_FLOATS / rec;
    return blocks < 1 ? 1ll : blocks;
  };
  const int both = per_sm[0] < per_sm[1] ? per_sm[0] : per_sm[1];
  p->blocks = grid(epoch ? per_sm[2] : (coop ? per_sm[1] : both));
  p->loss_blocks = epoch ? p->blocks : grid(coop ? per_sm[0] : both);
  const long long stride = p->path == STEP_PATH ? (rec + 3) & ~3ll : rec;  // a record's floats
  p->scratch = (p->blocks > p->loss_blocks ? p->blocks : p->loss_blocks) * stride;
  return (int)cudaSuccess;
}

int sgd_epoch_run(const void* plan, int loss, int penalty, int schedule, int fit_intercept,
                  const void* x, long long xs0, long long xs1, const void* y, long long ys0,
                  long long ys1, const void* mask, long long ms0, long long ms1, void* coef,
                  void* intercept, void* t, const void* hyper, long long B, int n_mb, int d,
                  int K, void* scratch, void* out, void* stream);

// One step (grad != 0) or the loss alone (grad == 0) of plan's shape.  x
// (B, d), y (B, K) and mask (B,) float32 with row strides xs, ys, ms
// (elements) and contiguous rows; coef (d, K), intercept (K,), t (), hyper
// (7,) and out (2,) float32, contiguous, on one device.  With grad: coef,
// intercept (if fit_intercept) and t updated in place.  out = (mean loss,
// sum of the mask).  scratch: plan[6] floats.  ticket: one unsigned, 0 (the
// step path leaves it 0).  At K = 1, d <= 256 the step (or the loss) is
// one launch of step_kernel; on the tensor-core path a step is an epoch of
// one minibatch (one cooperative launch); elsewhere the block kernel, then
// finalize_kernel.

int sgd_step(const void* plan, int loss, int grad, int penalty, int schedule, int fit_intercept,
             const void* x, long long xs, const void* y, long long ys, const void* mask,
             long long ms, void* coef, void* intercept, void* t, const void* hyper, long long B,
             int d, int K, void* scratch, void* ticket, void* out, void* stream) {
  const Plan p = *(const Plan*)plan;
  if (grad && p.path == TC_PATH)
    return sgd_epoch_run(plan, loss, penalty, schedule, fit_intercept, x, xs, 0, y, ys, 0, mask,
                         ms, 0, coef, intercept, t, hyper, B, 1, d, K, scratch, out, stream);
  cudaStream_t s = (cudaStream_t)stream;
  const void* fn = select_kernel(loss, p, grad != 0);
  if (fn == nullptr || penalty < 0 || penalty > 3 || schedule < 0 || schedule > 3)
    return (int)cudaErrorInvalidValue;
  if (p.path == STEP_PATH) {
    const bool rows16 = (d & 3) == 0 && (xs & 3) == 0 && ((uintptr_t)x & 15) == 0;
    StepArgs a;
    a.x = (const float*)x;
    a.xs = xs;
    a.y = (const float*)y;
    a.ys = ys;
    a.mask = (const float*)mask;
    a.ms = ms;
    a.coef = (float*)coef;
    a.intercept = (float*)intercept;
    a.t = (float*)t;
    a.hyper = (const float*)hyper;
    a.B = B;
    a.d = d;
    a.penalty = penalty;
    a.schedule = schedule;
    a.fit_intercept = fit_intercept;
    a.xmode = !rows16 ? X_FLOATS : xs == d ? X_TILE : X_ROWS;
    a.part = (float*)scratch;
    a.ticket = (unsigned*)ticket;
    a.out = (float*)out;
    a.st = nullptr;
    a.mrow = 0;
    void* args[] = {(void*)&a};
    return (int)cudaLaunchKernel(fn, dim3((unsigned)(grad ? p.blocks : p.loss_blocks)), dim3(ST),
                                 args, (size_t)p.smem, s);
  }
  const float *xf = (const float*)x, *yf = (const float*)y, *mf = (const float*)mask;
  const float *cf = (const float*)coef, *bf = (const float*)intercept, *hf = (const float*)hyper;
  float* part = (float*)scratch;
  void* args[] = {(void*)&xf, (void*)&xs, (void*)&yf, (void*)&ys, (void*)&mf, (void*)&ms,
                  (void*)&cf, (void*)&bf, (void*)&hf, (void*)&B, (void*)&d, (void*)&K,
                  (void*)&part};
  const long long blocks = grad ? p.blocks : p.loss_blocks;
  cudaError_t err = cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(T), args,
                                     (size_t)p.smem, s);
  if (err != cudaSuccess) return (int)err;
  finalize_kernel<<<1, FT, 0, s>>>(part, (int)blocks, d, K, grad, penalty, schedule,
                                   fit_intercept, hf, (float*)coef, (float*)intercept,
                                   (float*)t, (float*)out);
  return (int)cudaGetLastError();
}

// The n_mb steps of an epoch (an epoch plan of the minibatch's B rows), in
// one cooperative launch.  x (B, n_mb, d), y (B, n_mb, K), mask (B, n_mb)
// float32: minibatch i is x + i*xs1 with rows xs0 apart (elements), each
// row contiguous; coef, intercept, t, hyper as sgd_step's, updated in
// place; out (n_mb, 2) contiguous: each step's (mean loss, sum of the
// mask).  scratch: plan[6] floats.
int sgd_epoch_run(const void* plan, int loss, int penalty, int schedule, int fit_intercept,
                  const void* x, long long xs0, long long xs1, const void* y, long long ys0,
                  long long ys1, const void* mask, long long ms0, long long ms1, void* coef,
                  void* intercept, void* t, const void* hyper, long long B, int n_mb, int d,
                  int K, void* scratch, void* out, void* stream) {
  const Plan p = *(const Plan*)plan;
  const void* fn = select_kernel(loss, p, 2);
  if (fn == nullptr || penalty < 0 || penalty > 3 || schedule < 0 || schedule > 3 || n_mb < 1)
    return (int)cudaErrorInvalidValue;
  EpochArgs a;
  a.x = (const float*)x;
  a.xs0 = xs0;
  a.xs1 = xs1;
  a.y = (const float*)y;
  a.ys0 = ys0;
  a.ys1 = ys1;
  a.mask = (const float*)mask;
  a.ms0 = ms0;
  a.ms1 = ms1;
  a.coef = (float*)coef;
  a.intercept = (float*)intercept;
  a.t = (float*)t;
  a.hyper = (const float*)hyper;
  a.B = B;
  a.n_mb = n_mb;
  a.d = d;
  a.K = K;
  a.penalty = penalty;
  a.schedule = schedule;
  a.fit_intercept = fit_intercept;
  a.part = (float*)scratch;
  a.out = (float*)out;
  void* args[] = {(void*)&a};
  return (int)cudaLaunchCooperativeKernel(fn, dim3((unsigned)p.blocks), dim3(T), args,
                                          (size_t)p.smem, (cudaStream_t)stream);
}

// K5': plans an ensemble epoch of M members, each a window of B rows, d
// features and K target columns, into plan (9 int64s: plan[3] is the
// blocks a member, plan[6] the floats of scratch).  K = 1, d <= 256: the
// step kernel's layout (STEP_PATH); K in 2..16, d <= 256: the tensor-core
// record (TC_PATH); else the row record (ROW_PATH).  A member's blocks are
// the card's resident blocks shared out over the members, at most one a
// tile (a row on the row path).  The plan depends only on (loss, B, d, K,
// M) and the card, so a shape's sums are taken in the same order every
// time.
int sgd_group_plan(int loss, long long B, int d, int K, int M, void* plan) {
  Plan* p = (Plan*)plan;
  if (loss < 0 || loss > 5 || d < 1 || K < 1 || B < 1 || M < 1 || M > 65535 ||
      (loss >= 4 && K != 1))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long rec = 2 + K + (long long)d * K;
  p->rec = rec;
  p->wide = 0;
  p->sacc = 0;
  long long units, stride = rec;  // stride: floats between two records
  int threads = T;
  if (K == 1 && d <= 256) {
    p->path = STEP_PATH;
    p->nj = d <= 64 ? 2 : 8;
    const StepLayout s = step_layout(d);
    p->smem = (long long)sizeof(float) * s.total;
    units = (B + s.R - 1) / s.R;
    stride = (3 + d + 3) & ~3;
    threads = ST;
  } else if (K <= 16 && d <= TC_MAX_D) {
    p->path = TC_PATH;
    p->nj = K <= 8 ? 1 : 2;
    p->wide = d > 64;
    const TcLayout s = tc_layout(d, K, (int)p->nj);
    p->smem = (long long)sizeof(float) * s.total;
    units = (B + s.R - 1) / s.R;
  } else {
    p->path = ROW_PATH;
    p->nj = 0;
    const long long sacc_bytes = (long long)sizeof(float) * (d + K + rec);
    p->sacc = sacc_bytes <= SMEM_LIMIT;
    p->smem = p->sacc ? sacc_bytes : (long long)sizeof(float) * (d + K);
    units = B;
  }
  const void* fn = select_group(loss, *p);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (p->smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem);
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, (size_t)p->smem);
  if (err != cudaSuccess) return (int)err;
  if (p->path == STEP_PATH && per_sm > SK_PER_SM) per_sm = SK_PER_SM;
  long long nb = (long long)sms * (per_sm < 1 ? 1 : per_sm) / M;
  if (nb > units) nb = units;
  if (nb > SCRATCH_FLOATS / (M * stride)) nb = SCRATCH_FLOATS / (M * stride);
  if (nb < 1) nb = 1;
  p->blocks = nb;
  p->loss_blocks = nb;
  p->scratch = M * nb * stride;
  return (int)cudaSuccess;
}

// K5': one SGD step of each of the M members of an ensemble on its own
// window, in one launch (a group plan of the same shape).  x (n, d) and y
// (n, K) float32 with row strides xs, ys (elements) and contiguous rows;
// st (M,) int64: member m's window is rows st[m] .. st[m] + B (read in
// place, windows may overlap); mask (M, B) float32, member m's row mrow
// apart, elements ms apart; coef (M, d, K), intercept (M, K), t (M,),
// hyper (M, 7) and out (M, 2) float32, contiguous, updated in place as
// sgd_step's, a member each.  scratch: plan[6] floats; tickets: M unsigned,
// 0 (each launch leaves them 0).
int sgd_group_step(const void* plan, int loss, int penalty, int schedule, int fit_intercept,
                   const void* x, long long xs, const void* y, long long ys, const void* mask,
                   long long mrow, long long ms, const void* st, void* coef, void* intercept,
                   void* t, const void* hyper, long long B, int d, int K, int M, void* scratch,
                   void* tickets, void* out, void* stream) {
  const Plan p = *(const Plan*)plan;
  const void* fn = select_group(loss, p);
  if (fn == nullptr || penalty < 0 || penalty > 3 || schedule < 0 || schedule > 3 || M < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)p.blocks, (unsigned)M);
  cudaStream_t s = (cudaStream_t)stream;
  if (p.path == STEP_PATH) {
    const bool rows16 = (d & 3) == 0 && (xs & 3) == 0 && ((uintptr_t)x & 15) == 0;
    StepArgs a;
    a.x = (const float*)x;
    a.xs = xs;
    a.y = (const float*)y;
    a.ys = ys;
    a.mask = (const float*)mask;
    a.ms = ms;
    a.coef = (float*)coef;
    a.intercept = (float*)intercept;
    a.t = (float*)t;
    a.hyper = (const float*)hyper;
    a.B = B;
    a.d = d;
    a.penalty = penalty;
    a.schedule = schedule;
    a.fit_intercept = fit_intercept;
    a.xmode = !rows16 ? X_FLOATS : xs == d ? X_TILE : X_ROWS;
    a.part = (float*)scratch;
    a.ticket = (unsigned*)tickets;
    a.out = (float*)out;
    a.st = (const long long*)st;
    a.mrow = mrow;
    void* args[] = {(void*)&a};
    return (int)cudaLaunchKernel(fn, grid, dim3(ST), args, (size_t)p.smem, s);
  }
  GroupArgs g;
  g.x = (const float*)x;
  g.xs = xs;
  g.y = (const float*)y;
  g.ys = ys;
  g.mask = (const float*)mask;
  g.mrow = mrow;
  g.ms = ms;
  g.st = (const long long*)st;
  g.coef = (float*)coef;
  g.intercept = (float*)intercept;
  g.t = (float*)t;
  g.hyper = (const float*)hyper;
  g.B = B;
  g.d = d;
  g.K = K;
  g.penalty = penalty;
  g.schedule = schedule;
  g.fit_intercept = fit_intercept;
  g.part = (float*)scratch;
  g.ticket = (unsigned*)tickets;
  g.out = (float*)out;
  void* args[] = {(void*)&g};
  return (int)cudaLaunchKernel(fn, grid, dim3(T), args, (size_t)p.smem, s);
}

}  // extern "C"
