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
// mask row (B*4, or M*B*4 for per-lane masks), and does 4*B*d*C flops with
// C = M*K columns (the forward product and the gradient's).  At the
// search's block (2^20 x 64, K = 1) the bytes take 0.0826 ms at 3.35 TB/s
// and the flops 0.004*C ms at 67 TFLOP/s: bound by bytes up to C ~ 20 (every
// cohort of M <= 15 the search launches), by float32 operations above it
// (0.108 ms at M = 27, 0.325 ms at M = 81).
//
// The design.  Columns are the C pairs (lane, class), c = m*K + k.
//   - The ring path (d <= 64, K <= 16).  A persistent grid, two blocks of
//     256 threads a SM, each block a column tile of CT columns: 4 at C <= 4,
//     8 at C <= 8, 12 at C <= 12, else 16 (the grid's y dimension takes the
//     column tiles where C > 16, each streaming the block anew).  A block
//     walks its row tiles of R = 128 rows (tile blockIdx.x, + gridDim.x, ...)
//     through a ring of S = 2 shared-memory stages: x (64 floats a row, zeros
//     past d) by bulk copies (TMA) on an mbarrier, one a tile where its rows
//     are one run of bytes and one a row elsewhere (4-byte cp.async copies
//     where rows are not 16-byte aligned), y and the tile's mask rows by
//     cp.async; the next tile is in flight while one computes, one barrier a
//     tile, so no tile waits out its loads' latency.  The whole grid must be
//     resident (see the finish below): where C needs more column tiles than
//     the card holds blocks (C > 16 * SMs * 2 on an H100), the step takes
//     the tile path.
//   - Register tiles shaped by the cohort.  The block's columns are split
//     into slices of TC = 4 columns (3 at CT = 12: four slices of 3, not
//     three of 4 and one of padding), each slice taken by its own warps, so
//     that a slice of padding only (C = 9 at CT = 12, or the last column
//     tile) computes nothing.  A group of 8 lanes takes TR = 8 rows (4 at CT
//     = 4) of its slice: lane q owns 8 features (4*q.. and 32 + 4*q.., so
//     that the group's 16-byte loads of a row fall on 8 distinct bank
//     quads), reads their coefficients (a table staged once a launch) 4
//     features at a time, and its TR x TC partial margins are summed over
//     the group by three transposing shuffle steps, which leave each lane
//     TR*TC/8 whole margins (one row, consecutive columns).  Each (row,
//     column)'s loss terms are then computed once, branch-free, with y and
//     the mask from the stage and the intercept, epsilon and mask row from a
//     table loaded once a launch; mask*dl goes to the warp's small table
//     (__syncwarp only), and the lane's 8 x TC slice of the gradient
//     accumulates in its registers.  Capped at 128 registers (two blocks a
//     SM), no spills at CT <= 8.
//   - The block's record (per column its loss sum, gint and mask sum, then
//     its gradient in coef's layout) stays in registers across all its
//     tiles and is written once at the block's end, one store an element:
//     the warp's groups summed by shuffles, the warps of a slice in order.
//     Then the same grid, launched cooperatively (every block resident: the
//     plan's grid is the SMs' occupancy), synchronises once and block b
//     finishes lanes b, b + blocks, ...: its first warp sums the lane's loss
//     and count (lanes over the blocks' records), the other warps each an
//     element's gradient over the records in block order (the loads 16 in
//     flight, the adds in order), then the penalty, the schedule and the
//     update.  One launch a step; a shape's bits do not depend on timing, no
//     float atomics.
//   - What bounds it (cohort_variants.py's skeletons): at C <= 4 the ring
//     runs at ~75% of the bytes' bound; above, the SM's issue slots: beside
//     the products, the shuffle sums (~20% of the time at C = 9) and the
//     loss terms (~14%: expf, log1pf and a division a term for log_loss).
//   - The tile path (d > 64, K > 16, or more column tiles than resident
//     blocks): a tile of 256 rows x 16 columns (64 x 4 threads of 4 x 4
//     register tiles) over feature chunks of 64, x's chunk staged in shared
//     memory, the block's record read, added to and written back in global
//     memory each tile; then finish_kernel, its programmatic dependent, sums
//     the records in block order as the ring's finish does.  Registers capped
//     at 128, two blocks a SM.
//   - Any M*K (columns are tiled), any d, any B.
// Row indices are 64-bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 256;   // threads of the record kernels
constexpr int DC = 64;   // features a chunk (the ring path's most)
constexpr int NH = 7;    // hyperparameters a lane
constexpr int UT = 256;  // threads of finish_kernel
constexpr unsigned FULL = 0xffffffffu;
constexpr long long SCRATCH_FLOATS = 1ll << 23;  // most floats of block records a call

// The ring path's shape.
constexpr int RING_R = 128;             // rows a tile
constexpr int RING_S = 2;               // stages
constexpr int RING_TR = 8;              // most rows a group of 8 lanes takes at a time
constexpr int RING_MAX_K = 16;          // larger K takes the tile path
constexpr int CT8_MAX_C = 8;            // C in (4, CT8_MAX_C] takes CT = 8
constexpr int CT12_MAX_C = 12;          // C in (CT8_MAX_C, CT12_MAX_C] takes 12, above it 16

// The tile path's tile: NTX x NTY threads, each a 4 x 4 register tile of
// the margins (rows ty*4.., columns tx*4..) and of the gradient.
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
  long long blocks;   // record blocks (the records summed), the grid's x
  long long smem;     // the record kernel's dynamic shared memory, bytes
  long long rec;      // floats of a block record: 3*M*K + M*d*K
  long long scratch;  // floats of scratch: blocks*rec records, then 2*M of lanes
  long long ct;       // the ring path's column tile (4, 8 or 16); 0: the tile path
  long long cols;     // the ring path's column tiles, the grid's y
};
static_assert(sizeof(Plan) == 6 * sizeof(long long), "Plan is 6 int64s");

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
  float* coef;             // (M, d, K)
  float* intercept;        // (M, K)
  const float* hyper;      // (M, 7)
  float* t;                // (M,)
  float* out;              // (M, 2)
  long long B;
  int d, K, M;
  long long rec;
  float* part;             // blocks * rec floats, then 2*M of lanes
  int nmc;                 // the ring path: mask rows a stage holds
  int vec4;                // the ring path: x's rows by 16-byte copies (bulk copies with TMA)
  int penalty, schedule, fit_intercept;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's newest groups of copies are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// The ring path.

// The register tile of a column tile of CTL columns: a group of 8 lanes
// takes TR rows of the TC columns of its warp's column slice, a warp 4
// groups; the WPC warps of a slice take ROWS rows a pass and
// PASSES passes cover a tile's RING_R rows.  TC = 4, or 3 at CT = 12: four
// slices of 3, not three of 4 and one of padding, whose warps would leave
// one of the SM's four schedulers (warp % 4) idle and the others as busy.  After the shuffle sum
// a lane holds VL margins: row q*VL / TC of its group, columns q*VL % TC ...
template <int CTL>
struct RingShape {
  static constexpr int NW = T / 32;
  static constexpr int TC = CTL == 12 ? 3 : 4;
  static constexpr int NCS = CTL / TC;
  static constexpr int WPC = NW / NCS;
  static constexpr int TR = RING_R / (WPC * 4) < RING_TR ? RING_R / (WPC * 4) : RING_TR;
  static constexpr int ROWS = WPC * 4 * TR;  // rows a pass
  static constexpr int PASSES = RING_R / ROWS;
  static constexpr int V = TR * TC;
  static constexpr int VL = V / 8;
  static_assert(CTL % TC == 0 && PASSES * ROWS == RING_R && V % 8 == 0 && VL <= TC, "ring shape");
};

// The ring path's shared memory, in floats: S stages of x (R rows of 64),
// of y (R*K) and of the mask (R*nmc); each warp's mask*dl table (its 4
// groups' TR rows of 4); the coefficients (as (slice, feature f, lane q, 4
// columns, the 4th 0 where TC = 3) so that a group's 16-byte loads fall on
// 8 bank quads);
// a float4 a column (intercept, epsilon, mask row, k); S mbarriers.  At the block's end the stages hold the warps' gradients
// (WPC x 64 x CTL) and the row groups' loss, gint and count sums (slots x 3
// x CTL).
struct RingLayout {
  int x, y, ys, m, ms, w, cf, cc, bar, total;
};
__host__ __device__ inline RingLayout ring_layout(int ctl, int ncs, int nw, int tr, int K,
                                                  int nmc) {
  RingLayout s;
  const int wpc = nw / ncs, rows = wpc * 4 * tr;
  int off = 0;
  s.x = off;
  off += RING_S * RING_R * DC;
  s.ys = (RING_R * K + 3) & ~3;
  s.y = off;
  off += RING_S * s.ys;
  s.ms = (RING_R * nmc + 3) & ~3;
  s.m = off;
  off += RING_S * s.ms;
  s.w = off;
  off += nw * 4 * tr * 4;
  s.cf = off;
  off += DC * 4 * ncs;
  s.cc = off;
  off += 4 * ctl;
  s.bar = off;
  off += 2 * RING_S;
  const int red = wpc * DC * ctl + 3 * rows * ctl;
  s.total = off > red ? off : red;
  return s;
}

// feature f (0..7) of group lane q: two runs of 4, so that a group's
// 16-byte loads of one row fall on 8 distinct bank quads
__device__ __forceinline__ int feat(int q, int f) { return (f < 4 ? 4 * q : 32 + 4 * q - 4) + f; }

// One step of the shuffle sum over a group of 8 lanes: values [0, 2H) in,
// [0, H) out, the lower half of the sums where this lane's bit is clear and
// the upper half where it is set.
template <int H>
__device__ __forceinline__ void halve(float* v, int lane, int bit) {
  const bool up = (lane & bit) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, bit);
  }
}

// The copies of local tile n (tile blockIdx.x + n*gridDim.x) into its stage.
__device__ __forceinline__ void ring_issue(const Args& a, const RingLayout& s, float* sm,
                                           long long n, int m_lo, int nm) {
  const int st = (int)(n % RING_S);
  const long long r0 = ((long long)blockIdx.x + n * gridDim.x) * RING_R;
  const long long left = a.B - r0;
  const int nrows = left < RING_R ? (int)left : RING_R;
  float* xs = sm + s.x + st * RING_R * DC;
  if (a.vec4) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(sm + s.bar) + st;
    if (threadIdx.x == 0) mbar_expect(bar, (unsigned)(nrows * a.d * 4));
    if (a.d == DC && a.xs == DC) {  // the tile's rows are one run of bytes
      if (threadIdx.x == 0) bulk_copy(xs, a.x + r0 * DC, (unsigned)(nrows * DC * 4), bar);
    } else if (threadIdx.x < 32) {  // a copy a row
      for (int r = threadIdx.x; r < nrows; r += 32)
        bulk_copy(xs + r * DC, a.x + (r0 + r) * a.xs, (unsigned)(a.d * 4), bar);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * a.d; e += blockDim.x) {
      const int r = e / a.d, j = e - r * a.d;
      cp_async4(xs + r * DC + j, a.x + (r0 + r) * a.xs + j);
    }
  }
  float* ys = sm + s.y + st * s.ys;
  for (int e = threadIdx.x; e < nrows * a.K; e += blockDim.x) {
    const int r = e / a.K;
    cp_async4(ys + e, a.y + (r0 + r) * a.ys + (e - r * a.K));
  }
  float* ms = sm + s.m + st * s.ms;
  for (int e = threadIdx.x; e < nrows * nm; e += blockDim.x) {
    const int i = e / nrows, r = e - i * nrows;
    cp_async4(ms + i * RING_R + r, a.mask + (long long)(m_lo + i) * a.mm + (r0 + r) * a.mb);
  }
}

// The sums of lane m over the blocks' records: out[m] = (mean loss, sum of
// the mask), lane = (eta at t_m, the count), t_m += 1.  Called by the 32
// lanes of one warp (lanes over the blocks); COHERENT: the records were
// written by other blocks of this launch (read through L2).
template <bool COHERENT>
__device__ __forceinline__ float record_at(const float* p) {
  if constexpr (COHERENT) return __ldcg(p);
  return *p;
}
template <bool COHERENT>
__device__ __forceinline__ float lane_sum(const float* part, int blocks, long long rec,
                                          long long e) {
  float s = 0.f;
#pragma unroll 8
  for (int b = threadIdx.x & 31; b < blocks; b += 32) s += record_at<COHERENT>(part + b * rec + e);
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

template <bool COHERENT>
__device__ __forceinline__ void lane_finish(const float* part, int blocks, long long rec, int m,
                                            int M, int K, int schedule, const float* hyper,
                                            float* t, float* lane, float* out) {
  const long long C = (long long)M * K;
  float l = 0.f;
  for (int k = 0; k < K; ++k) l += lane_sum<COHERENT>(part, blocks, rec, (long long)m * K + k);
  const float cnt = lane_sum<COHERENT>(part, blocks, rec, 2 * C + (long long)m * K);
  if ((threadIdx.x & 31) != 0) return;
  const float count = cnt > 0.f ? cnt : 1.f;
  out[2 * m] = l / count;
  out[2 * m + 1] = cnt;
  const float tv = t[m];
  lane[0] = eta_at(schedule, hyper + (long long)m * NH, tv);
  lane[1] = count;
  t[m] = tv + 1.f;
}

// Element e of coef (M*d*K, then intercept M*K): its gradient summed over
// the blocks' records in block order.
template <bool COHERENT>
__device__ __forceinline__ float record_sum(const float* part, int blocks, long long rec,
                                            long long e, int M, int d, int K) {
  const long long C = (long long)M * K, n = C * d;
  const long long off = e < n ? 3 * C + e : C + (e - n);
  float s = 0.f;
#pragma unroll 16  // the loads in flight together, the adds in block order
  for (int b = 0; b < blocks; ++b) s += record_at<COHERENT>(part + b * rec + off);
  return s;
}

// Element e (of lane m) updated from its summed gradient s with the lane's
// penalty, eta and count (lane_finish's).
__device__ __forceinline__ void apply_update(long long e, float s, int M, int d, int K, int m,
                                             const float* lane, int penalty, int fit_intercept,
                                             const float* hyper, float* coef, float* intercept) {
  const long long n = (long long)M * K * d;
  const bool is_coef = e < n;
  const float eta = lane[0], g0 = s / lane[1];
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

// Every block's record written, the grid (launched cooperatively, all
// resident) synchronised, block b takes lanes b, b + blocks, ...: its first
// warp's lane_finish beside the other warps' record_sum, then apply_update,
// as finish_kernel.
__device__ void coop_finish(const Args& a) {
  __shared__ float lane[2];
  cooperative_groups::this_grid().sync();
  const int nb = gridDim.x * gridDim.y, blocks = gridDim.x;
  const int d = a.d, K = a.K, M = a.M;
  const long long n = (long long)M * K * d;
  const int E = (d + 1) * K;
  for (int m = blockIdx.y * gridDim.x + blockIdx.x; m < M; m += nb) {
    if (threadIdx.x < 32)
      lane_finish<true>(a.part, blocks, a.rec, m, M, K, a.schedule, a.hyper, a.t, lane, a.out);
    auto elem = [&](int i) {
      return i < d * K ? (long long)m * d * K + i : n + (long long)m * K + (i - d * K);
    };
    const int i0 = (int)threadIdx.x - 32;
    float s0 = 0.f;
    if (i0 >= 0 && i0 < E) s0 = record_sum<true>(a.part, blocks, a.rec, elem(i0), M, d, K);
    __syncthreads();
    if (i0 >= 0 && i0 < E)
      apply_update(elem(i0), s0, M, d, K, m, lane, a.penalty, a.fit_intercept, a.hyper, a.coef,
                   a.intercept);
    for (int i = T - 32 + (int)threadIdx.x; i < E; i += T)
      apply_update(elem(i), record_sum<true>(a.part, blocks, a.rec, elem(i), M, d, K), M, d, K,
                   m, lane, a.penalty, a.fit_intercept, a.hyper, a.coef, a.intercept);
    __syncthreads();  // lane is rewritten for the next lane
  }
}

template <typename L, int CTL>
__global__ void __launch_bounds__(T, 2) ring_kernel(Args a) {
  using S = RingShape<CTL>;
  constexpr int TC = S::TC, TR = S::TR, V = S::V, VL = S::VL;
  extern __shared__ __align__(16) float sm[];
  const RingLayout s = ring_layout(CTL, S::NCS, S::NW, TR, a.K, a.nmc);
  const int C = a.M * a.K, d = a.d, K = a.K;
  const int c0 = blockIdx.y * CTL;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane & 7, grp = lane >> 3;
  const int cs = warp / S::WPC, wr = warp % S::WPC;  // the warp's column slice, its rank there
  const int cl0 = c0 + cs * TC;                       // the slice's first column
  const bool live = cl0 < C;                          // a slice of padding computes nothing
  const int m_lo = c0 / K;
  const int nm = a.mm == 0 ? 1 : ((c0 + CTL - 1 < C - 1 ? c0 + CTL - 1 : C - 1) / K - m_lo + 1);

  // zeros in the stages (features past d, rows past a tile's end), the
  // column table, the mbarriers
  for (int e = threadIdx.x; e < s.w / 4; e += T)
    reinterpret_cast<float4*>(sm)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x < CTL) {
    const int c = c0 + threadIdx.x;
    const bool ok = c < C;
    const int m = ok ? c / K : m_lo, k = ok ? c % K : 0;
    const float b = ok ? a.intercept[c] : 0.f;
    const float eps = ok ? a.hyper[(long long)m * NH + EPSILON] : 0.f;
    reinterpret_cast<float4*>(sm + s.cc)[threadIdx.x] =
        make_float4(b, eps, __int_as_float(a.mm == 0 ? 0 : m - m_lo), __int_as_float(k));
  }
  if (threadIdx.x < RING_S) mbar_init(reinterpret_cast<uint64_t*>(sm + s.bar) + threadIdx.x);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeros before bulk copies

  // the coefficients of the block's columns for the whole launch: lane q of
  // slice cs reads features feat(q, f) of columns cs*TC.. as float4 (cs*8 + f)*8 + q
  for (int e = threadIdx.x; e < DC * 4 * S::NCS; e += T) {
    const int u = e % 4, qq = (e / 4) % 8, f = (e / 32) % 8, sl = e / 256;
    const int j = feat(qq, f), c = c0 + sl * TC + u;
    sm[s.cf + e] = u < TC && j < d && c < C
                       ? a.coef[((long long)(c / K) * d + j) * K + c % K] : 0.f;
  }
  const float4* cft = reinterpret_cast<const float4*>(sm + s.cf) + cs * 64 + q;
  // this lane's gradient (features feat(q, f), columns cl0 + u) and column sums
  float g[8][TC];
#pragma unroll
  for (int f = 0; f < 8; ++f)
#pragma unroll
    for (int u = 0; u < TC; ++u) g[f][u] = 0.f;
  float lsum[VL], gsum[VL], nsum[VL];
#pragma unroll
  for (int u = 0; u < VL; ++u) lsum[u] = gsum[u] = nsum[u] = 0.f;
  const int own_row = q * VL / TC, own_col = q * VL % TC;  // of the lane's margins
  __syncthreads();

  const long long tiles = (a.B + RING_R - 1) / RING_R;
  const long long nloc =
      tiles > (long long)blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
#pragma unroll
  for (int p = 0; p < RING_S - 1; ++p) {
    if (p < nloc) ring_issue(a, s, sm, p, m_lo, nm);
    cp_async_commit();
  }
  float* wt = sm + s.w + warp * 4 * TR * 4;  // this warp's mask*dl table, (4*TR, 4)
  const float4* ccol = reinterpret_cast<const float4*>(sm + s.cc) + cs * TC;
  for (long long n = 0; n < nloc; ++n) {
    cp_async_wait<RING_S - 2>();
    __syncthreads();  // tile n is in; every warp is done with tile n - 1's stage
    if (n + RING_S - 1 < nloc) ring_issue(a, s, sm, n + RING_S - 1, m_lo, nm);
    cp_async_commit();
    if (!live) continue;
    const int st = (int)(n % RING_S);
    if (a.vec4)
      mbar_wait(reinterpret_cast<uint64_t*>(sm + s.bar) + st, (unsigned)((n / RING_S) & 1));
    const long long r0 = ((long long)blockIdx.x + n * gridDim.x) * RING_R;
    const int nrows = a.B - r0 < RING_R ? (int)(a.B - r0) : RING_R;
    const float* xs = sm + s.x + st * RING_R * DC;
    const float* ys = sm + s.y + st * s.ys;
    const float* ms = sm + s.m + st * s.ms;
#pragma unroll
    for (int pass = 0; pass < S::PASSES; ++pass) {  // PASS_UNROLL
      const int rb0 = ((pass * S::WPC + wr) * 4 + grp) * TR;  // the group's first row
      // forward: the group's TR x TC partial margins over this lane's
      // features, a run of 4 at a time (4 x 4 coefficients in registers)
      float v[V];
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 c4[4] = {cft[(4 * h) * 8], cft[(4 * h + 1) * 8], cft[(4 * h + 2) * 8],
                              cft[(4 * h + 3) * 8]};
#pragma unroll
        const float cv[4][4] = {{c4[0].x, c4[1].x, c4[2].x, c4[3].x},
                                {c4[0].y, c4[1].y, c4[2].y, c4[3].y},
                                {c4[0].z, c4[1].z, c4[2].z, c4[3].z},
                                {c4[0].w, c4[1].w, c4[2].w, c4[3].w}};
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float4 x4 = *reinterpret_cast<const float4*>(xs + (rb0 + i) * DC + 32 * h + 4 * q);
#pragma unroll
          for (int u = 0; u < TC; ++u)
            v[i * TC + u] = fmaf(x4.x, cv[u][0], fmaf(x4.y, cv[u][1], fmaf(x4.z, cv[u][2],
                                 fmaf(x4.w, cv[u][3], v[i * TC + u]))));
        }
      }
      // the sums over the group's 8 lanes: each step halves the values a
      // lane holds, keeping the half its lane bit names
      halve<V / 2>(v, lane, 4);
      halve<V / 4>(v, lane, 2);
      halve<V / 8>(v, lane, 1);
      // the loss terms of this lane's VL margins: row own_row, columns own_col..
      const int row = rb0 + own_row;
      const bool row_ok = row < nrows;
      // (rows past the tile's end and padded columns: their mask read as
      // 0; their margins are finite, from finite rows and zero coefficients)
      float w[VL];
#pragma unroll
      for (int u = 0; u < VL; ++u) {
        const float4 cc = ccol[own_col + u];
        const int k = __float_as_int(cc.w);
        const bool ok = row_ok && cl0 + own_col + u < C;
        const float mk = ok ? ms[__float_as_int(cc.z) * RING_R + row] : 0.f;
        const Terms tr = L::terms(v[u] + cc.x, ys[row * K + k], cc.y);
        lsum[u] = ok ? fmaf(mk, tr.l, lsum[u]) : lsum[u];
        w[u] = mk * tr.dl;
        gsum[u] += w[u];
        nsum[u] += k == 0 ? mk : 0.f;
      }
      float* wrow = wt + (grp * TR + own_row) * 4 + own_col;
      if constexpr (VL == 4) {
        *reinterpret_cast<float4*>(wrow) = make_float4(w[0], w[1], w[2], w[3]);
      } else if constexpr (VL == 2) {
        *reinterpret_cast<float2*>(wrow) = make_float2(w[0], w[1]);
      } else {
#pragma unroll
        for (int u = 0; u < VL; ++u) wrow[u] = w[u];
      }
      __syncwarp();
      // gradient: the lane's 8 x TC slice over the group's rows
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float4 lo = *reinterpret_cast<const float4*>(xs + (rb0 + i) * DC + 4 * q);
        const float4 hi = *reinterpret_cast<const float4*>(xs + (rb0 + i) * DC + 32 + 4 * q);
        const float xr[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const float4 w4 = *reinterpret_cast<const float4*>(wt + (grp * TR + i) * 4);
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int f = 0; f < 8; ++f)
#pragma unroll
          for (int u = 0; u < TC; ++u) g[f][u] = fmaf(xr[f], wv[u], g[f][u]);
      }
      __syncwarp();  // the table is rewritten by the next pass
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the block's record: the warp's 4 groups summed by shuffles, the warps
  // of a slice in order
  float* gred = sm;                          // (WPC, 64, CTL)
  float* lred = sm + S::WPC * DC * CTL;      // (slots, 3, CTL)
#pragma unroll
  for (int f = 0; f < 8; ++f)
#pragma unroll
    for (int u = 0; u < TC; ++u) {
      float vsum = g[f][u];
      vsum += __shfl_xor_sync(FULL, vsum, 8);
      vsum += __shfl_xor_sync(FULL, vsum, 16);
      if (grp == 0) gred[(wr * DC + feat(q, f)) * CTL + cs * TC + u] = vsum;
    }
  {
    const int slot = (wr * 4 + grp) * TR + own_row;
#pragma unroll
    for (int u = 0; u < VL; ++u) {
      const int cl = cs * TC + own_col + u;
      lred[(slot * 3 + 0) * CTL + cl] = lsum[u];
      lred[(slot * 3 + 1) * CTL + cl] = gsum[u];
      lred[(slot * 3 + 2) * CTL + cl] = nsum[u];
    }
  }
  __syncthreads();
  float* out = a.part + (long long)blockIdx.x * a.rec;
  for (int e = threadIdx.x; e < 3 * CTL; e += T) {
    const int qq = e / CTL, cl = e % CTL;
    if (c0 + cl >= C) continue;
    float sum = 0.f;
    for (int slot = 0; slot < S::ROWS; ++slot) sum += lred[(slot * 3 + qq) * CTL + cl];
    out[(long long)qq * C + c0 + cl] = sum;
  }
  for (int e = threadIdx.x; e < d * CTL; e += T) {
    const int j = e / CTL, cl = e % CTL, c = c0 + cl;
    if (c >= C) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < S::WPC; ++w) sum += gred[(w * DC + j) * CTL + cl];
    out[3ll * C + ((long long)(c / K) * d + j) * K + c % K] = sum;
  }
  coop_finish(a);
}

// ---------------------------------------------------------------------------
// The tile path (d > 64 or K > 16).

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
__global__ void __launch_bounds__(T, 2) tile_kernel(Args a) {
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

// ---------------------------------------------------------------------------
// The finish: the records summed in block order.

// A block a lane m: its first warp's lane_finish beside the other warps'
// record_sum (a thread an element of the lane's coef and intercept), then
// apply_update.  Launched as the record kernel's programmatic dependent: it
// waits for the records before it reads them.
__global__ void __launch_bounds__(UT) finish_kernel(
    const float* __restrict__ part, int blocks, long long rec, int M, int d, int K, int schedule,
    int penalty, int fit_intercept, const float* __restrict__ hyper, float* __restrict__ t,
    float* __restrict__ out, float* __restrict__ coef, float* __restrict__ intercept) {
  __shared__ float lane[2];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int m = blockIdx.x;
  if (threadIdx.x < 32) lane_finish<false>(part, blocks, rec, m, M, K, schedule, hyper, t, lane, out);
  const long long n = (long long)M * K * d;
  const int E = (d + 1) * K;  // the lane's elements: d*K of coef, K of intercept
  auto elem = [&](int i) {
    return i < d * K ? (long long)m * d * K + i : n + (long long)m * K + (i - d * K);
  };
  const int i0 = (int)threadIdx.x - 32;
  float s0 = 0.f;
  if (i0 >= 0 && i0 < E) s0 = record_sum<false>(part, blocks, rec, elem(i0), M, d, K);
  __syncthreads();
  if (i0 >= 0 && i0 < E)
    apply_update(elem(i0), s0, M, d, K, m, lane, penalty, fit_intercept, hyper, coef, intercept);
  for (int i = UT - 32 + (int)threadIdx.x; i < E; i += UT)
    apply_update(elem(i), record_sum<false>(part, blocks, rec, elem(i), M, d, K), M, d, K, m, lane,
                 penalty, fit_intercept, hyper, coef, intercept);
}

template <typename L>
const void* kernel_for(int ct) {
  switch (ct) {
    case 4: return (const void*)ring_kernel<L, 4>;
    case 8: return (const void*)ring_kernel<L, 8>;
    case 12: return (const void*)ring_kernel<L, 12>;
    case 16: return (const void*)ring_kernel<L, 16>;
  }
  return (const void*)tile_kernel<L>;
}

const void* select_kernel(int loss, int ct) {
  switch (loss) {
    case 0: return kernel_for<LogLoss>(ct);
    case 1: return kernel_for<Hinge>(ct);
    case 2: return kernel_for<SquaredHinge>(ct);
    case 3: return kernel_for<ModifiedHuber>(ct);
    case 4: return kernel_for<SquaredError>(ct);
    case 5: return kernel_for<Huber>(ct);
  }
  return nullptr;
}

// the ring path's column tile for C columns
int ring_ct(long long C) {
  return C <= 4 ? 4 : C <= CT8_MAX_C ? 8 : C <= CT12_MAX_C ? 12 : 16;
}

// the mask rows a stage of the ring path holds: the lanes a column tile spans
int ring_nmc(int ct, int K, int M) {
  const int span = (ct + K - 1) / K + 1;
  return span < M ? span : M;
}

template <int CTL>
int ring_smem(int K, int nmc) {
  using S = RingShape<CTL>;
  return (int)sizeof(float) * ring_layout(CTL, S::NCS, S::NW, S::TR, K, nmc).total;
}

// the ring path's threads a block and shared memory, bytes
int ring_smem(int ct, int K, int nmc) {
  switch (ct) {
    case 4: return ring_smem<4>(K, nmc);
    case 8: return ring_smem<8>(K, nmc);
    case 12: return ring_smem<12>(K, nmc);
  }
  return ring_smem<16>(K, nmc);
}

// The kernel's blocks a SM at smem bytes of dynamic shared memory, its
// limit raised to smem first.  The limit is a kernel's, not a plan's: never
// lowered below what an earlier plan needs.
cudaError_t blocks_per_sm(const void* fn, int smem, int* per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  if (attr.maxDynamicSharedSizeBytes < smem) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, T, (size_t)smem);
}

}  // namespace

extern "C" {

const char* cohort_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Plans a step of M lanes of loss (0 log_loss, 1 hinge, 2 squared_hinge, 3
// modified_huber, 4 squared_error, 5 huber) over B rows, d features and K
// target columns into plan (6 int64s; plan[3] is the floats of scratch it
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
  // the ring path where its cooperative grid, a block at least a column
  // tile, is resident at once; the tile path elsewhere
  int ct = 0, smem = SMEM;
  long long cols = 1;
  if (d <= DC && K <= RING_MAX_K) {
    ct = ring_ct(C);
    cols = (C + ct - 1) / ct;
    smem = ring_smem(ct, K, ring_nmc(ct, K, M));
    err = blocks_per_sm(select_kernel(loss, ct), smem, &per_sm);
    if (err != cudaSuccess) return (int)err;
    if (cols > (long long)sms * per_sm) ct = 0, cols = 1, smem = SMEM;
  }
  if (ct == 0) {
    err = blocks_per_sm(select_kernel(loss, 0), smem, &per_sm);
    if (err != cudaSuccess) return (int)err;
  }
  const long long rows = ct ? RING_R : R;
  const long long tiles = (B + rows - 1) / rows;
  // the ring's grid: blocks * cols <= sms * per_sm, every block resident
  long long blocks = (long long)sms * (per_sm < 1 ? 1 : per_sm) / cols;
  if (blocks > tiles) blocks = tiles;
  if (blocks > SCRATCH_FLOATS / rec) blocks = SCRATCH_FLOATS / rec;
  if (blocks < 1) blocks = 1;
  p->blocks = blocks;
  p->smem = smem;
  p->rec = rec;
  p->scratch = blocks * rec + 2 * (long long)M;
  p->ct = ct;
  p->cols = cols;
  return (int)cudaSuccess;
}

// One step of M lanes of plan's shape.  x (B, d) and y (B, K) float32 with
// row strides xs, ys (elements) and contiguous rows; mask (M, B) float32,
// lane m's row i at m*mm + i*mb (mm = 0 for one mask shared by the lanes);
// coef (M, d, K), intercept (M, K), t (M,), hyper (M, 7) and out (M, 2)
// float32, contiguous, on one device.  coef, intercept (if fit_intercept)
// and t are updated in place; out[m] = (mean loss, sum of lane m's mask).
// scratch: plan[3] floats.  The ring path: one cooperative launch; the tile
// path: the records, then finish_kernel.
int cohort_step(const void* plan, int loss, int penalty, int schedule, int fit_intercept,
                const void* x, long long xs, const void* y, long long ys, const void* mask,
                long long mm, long long mb, void* coef, void* intercept, void* t,
                const void* hyper, long long B, int d, int K, int M, void* scratch, void* out,
                void* stream) {
  const Plan p = *(const Plan*)plan;
  const void* fn = select_kernel(loss, (int)p.ct);
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
  a.coef = (float*)coef;
  a.intercept = (float*)intercept;
  a.hyper = (const float*)hyper;
  a.t = (float*)t;
  a.out = (float*)out;
  a.B = B;
  a.d = d;
  a.K = K;
  a.M = M;
  a.rec = p.rec;
  a.part = (float*)scratch;
  a.nmc = p.ct ? ring_nmc((int)p.ct, K, M) : 0;
  a.vec4 = d % 4 == 0 && xs % 4 == 0 && ((uintptr_t)x & 15) == 0;
  a.penalty = penalty;
  a.schedule = schedule;
  a.fit_intercept = fit_intercept;
  void* args[] = {(void*)&a};
  const dim3 grid((unsigned)p.blocks, (unsigned)p.cols);
  if (p.ct) return (int)cudaLaunchCooperativeKernel(fn, grid, dim3(T), args, (size_t)p.smem, s);
  const cudaError_t err = cudaLaunchKernel(fn, grid, dim3(T), args, (size_t)p.smem, s);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)M);
  cfg.blockDim = dim3(UT);
  cfg.stream = s;
  cudaLaunchAttribute dep;
  dep.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dep.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &dep;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, finish_kernel, (const float*)scratch, (int)p.blocks, p.rec,
                                 M, d, K, schedule, penalty, fit_intercept, (const float*)hyper,
                                 (float*)t, (float*)out, (float*)coef, (float*)intercept);
}

}  // extern "C"
