// K2-OvR and K2-MN: the multi-class logistic losses and their gradients
// over row shards, for Hopper (sm_90a), plain C ABI.
//
// K2-OvR (mode 0) replaces dask_ml_tpu/solvers/families.py :: Logistic.loss
// (:34) under jax.vmap of solvers/algorithms.py :: packed_solve's `one`
// (:757-800), and Logistic.loss and Normal.loss (:53) under jax.vmap of
// lambda_sweep (:802): K problems that share x.  For every active lane
// l = k*P + p (problem k, shard p) of B (K*P, d):
//   eta_i = x_pi . B_l
//   f_l   = sum_i mask_pi * loss(eta_i, Y_kpi)
//   g_l   = sum_i mask_pi * dloss/deta(eta_i, Y_kpi) * x_pi     (GRAD only)
// with x (P, m, d), mask (P, m) and the family's terms (a functor, as K2's
// in logistic.cu): Logistic softplus(eta) - y*eta and sigmoid(eta) - y,
// Normal (y - eta)^2/2 and eta - y.  Y is (K, P, m) with a class stride
// `ystride` in floats: P*m for K targets of their own (one-vs-rest), or 0
// for one target that all K problems share (a sweep over lambda, whose
// lanes differ only in beta).  With a shared target a tile stages one
// target run, not K; where d <= 32 and K <= 16 the lanes then run on the
// tensor cores as K2-MN's classes do (tc_kernel, below), else ovr_kernel
// stages it: its stage shrinks by (K - 1)*(R + 4) floats and a tile's
// copies by K - 1 runs.
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
// Bound on an H100: one evaluation must read x once (n*d*4 bytes) plus the
// targets and the mask (OvR: n*(K + 1)*4, n*2*4 with a shared target; MN:
// n*8), and does 4*n*d*K flops
// (K dots and K axpys a row).  At the packed fit's shape (P = 8,
// m = 1.375M, d = 29, K = 4) that is 1.496 GB, 0.447 ms at 3.35 TB/s,
// against 5.1 GFLOP, 0.076 ms at 67 TFLOP/s; at bench.py's packed A/B
// shape (P = 1, m = 1M, d = 28, K = 16) 0.180 GB, 0.054 ms, against
// 1.8 GFLOP, 0.027 ms.  Both are memory-bound, K=16 by only 2x.
//
// K2-OvR (ovr_kernel).  What held the first design back, counted from its
// code: the K target runs and the mask of each tile were plain global
// loads inside the tile loop (K*R + R a tile: 5 a thread at K=4, R=256;
// 8 at K=16, R=128), each paying the DRAM latency that only x's cp.async
// hid; the logits, targets, weights and losses made round trips through
// (row, class) tables in shared memory, with a separate loss pass; four
// __syncthreads a tile.  Its value-only variant reached half the bound.
// The design now:
//   1. Every input of a tile is copied asynchronously, in a ring of
//      STAGES = 3 tiles, up to two in flight while one is used.  A tile is
//      its R*d floats of x, its target runs Y[k, p, r0:r0+R] and its mask
//      run; each run whose source and length are whole 16-byte units is
//      one TMA bulk copy (cp.async.bulk, issued by thread 0), the others go
//      by the threads' 16-byte cp.async (copy_tile: no alignment needed).
//      Both complete on the stage's mbarrier: thread 0 arrives with the
//      bulk bytes expected, every thread through
//      cp.async.mbarrier.arrive.noinc once its own copies have landed.  The
//      tile loop holds no synchronous global load.  R comes from
//      OVR_BUDGET, so that two blocks fit a SM: R = 256 at d = 29, K = 4
//      (111 KB), R = 128 at d = 28, K = 16 (90 KB).
//   2. Row terms in registers.  A block takes at most 16 classes (NCT
//      float4 chunks; more classes take more blocks along grid z, each
//      reading x again).  The S = 256/R threads of a row split the chunks
//      (SC ways, the same across a warp) and then the features (SF ways,
//      joined by an xor-shuffle tree); a row's logits stay in the
//      registers of the thread that computed them, the family's terms run
//      there, each lane's loss is summed in registers across the block's
//      tiles, and only the weights mask*(sigmoid - Y) go to shared memory,
//      once, as float4s.
//   3. One __syncthreads a tile, between the forward and the gradient; it
//      is also the stage hand-off: after it no thread reads the previous
//      tile's stage or the weights two tiles back (double-buffered), so the
//      next copy is issued into it.  A gradient thread owns a row group and
//      F features (4 interleaved, 1 at 16 classes a block) for all the
//      block's classes, in registers across tiles (past d = 256*F a
//      feature a thread, added to the block's record once a tile).
//   What bounds it now, counted (no counters run on the card) and borne
//   out by variants with the forward or the copies taken out: a 16-byte
//   shared-memory load costs four wavefronts (one shared-memory cycle
//   each) even when every lane reads the same address, so the broadcasts
//   of beta (forward) and of the weights (gradient), not the FMAs, bound
//   the compute.  A 256-row tile at K=4, d=29 (8 warps): forward 29 x
//   loads (1 wavefront) and 29 beta float4s (4) a warp, 1,160; targets,
//   mask and weight stores 72; gradient (F = 4, W = 8 threads a group,
//   G = 32 groups, whose warps' rows are 8 apart so that the x loads miss
//   each other's banks) 64 warp-rows of one weight float4 and four x
//   loads, 512: ~1,740 wavefronts, ~0.32 ms over the 326 tiles a SM takes
//   (value only ~1,200, ~0.22 ms), under the 0.447 ms byte bound, but
//   overlapped with the copies only in part: the copies decide at K=4.
//   A 128-row tile at K=16, d=28: forward 28 x loads (4-way conflict at
//   an even d) and 56 beta float4s a warp, ~2,700; gradient 112
//   warp-rows of four weight float4s and one x load, ~1,900: ~4,700
//   wavefronts, ~0.16 ms over 59 tiles a SM, above the 0.134 ms that 40%
//   of the bound asks; the copy ring, 18 runs a tile, is slow there too.
//   4. Tensor cores (mma.sync TF32 with a 3-pass hi/lo split, x and the
//      weights read once as fragments) are not used here.  At K=4 the
//      kernel reaches 70% of its bound without them; at K=16 they would
//      remove most of the wavefronts above, but not the copy ring's cost,
//      which needs larger tiles first.  Over one shared target they are:
//      see K2-OvR over one shared target, below.
//
// K2-MN (tc_kernel with Softmax row terms).  The bound at the multinomial fit's (8, 1.375M, 29),
// K=4: 1.364 GB, 0.407 ms; at (1, 1M, 28), K=16: 0.120 GB, 0.0358 ms
// (1.8 GFLOP, 0.027 ms at 67 TFLOP/s).  What held the first design
// (tiled_kernel) back, counted from its code: the labels and the mask were
// plain global loads in the tile loop, x only double-buffered; four
// __syncthreads a tile, the logits, weights and losses making round trips
// through shared (row, class) tables and a softmax pass of one thread a row
// (2K expf a row, in both variants); and shared-memory wavefronts, not FMAs,
// bounded its compute: a beta float4 per feature per 4 classes in the
// forward, a weight float4 and an x value per row per 4 classes in the
// gradient, ~5,000 wavefronts a 128-row tile at K=16 (~0.16 ms over the 59
// tiles a SM takes) and ~2,500 a 256-row tile at K=4 (~0.45 ms over 326).
// It ran at 52% (value and gradient) and 66% (value) of the bound at K=4,
// 14% at K=16.  The design now:
//   1. Every input of a tile is copied asynchronously by stage_tile, as in
//      K2-OvR: the tile's R*d floats of x, its R labels and its R mask
//      values, each one TMA bulk copy where whole 16-byte units, else
//      cp.async, into a ring of S stages on an mbarrier each.  R = 256 (two
//      16-row groups a warp) and S = 3 where three such stages fit 112 KB
//      (two blocks a SM), else R = 128; S as many as fit, up to 8.  One
//      __syncthreads a tile, after its last read, hands its stage back: the
//      tile S ahead is copied into it at once.
//   2. Both class products run on the tensor cores: mma.sync m16n8k8 TF32
//      with a 3-pass split (lo*hi + hi*lo + hi*hi, float32 sums), a warp a
//      16-row group.  Forward eta (16 x 8*NN) = x (16 x 8*NKS) . B: B's hi
//      and lo fragments stay in registers for the whole block (4*NKS*NN:
//      16 at d = 29, K = 4; 32 at d = 28, K = 16), so beta is never
//      broadcast; x's A fragments are 32-bit shared loads (lane (g, t) reads
//      row g, feature t: 32 distinct banks at d = 28, two lanes a bank at
//      d = 29).  The three passes go to three accumulators, so that no
//      product waits on the one before (on an H100, multiclass_variants.py:
//      value-and-grad at K=4 0.564 ms against 0.595-0.603 ms with one).
//      Gradient G (16*NMT x 8*NN) += x^T . W (16 rows): each tile's
//      product starts from zero and is added to G's
//      registers on the CUDA cores (where the warps wait for the tile's
//      barrier anyway), since the tensor cores round their float32 sums
//      toward zero; summed on them over a warp's ~5,200 rows of the fit's
//      shape, that bias put the intercept's gradient 2.1e-5 of its Σ|terms|
//      off.  (Added a group at a time, it measured slower at K=4.)
//   3. Softmax terms in registers: the m16n8 accumulator puts a row's
//      classes on the four lanes of a quad, so its max and its sum of exps
//      are two xor-shuffles each; one __expf a class, reused for the weights
//      mask*(e/sum - onehot); the loss mask*(lse - eta_y) is added on the
//      lane that holds class y (lane t = 0 where y picks none), in registers,
//      the same way in both variants.  The weights pass from the accumulator
//      layout to the B operand's through a warp-private (16, SW) slab with
//      __syncwarp only.  Padded classes (half the n-tile at K=4) get no max,
//      no exp and weight 0; features past d read zeros in the forward and
//      land in rows of G that are never written out; a tile's rows past its
//      last are zeros with mask 0.
//   The split's error: hi = TF32(v) keeps 11 significant bits, lo = v - hi
//   is exact in float32 and read truncated to TF32 (under 2^-21 |v| lost),
//   and lo*lo (under 2^-22 |a||b|) is dropped: each product is within ~2^-20
//   of its value, far inside TOL = 1e-5 of Σ|terms|; one TF32 pass (2^-11)
//   would not hold it (tests/test_torch_multiclass.py checks both).
//   What bounds it now: the copy ring.  With the compute taken out it runs
//   at 0.450 ms at K=4 (90% of the bound) and 0.046 ms at K=16 on an H100
//   (multiclass_variants.py, variant `ring`).  The compute, counted a 16-row
//   group at K=4, d=29: 32 x loads (~80 wavefronts with the bank
//   conflicts above) and 24 MMAs, ~0.25 ms of shared memory over the
//   5,208 groups a SM takes, overlaps the copies only in part, since a
//   stage is held from its copy's issue to the end of its compute; the
//   value-only variant (16 loads, 12 MMAs) pays ~0.035 ms over the ring,
//   the gradient ~0.115 ms.  Past d = TC_MAX_D = 32 or K = TC_MAX_K = 16 (B's
//   fragments past 32 registers, a row's logits past 4 a lane) tiled_kernel,
//   the first design, takes over.
//
// K2-OvR over one shared target (tc_kernel with PerLane<Fam> row terms,
// plan path 3, where d <= TC_MAX_D and K <= TC_MAX_K: a sweep's L lanes).
// The bound at the sweeps' (8, 916667, 29): x once, one target and the
// mask, 0.9093 GB, 0.2714 ms at 3.35 TB/s, against 6.805 GFLOP at L = 8
// (0.014 ms at 495 TFLOP/s TF32, 0.10 ms at 67 float32).  What held
// ovr_kernel back there, counted from its code: a block took L = 8 lanes
// (two float4 chunks) whose beta (d, 8) and weights reached the threads as
// 16-byte shared-memory broadcasts, four wavefronts each, which bounded its
// compute; a 256-row stage with beta and the two (R, KS) weight tables
// needs 120.9 KB of the 112 KB two-block budget, so its tiles fell to 128
// rows, where a row brings only 31 floats (x, the target, the mask) to hide
// the fixed shared-memory cost of 8 lanes.  It ran at 33% (value and
// gradient) and 43% (value) of the bound at L = 8, 34% and 49% at L = 5.
// The design now is K2-MN's, a lane where K2-MN has a class:
//   1. beta in registers: B_p's column k is lane k*P + p, gathered once a
//      block into hi/lo TF32 B fragments, zeros for an off lane (whose
//      terms add nothing and whose f and g are not written); nothing of
//      beta goes to shared memory.  An MMA's output column reads only its
//      own B column, so a lane's sums have the same bits whichever other
//      lanes are on.
//   2. Both products on mma.sync m16n8k8 with the 3-pass split, as K2-MN's.
//   3. The family's terms (Fam::terms, as ovr_kernel computes them) on the
//      accumulator layout, a (row, lane) a register: acc[n][2r + c] is row
//      g + 8r of lane 8n + 2t + c.  A lane's loss is summed in registers
//      across tiles, then over the eight lanes of one t by a fixed shuffle
//      tree and over the warps in order; the padded lanes of the n-tile (3
//      of 8 at L = 5) add no term and get weight 0; rows past a tile read
//      target and mask 0.  The weights reach the B operand through the
//      warp's slab, as K2-MN's.
//   4. A stage holds a 256-row x tile, the target run and the mask run:
//      3 x (256*29 + 4 + 2*260) floats = 95.4 KB, and 4 KB of warp slabs,
//      two blocks a SM, one __syncthreads a tile.  Every run is one TMA
//      bulk copy, also off a 16-byte boundary (stage_tile<true> copies the
//      16-byte units that hold it): at m = 916667 the odd shards' bases lie
//      12 bytes off, and there the threads' cp.async copies (variant
//      `cpasync`) took the logistic L = 8 value and gradient to 0.544-0.553
//      ms and the value to 0.407 ms (multiclass_variants.py, an H100).
//   5. At one n-tile the logistic family's gradient keeps its three passes
//      in three accumulators (GRAD3, above).
//   What bounds it now, on an H100 (multiclass_variants.py, in turns): the
//   copy ring alone (`ring`) runs at 0.324-0.325 ms at both shapes (84% of
//   the bound); the value-only variants (0.344-0.356 ms) and the Normal
//   value and gradient (0.340) sit within 0.03 ms of it, since a stage is
//   held from its copy's issue to the end of its compute (their compute
//   alone, `nocopy`: 0.264-0.267, 0.195-0.198 and 0.320-0.324 ms).  The
//   logistic value and gradient (0.434 ms) is compute-bound: its compute
//   alone takes 0.458-0.463 ms (longer than the whole kernel; not
//   explained); with the Normal family's terms in place of its own
//   (`noterms`, wrong sums on purpose) the kernel runs at 0.352 ms, and with
//   __expf, __logf and __fdividef (`fastterms`) at 0.338-0.339: the accurate
//   expf, log1pf and two divisions of each (row, lane) take ~0.08 ms.  They
//   add 616 SASS instructions to the kernel (3152 against 2536, `--sass`),
//   ~77 a (row, lane) over its two inlined copies of the group (a whole and
//   a partial tile's).
//
// Both: deterministic (per-block records summed in block order by
// finalize_kernel (OvR) or in a fixed lane order and shuffle tree by
// mn_finalize_kernel (MN); no float atomics); f has the same bits with and
// without the gradient; inactive lanes (OvR: a class of a shard; MN: a
// shard) are not read and their f, g not written, and a lane's sums never
// depend on which other lanes are active.  Past what a block's shared
// memory holds (large d, or d*K for MN's tiled_kernel), row_kernel takes
// over: a block a row at a time, a warp a class's dot, the gradient
// accumulated in the block's record in global memory.  Row indices are
// 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 256;                     // threads per block
constexpr int NW = T / 32;                 // warps per block
constexpr int MIN_R = 8;                   // fewest rows a tile (S = 32)
constexpr int KC = 4;                      // classes a float4 chunk
constexpr int STAGES = 3;                  // OvR: tiles in the copy ring
constexpr int TC_MAX_D = 32;               // most features, and classes or lanes,
constexpr int TC_MAX_K = 16;               // that tc_kernel holds in registers
constexpr int TC_MAX_STAGES = 8;           // most tiles in tc_kernel's ring
constexpr long long TC_BUDGET = 112 << 10;    // dynamic bytes of tc_kernel, two blocks a SM
constexpr long long SMEM_BUDGET = 100 << 10;  // MN past tc_kernel: staged bytes a block
constexpr long long OVR_BUDGET = 112 << 10;   // OvR: dynamic bytes a block, two blocks a SM
constexpr long long SCRATCH_CAP = 1LL << 26;  // floats of block records

enum { OVR = 0, MN = 1 };

struct Plan {
  long long path;      // 0: ovr_kernel / tiled_kernel, 1: row_kernel, 2: tc_kernel (MN),
                       // 3: tc_kernel over one shared target (OvR)
  long long R;         // rows a tile
  long long G;         // row groups of the gradient (tc_kernel: tiles in its ring)
  long long blocks;    // blocks a shard (OvR: a shard and class group)
  long long smem;      // dynamic shared memory, bytes
  long long rec;       // floats of a block record: K * (d + 1)
  long long scratch;   // floats of scratch: P * blocks * rec
  long long aux;       // OvR: float4 class chunks a block (NCT); MN: row groups of the loss
                       // (tiled_kernel) or n-tiles of 8 classes or lanes (tc_kernel)
};
static_assert(sizeof(Plan) == 8 * sizeof(long long), "Plan is 8 int64s");

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

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// an arrival that also expects `bytes` more from bulk copies
__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// an arrival made once all this thread's cp.async copies so far have landed
__device__ __forceinline__ void mbar_arrive_cp_async(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(smem_addr(bar))
               : "memory");
}
// waits for the phase of the given parity to complete
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}
// orders this thread's earlier shared-memory accesses before later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Floats that src lies past a 16-byte boundary.
__device__ __forceinline__ int misalign(const float* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// Whether cnt floats from src are whole 16-byte units: a bulk copy.
__device__ __forceinline__ bool bulk_ok(const float* src, int cnt) {
  return ((reinterpret_cast<uintptr_t>(src) & 15) | (uintptr_t)(cnt & 3)) == 0;
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
  float loss;  // the row's loss term, times the mask
  float w;     // d loss / d eta, times the mask
};

// The families of K2-OvR: a row's terms from eta, y and the mask, as K2's
// (logistic.cu) compute them.  LONG: its terms are long enough to make
// tc_kernel's value and gradient compute-bound (expf, log1pf and a
// division a row and lane).
struct Logistic {
  static constexpr bool LONG = true;
  __device__ __forceinline__ static RowTerms terms(float eta, float y, float m) {
    const float e = expf(-fabsf(eta));
    const float sp = fmaxf(eta, 0.f) + log1pf(e);
    const float sig = eta >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);
    return {m * (sp - y * eta), m * (sig - y)};
  }
};
struct Normal {
  static constexpr bool LONG = false;
  __device__ __forceinline__ static RowTerms terms(float eta, float y, float m) {
    const float r = y - eta;
    return {m * (0.5f * r * r), m * (eta - y)};
  }
};
enum { LOGISTIC = 0, NORMAL = 1 };

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

// Row groups: of the gradient, so that (group, feature) pairs fill a
// block, and of the MN loss.
__host__ __device__ __forceinline__ int row_groups(int cols, int R) {
  const int g = T / cols;
  return g < 1 ? 1 : (g > R ? R : g);
}

// ------------------------------------------------------------- K2-OvR

// Float4 class chunks a block of ovr_kernel takes for K classes.
__host__ __device__ __forceinline__ int ovr_chunks(int K) {
  const int nc = (K + KC - 1) / KC;
  return nc <= 1 ? 1 : (nc <= 2 ? 2 : 4);
}

// Features a gradient thread of ovr_kernel takes (interleaved, W = ceil(d/F)
// apart), so that one float4 of weights feeds F*4 FMAs (one at 16 classes a
// block, where the F*16 accumulators would spill).
__host__ __device__ constexpr int ovr_grad_feats(int nct) { return nct == 4 ? 1 : 4; }

// Floats of one stage of the ring: x (R*d + 4), then KY target runs and
// the mask run (R + 4 each; the 4 spare floats take a copy_tile offset).
__host__ __device__ __forceinline__ long long ovr_stage_floats(int R, int d, int KY) {
  return (long long)R * d + 4 + (KY + 1LL) * (R + 4);
}

// Floats of the ring, which after the tile loop holds the gradient's
// (G, KB, d) group totals.
__host__ __device__ __forceinline__ long long ovr_ring_floats(int R, int d, int KY, int G, int KB) {
  const long long ring = STAGES * ovr_stage_floats(R, d, KY), gred = (long long)G * KB * d;
  return ring > gred ? ring : gred;
}

// Target runs a stage holds: one a class of the block, or one for all of
// them where the target is shared.
__host__ __device__ __forceinline__ int ovr_target_runs(int K, int KB, bool shared) {
  return shared ? 1 : (K < KB ? K : KB);
}

// Floats of ovr_kernel's dynamic shared memory: the ring, beta (d, KB) and
// two (R, KS) weight tables.
long long ovr_floats(int R, int d, int K, int G, bool shared) {
  const int KB = KC * ovr_chunks(K), KY = ovr_target_runs(K, KB, shared);
  return ovr_ring_floats(R, d, KY, G, KB) + (long long)d * KB + 2LL * R * row_stride(KB);
}

// Floats of the 16-byte units that hold cnt floats from src.
__device__ __forceinline__ int unit_floats(const float* src, int cnt) {
  return (misalign(src) + cnt + 3) & ~3;
}

// Copies tile rows [r0, r0 + rows) of shard p into the stage at buf,
// completing on bar: x's rows (nx floats from xt), the target runs c < KY
// whose bit is set in `on` (from yt, run c at yt + c*ystride) and the mask
// run (from mt), each to misalign(src) floats into its slot.  A run whose
// source and length are whole 16-byte units is one bulk copy issued by
// thread 0; the others are the threads' cp.async, or with ANY one bulk copy
// too, of the 16-byte units that hold the run: up to 3 floats either side
// of it land in its slot's 4 spare floats and are not read (a 16-byte unit
// never straddles a page, so those reads cannot fault).  Thread 0 arrives
// expecting the bulk bytes, every thread once its cp.async copies have
// landed: T + 1 arrivals a phase.
template <bool ANY = false>
__device__ __forceinline__ void stage_tile(float* buf, unsigned long long* bar, const float* xt,
                                           int nx, const float* yt, long long ystride,
                                           const float* mt, int rows, int R, int KY, int yoff,
                                           unsigned on) {
  float* ybuf = buf + yoff;
  float* mbuf = ybuf + KY * (R + 4);
  if (ANY) {
    if (threadIdx.x == 0) {
      unsigned bytes = 4u * (unit_floats(xt, nx) + unit_floats(mt, rows));
      for (int c = 0; c < KY; ++c)
        if (on >> c & 1) bytes += 4u * unit_floats(yt + c * ystride, rows);
      fence_proxy_async();
      mbar_arrive_tx(bar, bytes);
      bulk_copy(buf, xt - misalign(xt), 4u * unit_floats(xt, nx), bar);
      for (int c = 0; c < KY; ++c)
        if (on >> c & 1) {
          const float* yc = yt + c * ystride;
          bulk_copy(ybuf + c * (R + 4), yc - misalign(yc), 4u * unit_floats(yc, rows), bar);
        }
      bulk_copy(mbuf, mt - misalign(mt), 4u * unit_floats(mt, rows), bar);
    }
    mbar_arrive_cp_async(bar);
    return;
  }
  const bool x_bulk = bulk_ok(xt, nx), m_bulk = bulk_ok(mt, rows);
  if (threadIdx.x == 0) {
    unsigned bytes = (x_bulk ? 4u * nx : 0u) + (m_bulk ? 4u * rows : 0u);
    for (int c = 0; c < KY; ++c)
      if ((on >> c & 1) && bulk_ok(yt + c * ystride, rows)) bytes += 4u * rows;
    fence_proxy_async();
    mbar_arrive_tx(bar, bytes);
    if (x_bulk) bulk_copy(buf, xt, 4u * nx, bar);
    for (int c = 0; c < KY; ++c)
      if ((on >> c & 1) && bulk_ok(yt + c * ystride, rows))
        bulk_copy(ybuf + c * (R + 4), yt + c * ystride, 4u * rows, bar);
    if (m_bulk) bulk_copy(mbuf, mt, 4u * rows, bar);
  }
  if (!x_bulk) copy_tile(buf, xt, nx);
  for (int c = 0; c < KY; ++c)
    if ((on >> c & 1) && !bulk_ok(yt + c * ystride, rows))
      copy_tile(ybuf + c * (R + 4), yt + c * ystride, rows);
  if (!m_bulk) copy_tile(mbuf, mt, rows);
  mbar_arrive_cp_async(bar);
}

// The forward of one row: acc[i][c] += x_r . beta[:, i*cstride + c] over
// the features j = sf, sf + step, ... (bs: beta_s at the thread's first
// chunk; STEP: the stride when known at compile time, else step).
template <int KB, int NCH, int STEP>
__device__ __forceinline__ void row_dots(float (&acc)[NCH][KC], const float* xr, const float* bs,
                                         int cstride, int d, int sf, int step) {
  if (STEP) step = STEP;
#pragma unroll 4
  for (int j = sf; j < d; j += step) {
    const float xv = xr[j];
    const float* bj = bs + j * KB;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const float4 b = *reinterpret_cast<const float4*>(bj + i * cstride);
      acc[i][0] = fmaf(xv, b.x, acc[i][0]);
      acc[i][1] = fmaf(xv, b.y, acc[i][1]);
      acc[i][2] = fmaf(xv, b.z, acc[i][2]);
      acc[i][3] = fmaf(xv, b.w, acc[i][3]);
    }
  }
}

// Grid (blocks, P, class groups).  Block (b, p, z) takes classes
// [z*KB, z*KB + KB) of shard p (KB = 4*NCT), over the shard's row tiles b,
// b + blocks, ..., and writes their parts of its record
// bpart[(p*blocks + b)*K*(d + 1)]: for class k, (GRAD) g at k*(d+1) + j
// and f at k*(d+1) + d.  In the forward the S = 256/R threads of a row
// split the NCT chunks SC = NCT/NCH ways (NCH chunks a thread) and then
// the features SF = S/SC ways.  Class k's target is Y[k*ystride + p*m + i];
// ystride 0 (a shared target) stages one run a tile for all the classes.
template <typename Fam, int NCT, int NCH, bool GRAD>
__global__ void __launch_bounds__(T, 2) ovr_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ mask,
    const float* __restrict__ beta, const unsigned char* __restrict__ active, long long P,
    long long m, int d, int K, int R, int G, long long ystride, float* __restrict__ bpart) {
  constexpr int KB = KC * NCT, SC = NCT / NCH, PER_SC = T / SC;
  const int p = blockIdx.y, kbase = blockIdx.z * KB, nk = min(K - kbase, KB);
  unsigned on = 0;  // bit c: class kbase + c is computed
  for (int c = 0; c < nk; ++c)
    if (active[(long long)(kbase + c) * P + p]) on |= 1u << c;
  if (on == 0) return;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bar[STAGES];
  __shared__ float lred[KB * NW];  // (class, warp) loss sums
  constexpr int F = ovr_grad_feats(NCT);
  // the target runs a stage holds (KY), which run class c reads (c * ky),
  // and the runs to copy (yon: all of the block's on classes', or the one)
  const bool shared = ystride == 0;
  const int KY = ovr_target_runs(K, KB, shared), ky = shared ? 0 : 1;
  const unsigned yon = shared ? 1u : on;
  const int C = d + 1, KS = row_stride(KB), yoff = R * d + 4;
  const int stage_floats = (int)ovr_stage_floats(R, d, KY);
  float* beta_s = smem + (int)ovr_ring_floats(R, d, KY, G, KB);  // (d, KB)
  float* w_s = beta_s + d * KB;  // 2 x (R, KS): the weights of tile i in half i % 2
  // gradient: thread q*W + f (q < G) owns group q's features f, f + W, ...
  // (F of them) across all tiles; past W > T a thread a feature, per tile
  const int W = (d + F - 1) / F, q_own = threadIdx.x / W, f_own = threadIdx.x - q_own * W;
  const bool single = W <= T;

  // forward: thread (sc, r_own, sf) takes row r_own's chunks sc, sc + SC,
  // ... and its features sf, sf + SF, ...; sc is the same across a warp
  const int SF = T / R / SC, sc = threadIdx.x / PER_SC, rem = threadIdx.x - sc * PER_SC;
  const int r_own = rem / SF, sf = rem - r_own * SF;

  for (int e = threadIdx.x; e < d * KB; e += T) {
    const int j = e / KB, c = e - j * KB;
    beta_s[e] = (on >> c & 1) ? beta[((long long)(kbase + c) * P + p) * d + j] : 0.f;
  }
  for (int e = threadIdx.x; e < KB * NW; e += T) lred[e] = 0.f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar + s, T + 1);
    mbar_init_fence();
  }
  float* rec = bpart + ((long long)p * gridDim.x + blockIdx.x) * ((long long)K * C);
  if (GRAD && !single)
    for (int e = threadIdx.x; e < nk * d; e += T) {
      const int c = e / d, j = e - c * d;
      if (on >> c & 1) rec[(long long)(kbase + c) * C + j] = 0.f;
    }
  __syncthreads();

  const float* xl = x + (long long)p * m * d;
  const float* ml = mask + (long long)p * m;
  const float* yl = y + (long long)kbase * ystride + (long long)p * m;
  const long long ntiles = (m + R - 1) / R, step = gridDim.x, t0 = blockIdx.x;
  for (int i = 0; i < STAGES - 1; ++i) {
    const long long t = t0 + i * step;
    if (t < ntiles) {
      const int rows = (int)min((long long)R, m - t * R);
      stage_tile(smem + i * stage_floats, bar + i, xl + t * R * d, rows * d, yl + t * R, ystride,
                 ml + t * R, rows, R, KY, yoff, yon);
    }
  }
  // where a tile's rows sit in its stage: R*d and R are multiples of 4, so
  // each run's offset from its 16-byte boundary is the same in every tile
  const int x_at = misalign(xl), m_at = yoff + KY * (R + 4) + misalign(ml);
  const int y_mis = misalign(yl), ys_mis = (int)(ystride & 3);
  const float* bs = beta_s + sc * KC;

  // group q's first row: where 4 divides G, the groups of a warp (four at
  // W = 8) start G/4 rows apart, so that their x loads fall in distinct
  // banks (G = 32 at d = 29: 8 rows, 232 floats)
  const int q_row = G % 4 ? q_own : (q_own & 3) * (G >> 2) + (q_own >> 2);
  int x_off[F];  // feature f_own + i*W, or f_own itself past d (not kept)
#pragma unroll
  for (int i = 0; i < F; ++i) x_off[i] = f_own + i * W < d ? i * W : 0;

  float lsum[NCH][KC], gsum[F][NCT][KC];
#pragma unroll
  for (int i = 0; i < NCH; ++i)
#pragma unroll
    for (int c = 0; c < KC; ++c) lsum[i][c] = 0.f;
#pragma unroll
  for (int i = 0; i < F; ++i)
#pragma unroll
    for (int ch = 0; ch < NCT; ++ch)
#pragma unroll
      for (int c = 0; c < KC; ++c) gsum[i][ch][c] = 0.f;

  int s = 0, i = 0;
  unsigned parity = 0;
  for (long long t = t0; t < ntiles; t += step, ++i) {
    const int rows = (int)min((long long)R, m - t * R);
    const float* buf = smem + s * stage_floats;
    const float* xs = buf + x_at;
    float* wt = w_s + (i & 1) * R * KS;
    mbar_wait(bar + s, parity);

    // forward: the row's logits in registers (an off class has zero beta)
    float acc[NCH][KC];
#pragma unroll
    for (int u = 0; u < NCH; ++u)
#pragma unroll
      for (int c = 0; c < KC; ++c) acc[u][c] = 0.f;
    if (r_own < rows) {
      if (SF == 1)
        row_dots<KB, NCH, 1>(acc, xs + r_own * d, bs, SC * KC, d, 0, 1);
      else
        row_dots<KB, NCH, 0>(acc, xs + r_own * d, bs, SC * KC, d, sf, SF);
    }
    if (SF > 1) {
#pragma unroll
      for (int u = 0; u < NCH; ++u)
#pragma unroll
        for (int c = 0; c < KC; ++c)
          for (int o = 1; o < SF; o <<= 1)
            acc[u][c] += __shfl_xor_sync(0xffffffffu, acc[u][c], o);
    }
    // row terms where the logits are; the loss stays in registers
    if (sf == 0 && r_own < rows) {
      const float mv = buf[m_at + r_own];
#pragma unroll
      for (int u = 0; u < NCH; ++u) {
        const int k0 = (sc + u * SC) * KC;
        float w[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int k = k0 + c;
          const bool kon = on >> k & 1;
          const float yv = buf[yoff + k * ky * (R + 4) + ((y_mis + k * ys_mis) & 3) + r_own];
          const RowTerms rt = Fam::terms(acc[u][c], yv, mv);
          lsum[u][c] += kon ? rt.loss : 0.f;
          w[c] = kon ? rt.w : 0.f;
        }
        if (GRAD)
          *reinterpret_cast<float4*>(wt + r_own * KS + k0) = make_float4(w[0], w[1], w[2], w[3]);
      }
    }
    __syncthreads();  // the weights are in; the previous tile's stage is free

    const long long tn = t + (STAGES - 1) * step;
    if (tn < ntiles) {
      const int sn = s == 0 ? STAGES - 1 : s - 1, rn = (int)min((long long)R, m - tn * R);
      stage_tile(smem + sn * stage_floats, bar + sn, xl + tn * R * d, rn * d, yl + tn * R,
                 ystride, ml + tn * R, rn, R, KY, yoff, yon);
    }

    // gradient: group q over rows q_row, q_row + G, ..., F features and
    // all the block's classes a thread
    if (GRAD && single && q_own < G) {
      const float* xq = xs + q_row * d + f_own;
      const float* wq = wt + q_row * KS;
      const int n = rows > q_row ? (rows - q_row + G - 1) / G : 0, xstep = G * d, wstep = G * KS;
#pragma unroll 1
      for (int u = 0; u < n; ++u) {
        const float* xr = xq + u * xstep;
        float xv[F];
#pragma unroll
        for (int i = 0; i < F; ++i) xv[i] = xr[x_off[i]];
#pragma unroll
        for (int ch = 0; ch < NCT; ++ch) {
          const float4 w = *reinterpret_cast<const float4*>(wq + u * wstep + ch * KC);
#pragma unroll
          for (int i = 0; i < F; ++i) {
            gsum[i][ch][0] = fmaf(w.x, xv[i], gsum[i][ch][0]);
            gsum[i][ch][1] = fmaf(w.y, xv[i], gsum[i][ch][1]);
            gsum[i][ch][2] = fmaf(w.z, xv[i], gsum[i][ch][2]);
            gsum[i][ch][3] = fmaf(w.w, xv[i], gsum[i][ch][3]);
          }
        }
      }
    } else if (GRAD && !single) {
      for (int j = threadIdx.x; j < d; j += T) {
        float a[NCT][KC];
#pragma unroll
        for (int ch = 0; ch < NCT; ++ch)
#pragma unroll
          for (int c = 0; c < KC; ++c) a[ch][c] = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float xv = xs[r * d + j];
#pragma unroll
          for (int ch = 0; ch < NCT; ++ch) {
            const float4 w = *reinterpret_cast<const float4*>(wt + r * KS + ch * KC);
            a[ch][0] = fmaf(w.x, xv, a[ch][0]);
            a[ch][1] = fmaf(w.y, xv, a[ch][1]);
            a[ch][2] = fmaf(w.z, xv, a[ch][2]);
            a[ch][3] = fmaf(w.w, xv, a[ch][3]);
          }
        }
#pragma unroll
        for (int ch = 0; ch < NCT; ++ch)
#pragma unroll
          for (int c = 0; c < KC; ++c)
            if (on >> (ch * KC + c) & 1) rec[(long long)(kbase + ch * KC + c) * C + j] += a[ch][c];
      }
    }
    if (++s == STAGES) {
      s = 0;
      parity ^= 1;
    }
  }

  // the loss: a fixed shuffle tree a warp (its lanes hold the same
  // classes), then the warps in order, the others' zeros between (the
  // same in both variants, so f has the same bits)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < NCH; ++u)
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      float v = lsum[u][c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) lred[((sc + u * SC) * KC + c) * NW + warp] = v;
    }
  float* gred = smem;  // (G, KB, d), over the ring
  if (GRAD && single) {
    __syncthreads();  // every thread is past its last tile: the ring is free
    if (q_own < G) {
#pragma unroll
      for (int i = 0; i < F; ++i) {
        if (f_own + i * W >= d) continue;
#pragma unroll
        for (int ch = 0; ch < NCT; ++ch)
#pragma unroll
          for (int c = 0; c < KC; ++c)
            gred[(q_own * KB + ch * KC + c) * d + f_own + i * W] = gsum[i][ch][c];
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < nk; c += T) {
    if (!(on >> c & 1)) continue;
    float sum = 0.f;
    for (int w = 0; w < NW; ++w) sum += lred[c * NW + w];
    rec[(long long)(kbase + c) * C + d] = sum;
  }
  if (GRAD && single)
    for (int e = threadIdx.x; e < nk * d; e += T) {
      const int c = e / d, j = e - c * d;
      if (!(on >> c & 1)) continue;
      float sum = 0.f;
      for (int q = 0; q < G; ++q) sum += gred[(q * KB + c) * d + j];
      rec[(long long)(kbase + c) * C + j] = sum;
    }
}

// ------------------------------------------ the tensor-core path (MN, OvR)

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

// The 3-pass split product c += a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, the
// small terms first (a_lo*b_lo, below 2^-22 |a||b|, is left out).
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], const unsigned (&bh)[2],
                                     const unsigned (&bl)[2]) {
  mma8(c, al, bh[0], bh[1]);
  mma8(c, ah, bl[0], bl[1]);
  mma8(c, ah, bh[0], bh[1]);
}

// The row stride of a warp's (16, SW) weight slab: an odd number of 8-float
// runs, so that both its float2 stores (a row a quad) and its fragment
// loads (8 classes of 4 rows) fall on 32 distinct banks.
__host__ __device__ constexpr int tc_slab_stride(int nn) { return nn % 2 ? 8 * nn : 8 * nn + 8; }

// Floats of tc_kernel's dynamic shared memory: the ring of S tiles (R*d + 4
// floats of x, then the target and the mask run, R + 4 each), then a (16, SW)
// weight slab a warp.  After the tile loop the ring holds the warps'
// (NW, d, K) gradient totals.
long long tc_floats(int R, int d, int nn, int S) {
  return S * ovr_stage_floats(R, d, 1) + (long long)NW * 16 * tc_slab_stride(nn);
}

// The per-lane constants of a warp's 16-row groups (g = lane / 4, t = lane % 4).
template <int NKS>
struct TcLane {
  static constexpr int NMT = (NKS + 1) / 2;  // 16-feature tiles of the gradient
  int xa;          // forward: row g, feature t
  int lo, hi;      // forward's last k-step: features 8*(NKS-1) + t (+ 4),
                   // clamped below d, less t
  bool lo_ok, hi_ok;
  int gx[NMT][2];  // gradient: features 16*mt + g (+ 8), clamped below d
};

// The row terms of tc_kernel: how a warp's 16-row group turns its logits
// acc[n][2r + c] (row g + 8r, class or lane 8n + 2t + c) into the losses it
// adds to lsum and (GRAD) the weights w, in the same layout.  lab and msk:
// the group's targets and mask; va, vb: rows g and g + 8 are in the tile;
// on: bit k, lane k is computed (OvR).  GRAD3: at one n-tile the
// gradient's three passes go to three accumulators, where the terms make a
// group compute-bound and a shorter chain of products pays (on an H100,
// multiclass_variants.py: the logistic value and gradient at L = 8 0.434
// ms against 0.459-0.461 with one accumulator, `one_gacc`; the Normal one
// at L = 5 0.340 against 0.352-0.353 with three, `three_gacc`).

// K2-MN: the softmax of a row's classes, which lie on the four lanes of its
// quad; one loss a shard, in lsum[0][0].
struct Softmax {
  static constexpr bool PER_LANE = false, GRAD3 = false;
  template <int NN, bool GRAD>
  __device__ __forceinline__ static void rows(const float (&acc)[NN][4], const float* lab,
                                              const float* msk, bool va, bool vb, int K,
                                              unsigned, float (&w)[NN][4],
                                              float (&lsum)[NN][2]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    // a row's max and sum of exps are two xor-shuffles each; one __expf a
    // class, reused for the weights mask*(e/sum - onehot)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float yv = lab[g + 8 * r];
      const float mv = (r ? vb : va) ? msk[g + 8 * r] : 0.f;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (8 * n + 2 * t + c < K) mx = fmaxf(mx, acc[n][2 * r + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float e[NN][2], sum = 0.f;
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          e[n][c] = 8 * n + 2 * t + c < K ? __expf(acc[n][2 * r + c] - mx) : 0.f;
          sum += e[n][c];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float lse = mx + __logf(sum);
      const int cy = class_index(yv, K);
      // the row's loss mask*(lse - eta_y) on the lane that holds class y
      // (lane t = 0 where y picks no class)
      bool own = cy < 0 && t == 0;
      float picked = 0.f;
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (8 * n + 2 * t + c == cy) {
            picked = acc[n][2 * r + c];
            own = true;
          }
      if (own) lsum[0][0] = fmaf(mv, lse - picked, lsum[0][0]);
      if (GRAD) {
        const float inv = __frcp_rn(sum);
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int k = 8 * n + 2 * t + c;
            w[n][2 * r + c] = k < K ? mv * (e[n][c] * inv - (k == cy ? 1.f : 0.f)) : 0.f;
          }
      }
    }
  }
};

// K2-OvR over one shared target: family Fam's terms of each (row, lane),
// as ovr_kernel computes them; a loss a lane, lane 8n + 2t + c's in
// lsum[n][c].  An off lane (and a padded one, past K) adds no loss and gets
// weight 0; a row past the tile reads target and mask 0 (its x is zeros).
template <typename Fam>
struct PerLane {
  static constexpr bool PER_LANE = true, GRAD3 = Fam::LONG;
  template <int NN, bool GRAD>
  __device__ __forceinline__ static void rows(const float (&acc)[NN][4], const float* lab,
                                              const float* msk, bool va, bool vb, int,
                                              unsigned on, float (&w)[NN][4],
                                              float (&lsum)[NN][2]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool v = r ? vb : va;
      const float yv = v ? lab[g + 8 * r] : 0.f;
      const float mv = v ? msk[g + 8 * r] : 0.f;
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool kon = on >> (8 * n + 2 * t + c) & 1;
          const RowTerms rt = Fam::terms(acc[n][2 * r + c], yv, mv);
          lsum[n][c] += kon ? rt.loss : 0.f;
          if (GRAD) w[n][2 * r + c] = kon ? rt.w : 0.f;
        }
    }
  }
};

// One 16-row group of tc_kernel, a warp: the forward eta = x.B on the tensor
// cores, the row terms (Terms) in the registers that hold the logits, and
// (GRAD) G += x^T.W, the split's three passes into G[0] (GP = 1) or into
// G[0], G[1], G[2] (GP = 3).  x (16, d) rows of the stage at xg, their
// targets at lab and mask at msk; FULL: all 16 rows are in the tile, else
// the rows from nrows on are taken as zeros with mask 0.
template <typename Terms, int NKS, int NN, int GP, bool GRAD, bool FULL>
__device__ __forceinline__ void tc_group(const float* xg, const float* lab, const float* msk,
                                         int d, int K, unsigned on, int nrows,
                                         const TcLane<NKS>& L, const unsigned (&bh)[NKS][NN][2],
                                         const unsigned (&bl)[NKS][NN][2], float* slab,
                                         float (&G)[GP][TcLane<NKS>::NMT][NN][4],
                                         float (&lsum)[NN][2]) {
  constexpr int NMT = TcLane<NKS>::NMT, SW = tc_slab_stride(NN);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool va = FULL || g < nrows, vb = FULL || g + 8 < nrows;

  // forward: A = rows (g, g + 8) x features (t, t + 4) of each k-step; the
  // three passes in three accumulators, so that no product waits on another
  float acc[NN][4], acc_hl[NN][4], acc_lh[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = acc_hl[n][c] = acc_lh[n][c] = 0.f;
  const float* xa = xg + L.xa;
  const float* xb = xa + 8 * d;
#pragma unroll
  for (int s = 0; s < NKS; ++s) {
    float v[4];
    if (s < NKS - 1) {
      v[0] = xa[8 * s];
      v[1] = xb[8 * s];
      v[2] = xa[8 * s + 4];
      v[3] = xb[8 * s + 4];
    } else {  // past d: zeros (beta's rows there are zeros too)
      v[0] = L.lo_ok ? xa[L.lo] : 0.f;
      v[1] = L.lo_ok ? xb[L.lo] : 0.f;
      v[2] = L.hi_ok ? xa[L.hi] : 0.f;
      v[3] = L.hi_ok ? xb[L.hi] : 0.f;
    }
    if (!FULL) {
      v[0] = va ? v[0] : 0.f;
      v[2] = va ? v[2] : 0.f;
      v[1] = vb ? v[1] : 0.f;
      v[3] = vb ? v[3] : 0.f;
    }
    unsigned ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(v[i], ah[i], al[i]);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      mma8(acc_lh[n], al, bh[s][n][0], bh[s][n][1]);
      mma8(acc_hl[n], ah, bl[s][n][0], bl[s][n][1]);
      mma8(acc[n], ah, bh[s][n][0], bh[s][n][1]);
    }
  }
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] += acc_lh[n][c] + acc_hl[n][c];

  // row terms where the logits are: acc[n][2r + c] is row g + 8r's logit of
  // class 8n + 2t + c
  float w[NN][4];
  Terms::template rows<NN, GRAD>(acc, lab, msk, va, vb, K, on, w, lsum);
  if (!GRAD) return;

  // the weights from the accumulator layout to the B operand's, through
  // the warp's slab: B (8 rows, 8 classes) of k-step ks holds rows
  // 8*ks + t and 8*ks + t + 4 of class 8n + g
  __syncwarp();  // the previous group's slab loads are done
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    *reinterpret_cast<float2*>(slab + g * SW + 8 * n + 2 * t) = make_float2(w[n][0], w[n][1]);
    *reinterpret_cast<float2*>(slab + (g + 8) * SW + 8 * n + 2 * t) =
        make_float2(w[n][2], w[n][3]);
  }
  __syncwarp();
  unsigned wh[2][NN][2], wl[2][NN][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        split_tf32(slab[(8 * ks + t + 4 * i) * SW + 8 * n + g], wh[ks][n][i], wl[ks][n][i]);

  // gradient: A = x^T, features (g, g + 8) of each 16-feature tile x rows
  // (t, t + 4) of each k-step; features past d land in G's rows past d,
  // which are never written out
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int r0 = 8 * ks + t;
    const float* x0 = xg + r0 * d;
    const float* x1 = x0 + 4 * d;
    const bool v0 = FULL || r0 < nrows, v1 = FULL || r0 + 4 < nrows;
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt) {
      float v[4] = {x0[L.gx[mt][0]], x0[L.gx[mt][1]], x1[L.gx[mt][0]], x1[L.gx[mt][1]]};
      if (!FULL) {
        v[0] = v0 ? v[0] : 0.f;
        v[1] = v0 ? v[1] : 0.f;
        v[2] = v1 ? v[2] : 0.f;
        v[3] = v1 ? v[3] : 0.f;
      }
      unsigned ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], ah[i], al[i]);
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        if constexpr (GP == 3) {
          mma8(G[0][mt][n], al, wh[ks][n][0], wh[ks][n][1]);
          mma8(G[1][mt][n], ah, wl[ks][n][0], wl[ks][n][1]);
          mma8(G[2][mt][n], ah, wh[ks][n][0], wh[ks][n][1]);
        } else {
          mma3(G[0][mt][n], ah, al, wh[ks][n], wl[ks][n]);
        }
      }
    }
  }
}

// Grid (blocks, P).  Block b of shard p takes the shard's row tiles b,
// b + blocks, ... (R rows each, 16 a group, group q of a tile to warp
// q % NW) through a ring of S stages, and writes its record
// bpart[(p*blocks + b)*K*(d + 1)]: (GRAD) g of class or lane k at
// k*(d+1) + j, and at k*(d+1) + d the loss (K2-MN: one, at k = 0).
// NKS = ceil(d/8) k-steps of the forward, NN = ceil(K/8) n-tiles of 8
// classes or lanes.  K2-MN (Terms = Softmax): B_p is beta[p] read as (d, K),
// y the class indices.  K2-OvR over one shared target (PerLane<Fam>): B_p's
// column k is lane k*P + p of beta (K*P, d), zeros where that lane is off,
// and y the one target, (P, m).
template <typename Terms, int NKS, int NN, bool GRAD>
__global__ void __launch_bounds__(T, 2) tc_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ mask,
    const float* __restrict__ beta, const unsigned char* __restrict__ active, long long P,
    long long m, int d, int K, int R, int S, float* __restrict__ bpart) {
  constexpr int NMT = TcLane<NKS>::NMT, SW = tc_slab_stride(NN);
  constexpr int MODE = Terms::PER_LANE ? OVR : MN;
  // the shared-target path stages every run by bulk copy (K2-MN keeps its
  // staging: on an H100 this made its K = 4 value and gradient 0.602-0.603
  // ms against 0.576-0.582, multiclass_variants.py's `mn_bulk`)
  constexpr bool ANY = Terms::PER_LANE;
  constexpr int GP = Terms::GRAD3 && NN == 1 ? 3 : 1;
  const int p = blockIdx.y;
  unsigned on = 0;  // bit k: class or lane k is computed
  if (MODE == MN) {
    if (!active[p]) return;
    on = ~0u;
  } else {
    for (int k = 0; k < K; ++k)
      if (active[(long long)k * P + p]) on |= 1u << k;
    if (on == 0) return;
  }
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bar[TC_MAX_STAGES];
  __shared__ float lred[(Terms::PER_LANE ? 8 * NN : 1) * NW];  // (loss, warp) sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int C = d + 1, yoff = R * d + 4, stage_floats = (int)ovr_stage_floats(R, d, 1);
  float* slab = smem + S * stage_floats + warp * 16 * SW;

  // B_p (d, K): its B fragments, split, in registers for the whole block
  // (zeros past d, past K and in an off lane's column)
  unsigned bh[NKS][NN][2], bl[NKS][NN][2];
#pragma unroll
  for (int s = 0; s < NKS; ++s)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = 8 * s + t + 4 * i, k = 8 * n + g;
        const bool kon = j < d && k < K && (on >> k & 1);
        split_tf32(kon ? beta[beta_at<MODE>(P, p, d, K, k, j)] : 0.f, bh[s][n][i], bl[s][n][i]);
      }
  TcLane<NKS> L;
  L.xa = g * d + t;
  L.lo = min(8 * (NKS - 1) + t, d - 1) - t;
  L.hi = min(8 * (NKS - 1) + t + 4, d - 1) - t;
  L.lo_ok = 8 * (NKS - 1) + t < d;
  L.hi_ok = 8 * (NKS - 1) + t + 4 < d;
#pragma unroll
  for (int mt = 0; mt < NMT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) L.gx[mt][i] = min(16 * mt + g + 8 * i, d - 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bar + s, T + 1);
    mbar_init_fence();
  }
  __syncthreads();

  const float* xl = x + (long long)p * m * d;
  const float* yl = y + (long long)p * m;
  const float* ml = mask + (long long)p * m;
  const long long ntiles = (m + R - 1) / R, step = gridDim.x, t0 = blockIdx.x;
  for (int i = 0; i < S; ++i) {
    const long long tt = t0 + i * step;
    if (tt < ntiles) {
      const int rows = (int)min((long long)R, m - tt * R);
      stage_tile<ANY>(smem + i * stage_floats, bar + i, xl + tt * R * d, rows * d, yl + tt * R,
                      0, ml + tt * R, rows, R, 1, yoff, 1u);
    }
  }
  // where a tile's runs sit in its stage: R*d and R are multiples of 4, so
  // each run's offset from its 16-byte boundary is the same in every tile
  const int x_at = misalign(xl), y_at = yoff + misalign(yl), m_at = yoff + R + 4 + misalign(ml);
  const int groups = R / 16;

  // the gradient: each tile's product on the tensor cores starts from zero
  // (Gt) and is added to G on the CUDA cores, since the tensor cores round
  // their float32 sums toward zero, a bias that would build up over a
  // block's rows
  float G[NMT][NN][4], Gt[GP][NMT][NN][4], lsum[NN][2];
#pragma unroll
  for (int mt = 0; mt < NMT; ++mt)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) G[mt][n][c] = 0.f;
#pragma unroll
  for (int n = 0; n < NN; ++n) lsum[n][0] = lsum[n][1] = 0.f;

  int s = 0;
  unsigned parity = 0;
  for (long long tt = t0; tt < ntiles; tt += step) {
    const int rows = (int)min((long long)R, m - tt * R);
    const float* buf = smem + s * stage_floats;
    mbar_wait(bar + s, parity);
#pragma unroll
    for (int i = 0; i < GP; ++i)
#pragma unroll
      for (int mt = 0; mt < NMT; ++mt)
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) Gt[i][mt][n][c] = 0.f;
#pragma unroll 1
    for (int q = warp; q < groups; q += NW) {
      const int r0 = 16 * q;
      if (r0 >= rows) break;
      const float *xg = buf + x_at + r0 * d, *lab = buf + y_at + r0, *msk = buf + m_at + r0;
      if (r0 + 16 <= rows)
        tc_group<Terms, NKS, NN, GP, GRAD, true>(xg, lab, msk, d, K, on, 16, L, bh, bl, slab,
                                                 Gt, lsum);
      else
        tc_group<Terms, NKS, NN, GP, GRAD, false>(xg, lab, msk, d, K, on, rows - r0, L, bh, bl,
                                                  slab, Gt, lsum);
    }
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt)
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)  // the small passes first
          G[mt][n][c] += GP == 3 ? Gt[2][mt][n][c] + (Gt[0][mt][n][c] + Gt[1][mt][n][c])
                                 : Gt[0][mt][n][c];
    __syncthreads();  // no warp reads this stage any more: the next copy goes into it
    const long long tn = tt + S * step;
    if (tn < ntiles) {
      const int rn = (int)min((long long)R, m - tn * R);
      stage_tile<ANY>(smem + s * stage_floats, bar + s, xl + tn * R * d, rn * d, yl + tn * R,
                      0, ml + tn * R, rn, R, 1, yoff, 1u);
    }
    if (++s == S) {
      s = 0;
      parity ^= 1;
    }
  }

  // the losses: a fixed shuffle tree a warp, then the warps in order (the
  // same in both variants, so f has the same bits).  K2-MN's one loss is
  // spread over all 32 lanes; K2-OvR's lane 8n + 2t + c over the eight
  // lanes of one t
  if constexpr (Terms::PER_LANE) {
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = lsum[n][c];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        const int k = 8 * n + 2 * t + c;
        if (g == 0 && k < K) lred[k * NW + warp] = v;
      }
  } else {
    float v = lsum[0][0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) lred[warp] = v;
  }
  float* rec = bpart + ((long long)p * gridDim.x + blockIdx.x) * ((long long)K * C);
  float* gred = smem;  // (NW, d, K), over the ring: every tile's copy has landed
  if (GRAD) {
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt)
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 16 * mt + g + 8 * (c >> 1), k = 8 * n + 2 * t + (c & 1);
          if (j < d && k < K) gred[(warp * d + j) * K + k] = G[mt][n][c];
        }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < (Terms::PER_LANE ? K : 1); k += T) {
    if (!(on >> k & 1)) continue;
    float sum = 0.f;
    for (int w = 0; w < NW; ++w) sum += lred[k * NW + w];
    rec[k * C + d] = sum;
  }
  if (GRAD)
    for (int e = threadIdx.x; e < d * K; e += T) {
      const int j = e / K, k = e - j * K;
      if (!(on >> k & 1)) continue;
      float sum = 0.f;
      for (int w = 0; w < NW; ++w) sum += gred[(w * d + j) * K + k];
      rec[k * C + j] = sum;
    }
}

// Past tc_kernel's registers (d > TC_MAX_D or K > TC_MAX_K): the first
// design.  A block stages R whole rows with 16-byte cp.async,
// double-buffered; beta and the (row, class) tables keep the classes padded
// to float4s (the tables' row stride an odd number of float4s).
// Floats of its dynamic shared memory, in the order laid out.
long long staged_floats(int d, int K, int R, int G, int GL) {
  return 2LL * (R * (long long)d + 4) + d * (long long)padded(K) + 2LL * R * row_stride(K) + R +
         (long long)G * K * d + GL;
}

// Grid (blocks, P).  Block b of shard p takes the shard's row tiles b,
// b + blocks, ... and writes its record as tc_kernel does.  Forward: S =
// 256/R threads a row, KC classes at a time in registers, joined by an
// xor-shuffle tree into the (row, class) table; a thread a row for the
// softmax terms; the gradient a (row group, feature) owner with KC classes
// in registers a tile, added to shared-memory totals; the loss its own row
// groups in both variants.
template <bool GRAD>
__global__ void __launch_bounds__(T) tiled_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ mask,
    const float* __restrict__ beta, const unsigned char* __restrict__ active, long long P,
    long long m, int d, int K, int R, int G, int GL, float* __restrict__ bpart) {
  const int p = blockIdx.y;
  if (!active[p]) return;
  extern __shared__ __align__(16) float smem[];
  const int C = d + 1, KP = padded(K), KS = row_stride(K);
  const int tile_floats = R * d + 4;
  // every offset here is a multiple of 4 floats
  float* beta_s = smem + 2 * tile_floats;  // (d, KP)
  float* w_s = beta_s + d * KP;            // (R, KS): the logits, then the weights
  float* ly_s = w_s + R * KS;              // (R,): the labels, then the losses
  float* m_s = ly_s + R * KS;              // R
  float* gacc = m_s + R;                   // (G, K, d) gradient totals
  float* lacc = gacc + G * K * d;          // (GL,) loss totals

  const int S = T / R, r_own = threadIdx.x / S, s_own = threadIdx.x - r_own * S;
  for (int e = threadIdx.x; e < KP * d; e += T) {
    const int k = e % KP, j = e / KP;
    beta_s[j * KP + k] = k < K ? beta[((long long)p * d + j) * K + k] : 0.f;
  }
  if (GRAD)
    for (int e = threadIdx.x; e < G * K * d; e += T) gacc[e] = 0.f;
  for (int e = threadIdx.x; e < GL; e += T) lacc[e] = 0.f;
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
    for (int r = threadIdx.x; r < rows; r += T) ly_s[r] = y[(long long)p * m + r0 + r];
    for (int r = threadIdx.x; r < rows; r += T) m_s[r] = ml[r0 + r];
    cp_async_wait_prior();
    __syncthreads();
    const float* xs = smem + cur * tile_floats + misalign(xl + r0 * d);

    // forward: the (row, class) logits, S threads a row, KC classes at a time
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

    // row terms: the row's loss and weights
    for (int r = threadIdx.x; r < rows; r += T)
      ly_s[r] = softmax_terms(w_s + r * KS, K, ly_s[r], m_s[r]);
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
    // loss: thread q over rows q, q + GL, ...; the same in both variants,
    // so f has the same bits
    for (int q = threadIdx.x; q < GL; q += T) {
      float acc = 0.f;
      for (int r = q; r < rows; r += GL) acc += ly_s[r];
      lacc[q] += acc;
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
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int q = 0; q < GL; ++q) s += lacc[q];
    rec[d] = s;
  }
}

// Large d*K: block b of shard p takes rows b, b + blocks, ...; each row's
// logits are dotted a warp a class, its terms computed (OvR: by Fam, class
// k's target at Y[k*ystride + p*m + r]), and its contribution added to the
// block's record in global memory (each element by one thread, in row
// order).  Dynamic shared memory: 3*K floats.
template <int MODE, typename Fam, bool GRAD>
__global__ void __launch_bounds__(T) row_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ mask,
    const float* __restrict__ beta, const unsigned char* __restrict__ active, long long P,
    long long m, int d, int K, long long ystride, float* __restrict__ bpart) {
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
        if (class_on<MODE>(active, P, p, k)) y_s[k] = y[(long long)k * ystride + p * m + r];
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
        const RowTerms rt = Fam::terms(e_s[k], y_s[k], mv);
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

// K2-MN: for each active shard, f and (grad) g summed over the shard's
// block records, a warp an element: lane l takes records l, l + 32, ... in
// order, then a fixed xor-shuffle tree.  Grid (ceil(K*(d+1)/NW), P).
__global__ void __launch_bounds__(T) mn_finalize_kernel(const float* __restrict__ bpart,
                                                        const unsigned char* __restrict__ active,
                                                        int blocks, int d, int K, int grad,
                                                        float* __restrict__ f,
                                                        float* __restrict__ g) {
  const int p = blockIdx.y, C = d + 1, e = blockIdx.x * NW + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31, k = e / C, j = e - k * C;
  if (e >= K * C || !active[p] || (j == d ? k > 0 : !grad)) return;  // warp-uniform
  const long long rec = (long long)K * C;
  const float* shard = bpart + (long long)p * blocks * rec + e;
  float s = 0.f;
  for (int b = lane; b < blocks; b += 32) s += shard[b * rec];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) {
    if (j == d)
      f[p] = s;
    else
      g[((long long)p * d + j) * K + k] = s;
  }
}

// K2-OvR: for each active lane, f and (grad) g summed over the shard's
// block records, in block order.  Grid (ceil(K*(d+1)/256), P).
__global__ void finalize_kernel(const float* __restrict__ bpart,
                                const unsigned char* __restrict__ active, long long P, int blocks,
                                int d, int K, int grad, float* __restrict__ f,
                                float* __restrict__ g) {
  const int p = blockIdx.y, C = d + 1;
  const long long rec = (long long)K * C;
  const float* shard = bpart + (long long)p * blocks * rec;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < K * C; e += gridDim.x * blockDim.x) {
    const int k = e / C, j = e - k * C;
    const long long l = (long long)k * P + p;
    if (!active[l]) continue;
    if (j != d && !grad) continue;
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += shard[(long long)b * rec + e];
    if (j == d)
      f[l] = s;
    else
      g[l * d + j] = s;
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

// The fewer blocks a SM of the two variants of a kernel.
template <typename KernGrad, typename KernValue>
cudaError_t occupancy2(KernGrad kg, KernValue kv, int dev, size_t smem, int* per_sm) {
  int ps_grad = 0, ps_value = 0;
  cudaError_t err = occupancy(kg, dev, smem, &ps_grad);
  if (err != cudaSuccess) return err;
  if ((err = occupancy(kv, dev, smem, &ps_value)) != cudaSuccess) return err;
  *per_sm = ps_grad < ps_value ? ps_grad : ps_value;
  return cudaSuccess;
}

// The tiled path's rows a tile, the largest power of two from T down to
// MIN_R whose shared memory fits the mode's budget (0: none does), and
// its gradient row groups.  OvR's stage holds one target run where the
// target is shared.
int tile_rows(int mode, int d, int K, bool shared, int* G) {
  const int f = mode == OVR ? ovr_grad_feats(ovr_chunks(K)) : 1;
  for (int r = T; r >= MIN_R; r >>= 1) {
    const int g = row_groups((d + f - 1) / f, r);
    const long long bytes = mode == OVR ? 4 * ovr_floats(r, d, K, g, shared)
                                        : 4 * staged_floats(d, K, r, g, row_groups(1, r));
    if (bytes <= (mode == OVR ? OVR_BUDGET : SMEM_BUDGET)) {
      *G = g;
      return r;
    }
  }
  return 0;
}

typedef void (*OvrKern)(const float*, const float*, const float*, const float*,
                        const unsigned char*, long long, long long, int, int, int, int, long long,
                        float*);

// The ovr_kernel instance of family Fam for nct chunks a block and R rows a
// tile: the 256/R threads of a row split the chunks min(256/R, nct) ways.
template <typename Fam, bool GRAD>
OvrKern ovr_instance(int nct, int R) {
  const int sc = T / R < nct ? T / R : nct, nch = nct / sc;
  if (nct == 1) return ovr_kernel<Fam, 1, 1, GRAD>;
  if (nct == 2) return nch == 1 ? ovr_kernel<Fam, 2, 1, GRAD> : ovr_kernel<Fam, 2, 2, GRAD>;
  return nch == 1 ? ovr_kernel<Fam, 4, 1, GRAD>
                  : (nch == 2 ? ovr_kernel<Fam, 4, 2, GRAD> : ovr_kernel<Fam, 4, 4, GRAD>);
}

typedef void (*TcKern)(const float*, const float*, const float*, const float*,
                       const unsigned char*, long long, long long, int, int, int, int, float*);

// The tc_kernel instance of row terms Terms for d features and K classes or
// lanes (d <= TC_MAX_D, K <= TC_MAX_K): ceil(d/8) k-steps, ceil(K/8) n-tiles.
template <typename Terms, bool GRAD>
TcKern tc_instance(int d, int K) {
  static const TcKern one[4] = {tc_kernel<Terms, 1, 1, GRAD>, tc_kernel<Terms, 2, 1, GRAD>,
                                tc_kernel<Terms, 3, 1, GRAD>, tc_kernel<Terms, 4, 1, GRAD>};
  static const TcKern two[4] = {tc_kernel<Terms, 1, 2, GRAD>, tc_kernel<Terms, 2, 2, GRAD>,
                                tc_kernel<Terms, 3, 2, GRAD>, tc_kernel<Terms, 4, 2, GRAD>};
  return (K + 7) / 8 == 1 ? one[(d + 7) / 8 - 1] : two[(d + 7) / 8 - 1];
}

// The tensor-core path's plan (tc_kernel with row terms Terms, as plan
// path `path`): 256-row tiles (two 16-row groups a warp) where three of
// them fit the budget, else 128; as many stages as fit.
template <typename Terms>
cudaError_t plan_tc(int dev, long long m, int d, int K, long long path, Plan* p,
                    long long* units, int* per_sm) {
  const int nn = (K + 7) / 8;
  const long long slab = 4LL * NW * 16 * tc_slab_stride(nn);
  int R = 2 * 16 * NW;
  if ((TC_BUDGET - slab) / (4 * ovr_stage_floats(R, d, 1)) < 3) R /= 2;
  const long long S = (TC_BUDGET - slab) / (4 * ovr_stage_floats(R, d, 1));
  p->path = path;
  p->R = R;
  p->G = S < TC_MAX_STAGES ? S : TC_MAX_STAGES;
  p->aux = nn;
  p->smem = 4 * tc_floats(R, d, nn, (int)p->G);
  *units = (m + R - 1) / R;
  return occupancy2(tc_instance<Terms, true>(d, K), tc_instance<Terms, false>(d, K), dev,
                    (size_t)p->smem, per_sm);
}

// OvR's plan for family Fam: over one shared target of at most TC_MAX_D
// features and TC_MAX_K lanes tc_kernel; else ovr_kernel where a tile fits,
// else row_kernel.
template <typename Fam>
cudaError_t plan_ovr(int dev, long long m, int d, int K, bool shared, Plan* p, long long* units,
                     int* per_sm) {
  if (shared && d <= TC_MAX_D && K <= TC_MAX_K)
    return plan_tc<PerLane<Fam>>(dev, m, d, K, 3, p, units, per_sm);
  int G = 1;
  const int R = tile_rows(OVR, d, K, shared, &G);
  p->G = G;
  if (R > 0) {
    const int nct = ovr_chunks(K);
    p->path = 0;
    p->R = R;
    p->aux = nct;
    p->smem = 4 * ovr_floats(R, d, K, G, shared);
    *units = (m + R - 1) / R;
    return occupancy2(ovr_instance<Fam, true>(nct, R), ovr_instance<Fam, false>(nct, R), dev,
                      (size_t)p->smem, per_sm);
  }
  p->path = 1;
  p->R = 1;
  p->aux = 1;
  p->smem = 3 * sizeof(float) * (long long)K;
  *units = m;
  return occupancy2(row_kernel<OVR, Fam, true>, row_kernel<OVR, Fam, false>, dev,
                    (size_t)p->smem, per_sm);
}

cudaError_t plan_mode(int mode, int family, int dev, long long m, int d, int K, bool shared,
                      Plan* p, long long* units, int* per_sm) {
  if (mode == OVR)
    return family == NORMAL ? plan_ovr<Normal>(dev, m, d, K, shared, p, units, per_sm)
                            : plan_ovr<Logistic>(dev, m, d, K, shared, p, units, per_sm);
  if (d <= TC_MAX_D && K <= TC_MAX_K)
    return plan_tc<Softmax>(dev, m, d, K, 2, p, units, per_sm);
  cudaError_t err;
  int G = 1;
  const int R = tile_rows(MN, d, K, false, &G);
  p->G = G;
  if (R > 0) {
    p->path = 0;
    p->R = R;
    p->aux = row_groups(1, R);
    p->smem = 4 * staged_floats(d, K, R, G, (int)p->aux);
    err = occupancy2(tiled_kernel<true>, tiled_kernel<false>, dev, (size_t)p->smem, per_sm);
    *units = (m + R - 1) / R;
  } else {
    p->path = 1;
    p->R = 1;
    p->aux = 1;
    p->smem = 3 * sizeof(float) * (long long)K;
    err = occupancy2(row_kernel<MN, Logistic, true>, row_kernel<MN, Logistic, false>, dev,
                     (size_t)p->smem, per_sm);
    *units = m;
  }
  return err;
}

// Class groups along grid z: ovr_kernel's blocks take 4*aux classes each.
int class_groups(int mode, const Plan& p, int K) {
  if (mode != OVR || p.path != 0) return 1;
  const int chunks = (K + KC - 1) / KC;
  return (chunks + (int)p.aux - 1) / (int)p.aux;
}

template <typename Fam>
void launch_ovr(const Plan& p, const float* x, const float* y, const float* mask,
                const float* beta, const unsigned char* act, long long P, long long m, int d,
                int K, long long ystride, int grad, float* bpart, cudaStream_t s) {
  const dim3 grid((unsigned)p.blocks, (unsigned)P, (unsigned)class_groups(OVR, p, K));
  const size_t smem = (size_t)p.smem;
  if (p.path == 3) {
    const TcKern kern = grad ? tc_instance<PerLane<Fam>, true>(d, K)
                             : tc_instance<PerLane<Fam>, false>(d, K);
    kern<<<grid, T, smem, s>>>(x, y, mask, beta, act, P, m, d, K, (int)p.R, (int)p.G, bpart);
  } else if (p.path == 0) {
    const OvrKern kern = grad ? ovr_instance<Fam, true>((int)p.aux, (int)p.R)
                              : ovr_instance<Fam, false>((int)p.aux, (int)p.R);
    kern<<<grid, T, smem, s>>>(x, y, mask, beta, act, P, m, d, K, (int)p.R, (int)p.G, ystride,
                               bpart);
  } else if (grad) {
    row_kernel<OVR, Fam, true><<<grid, T, smem, s>>>(x, y, mask, beta, act, P, m, d, K, ystride,
                                                     bpart);
  } else {
    row_kernel<OVR, Fam, false><<<grid, T, smem, s>>>(x, y, mask, beta, act, P, m, d, K,
                                                      ystride, bpart);
  }
}

void launch_mn(const Plan& p, const float* x, const float* y, const float* mask,
               const float* beta, const unsigned char* act, long long P, long long m, int d,
               int K, int grad, float* bpart, cudaStream_t s) {
  const dim3 grid((unsigned)p.blocks, (unsigned)P, 1u);
  const size_t smem = (size_t)p.smem;
  if (p.path == 2) {
    const TcKern kern =
        grad ? tc_instance<Softmax, true>(d, K) : tc_instance<Softmax, false>(d, K);
    kern<<<grid, T, smem, s>>>(x, y, mask, beta, act, P, m, d, K, (int)p.R, (int)p.G, bpart);
  } else if (p.path == 0) {
    const int R = (int)p.R, G = (int)p.G, GL = (int)p.aux;
    if (grad)
      tiled_kernel<true><<<grid, T, smem, s>>>(x, y, mask, beta, act, P, m, d, K, R, G, GL, bpart);
    else
      tiled_kernel<false><<<grid, T, smem, s>>>(x, y, mask, beta, act, P, m, d, K, R, G, GL, bpart);
  } else if (grad) {
    row_kernel<MN, Logistic, true><<<grid, T, smem, s>>>(x, y, mask, beta, act, P, m, d, K, 0,
                                                         bpart);
  } else {
    row_kernel<MN, Logistic, false><<<grid, T, smem, s>>>(x, y, mask, beta, act, P, m, d, K, 0,
                                                          bpart);
  }
}

}  // namespace

extern "C" {

const char* multiclass_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Plans a call of mode (0 OvR, 1 MN) and family (OvR: 0 logistic, 1
// normal; MN: 0) over P shards of m rows, d features and K classes, with
// OvR's target shared by all K classes (shared != 0: a class stride of 0)
// or not, into plan (8 int64s; plan[6] is the floats of scratch it
// needs), to be passed back to multiclass_value_and_grad with the same
// mode, family and sharing.  The plan depends only on these and the card,
// so a lane's sums are taken in the same order whatever the other lanes do.
int multiclass_plan(int mode, int family, long long P, long long m, int d, int K, int shared,
                    void* plan) {
  Plan* p = (Plan*)plan;
  int dev = 0, sms = 0, per_sm = 1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long units = 1;
  err = plan_mode(mode, family, dev, m, d, K, shared != 0, p, &units, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  p->rec = (long long)K * (d + 1);
  // one wave over all shards and class groups, split evenly between them,
  // and records that fit the scratch cap
  long long blocks = (long long)sms * per_sm / (P * class_groups(mode, *p, K));
  const long long cap = SCRATCH_CAP / (P * p->rec);
  if (blocks > cap) blocks = cap;
  if (blocks > units) blocks = units;
  if (blocks < 1) blocks = 1;
  p->blocks = blocks;
  p->scratch = P * blocks * p->rec;
  return (int)cudaSuccess;
}

// x (P, m, d), mask (P, m): float32, contiguous, on one device.  Mode 0:
// y (K, P, m) with class stride ystride floats (P*m, or 0 for one target
// shared by all K classes; each class's (P, m) contiguous), beta (K*P, d),
// active (K*P,), f (K*P,), g (K*P, d), the terms of `family` (0 logistic,
// 1 normal).  Mode 1: y (P, m) class indices, beta (P, d*K), active (P,),
// f (P,), g (P, d*K); family 0, ystride unused.  f and g are written only
// for active lanes, g only when grad != 0.  plan: multiclass_plan's for
// the same mode, family and sharing; scratch: plan[6] floats.
int multiclass_value_and_grad(int mode, int family, const void* x, const void* y,
                              const void* mask, const void* beta, const void* active,
                              long long P, long long m, int d, int K, long long ystride, int grad,
                              const void* plan, void* scratch, void* f, void* g, void* stream) {
  const Plan p = *(const Plan*)plan;
  cudaStream_t s = (cudaStream_t)stream;
  const float *xf = (const float*)x, *yf = (const float*)y, *mf = (const float*)mask,
              *bf = (const float*)beta;
  const unsigned char* act = (const unsigned char*)active;
  float* bpart = (float*)scratch;
  // the shared-target path stages the one target at y: a plan made for
  // it takes no other
  if (mode == OVR && p.path == 3 && ystride != 0) return (int)cudaErrorInvalidValue;
  if (mode != OVR)
    launch_mn(p, xf, yf, mf, bf, act, P, m, d, K, grad, bpart, s);
  else if (family == NORMAL)
    launch_ovr<Normal>(p, xf, yf, mf, bf, act, P, m, d, K, ystride, grad, bpart, s);
  else
    launch_ovr<Logistic>(p, xf, yf, mf, bf, act, P, m, d, K, ystride, grad, bpart, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cols = K * (d + 1);
  const dim3 fgrid((unsigned)((cols + 255) / 256), (unsigned)P);
  if (mode == OVR)
    finalize_kernel<<<fgrid, 256, 0, s>>>(bpart, act, P, (int)p.blocks, d, K, grad, (float*)f,
                                          (float*)g);
  else
    mn_finalize_kernel<<<dim3((unsigned)((cols + NW - 1) / NW), (unsigned)P), T, 0, s>>>(
        bpart, act, (int)p.blocks, d, K, grad, (float*)f, (float*)g);
  return (int)cudaGetLastError();
}

}  // extern "C"
