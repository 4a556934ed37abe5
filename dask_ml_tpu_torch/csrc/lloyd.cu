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
// reduce_kernel (lloyd_assign_reduce) replaces _lloyd_step_fn
// (k_means.py:88).  Bound on an H100: at k=8 one round reads n*d*4 + n*4
// bytes and does n*k*d FMAs; at 100M x 50 that is 20.4 GB (6.09 ms at
// 3.35 TB/s) against 40 G FMAs (1.2 ms at 67 TFLOP/s), so the round is
// memory-bound, and the reduce's own instructions must hide under the
// copies.  The design:
//   - Staging as the one-row-a-thread assign: x row-major in shared memory,
//     16-byte cp.async copies into two buffers, so that the next row tile
//     (or feature chunk) is in flight while this one is assigned and
//     reduced.  The centers and their norms, packed by the assign's
//     pack_centers_kernel (tiles of 8), are staged once per call where they
//     fit, else read from global memory through L1 (every thread of a warp
//     reads one address).
//   - The reduce has no read-modify-write chain through shared memory for
//     k <= 16 and d <= DCH (the register path): each thread owns Q feature
//     columns, strided so a warp reads neighbouring floats, of a fixed row
//     slice, and keeps one register accumulator per (cluster, column); a
//     row adds w*x into its label's accumulators by an unrolled compare
//     (predicated adds: a dynamic register index would spill).  The counts
//     are one more column, of ones.  Slices merge in slice order at the
//     block's end.
//   - Past that (the partial path), row groups own feature columns and
//     walk their rows into a (groups, k*d + k) partial in shared memory, or
//     straight into the block's record in global scratch where that does
//     not fit; each thread takes two rows at a time, both loads issued
//     before the stores, so two chains overlap (the same bits as one).
//   - Per-block records, added in block order by finalize_kernel.
//   - A MiniBatchKMeans step (lloyd_assign_reduce_update) makes the same
//     launches with finalize_update_kernel last: the same sums, and K7a's
//     update (csrc/minibatch.cu's Kahan pair and Sculley move) as their
//     epilogue, one launch fewer than K1a then K7a, with the same bits.
//
// assign_kernel (lloyd_assign).  Its largest caller is k-means||: every
// round is a pass over all n rows against the valid candidate slots so
// far (502 at the last round of a 100M x 50 fit), 2*n*k*d flops that put
// it far past the memory bound (100M x 50 x 502: 5.0 TFLOP, 75 ms at
// 67 TFLOP/s, against 21 GB, 6.4 ms).  The wrapper drops the invalid
// slots before the launch; pack_centers_kernel lays the valid centers out
// feature-major in center tiles, with their norms (the reduce uses the
// same packing); the kernel maps each label back through `slot`.  The
// design is an SGEMM-style register tile with the argmin fused into its
// epilogue:
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
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 256;    // threads per block (both kernels)
constexpr int DCH = 64;   // features per staged chunk (both kernels)

// The centers as both kernels read them, packed once per call for a center
// tile of BN: cn[c] = sum_j centers[c][j]^2 in feature order, and
// cp[(ct*d + j)*BN + i] = centers[ct*BN + i][j], feature-major within a
// tile, so a tile's feature chunk is one contiguous run.  Slots past k are
// zero.
template <int BN>
__global__ void pack_centers_kernel(const float* __restrict__ centers, int k, int d,
                                    int slots, float* __restrict__ cn,
                                    float* __restrict__ cp) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= slots) return;
  const int ct = c / BN, i = c - ct * BN;
  float s = 0.f;
  for (int j = 0; j < d; ++j) {
    const float v = c < k ? centers[(size_t)c * d + j] : 0.f;
    s = fmaf(v, v, s);
    cp[((size_t)ct * d + j) * BN + i] = v;
  }
  cn[c] = s;
}

// Center slots of a call: k rounded up to the tile width.
__host__ __device__ __forceinline__ int center_slots(int k, int bn) {
  return (k + bn - 1) / bn * bn;
}

// Packs the k centers for tiles of BN into scratch, laid out as cn (slots
// floats), then cp (slots*d floats); returns cp.
template <int BN>
float* pack_centers(const float* centers, int k, int d, float* scratch, cudaStream_t s) {
  const int slots = center_slots(k, BN);
  float* cp = scratch + slots;
  pack_centers_kernel<BN><<<(slots + 127) / 128, 128, 0, s>>>(centers, k, d, slots, scratch, cp);
  return cp;
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

// MiniBatchKMeans' Sculley update (K7a), as csrc/minibatch.cu has it: the
// Kahan add of the batch mass into (hi, lo), which returns 1/max(mass,
// FLT_MIN) or 0 where the mass is 0; and c + (bsum - bmass*c)*inv.  Every
// operation is rounded on its own (no contraction into FMAs).
__device__ __forceinline__ float kahan_inv(float bmass, float& hi, float& lo) {
  const float y = __fadd_rn(bmass, lo);
  const float t = __fadd_rn(hi, y);
  lo = __fsub_rn(y, __fsub_rn(t, hi));
  hi = t;
  const float mass = __fadd_rn(hi, lo);
  return mass > 0.f ? __fdiv_rn(1.f, fmaxf(mass, FLT_MIN)) : 0.f;
}
__device__ __forceinline__ float sculley(float c, float bsum, float bmass, float inv) {
  return __fadd_rn(c, __fmul_rn(__fsub_rn(bsum, __fmul_rn(bmass, c)), inv));
}

constexpr int FU = 256;  // elements a chunk of finalize_update_kernel, which has 2*FU threads

// finalize_kernel with K7a's update as its epilogue (one MiniBatchKMeans
// step: K1a's sums, then the update, in K1a's last launch).  Block chunks
// of FU elements of the record (k*d sums, k masses, the inertia); thread e
// < FU sums element e0 + e over the blocks in block order and writes it to
// out, as finalize_kernel.  Beside it, thread FU + i sums the mass of the
// chunk's i-th centre over the blocks in the same order (the bits of that
// mass element's own sum, which another block may take) and takes inv
// from the old pair; then the thread of sum (c, j) writes new_centers[c][j],
// and the thread of mass c the new pair.  The two chains of loads run side
// by side, so the masses add no chain to finalize_kernel's; the sums'
// order (block order, one add after another) is what bounds the kernel.
// Everything is read from the old state and written to fresh buffers: no
// value another block writes is read.
__global__ void __launch_bounds__(2 * FU) finalize_update_kernel(
    const float* __restrict__ bpart, int blocks, int k, int d,
    const float* __restrict__ centers, const float* __restrict__ counts,
    float* __restrict__ out, float* __restrict__ new_centers, float* __restrict__ new_counts) {
  __shared__ float inv_s[FU], bm_s[FU];
  const long long kd = (long long)k * d, rec = kd + k + 1;
  const int t = threadIdx.x;
  for (long long e0 = (long long)blockIdx.x * FU; e0 < rec; e0 += (long long)gridDim.x * FU) {
    const long long e = e0 + t;
    const long long c0 = e0 / d;  // the chunk's first centre (of its sums)
    const long long nc = e0 < kd ? (min(e0 + FU, kd) - 1) / d - c0 + 1 : 0;
    __syncthreads();  // the last chunk's reads of inv_s and bm_s are done
    // the old state this thread's update reads, loaded ahead of its sum
    const long long c = t >= FU ? c0 + (t - FU) : e - kd;  // the centre of a mass
    const bool mass = t >= FU ? t - FU < nc : e >= kd && e < kd + k;
    float hi = mass ? counts[c] : 0.f, lo = mass ? counts[k + c] : 0.f;
    const float old = t < FU && e < kd ? centers[e] : 0.f;
    float sum = 0.f;
    if (t >= FU) {
      if (mass) {
#pragma unroll 32  // the loads in flight together, the adds in block order
        for (int b = 0; b < blocks; ++b) sum += bpart[(size_t)b * rec + kd + c];
        inv_s[t - FU] = kahan_inv(sum, hi, lo);
        bm_s[t - FU] = sum;
      }
    } else if (e < rec) {
#pragma unroll 32
      for (int b = 0; b < blocks; ++b) sum += bpart[(size_t)b * rec + e];
    }
    __syncthreads();
    if (t >= FU || e >= rec) continue;
    out[e] = sum;
    if (e < kd) {
      const int i = (int)(e / d - c0);
      new_centers[e] = sculley(old, sum, bm_s[i], inv_s[i]);
    } else if (mass) {
      kahan_inv(sum, hi, lo);
      new_counts[c] = hi;
      new_counts[k + c] = lo;
    }
  }
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

// cs[j*BN + c] <- cp[(ct*d + j0 + j)*BN + c] for j < wc, cn_s[c] <- cn[ct*BN
// + c]: center tile ct's feature chunk from the packed centers
// (pack_centers_kernel), one contiguous run, 16 bytes at a time.
template <class S>
__device__ __forceinline__ void copy_c(float* cs, float* cn_s, const float* __restrict__ cp,
                                       const float* __restrict__ cn, int d, int ct, int j0,
                                       int wc) {
  const float* src = cp + ((size_t)ct * d + j0) * S::BN;
  for (int e = 4 * threadIdx.x; e < wc * S::BN; e += 4 * T) cp_async16(cs + e, src + e, 16);
  for (int e = 4 * threadIdx.x; e < S::BN; e += 4 * T)
    cp_async16(cn_s + e, cn + ct * S::BN + e, 16);
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
              const float* __restrict__ cp, const float* __restrict__ cn,
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
  copy_c<S>(cs, cn_s, cp, cn, d, 0, 0, w);
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
    if (c2) copy_c<S>(cs + (pc ^ 1) * CB, cn_s + (pc ^ 1) * BN, cp, cn, d, ct2, ch2 * w, wc2);
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
  p->scratch = (long long)center_slots(k, S::BN) * (d + 1) + p->blocks;
  return cudaSuccess;
}

// ---------------------------------------------------------------- reduce

constexpr int Q = 4;     // register path: feature columns a thread
constexpr int GMAX = 8;  // partial path: row groups
constexpr size_t SMEM_BUDGET = 200 * 1024;
constexpr int MAX_BLOCKS_PER_SM = 4;

// A reduce launch's plan: made once per call by lloyd_plan, which hands it
// to the caller as 8 int64s to size the scratch, and passed back to the
// launch.
struct Plan {
  long long kr;         // register path for up to kr (8 or 16) clusters, or 0
  long long groups;     // partial path: row groups, each with its own partial
  long long p_in_smem;  // partial path: the (groups, k*d + k) partial lives in
                        // shared memory; else groups == 1 and it is the record
  long long c_in_smem;  // the packed centers and norms are staged once
  long long smem;       // dynamic shared bytes per block
  long long blocks;
  long long rec;        // floats per block record: k*d + k + 1
  long long scratch;    // floats of scratch the call needs
};
static_assert(sizeof(Plan) == 8 * sizeof(long long), "Plan is 8 int64s");

// Register path: column groups of Q columns (d features and the count) and
// the row slices that run side by side in a block.
__host__ __device__ __forceinline__ int col_groups(int d) { return (d + Q) / Q; }

// A block walks steps, its row tiles grid-stride.  Whole rows (d <= DCH)
// take one step a tile: distances, then the reduce, on one staged copy.
// Chunked rows take a step per (center tile, feature chunk) for the
// distances, then one per feature chunk for the reduce.  The copy of step
// s+1 is in flight while step s computes.  KR > 0: the register path for
// k <= KR (whole rows only); KR == 0: the partial path.
template <int KR>
__global__ void __launch_bounds__(T, 2)
reduce_kernel(const float* __restrict__ x, const float* __restrict__ mask,
              const float* __restrict__ cp, const float* __restrict__ cn, long long n,
              int d, int k, Plan p, float* __restrict__ bpart) {
  using S = Narrow;
  constexpr int BN = S::BN;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int w = d < DCH ? d : DCH;
  const int XB = S::xbuf(d, w);
  const int nch = (d + w - 1) / w, nct = (k + BN - 1) / BN, slots = center_slots(k, BN);
  float* xs = smem;  // 2 x buffers
  int* lab_s = reinterpret_cast<int*>(xs + 2 * XB);
  float* w_s = reinterpret_cast<float*>(lab_s + T);
  float* r_s = w_s + T;
  float* cs = r_s + T;  // packed centers, then their norms (c_in_smem)
  const bool c_smem = KR > 0 || p.c_in_smem;
  const float* cpb = c_smem ? cs : cp;
  const float* cnb = c_smem ? cs + (size_t)slots * d : cn;
  const size_t kd = (size_t)k * d, prec = kd + k;
  float* out = bpart + (size_t)blockIdx.x * p.rec;
  float* P = p.p_in_smem ? cs + (c_smem ? (size_t)slots * (d + 1) : 0) : out;
  const int G = (int)p.groups;
  const long long ntiles = (n + S::BM - 1) / S::BM;
  const int nd = nch == 1 ? 1 : nct * nch;  // distance steps a tile
  const int ns = nch == 1 ? 1 : nd + nch;   // steps a tile

  // register path: thread (slice sl, column group g) owns columns g + q*NG
  const int NG = KR > 0 ? col_groups(d) : 1, NS = T / NG;
  const int g = t % NG, sl = t / NG;
  float racc[KR > 0 ? KR : 1][Q];
#pragma unroll
  for (int c = 0; c < (KR > 0 ? KR : 1); ++c)
#pragma unroll
    for (int q = 0; q < Q; ++q) racc[c][q] = 0.f;
  if constexpr (KR == 0)
    for (size_t e = t; e < G * prec; e += T) P[e] = 0.f;

  long long tile = blockIdx.x;
  int i = 0, px = 0;  // this step and its x buffer
  copy_x<S>(xs, x, n, d, tile * S::BM, 0, w);
  if (c_smem)
    for (int e = 4 * t; e < slots * (d + 1); e += 4 * T)
      cp_async16(cs + e, e < slots * d ? cp + e : cn + (e - slots * d), 16);
  cp_async_commit();

  float inert = 0.f, wgt = 0.f;
  float best[1] = {INFINITY}, xn[1] = {0.f}, acc[1][BN];
  int bidx[1] = {0};
#pragma unroll
  for (int c = 0; c < BN; ++c) acc[0][c] = 0.f;

  while (true) {
    long long tile2 = tile;
    int i2 = i + 1;
    if (i2 == ns) { i2 = 0; tile2 += gridDim.x; }
    const int ch = nch == 1 ? 0 : i < nd ? i % nch : i - nd;
    const int ch2 = nch == 1 ? 0 : i2 < nd ? i2 % nch : i2 - nd;
    const bool more = tile2 < ntiles;
    const bool x2 = more && (tile2 != tile || ch2 != ch);
    if (x2) copy_x<S>(xs + (px ^ 1) * XB, x, n, d, tile2 * S::BM, ch2 * w, min(w, d - ch2 * w));
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();  // this step's x has landed, from every thread

    const long long r0 = tile * S::BM;
    const int rows = (int)min((long long)S::BM, n - r0);
    const int j0 = ch * w, wc = min(w, d - j0), xp = row_stride(d, wc);
    const float* xb = xs + px * XB;
    if (i < nd) {  // distances
      if (i == nd - 1) wgt = t < rows ? __ldcs(mask + r0 + t) : 0.f;
      for (int ct = nch == 1 ? 0 : i / nch; ct < (nch == 1 ? nct : i / nch + 1); ++ct) {
        const float* cb = cpb + ((size_t)ct * d + j0) * BN;
        if (ct == 0) dot_chunk<S, true>(xb, cb, xp, wc, 0, t, acc, xn[0]);
        else dot_chunk<S, false>(xb, cb, xp, wc, 0, t, acc, xn[0]);
        if (ch == nch - 1) {
          if ((ct + 1) * BN <= k) fold_tile<S, false>(acc, xn, cnb + ct * BN, ct * BN, k, 0, best, bidx);
          else fold_tile<S, true>(acc, xn, cnb + ct * BN, ct * BN, k, 0, best, bidx);
        }
      }
      if (i == nd - 1) {  // the row's nearest center is known
        if (t < rows) inert += wgt * best[0];
        lab_s[t] = bidx[0];
        w_s[t] = wgt;
        best[0] = INFINITY;
        bidx[0] = 0;
        xn[0] = 0.f;
      }
      if (nch == 1) __syncthreads();  // lab_s and w_s are written
    }
    if (nch == 1 || i >= nd) {  // the reduce of chunk ch
      if constexpr (KR > 0) {
        if (sl < NS) {
          for (int r = sl; r < rows; r += NS) {
            const int lab = lab_s[r];
            const float wr = w_s[r];
            const float* xr = xb + r * xp;
            float v[Q];
#pragma unroll
            for (int q = 0; q < Q; ++q) {
              const int col = g + q * NG;
              v[q] = wr * (col < d ? xr[col] : col == d ? 1.f : 0.f);
            }
#pragma unroll
            for (int c = 0; c < KR; ++c)
              if (lab == c) {
#pragma unroll
                for (int q = 0; q < Q; ++q) racc[c][q] += v[q];
              }
          }
        }
      } else {
        const int cols = wc + (ch == 0);  // chunk 0 also carries the count column
        const int gg = t / cols, jj = t - gg * cols;
        if (gg < G) {
          const bool one = jj == wc;
          float* base = P + gg * prec + (one ? kd : (size_t)(j0 + jj));
          const size_t stride = one ? 1 : d;
          const float* xc = xb + jj;
          int r = gg;
          for (; r + G < rows; r += 2 * G) {
            const int la = lab_s[r], lb = lab_s[r + G];
            const float va = w_s[r] * (one ? 1.f : xc[r * xp]);
            const float vb = w_s[r + G] * (one ? 1.f : xc[(r + G) * xp]);
            float* pa = base + la * stride;
            float* pb = base + lb * stride;
            const float a = *pa, b = *pb;
            if (la == lb) {
              *pa = (a + va) + vb;
            } else {
              *pa = a + va;
              *pb = b + vb;
            }
          }
          if (r < rows) base[lab_s[r] * stride] += w_s[r] * (one ? 1.f : xc[r * xp]);
        }
      }
    }
    if (x2) __syncthreads();  // the next step's copies refill this step's buffer
    if (!more) break;
    if (x2) px ^= 1;
    tile = tile2;
    i = i2;
  }

  // per-block record, in a fixed order
  r_s[t] = inert;
  __syncthreads();
  for (int s = T / 2; s > 0; s >>= 1) {
    if (t < s) r_s[t] += r_s[t + s];
    __syncthreads();
  }
  const float total = r_s[0];
  if constexpr (KR > 0) {
    __syncthreads();  // every thread has read r_s: the merge reuses shared memory
    const int NC = NG * Q;
    float* M = smem;  // (slice, cluster, column)
    if (sl < NS)
#pragma unroll
      for (int c = 0; c < KR; ++c)
#pragma unroll
        for (int q = 0; q < Q; ++q) M[(sl * KR + c) * NC + g + q * NG] = racc[c][q];
    __syncthreads();
    for (int e = t; e < k * (d + 1); e += T) {
      const int c = e / (d + 1), col = e - c * (d + 1);
      float s = 0.f;
      for (int s2 = 0; s2 < NS; ++s2) s += M[(s2 * KR + c) * NC + col];
      out[col < d ? (size_t)c * d + col : kd + c] = s;
    }
  } else if (p.p_in_smem) {
    for (size_t e = t; e < prec; e += T) {
      float s = 0.f;
      for (int gg = 0; gg < G; ++gg) s += P[gg * prec + e];
      out[e] = s;
    }
  }
  if (t == 0) out[p.rec - 1] = total;
}

template <int KR>
cudaError_t reduce_occupancy(size_t smem, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(reduce_kernel<KR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, reduce_kernel<KR>, T, smem);
}

cudaError_t make_plan(long long n, int d, int k, Plan* p) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int w = d < DCH ? d : DCH;
  const long long slots = center_slots(k, Narrow::BN);
  const size_t base = 2 * (size_t)Narrow::xbuf(d, w) + 3 * T;  // x buffers, lab_s, w_s, r_s
  const size_t cf = (size_t)slots * (d + 1);                    // packed centers, norms
  const size_t prec = (size_t)k * d + k;
  const size_t budget = SMEM_BUDGET / sizeof(float);
  p->kr = d > DCH ? 0 : k <= 8 ? 8 : k <= 16 ? 16 : 0;
  size_t floats;
  if (p->kr) {
    const int ng = col_groups(d);
    const size_t merge = (size_t)(T / ng) * p->kr * ng * Q;
    p->groups = 0;
    p->p_in_smem = 0;
    p->c_in_smem = 1;
    floats = base + cf > merge ? base + cf : merge;
  } else {
    p->c_in_smem = base + cf <= budget;
    const size_t used = base + (p->c_in_smem ? cf : 0);
    long long g = T / (w + 1) < GMAX ? T / (w + 1) : GMAX;
    while (g > 1 && used + g * prec > budget) --g;
    p->p_in_smem = used + g * prec <= budget;
    p->groups = p->p_in_smem ? g : 1;
    floats = used + (p->p_in_smem ? g * prec : 0);
  }
  p->smem = (long long)(floats * sizeof(float));
  err = p->kr == 8    ? reduce_occupancy<8>((size_t)p->smem, &per_sm)
        : p->kr == 16 ? reduce_occupancy<16>((size_t)p->smem, &per_sm)
                      : reduce_occupancy<0>((size_t)p->smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  if (per_sm > MAX_BLOCKS_PER_SM) per_sm = MAX_BLOCKS_PER_SM;
  // a record of k*d + k + 1 floats a block: keep large ones few
  if (!p->kr && !p->p_in_smem) per_sm = 1;
  const long long ntiles = (n + T - 1) / T;
  const long long most = (long long)sms * per_sm;
  p->blocks = ntiles < most ? ntiles : most;
  p->rec = (long long)prec + 1;
  p->scratch = slots * (d + 1) + p->blocks * p->rec;
  return cudaSuccess;
}

// The packed centres, then reduce_kernel's block records into scratch (as
// lloyd_plan sized it); returns the records.
float* launch_reduce(const void* x, const void* mask, const void* centers, long long n, int d,
                     int k, const Plan& p, void* scratch, cudaStream_t s) {
  float* cn = (float*)scratch;
  float* cp = pack_centers<Narrow::BN>((const float*)centers, k, d, cn, s);
  float* bpart = cp + (size_t)center_slots(k, Narrow::BN) * d;
  const float *xf = (const float*)x, *mf = (const float*)mask;
  if (p.kr == 8)
    reduce_kernel<8><<<(int)p.blocks, T, (size_t)p.smem, s>>>(xf, mf, cp, cn, n, d, k, p, bpart);
  else if (p.kr == 16)
    reduce_kernel<16><<<(int)p.blocks, T, (size_t)p.smem, s>>>(xf, mf, cp, cn, n, d, k, p, bpart);
  else
    reduce_kernel<0><<<(int)p.blocks, T, (size_t)p.smem, s>>>(xf, mf, cp, cn, n, d, k, p, bpart);
  return bpart;
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

// x (n,d), mask (n,), centers (k,d): float32, contiguous, on one device,
// x 16-byte aligned.  out: k*d sums, then k counts, then the inertia
// (k*d + k + 1 floats).
int lloyd_assign_reduce(const void* x, const void* mask, const void* centers,
                        long long n, int d, int k, const void* plan,
                        void* scratch, void* out, void* stream) {
  const Plan p = *(const Plan*)plan;
  cudaStream_t s = (cudaStream_t)stream;
  float* bpart = launch_reduce(x, mask, centers, n, d, k, p, scratch, s);
  const long long fb = (p.rec + 255) / 256;
  finalize_kernel<<<(int)(fb < 1024 ? fb : 1024), 256, 0, s>>>(
      bpart, (int)p.blocks, p.rec, (float*)out);
  return (int)cudaGetLastError();
}

// One MiniBatchKMeans step: lloyd_assign_reduce on the batch x (n,d) with
// weights mask (n,) against centers (k,d), its last launch also the
// Sculley update of centers and the Kahan pair counts (2,k) (K7a) into
// new_centers (k,d) and new_counts (2,k), fresh buffers.  out as
// lloyd_assign_reduce's (the sums, the masses, the inertia).  plan from
// lloyd_plan(n, d, k); the bits of lloyd_assign_reduce then K7a.
int lloyd_assign_reduce_update(const void* x, const void* mask, const void* centers,
                               const void* counts, long long n, int d, int k, const void* plan,
                               void* scratch, void* out, void* new_centers, void* new_counts,
                               void* stream) {
  const Plan p = *(const Plan*)plan;
  cudaStream_t s = (cudaStream_t)stream;
  float* bpart = launch_reduce(x, mask, centers, n, d, k, p, scratch, s);
  const long long fb = (p.rec + FU - 1) / FU;
  finalize_update_kernel<<<(int)(fb < 1024 ? fb : 1024), 2 * FU, 0, s>>>(
      bpart, (int)p.blocks, k, d, (const float*)centers, (const float*)counts, (float*)out,
      (float*)new_centers, (float*)new_counts);
  return (int)cudaGetLastError();
}

// Plans a lloyd_assign call against k centers into plan (4 int64s;
// plan[3] is the floats of scratch it needs).
int assign_plan(long long n, int d, int k, void* plan) {
  AssignPlan* p = (AssignPlan*)plan;
  p->wide = k > SMALL_K;
  return (int)(p->wide ? plan_for<Wide>(n, d, k, p) : plan_for<Narrow>(n, d, k, p));
}

// x (n,d), mask (n,), centers (k,d): float32, contiguous, x 16-byte
// aligned; slot (k,) int64 or null: the label of center i is slot[i] (else
// i).  labels (n,) int64, mind2 (n,) float32, inertia (1,).
int lloyd_assign(const void* x, const void* mask, const void* centers, const void* slot,
                 long long n, int d, int k, const void* plan, void* labels, void* mind2,
                 void* scratch, void* inertia, void* stream) {
  const AssignPlan p = *(const AssignPlan*)plan;
  cudaStream_t s = (cudaStream_t)stream;
  float* cn = (float*)scratch;
  const float *xf = (const float*)x, *mf = (const float*)mask, *cf = (const float*)centers;
  const long long* sl = (const long long*)slot;
  const int bn = p.wide ? Wide::BN : Narrow::BN;
  float* cp = p.wide ? pack_centers<Wide::BN>(cf, k, d, cn, s)
                     : pack_centers<Narrow::BN>(cf, k, d, cn, s);
  float* bpart = cp + (size_t)center_slots(k, bn) * d;
  if (p.wide)
    assign_kernel<Wide><<<(int)p.blocks, T, (size_t)p.smem, s>>>(
        xf, mf, cp, cn, sl, n, d, k, (int64_t*)labels, (float*)mind2, bpart);
  else
    assign_kernel<Narrow><<<(int)p.blocks, T, (size_t)p.smem, s>>>(
        xf, mf, cp, cn, sl, n, d, k, (int64_t*)labels, (float*)mind2, bpart);
  finalize_kernel<<<1, 32, 0, s>>>(bpart, (int)p.blocks, 1, (float*)inertia);
  return (int)cudaGetLastError();
}

}  // extern "C"
