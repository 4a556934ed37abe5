// K10 for Hopper (sm_90a), plain C ABI: cancellation-guarded pairwise
// squared distances with a fused epilogue (d², √d² or exp(−γd²)).
//
// Replaces: dask_ml_tpu/metrics/pairwise.py:153 _sq_euclidean_safe, with
// :142 _exact_sq_chunked and :120 _row_chunked, under :209 _euclid_tile,
// :376 _rbf_tile and :344 _SelfTile.  What it computes, as the reference:
//   a  = 0.5 (mean_rows x + mean_rows y), and x, y centred on it;
//   d² = max((|x|² + |y|²) − 2 x·y, 0) in float32;
//   where d² < TAU (|x|² + |y|²) (TAU = 1e-2, :117) the expansion has lost
//   its digits to cancellation, and d² is recomputed exactly as Σ(x−y)²;
//   self_pairs: the global diagonal (row0 + i == col0 + j) is 0, unflagged.
// Every product is float32 on the CUDA cores (no TF32: the reference's
// Precision.HIGHEST); the dot products and the exact recompute are fmaf
// chains in feature order, y's norms too; x's norms are fmaf chains that
// start, for an even d, at a feature that turns with the row (so that a
// warp's reads of the staged band do not share banks).
//
// Bound on an H100: at x (2^20, 50) against y (1024, 50) the call writes
// 4.29 GB of output and reads 0.21 GB (1.35 ms at 3.35 TB/s) and does
// 2·n·m·d = 107 GFLOP of products (1.6 ms at 67 TFLOP/s float32): the
// products bound it, and the output must stream out under them.  At x
// (10M, 50) against a Nyström sample of 100 rows it is the bytes (2 GB in,
// 4 GB out).  The design:
//   - colsum_kernel: per-block column sums of x and of y (one read each,
//     four running sums a thread, a fixed order), then anchor_kernel sums
//     them in block order into a.  This full pass over x comes before any
//     tile (the anchor needs every row); the bound above does not count it.
//   - prep_y_kernel: y centred, feature-major (d, mpad), zero past m, and
//     its norms: staged once for the call, so a y tile is a plain copy.
//   - band_kernel (d <= 64): persistent, about two CTAs a SM.  A CTA takes
//     a contiguous run of output tiles in band order (every column tile of
//     a 128-row band of x before the next band), so it stages an x band
//     once: cp.async copies the band's rows, one contiguous run (read at a
//     shift where x is not 16-byte aligned), and the band is centred and
//     transposed in shared memory, its norms computed on the way.  The
//     next band's rows and the next y tile are in flight (cp.async, into a
//     second buffer) while the products and the epilogue of the tile
//     before run.  A tile is 128 rows by 128 columns (104 where m <= 104,
//     the Nyström sample's 100, so fewer lanes idle), each thread an 8 x 8
//     micro-tile fed by four 16-byte shared loads a feature.  Where y fits
//     one tile it stays in shared memory for the CTA's life.  The
//     epilogue, one instance per output function, applies the self-pair
//     rule (only in tiles the diagonal crosses), the flag and the exact
//     recompute from the staged band and tile, and streams the tile out
//     with 16-byte stores where the output rows allow.  The output may be
//     a column block of a wider matrix (ldo), so a ring step writes its
//     block in place.
//   - wide_kernel (d > 64): one 128 x 128 tile a block, features staged 64
//     at a time (the first design); a flagged entry's exact recompute
//     reads the rows from global memory.
//   - The flagged entries are counted: an integer shared atomic a thread
//     that flagged, one global atomic a CTA.
// What still holds it back (k7k10_variants.py's clock64 probe on an H100):
// a tile's epilogue takes as long as its products, two CTAs a SM overlap
// them only in part, and at the Nyström shape the epilogue is 1.7x the
// products (the 104-column tile's 16-byte shared loads also meet bank
// conflicts, its 400-byte output rows end mid-sector), and each band,
// staged for one tile there, is centred and transposed by 128 threads in a
// chain; the 8 x 8 micro-tile's four 16-byte shared loads a feature keep
// shared memory about as busy as the FMAs.  No float atomics: the same
// input gives the same bits.  Row indices are 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 256;               // threads of colsum_kernel, prep_y_kernel, wide_kernel
constexpr int TY = 16;               // tile thread rows (every tile kernel)
constexpr int TM = 8, TN = 8;        // a thread's micro-tile
constexpr int BM = TM * TY;          // 128 x rows a tile: a band
constexpr int WIDE_TX = 16;          // wide_kernel's tile thread columns
constexpr int WIDE_BN = TN * WIDE_TX;
constexpr int NARROW_TX = 13;        // band_kernel's tile of 104 columns, for m <= 104
constexpr int DCH = 64;              // features band_kernel holds; wide_kernel's chunk
constexpr int XP = BM + 4;           // wide_kernel: feature stride of a staged chunk
constexpr float TAU = 1e-2f;         // the reference's _SAFE_TAU
constexpr int MAX_SUM_BLOCKS = 1024;
static_assert(BM == WIDE_BN && BM + WIDE_BN == T, "a wide thread computes one row or column norm");

__host__ __device__ __forceinline__ long long round4(long long v) { return (v + 3) / 4 * 4; }

// Blocks of colsum_kernel for n rows.
__host__ __device__ __forceinline__ long long sum_blocks(long long n) {
  const long long b = (n + T - 1) / T;
  return b < 1 ? 1 : b > MAX_SUM_BLOCKS ? MAX_SUM_BLOCKS : b;
}

// part[b*d + j] = Σ x[r][j] over block b's rows: a thread sums its group's
// rows in four running sums, rows 4 apart, added in a fixed order; then the
// groups are added in order.
__global__ void colsum_kernel(const float* __restrict__ x, long long n, int d,
                              long long per_block, float* __restrict__ part) {
  __shared__ float red[T];
  const int t = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * per_block;
  const long long r1 = r0 + per_block < n ? r0 + per_block : n;
  const int W = d < T ? d : T;  // columns a pass
  const int G = T / W;          // row groups
  for (int j0 = 0; j0 < d; j0 += W) {
    const int g = t / W, j = j0 + t % W;
    float s = 0.f;
    if (g < G && j < d) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      long long r = r0 + g;
      for (; r + 3LL * G < r1; r += 4LL * G) {
        s0 += x[r * d + j];
        s1 += x[(r + G) * d + j];
        s2 += x[(r + 2LL * G) * d + j];
        s3 += x[(r + 3LL * G) * d + j];
      }
      for (; r < r1; r += G) s0 += x[r * d + j];
      s = (s0 + s1) + (s2 + s3);
    }
    red[t] = s;
    __syncthreads();
    if (t < W && j0 + t < d) {
      float tot = 0.f;
      for (int gg = 0; gg < G; ++gg) tot += red[gg * W + t];
      part[(size_t)blockIdx.x * d + j0 + t] = tot;
    }
    __syncthreads();
  }
}

// anchor[j] = 0.5 (Σ_b px[b][j] / n + Σ_b py[b][j] / m), blocks in order.
__global__ void anchor_kernel(const float* __restrict__ px, int bx, long long n,
                              const float* __restrict__ py, int by, long long m, int d,
                              float* __restrict__ anchor) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < d; j += gridDim.x * blockDim.x) {
    float sx = 0.f, sy = 0.f;
    for (int b = 0; b < bx; ++b) sx += px[(size_t)b * d + j];
    for (int b = 0; b < by; ++b) sy += py[(size_t)b * d + j];
    anchor[j] = 0.5f * (sx / (float)n + sy / (float)m);
  }
}

// yt[j*mpad + c] = y[c][j] − anchor[j] (0 for c >= m); yn[c] = its norm.
__global__ void prep_y_kernel(const float* __restrict__ y, long long m, int d,
                              const float* __restrict__ anchor, long long mpad,
                              float* __restrict__ yt, float* __restrict__ yn) {
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < mpad;
       c += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) {
      const float v = c < m ? y[c * d + j] - anchor[j] : 0.f;
      yt[j * mpad + c] = v;
      s = fmaf(v, v, s);
    }
    yn[c] = s;
  }
}

struct Args {
  const float* x;
  const float* y;        // wide_kernel
  const float* anchor;
  const float* yt;       // band_kernel: y centred, feature-major (d, mpad)
  const float* yn;       // band_kernel: y's norms (mpad)
  long long n, m, mpad;
  int d;
  int self_pairs;
  long long row0, col0;  // global offsets of x's row 0 and y's row 0
  int kind;              // wide_kernel: 0 d², 1 √d², 2 exp(neg_gamma·d²)
  float neg_gamma;
  float* out;
  long long ldo;         // out's row stride, in floats
  int vec;               // out rows take 16-byte stores
  long long nct;         // column tiles
  long long tiles;       // band_kernel: row bands x column tiles
  unsigned long long* flagged;
};

// The micro-tile's rows and columns: TM/4 runs of 4 rows, TY*4 apart, and
// likewise for the columns, so that a thread reads its 8 of a feature as
// two float4s and a warp's stores of a row are contiguous 16-byte runs.
__device__ __forceinline__ int row_of(int i, int ty) { return (i / 4) * (TY * 4) + ty * 4 + i % 4; }
template <int TX>
__device__ __forceinline__ int col_of(int c, int tx) { return (c / 4) * (TX * 4) + tx * 4 + c % 4; }

template <int KIND>
__device__ __forceinline__ float finish(float d2, float neg_gamma) {
  return KIND == 0 ? d2 : KIND == 1 ? sqrtf(d2) : expf(neg_gamma * d2);
}

__device__ __forceinline__ float finish_rt(float d2, int kind, float neg_gamma) {
  return kind == 0 ? finish<0>(d2, neg_gamma)
       : kind == 1 ? finish<1>(d2, neg_gamma) : finish<2>(d2, neg_gamma);
}

// 16 bytes global -> shared, asynchronously; bytes < 16 fills the rest with 0.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------ band_kernel

// Floats of the raw band buffer: BM rows of d, and 3 for the shift.
__host__ __device__ __forceinline__ long long raw_floats(int d) {
  return round4((long long)BM * d + 3);
}

// band_kernel's shared floats, in the order they are laid out: the raw
// band, the centred transposed band, its norms, the y tile stages and their
// norms, the anchor, and the flag counter.
__host__ __device__ __forceinline__ long long band_smem_floats(int d, int bn, int ystages) {
  return raw_floats(d) + (long long)d * BM + BM + (long long)ystages * ((long long)d * bn + bn) +
         round4(d) + 4;
}

// Issues the copies of rows [r0, r0 + BM) of x (fewer at the end) into raw,
// row-major from raw[shift]: the 16-byte run that covers them.
__device__ __forceinline__ void load_band(float* raw, const float* __restrict__ x, long long n,
                                          int d, long long r0, int shift, int nt) {
  const long long rows = n - r0 < BM ? n - r0 : BM;
  const float* base = x + r0 * d - shift;
  const float* xend = x + n * d;
  const int pieces = (int)((shift + rows * d + 3) / 4);
  for (int p = threadIdx.x; p < pieces; p += nt) {
    const float* src = base + 4 * p;
    const long long avail = xend - src;
    cp_async16(raw + 4 * p, src, avail >= 4 ? 16 : (int)avail * 4);
  }
}

// Issues the copies of y tile columns [c0, c0 + BN) of yt and yn.
template <int BN>
__device__ __forceinline__ void load_ytile(float* ys, float* yn_s, const float* __restrict__ yt,
                                           const float* __restrict__ yn, long long mpad, int d,
                                           long long c0, int nt) {
  constexpr int PR = BN / 4;  // 16-byte pieces a feature
  for (int p = threadIdx.x; p < d * PR; p += nt) {
    const int j = p / PR, q = p - j * PR;
    cp_async16(ys + j * BN + 4 * q, yt + j * mpad + c0 + 4 * q, 16);
  }
  for (int p = threadIdx.x; p < PR; p += nt) cp_async16(yn_s + 4 * p, yn + c0 + 4 * p, 16);
}

// Threads t < BM: row t of the staged band, centred, into xs[j*BM + t] and
// its norm into xn[t]; rows past `rows` are zero.
__device__ __forceinline__ void transpose_band(const float* raw, const float* anc, float* xs,
                                               float* xn, int d, int rows) {
  const int r = threadIdx.x;
  if (r >= BM) return;
  if (r >= rows) {
    for (int j = 0; j < d; ++j) xs[j * BM + r] = 0.f;
    xn[r] = 0.f;
    return;
  }
  const float* src = raw + r * d;
  int j = (d & 1) ? 0 : r % d;  // even d: row r starts at feature r mod d
  float s = 0.f;
  for (int jj = 0; jj < d; ++jj) {
    const float v = src[j] - anc[j];
    xs[j * BM + r] = v;
    s = fmaf(v, v, s);
    j = j + 1 == d ? 0 : j + 1;
  }
  xn[r] = s;
}

// The epilogue of one tile: the self-pair rule, the flag, the exact
// recompute from the staged band and tile, the output function and the
// stores.  Returns the entries it recomputed.
template <int TX, int KIND>
__device__ __forceinline__ unsigned epilogue(const Args& a, const float (&acc)[TM][TN],
                                             const float* xs, const float* ys, const float* xn_s,
                                             const float* yn_s, int ty, int tx, long long r0,
                                             long long c0) {
  constexpr int BN = TX * TN;
  const int d = a.d;
  float ynr[TN];
#pragma unroll
  for (int c = 0; c < TN; ++c) ynr[c] = yn_s[col_of<TX>(c, tx)];
  // a self tile pins local column r + dshift of local row r, where the
  // global diagonal crosses this tile
  bool diag = false;
  int dshift = 0;
  if (a.self_pairs) {
    const long long delta = (a.row0 + r0) - (a.col0 + c0);
    if (delta > -BM && delta < BN) {
      diag = true;
      dshift = (int)delta;
    }
  }
  unsigned nflag = 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row_of(i, ty);
    const long long gr = r0 + r;
    if (gr >= a.n) continue;
    const float xn = xn_s[r];
    float* orow = a.out + gr * a.ldo;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int cc0 = col_of<TX>(4 * q, tx);
      const long long gc0 = c0 + cc0;
      if (gc0 >= a.m) continue;
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int cc = cc0 + u;
        const float scale = xn + ynr[4 * q + u];
        float d2 = fmaxf(scale - 2.f * acc[i][4 * q + u], 0.f);
        bool flag = d2 < TAU * scale;
        if (diag && cc == r + dshift) {
          d2 = 0.f;
          flag = false;
        }
        if (flag && gc0 + u < a.m) {
          ++nflag;
          float s = 0.f;
          for (int j = 0; j < d; ++j) {
            const float e = xs[j * BM + r] - ys[j * BN + cc];
            s = fmaf(e, e, s);
          }
          d2 = s;
        }
        v[u] = finish<KIND>(d2, a.neg_gamma);
      }
      if (a.vec && gc0 + 3 < a.m) {
        __stcs(reinterpret_cast<float4*>(orow + gc0), make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (gc0 + u < a.m) __stcs(orow + gc0 + u, v[u]);
      }
    }
  }
  return nflag;
}

template <int TX, int KIND>
__global__ void __launch_bounds__(TX * TY, 2) band_kernel(Args a) {
  constexpr int NT = TX * TY, BN = TX * TN;
  extern __shared__ __align__(16) float smem[];
  const int d = a.d;
  const bool resident = a.nct == 1;  // y is one tile: staged once
  const int ystages = resident ? 1 : 2;
  float* raw = smem;
  float* xs = raw + raw_floats(d);
  float* xn_s = xs + d * BM;
  float* ys0 = xn_s + BM;
  float* yn0 = ys0 + ystages * d * BN;
  float* anc = yn0 + ystages * BN;
  unsigned* nflag_s = reinterpret_cast<unsigned*>(anc + round4(d));
  const int t = threadIdx.x, ty = t / TX, tx = t - ty * TX;
  const int shift = (int)(((uintptr_t)a.x & 15) / sizeof(float));

  // this CTA's run of tiles, [t0, t1): the tiles split evenly
  const long long per = a.tiles / gridDim.x, extra = a.tiles % gridDim.x;
  const long long b = blockIdx.x;
  const long long t0 = b * per + (b < extra ? b : extra);
  const long long t1 = t0 + per + (b < extra ? 1 : 0);

  if (t == 0) *nflag_s = 0u;
  for (int j = t; j < d; j += NT) anc[j] = a.anchor[j];
  load_band(raw, a.x, a.n, d, (t0 / a.nct) * BM, shift, NT);
  load_ytile<BN>(ys0, yn0, a.yt, a.yn, a.mpad, d, (t0 % a.nct) * BN, NT);
  cp_async_commit();

  unsigned nflag = 0;
  for (long long tile = t0; tile < t1; ++tile) {
    const long long band = tile / a.nct, ct = tile - band * a.nct;
    const long long r0 = band * BM, c0 = ct * BN;
    const int yb = resident ? 0 : (int)((tile - t0) & 1);
    const float* ys = ys0 + yb * d * BN;
    const float* yn_s = yn0 + yb * BN;
    cp_async_wait_all();
    __syncthreads();  // this tile's copies have landed, from every thread; the last tile is done
    if (tile == t0 || ct == 0) {
      transpose_band(raw + shift, anc, xs, xn_s, d, (int)(a.n - r0 < BM ? a.n - r0 : BM));
      __syncthreads();  // the band is staged; raw is free
      if ((band + 1) * a.nct < t1) load_band(raw, a.x, a.n, d, r0 + BM, shift, NT);
    }
    if (!resident && tile + 1 < t1)
      load_ytile<BN>(ys0 + (yb ^ 1) * d * BN, yn0 + (yb ^ 1) * BN, a.yt, a.yn, a.mpad, d,
                     ((tile + 1) % a.nct) * BN, NT);
    cp_async_commit();

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;
#pragma unroll 2
    for (int j = 0; j < d; ++j) {
      float av[TM], bv[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 u = *reinterpret_cast<const float4*>(xs + j * BM + row_of(4 * h, ty));
        av[4 * h] = u.x; av[4 * h + 1] = u.y; av[4 * h + 2] = u.z; av[4 * h + 3] = u.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 u = *reinterpret_cast<const float4*>(ys + j * BN + col_of<TX>(4 * h, tx));
        bv[4 * h] = u.x; bv[4 * h + 1] = u.y; bv[4 * h + 2] = u.z; bv[4 * h + 3] = u.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
    nflag += epilogue<TX, KIND>(a, acc, xs, ys, xn_s, yn_s, ty, tx, r0, c0);
  }
  cp_async_wait_all();
  if (nflag) atomicAdd(nflag_s, nflag);
  __syncthreads();
  if (t == 0 && *nflag_s) atomicAdd(a.flagged, (unsigned long long)*nflag_s);
}

// ------------------------------------------------------------ wide_kernel

// Stages features [j0, j0 + wc) of rows [r0, r0 + BM) of v, centred, into
// vs[j*XP + r]; rows past `rows` are zero.  Element e = r*wc + j walks the
// rows in memory order, so a warp's loads are contiguous.
__device__ __forceinline__ void stage(float* vs, const float* __restrict__ v,
                                      const float* __restrict__ anchor, long long rows,
                                      long long r0, int d, int j0, int wc) {
  for (int e = threadIdx.x; e < BM * wc; e += T) {
    const int r = e / wc, j = e - r * wc;
    const long long g = r0 + r;
    vs[j * XP + r] = g < rows ? v[g * d + j0 + j] - anchor[j0 + j] : 0.f;
  }
}

__global__ void __launch_bounds__(T, 2) wide_kernel(Args a) {
  constexpr int TX = WIDE_TX, BN = WIDE_BN;
  extern __shared__ __align__(16) float smem[];
  const int d = a.d;
  float* xs = smem;             // DCH x XP, feature-major, centred
  float* ys = xs + DCH * XP;    // likewise for y
  float* xn_s = ys + DCH * XP;  // BM row norms
  float* yn_s = xn_s + BM;      // BN column norms
  const int t = threadIdx.x, tx = t % TX, ty = t / TX;
  const long long tile = blockIdx.x;
  const long long r0 = (tile / a.nct) * BM, c0 = (tile % a.nct) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;

  for (int j0 = 0; j0 < d; j0 += DCH) {
    const int wc = min(DCH, d - j0);
    if (j0 > 0) __syncthreads();  // the last chunk's reads are done
    stage(xs, a.x, a.anchor, a.n, r0, d, j0, wc);
    stage(ys, a.y, a.anchor, a.m, c0, d, j0, wc);
    __syncthreads();
    {  // thread t < BM: row t's norm; else column t - BM's
      const float* v = t < BM ? xs + t : ys + (t - BM);
      float* nrm = t < BM ? xn_s + t : yn_s + (t - BM);
      float s = j0 == 0 ? 0.f : *nrm;
      for (int j = 0; j < wc; ++j) s = fmaf(v[j * XP], v[j * XP], s);
      *nrm = s;
    }
#pragma unroll 2
    for (int j = 0; j < wc; ++j) {
      float av[TM], bv[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 u = *reinterpret_cast<const float4*>(xs + j * XP + row_of(4 * h, ty));
        av[4 * h] = u.x; av[4 * h + 1] = u.y; av[4 * h + 2] = u.z; av[4 * h + 3] = u.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 u = *reinterpret_cast<const float4*>(ys + j * XP + col_of<TX>(4 * h, tx));
        bv[4 * h] = u.x; bv[4 * h + 1] = u.y; bv[4 * h + 2] = u.z; bv[4 * h + 3] = u.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
  }
  __syncthreads();  // every norm is written

  unsigned int nflag = 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row_of(i, ty);
    const long long gr = r0 + r;
    if (gr >= a.n) continue;
    const float xn = xn_s[r];
    float* orow = a.out + gr * a.ldo;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int cc0 = col_of<TX>(4 * q, tx);
      const long long gc0 = c0 + cc0;
      if (gc0 >= a.m) continue;
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int cc = cc0 + u;
        const long long gc = gc0 + u;
        const float scale = xn + yn_s[cc];
        float d2 = fmaxf(scale - 2.f * acc[i][4 * q + u], 0.f);
        bool flag = d2 < TAU * scale;
        if (a.self_pairs && a.row0 + gr == a.col0 + gc) {
          d2 = 0.f;
          flag = false;
        }
        if (flag && gc < a.m) {
          ++nflag;
          const float* xr = a.x + gr * d;
          const float* yr = a.y + gc * d;
          float s = 0.f;
          for (int j = 0; j < d; ++j) {
            const float e = (xr[j] - a.anchor[j]) - (yr[j] - a.anchor[j]);
            s = fmaf(e, e, s);
          }
          d2 = s;
        }
        v[u] = finish_rt(d2, a.kind, a.neg_gamma);
      }
      if (a.vec && gc0 + 3 < a.m) {
        __stcs(reinterpret_cast<float4*>(orow + gc0), make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (gc0 + u < a.m) __stcs(orow + gc0 + u, v[u]);
      }
    }
  }
  const unsigned int warp_flags = __reduce_add_sync(0xffffffffu, nflag);
  if ((t & 31) == 0 && warp_flags) atomicAdd(a.flagged, (unsigned long long)warp_flags);
}

size_t wide_smem() { return (size_t)(2 * DCH * XP + BM + WIDE_BN) * sizeof(float); }

// The tile's columns for m columns of y: 104 where m fits them, else 128.
int tile_cols(long long m) { return m <= NARROW_TX * TN ? NARROW_TX * TN : WIDE_BN; }

// Where each region of the scratch starts, in floats (16-byte aligned).
struct Scratch {
  long long px, py, anchor, yt, yn, mpad, total;
  Scratch(long long n, long long m, int d) {
    px = 0;
    py = px + sum_blocks(n) * d;
    anchor = py + sum_blocks(m) * d;
    yt = round4(anchor + d);
    const long long bn = tile_cols(m);
    mpad = d <= DCH ? (m + bn - 1) / bn * bn : 0;
    yn = yt + (long long)d * mpad;
    total = yn + mpad;
  }
};

template <int TX, int KIND>
cudaError_t launch_band(const Args& a, cudaStream_t s) {
  constexpr int NT = TX * TY;
  const size_t smem =
      (size_t)band_smem_floats(a.d, TX * TN, a.nct == 1 ? 1 : 2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(band_kernel<TX, KIND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, band_kernel<TX, KIND>, NT, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = (long long)per_sm * sms;
  const long long grid = a.tiles < resident ? a.tiles : resident;
  band_kernel<TX, KIND><<<(unsigned)grid, NT, smem, s>>>(a);
  return cudaGetLastError();
}

template <int TX>
cudaError_t launch_band_kind(const Args& a, int kind, cudaStream_t s) {
  return kind == 0 ? launch_band<TX, 0>(a, s)
       : kind == 1 ? launch_band<TX, 1>(a, s)
                   : launch_band<TX, 2>(a, s);
}

}  // namespace

extern "C" {

const char* pairwise_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Floats of scratch a call needs: the column-sum records of x and y, the
// anchor, and (d <= 64) y centred and transposed with its norms.
long long pairwise_scratch_floats(long long n, long long m, int d) {
  return Scratch(n, m, d).total;
}

// x (n, d), y (m, d): float32, contiguous, on one device.  out: n rows of
// m floats, ldo apart (a column block of a wider matrix, or the whole of an
// (n, m) one).  kind 0 writes d², 1 √d², 2 exp(−gamma·d²).  self_pairs:
// x and y are row blocks of one matrix at global offsets row0 and col0.
// flagged: one uint64, to which the count of recomputed entries is added.
int sq_euclidean_safe(const void* x, long long n, const void* y, long long m, int d,
                      long long row0, long long col0, int self_pairs, int kind, float gamma,
                      void* out, long long ldo, void* scratch, void* flagged, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* yf = (const float*)y;
  const Scratch sc(n, m, d);
  float* base = (float*)scratch;
  float* part_x = base + sc.px;
  float* part_y = base + sc.py;
  float* anchor = base + sc.anchor;
  const long long bx = sum_blocks(n), by = sum_blocks(m);
  colsum_kernel<<<(int)bx, T, 0, s>>>(xf, n, d, (n + bx - 1) / bx, part_x);
  const bool same = yf == xf && m == n;
  if (!same) colsum_kernel<<<(int)by, T, 0, s>>>(yf, m, d, (m + by - 1) / by, part_y);
  anchor_kernel<<<(d + T - 1) / T, T, 0, s>>>(part_x, (int)bx, n, same ? part_x : part_y,
                                              (int)(same ? bx : by), m, d, anchor);
  Args a;
  a.x = xf; a.y = yf; a.anchor = anchor;
  a.yt = base + sc.yt; a.yn = base + sc.yn;
  a.n = n; a.m = m; a.mpad = sc.mpad; a.d = d;
  a.self_pairs = self_pairs; a.row0 = row0; a.col0 = col0;
  a.kind = kind; a.neg_gamma = -gamma;
  a.out = (float*)out; a.ldo = ldo;
  a.vec = ((uintptr_t)out % 16 == 0) && (ldo % 4 == 0);
  a.flagged = (unsigned long long*)flagged;
  if (d <= DCH) {
    const int bn = tile_cols(m);
    a.nct = sc.mpad / bn;
    a.tiles = (n + BM - 1) / BM * a.nct;
    const long long pblocks = (sc.mpad + T - 1) / T;
    prep_y_kernel<<<(unsigned)(pblocks < 1024 ? pblocks : 1024), T, 0, s>>>(
        yf, m, d, anchor, sc.mpad, base + sc.yt, base + sc.yn);
    const cudaError_t err = bn == WIDE_BN ? launch_band_kind<WIDE_TX>(a, kind, s)
                                          : launch_band_kind<NARROW_TX>(a, kind, s);
    return (int)err;
  }
  a.nct = (m + WIDE_BN - 1) / WIDE_BN;
  a.tiles = (n + BM - 1) / BM * a.nct;
  if (a.tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = wide_smem();
  cudaError_t err = cudaFuncSetAttribute(wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  wide_kernel<<<(unsigned)a.tiles, T, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
