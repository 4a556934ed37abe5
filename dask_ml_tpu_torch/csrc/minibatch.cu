// K7 for Hopper (sm_90a), plain C ABI: MiniBatchKMeans' Sculley update
// (K7a) and a whole epoch of minibatch steps in one launch (K7b).
//
// K7a update_kernel replaces the tail of
// dask_ml_tpu/cluster/minibatch_kmeans.py:54 _mbk_step_fn, after K1a
// (lloyd_assign_reduce) has made the batch's weighted sums and masses: the
// Kahan add of the batch mass into the (hi, lo) pair, inv = 1/max(mass,
// FLT_MIN) (0 where the mass is 0), and Sculley's move
// c += (bsum - bmass*c)*inv.  Every operation is rounded as the
// reference's (no contraction into FMAs), so the plain version gives the
// same bits.  It moves (k*d) floats: launch-bound.
//
// K7b epoch_kernel replaces :124 _mbk_epoch_fn, the lax.scan of
// _mbk_step_fn over contiguous windows: step i takes the bs rows from
// (start + i*bs) mod max(n - bs + 1, 1) of the padded rows, assigns them
// (K1a's arithmetic: d2 = max((|x|^2 + |c|^2) - 2 x.c, 0), fmaf chains in
// feature order, the first of equal centres), sums w*x and w a centre,
// and updates as K7a.  It returns the centres, the pair and the mean of
// the step inertias.  Bound on an H100: an epoch reads the padded rows
// once (100M x 50: 20.4 GB, 6.09 ms at 3.35 TB/s), but the steps are a
// serial chain (each needs the last one's centres), so the floor is the
// step count times the latency of one step: a window's assign, a reduce
// across SMs and the update.  At bs = 1024 and k = 8 that is 97,656 steps
// of ~0.4 M FMAs each.  The design, for that chain:
//   - One thread-block cluster of CL = 8 CTAs runs the whole epoch; a CTA
//     owns an eighth of each window (128 rows at bs = 1024).  No grid-wide
//     sync: the cross-SM reduce is the cluster barrier plus distributed
//     shared memory (each CTA reads the 8 partials of the step from its
//     peers and sums them in rank order, so all 8 hold the same centres).
//   - The windows do not depend on the centres, so the rows of the next
//     two windows are in flight (cp.async, three stages) while a step
//     computes.  A window starts anywhere, so a CTA copies the 16-byte
//     aligned run that covers its rows and reads them at a shift.
//   - Assign: two threads a row, each with half the centres in registers
//     from a transposed copy (float4 reads); the pair merges (value,
//     index) by a shuffle.  Reduce: thread (group g, column j) adds its
//     rows' w*x (j < d) or w (j == d) into KR register accumulators by
//     predicated adds (K1a's register path), then the groups merge in
//     order.  The step partials are double-buffered, so one cluster
//     barrier a step is enough.
//   - For k <= 16 and d <= 255 (one column a thread); past that the
//     wrapper steps the epoch through K1a and K7a.
// No float atomics: the same input gives the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int T = 256;           // threads per block
constexpr int CL = 8;            // CTAs in the epoch's cluster
constexpr int STAGES = 3;        // window copies in flight, this one included
constexpr int MAX_UNIT_ROWS = T / 2;  // two threads a row in the assign
constexpr int EPB = 4096;        // K7a: elements of the centres a block
constexpr size_t XBUDGET = 150 * 1024;  // bytes of shared memory for the row stages

// The Kahan add of the batch mass into (hi, lo); returns 1/max(mass, FLT_MIN),
// or 0 where the mass is 0.
__device__ __forceinline__ float kahan_inv(float bmass, float& hi, float& lo) {
  const float y = __fadd_rn(bmass, lo);
  const float t = __fadd_rn(hi, y);
  lo = __fsub_rn(y, __fsub_rn(t, hi));
  hi = t;
  const float mass = __fadd_rn(hi, lo);
  return mass > 0.f ? __fdiv_rn(1.f, fmaxf(mass, FLT_MIN)) : 0.f;
}

// c + (bsum - bmass*c)*inv, each operation rounded on its own.
__device__ __forceinline__ float sculley(float c, float bsum, float bmass, float inv) {
  return __fadd_rn(c, __fmul_rn(__fsub_rn(bsum, __fmul_rn(bmass, c)), inv));
}

// ------------------------------------------------------------------ K7a

// Block b updates elements [b*EPB, (b+1)*EPB) of the centres; it computes
// the pair and inv of each centre it touches, and writes a centre's pair
// where that centre's first element lies.
__global__ void update_kernel(const float* __restrict__ sums, const float* __restrict__ bmass,
                              const float* __restrict__ centers,
                              const float* __restrict__ counts, int k, int d,
                              float* __restrict__ new_centers, float* __restrict__ new_counts) {
  __shared__ float inv_s[EPB + 2], bm_s[EPB + 2];
  const long long e0 = (long long)blockIdx.x * EPB;
  const long long kd = (long long)k * d;
  const long long e1 = e0 + EPB < kd ? e0 + EPB : kd;
  const int c0 = (int)(e0 / d), c1 = (int)((e1 - 1) / d);
  for (int c = c0 + threadIdx.x; c <= c1; c += blockDim.x) {
    float hi = counts[c], lo = counts[k + c];
    const float b = bmass[c];
    inv_s[c - c0] = kahan_inv(b, hi, lo);
    bm_s[c - c0] = b;
    if ((long long)c * d >= e0) {
      new_counts[c] = hi;
      new_counts[k + c] = lo;
    }
  }
  __syncthreads();
  for (long long e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    const int c = (int)(e / d);
    new_centers[e] = sculley(centers[e], sums[e], bm_s[c - c0], inv_s[c - c0]);
  }
}

// ------------------------------------------------------------------ K7b

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(a), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 1) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// An epoch launch's plan, made at the launch by plan_epoch.
struct Plan {
  long long kr;    // register accumulators a thread (8 or 16), 0: no K7b
  long long rows;  // R: rows of a window a CTA
  long long rt;    // rows a unit (one stage of copies)
  long long units; // units a step: ceil(R / rt)
  long long sf;    // floats of one row stage
  long long smem;  // dynamic shared bytes a CTA
};

struct EpochArgs {
  const float* x;
  const float* mask;
  long long n;  // padded rows
  int d, k;
  const float* centers;
  const float* counts;
  long long start, bs, n_batches;
  Plan p;
  float* centers_out;
  float* counts_out;
  float* inertia_out;
};

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) / 4 * 4; }

// Floats of each shared-memory region, in the order they are laid out;
// every region starts on a 16-byte boundary.
struct Layout {
  int sf, rt4, k, d, kr, e, g;
  __host__ __device__ Layout(const Plan& p, int k_, int d_)
      : sf((int)p.sf), rt4(round4((int)p.rt)), k(k_), d(d_), kr((int)p.kr),
        e(k_ * (d_ + 1) + 1), g(T / (d_ + 1)) {}
  __host__ __device__ int xbuf() const { return 0; }
  __host__ __device__ int mbuf() const { return xbuf() + STAGES * sf; }
  __host__ __device__ int cs() const { return mbuf() + STAGES * rt4; }
  __host__ __device__ int ct() const { return cs() + round4(k * d); }
  __host__ __device__ int cn() const { return ct() + d * kr; }
  __host__ __device__ int lab() const { return cn() + kr; }
  __host__ __device__ int w() const { return lab() + rt4; }
  __host__ __device__ int gpart() const { return w() + rt4; }
  __host__ __device__ int part() const { return gpart() + round4(g * k * (d + 1)); }
  __host__ __device__ int tot() const { return part() + 2 * round4(e); }
  __host__ __device__ int pair() const { return tot() + round4(e); }  // hi, lo, inv, bmass
  __host__ __device__ int red() const { return pair() + round4(4 * k); }
  __host__ __device__ int total() const { return red() + T; }
};

// The centres' transposed copy for the assign: ct[j*KR + h*(KR/2) + q] is
// feature j of centre h + 2q (0 past k), so the thread of half h reads its
// KR/2 centres of a feature as float4s; and their norms, fmaf chains in
// feature order as K1a's.
template <int KR>
__device__ void prepare_centers(const float* cs, float* ct, float* cn, int k, int d) {
  for (int e = threadIdx.x; e < d * KR; e += T) {
    const int j = e / KR, slot = e - j * KR;
    const int c = slot / (KR / 2) + 2 * (slot % (KR / 2));
    ct[e] = c < k ? cs[c * d + j] : 0.f;
  }
  for (int c = threadIdx.x; c < k; c += T) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(cs[c * d + j], cs[c * d + j], s);
    cn[c] = s;
  }
}

template <int KR>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(T, 1)
epoch_kernel(EpochArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const Layout L(a.p, a.k, a.d);
  const int k = a.k, d = a.d, D1 = d + 1, E = L.e, G = L.g;
  const int t = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  float* xbuf = smem + L.xbuf();
  float* mbuf = smem + L.mbuf();
  float* cs = smem + L.cs();
  float* ct = smem + L.ct();
  float* cn = smem + L.cn();
  int* lab_s = reinterpret_cast<int*>(smem + L.lab());
  float* w_s = smem + L.w();
  float* gpart = smem + L.gpart();
  float* part = smem + L.part();
  float* tot = smem + L.tot();
  float* hi_s = smem + L.pair();
  float* lo_s = hi_s + k;
  float* inv_s = lo_s + k;
  float* bm_s = inv_s + k;
  float* red_s = smem + L.red();

  const int R = (int)a.p.rows, RT = (int)a.p.rt, U = (int)a.p.units, SF = (int)a.p.sf;
  const int RT4 = L.rt4;  // the mask stages' stride
  const long long span = a.n - a.bs + 1 > 1 ? a.n - a.bs + 1 : 1;
  const int my0 = rank * R;
  const int my_rows = (int)(a.bs - my0 < R ? (a.bs - my0 > 0 ? a.bs - my0 : 0) : R);
  const long long total = a.n_batches * U;
  const float* xend = a.x + a.n * d;

  // unit -> (first global row, rows)
  auto geom = [&](long long unit, long long& g0, int& rc) {
    const long long i = unit / U;
    const int u = (int)(unit - i * U);
    const long long off = (a.start + i * a.bs) % span;
    rc = my_rows - u * RT;
    rc = rc < 0 ? 0 : rc > RT ? RT : rc;
    g0 = off + my0 + (long long)u * RT;
  };
  auto shift_of = [&](long long g0) {
    return (int)(((uintptr_t)(a.x + g0 * d) & 15) / sizeof(float));
  };
  auto prefetch = [&](long long unit) {
    if (unit < total) {
      long long g0;
      int rc;
      geom(unit, g0, rc);
      if (rc > 0) {
        const int b = (int)(unit % STAGES);
        const float* s = a.x + g0 * d;
        const int shift = shift_of(g0);
        const float* base = s - shift;
        const int pieces = (shift + rc * d + 3) / 4;
        float* dst = xbuf + b * SF;
        for (int p = t; p < pieces; p += T) {
          const float* src = base + 4 * p;
          const long long avail = xend - src;
          cp_async16(dst + 4 * p, src, avail >= 4 ? 16 : (int)avail * 4);
        }
        for (int r = t; r < rc; r += T) cp_async4(mbuf + b * RT4 + r, a.mask + g0 + r);
      }
    }
    cp_async_commit();
  };

  for (int e = t; e < k * d; e += T) cs[e] = a.centers[e];
  for (int c = t; c < k; c += T) {
    hi_s[c] = a.counts[c];
    lo_s[c] = a.counts[k + c];
  }
  __syncthreads();
  prepare_centers<KR>(cs, ct, cn, k, d);
  for (int s = 0; s < STAGES - 1; ++s) prefetch(s);
  __syncthreads();

  // reduce: thread (group g, column j)
  const int g = t / D1, j = t - g * D1;
  float racc[KR];
#pragma unroll
  for (int c = 0; c < KR; ++c) racc[c] = 0.f;
  float inert_t = 0.f;
  double inert_sum = 0.0;

  for (long long unit = 0; unit < total; ++unit) {
    prefetch(unit + STAGES - 1);
    cp_async_wait_stages();
    __syncthreads();  // this unit's rows have landed, from every thread

    long long g0;
    int rc;
    geom(unit, g0, rc);
    const long long i = unit / U;
    const int u = (int)(unit - i * U);
    const int b = (int)(unit % STAGES);
    const float* xb = xbuf + b * SF + (rc > 0 ? shift_of(g0) : 0);
    const float* mb = mbuf + b * RT4;

    {  // assign: thread pair (row r, half h)
      const int r = t >> 1, h = t & 1;
      const bool valid = r < rc;
      float best = INFINITY;
      int bidx = 0;
      if (valid) {
        float acc[KR / 2];
#pragma unroll
        for (int q = 0; q < KR / 2; ++q) acc[q] = 0.f;
        float xn = 0.f;
        const float* xr = xb + r * d;
        for (int jj = 0; jj < d; ++jj) {
          const float xv = xr[jj];
          xn = fmaf(xv, xv, xn);
          const float4* cj = reinterpret_cast<const float4*>(ct + jj * KR + h * (KR / 2));
#pragma unroll
          for (int q4 = 0; q4 < KR / 8; ++q4) {
            const float4 cv = cj[q4];
            acc[4 * q4] = fmaf(xv, cv.x, acc[4 * q4]);
            acc[4 * q4 + 1] = fmaf(xv, cv.y, acc[4 * q4 + 1]);
            acc[4 * q4 + 2] = fmaf(xv, cv.z, acc[4 * q4 + 2]);
            acc[4 * q4 + 3] = fmaf(xv, cv.w, acc[4 * q4 + 3]);
          }
        }
#pragma unroll
        for (int q = 0; q < KR / 2; ++q) {
          const int c = h + 2 * q;
          if (c < k) {
            const float dd = fmaxf((xn + cn[c]) - 2.f * acc[q], 0.f);
            if (dd < best) { best = dd; bidx = c; }
          }
        }
      }
      const float ov = __shfl_xor_sync(0xffffffffu, best, 1);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, 1);
      if (ov < best || (ov == best && oi < bidx)) { best = ov; bidx = oi; }
      if (valid && h == 0) {
        const float wr = mb[r];
        lab_s[r] = bidx;
        w_s[r] = wr;
        inert_t += wr * best;
      }
    }
    __syncthreads();  // labels and weights are written

    if (g < G) {  // the register reduce of this unit's rows
      for (int r = g; r < rc; r += G) {
        const int lab = lab_s[r];
        const float v = w_s[r] * (j < d ? xb[r * d + j] : 1.f);
#pragma unroll
        for (int c = 0; c < KR; ++c)
          if (lab == c) racc[c] += v;
      }
    }

    if (u == U - 1) {  // the step's last unit: reduce across the cluster, update
      if (g < G) {
#pragma unroll
        for (int c = 0; c < KR; ++c)
          if (c < k) gpart[(g * k + c) * D1 + j] = racc[c];
      }
#pragma unroll
      for (int c = 0; c < KR; ++c) racc[c] = 0.f;
      red_s[t] = inert_t;
      inert_t = 0.f;
      __syncthreads();
      float* P = part + (int)(i & 1) * round4(E);
      for (int e = t; e < k * D1; e += T) {
        float s = 0.f;
        for (int gg = 0; gg < G; ++gg) s += gpart[gg * k * D1 + e];
        P[e] = s;
      }
      for (int s = T / 2; s > 0; s >>= 1) {
        if (t < s) red_s[t] += red_s[t + s];
        __syncthreads();
      }
      if (t == 0) P[k * D1] = red_s[0];
      cluster.sync();  // every CTA's partial of step i is visible to all
      for (int e = t; e < E; e += T) {
        float s = 0.f;
        for (int q = 0; q < CL; ++q) s += cluster.map_shared_rank(P, q)[e];
        tot[e] = s;
      }
      __syncthreads();
      for (int c = t; c < k; c += T) {
        const float bm = tot[c * D1 + d];
        inv_s[c] = kahan_inv(bm, hi_s[c], lo_s[c]);
        bm_s[c] = bm;
      }
      if (t == 0) inert_sum += (double)tot[k * D1];
      __syncthreads();
      for (int e = t; e < k * d; e += T) {
        const int c = e / d;
        cs[e] = sculley(cs[e], tot[c * D1 + (e - c * d)], bm_s[c], inv_s[c]);
      }
      __syncthreads();
      prepare_centers<KR>(cs, ct, cn, k, d);
    }
    __syncthreads();  // this unit's buffers may be refilled
  }
  cp_async_wait_all();

  if (rank == 0) {
    for (int e = t; e < k * d; e += T) a.centers_out[e] = cs[e];
    for (int c = t; c < k; c += T) {
      a.counts_out[c] = hi_s[c];
      a.counts_out[k + c] = lo_s[c];
    }
    if (t == 0) a.inertia_out[0] = (float)(inert_sum / (double)a.n_batches);
  }
  cluster.sync();  // no CTA leaves while a peer may still read its partials
}

template <int KR>
cudaError_t set_smem(size_t bytes) {
  return cudaFuncSetAttribute(epoch_kernel<KR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Plans an epoch of bs-row windows over d features and k centres.
// p.kr == 0: K7b does not take this shape.
Plan plan_epoch(long long bs, int d, int k) {
  Plan p;
  p.kr = (k <= 8 ? 8 : k <= 16 ? 16 : 0);
  if (d + 1 > T || d < 1 || bs < 1) p.kr = 0;
  p.rows = (bs + CL - 1) / CL;
  const long long fit = ((long long)(XBUDGET / sizeof(float)) / STAGES - 8) / (d + 1);
  long long rt = p.rows < MAX_UNIT_ROWS ? p.rows : MAX_UNIT_ROWS;
  if (rt > fit) rt = fit;
  if (rt < 1) p.kr = 0;
  p.rt = rt < 1 ? 1 : rt;
  p.units = (p.rows + p.rt - 1) / p.rt;
  p.sf = (p.rt * d + 3 + 3) / 4 * 4;
  p.smem = p.kr ? (long long)Layout(p, k, d).total() * (long long)sizeof(float) : 0;
  return p;
}

}  // namespace

extern "C" {

enum { MBK_NOT_TAKEN = -1 };  // mbk_epoch: not a CUDA error code

const char* minibatch_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// sums (k, d), bmass (k,): K1a's outputs; centers (k, d), counts (2, k):
// the state.  Writes new_centers (k, d) and new_counts (2, k).
int mbk_update(const void* sums, const void* bmass, const void* centers, const void* counts,
               int k, int d, void* new_centers, void* new_counts, void* stream) {
  const long long kd = (long long)k * d;
  const long long blocks = (kd + EPB - 1) / EPB;
  update_kernel<<<(unsigned)blocks, T, 0, (cudaStream_t)stream>>>(
      (const float*)sums, (const float*)bmass, (const float*)centers, (const float*)counts, k,
      d, (float*)new_centers, (float*)new_counts);
  return (int)cudaGetLastError();
}

// x (n, d) padded rows and mask (n,), 16-byte aligned x; centers (k, d),
// counts (2, k).  One epoch of n_batches windows of bs rows from start.
// Writes centers_out, counts_out and inertia_out (1,): the mean step inertia.
// Returns MBK_NOT_TAKEN, and launches nothing, where K7b does not take the shape.
int mbk_epoch(const void* x, const void* mask, long long n, int d, int k, const void* centers,
              const void* counts, long long start, long long bs, long long n_batches,
              void* centers_out, void* counts_out, void* inertia_out,
              void* stream) {
  EpochArgs a;
  a.x = (const float*)x;
  a.mask = (const float*)mask;
  a.n = n; a.d = d; a.k = k;
  a.centers = (const float*)centers;
  a.counts = (const float*)counts;
  a.start = start; a.bs = bs; a.n_batches = n_batches;
  a.p = plan_epoch(bs, d, k);
  a.centers_out = (float*)centers_out;
  a.counts_out = (float*)counts_out;
  a.inertia_out = (float*)inertia_out;
  if (a.p.kr == 0) return MBK_NOT_TAKEN;
  // set at every launch: launches of other shapes may have set another size
  const cudaError_t err = a.p.kr == 8 ? set_smem<8>((size_t)a.p.smem)
                                      : set_smem<16>((size_t)a.p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.p.kr == 8)
    epoch_kernel<8><<<CL, T, (size_t)a.p.smem, s>>>(a);
  else
    epoch_kernel<16><<<CL, T, (size_t)a.p.smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
