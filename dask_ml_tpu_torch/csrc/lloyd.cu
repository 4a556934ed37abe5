// Fused Lloyd assign (+ cluster reduce) for Hopper (sm_90a), plain C ABI.
//
// Replaces: dask_ml_tpu/cluster/k_means.py :: _lloyd_step_fn (distances,
// argmin, masked inertia, per-cluster sums and counts) and _assign_fn /
// _phi_and_mind2 / _valid_d2 (distances, argmin, min), and with them the
// Pallas kernel that ebad2d0 deleted (dask_ml_tpu/ops/lloyd.py ::
// lloyd_assign_reduce).  The n x k distance matrix is never written.
//
// Bound on an H100: at k=8 one round reads n*d*4 + n*4 bytes and does
// n*k*d fused multiply-adds; at 100M x 50 that is 20.4 GB (6.1 ms at
// 3.35 TB/s) against 40 G FMAs (1.2 ms at 67 TFLOP/s float32), so the
// round is memory-bound.  The design therefore reads each row of x from
// device memory once per call: a block stages a 256-row tile through
// shared memory with coalesced loads and keeps it there for both the
// distances and the reduce.  The distances run in plain float32 FMA on
// the CUDA cores (no TF32, no tensor cores), so the argmin sees the same
// arithmetic as the reference's Precision.HIGHEST.
//
// Layout of the work:
//   - Each block walks row tiles grid-stride; one thread owns one row.
//   - Centers pass through shared memory CT at a time, features DCH at a
//     time, so any k*d fits; the running min/argmin stays in registers
//     across center tiles.  Ties keep the first index (jnp.argmin's rule).
//   - The reduce gives each thread one feature column of one row group and
//     walks the tile's rows in order into a (groups, k, d) partial in
//     shared memory; where that does not fit, one group accumulates
//     straight into the block's record in global scratch.
//   - A second kernel adds the per-block records in block order.
// No float atomics anywhere: the same input gives the same bits on the
// same card from run to run.  Every row index is 64-bit (row*d passes 2^31
// at row 42.9M for d=50).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 256;       // rows per tile = threads per block
constexpr int CT = 8;        // centers per register tile
constexpr int DCH = 64;      // features per staged chunk
constexpr int GMAX = 8;      // row groups in the reduce
constexpr size_t SMEM_BUDGET = 200 * 1024;
constexpr int MAX_BLOCKS_PER_SM = 4;

// A launch's plan: made once per call by lloyd_plan, which hands it to the
// caller as 8 int64s to size the scratch, and passed back to the launch.
struct Plan {
  long long w;          // staged chunk width, min(d, DCH)
  long long dp;         // row stride of the staged tile, odd: no bank conflicts
  long long groups;     // row groups in the reduce (0: no reduce)
  long long p_in_smem;  // the (groups, k*d + k) partial lives in shared memory;
                        // else groups == 1 and it is the block's own record
  long long smem;       // dynamic shared bytes per block
  long long blocks;
  long long rec;        // floats per block record: k*d + k + 1, or 1
  long long scratch;    // floats of scratch the call needs
};
static_assert(sizeof(Plan) == 8 * sizeof(long long), "Plan is 8 int64s");

__device__ __forceinline__ void stage_x(float* x_s, const float* __restrict__ x,
                                        long long r0, int rows, int d, int j0,
                                        int wc, int dp) {
  const int total = rows * wc;
  int r = threadIdx.x / wc, j = threadIdx.x % wc;
  const int dr = T / wc, dj = T % wc;
  if (wc == d) {  // the tile is one contiguous run of rows*d floats
    const float* src = x + r0 * d;
    for (int i = threadIdx.x; i < total; i += T) {
      x_s[r * dp + j] = __ldcs(src + i);
      r += dr; j += dj;
      if (j >= wc) { j -= wc; ++r; }
    }
  } else {
    for (int i = threadIdx.x; i < total; i += T) {
      x_s[r * dp + j] = __ldcs(x + (r0 + r) * d + j0 + j);
      r += dr; j += dj;
      if (j >= wc) { j -= wc; ++r; }
    }
  }
}

// c_s[j*CT + c] = centers[ct*CT + c][j0 + j]; slots past k are zero.
__device__ __forceinline__ void stage_c(float* c_s, const float* __restrict__ centers,
                                        int k, int d, int ct, int j0, int wc) {
  for (int i = threadIdx.x; i < CT * wc; i += T) {
    const int j = i / CT, c = i - j * CT;
    const int cc = ct * CT + c;
    c_s[i] = cc < k ? centers[(size_t)cc * d + j0 + j] : 0.f;
  }
}

__global__ void cnorm_kernel(const float* __restrict__ centers, int k, int d,
                             float* __restrict__ cn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < k) {
    const float* c = centers + (size_t)i * d;
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(c[j], c[j], s);
    cn[i] = s;
  }
}

template <bool REDUCE>
__global__ void __launch_bounds__(T)
lloyd_kernel(const float* __restrict__ x, const float* __restrict__ mask,
             const float* __restrict__ centers, const float* __restrict__ cn,
             const float* __restrict__ cvalid, long long n, int d, int k,
             Plan p, int64_t* __restrict__ labels, float* __restrict__ mind2,
             float* __restrict__ bpart) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int w = (int)p.w, dp = (int)p.dp, G = (int)p.groups;
  float* x_s = smem;
  float* c_s = x_s + T * dp;
  int* lab_s = reinterpret_cast<int*>(c_s + CT * w);
  float* w_s = reinterpret_cast<float*>(lab_s + T);
  float* r_s = w_s + T;
  const size_t kd = (size_t)k * d;
  float* out = bpart + (size_t)blockIdx.x * p.rec;
  float* P = nullptr;
  if (REDUCE) P = p.p_in_smem ? r_s + T : out;
  float* Pc = REDUCE ? P + G * kd : nullptr;

  const long long ntiles = (n + T - 1) / T;
  const int nch = (d + w - 1) / w;
  const int nct = (k + CT - 1) / CT;

  if (REDUCE)
    for (size_t e = t; e < G * (kd + k); e += T) P[e] = 0.f;
  float inert = 0.f;
  long long c_staged = -1;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long r0 = tile * T;
    const int rows = (int)min((long long)T, n - r0);
    const bool live = t < rows;
    int x_staged = -1;
    float xn = 0.f, best = INFINITY;
    int bidx = 0;
    for (int ct = 0; ct < nct; ++ct) {
      float acc[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[c] = 0.f;
      for (int ch = 0; ch < nch; ++ch) {
        const int j0 = ch * w, wc = min(w, d - j0);
        const long long cid = (long long)ct * nch + ch;
        const bool need_x = x_staged != ch, need_c = c_staged != cid;
        if (need_x || need_c) {
          __syncthreads();  // all readers of the old contents are done
          if (need_x) { stage_x(x_s, x, r0, rows, d, j0, wc, dp); x_staged = ch; }
          if (need_c) { stage_c(c_s, centers, k, d, ct, j0, wc); c_staged = cid; }
          __syncthreads();
        }
        if (live) {
          const float* xr = x_s + t * dp;
#pragma unroll 2
          for (int j = 0; j < wc; ++j) {
            const float xj = xr[j];
            if (ct == 0) xn = fmaf(xj, xj, xn);
            const float4 a = *reinterpret_cast<const float4*>(c_s + j * CT);
            const float4 b = *reinterpret_cast<const float4*>(c_s + j * CT + 4);
            acc[0] = fmaf(xj, a.x, acc[0]);
            acc[1] = fmaf(xj, a.y, acc[1]);
            acc[2] = fmaf(xj, a.z, acc[2]);
            acc[3] = fmaf(xj, a.w, acc[3]);
            acc[4] = fmaf(xj, b.x, acc[4]);
            acc[5] = fmaf(xj, b.y, acc[5]);
            acc[6] = fmaf(xj, b.z, acc[6]);
            acc[7] = fmaf(xj, b.w, acc[7]);
          }
        }
      }
      if (live) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int cc = ct * CT + c;
          if (cc < k) {
            float dd = fmaxf((xn + cn[cc]) - 2.f * acc[c], 0.f);
            // invalid candidate slots are selected out to +inf, never
            // pushed out by adding a large value
            if (cvalid != nullptr && !(cvalid[cc] > 0.f)) dd = INFINITY;
            if (dd < best) { best = dd; bidx = cc; }
          }
        }
      }
    }
    const float wgt = live ? mask[r0 + t] : 0.f;
    if (live) {
      inert += wgt * best;
      if (!REDUCE) { labels[r0 + t] = bidx; mind2[r0 + t] = best; }
    }
    if (REDUCE) {
      lab_s[t] = bidx;
      w_s[t] = wgt;
      const int g = t / w, jj = t % w;
      for (int ch = 0; ch < nch; ++ch) {
        const int j0 = ch * w, wc = min(w, d - j0);
        __syncthreads();  // lab_s/w_s written; old x_s readers done
        if (x_staged != ch) {
          stage_x(x_s, x, r0, rows, d, j0, wc, dp);
          x_staged = ch;
          __syncthreads();
        }
        if (g < G && jj < wc) {
          float* Pg = P + g * kd + j0 + jj;
          for (int r = g; r < rows; r += G)
            Pg[(size_t)lab_s[r] * d] += w_s[r] * x_s[r * dp + jj];
          if (ch == 0 && jj == 0) {
            float* Pcg = Pc + (size_t)g * k;
            for (int r = g; r < rows; r += G) Pcg[lab_s[r]] += w_s[r];
          }
        }
      }
    }
  }

  // per-block record, in a fixed order
  r_s[t] = inert;
  __syncthreads();
  for (int s = T / 2; s > 0; s >>= 1) {
    if (t < s) r_s[t] += r_s[t + s];
    __syncthreads();
  }
  if (REDUCE && p.p_in_smem) {
    for (size_t e = t; e < kd + k; e += T) {
      const float* src = e < kd ? P + e : Pc + (e - kd);
      const size_t stride = e < kd ? kd : (size_t)k;
      float s = 0.f;
      for (int g = 0; g < G; ++g) s += src[g * stride];
      out[e] = s;
    }
  }
  if (t == 0) out[p.rec - 1] = r_s[0];
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

cudaError_t make_plan(long long n, int d, int k, bool reduce, Plan* p) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  p->w = d < DCH ? d : DCH;
  p->dp = p->w | 1;
  p->groups = reduce ? (T / p->w < GMAX ? T / p->w : GMAX) : 0;
  const size_t base = (size_t)(T * p->dp + CT * p->w + 3 * T) * sizeof(float);
  const size_t part = (size_t)p->groups * ((size_t)k * d + k) * sizeof(float);
  p->p_in_smem = reduce && base + part <= SMEM_BUDGET;
  if (reduce && !p->p_in_smem) p->groups = 1;
  p->smem = (long long)(base + (p->p_in_smem ? part : 0));
  const void* fn = reduce ? (const void*)lloyd_kernel<true>
                          : (const void*)lloyd_kernel<false>;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p->smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, T, (size_t)p->smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  if (per_sm > MAX_BLOCKS_PER_SM) per_sm = MAX_BLOCKS_PER_SM;
  // a record of k*d + k + 1 floats a block: keep large ones few
  if (reduce && !p->p_in_smem) per_sm = 1;
  const long long ntiles = (n + T - 1) / T;
  const long long most = (long long)sms * per_sm;
  p->blocks = ntiles < most ? ntiles : most;
  p->rec = reduce ? (long long)k * d + k + 1 : 1;
  p->scratch = k + (long long)p->blocks * p->rec;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* lloyd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Plans a call with these sizes into plan (8 int64s; plan[7] is the floats
// of scratch it needs), to be passed back to the launch.
int lloyd_plan(long long n, int d, int k, int reduce, void* plan) {
  return (int)make_plan(n, d, k, reduce != 0, (Plan*)plan);
}

// x (n,d), mask (n,), centers (k,d): float32, contiguous, on one device.
// out: k*d sums, then k counts, then the inertia (k*d + k + 1 floats).
int lloyd_assign_reduce(const void* x, const void* mask, const void* centers,
                        long long n, int d, int k, const void* plan,
                        void* scratch, void* out, void* stream) {
  const Plan p = *(const Plan*)plan;
  cudaStream_t s = (cudaStream_t)stream;
  float* cn = (float*)scratch;
  float* bpart = cn + k;
  cnorm_kernel<<<(k + 127) / 128, 128, 0, s>>>((const float*)centers, k, d, cn);
  lloyd_kernel<true><<<(int)p.blocks, T, (size_t)p.smem, s>>>(
      (const float*)x, (const float*)mask, (const float*)centers, cn, nullptr,
      n, d, k, p, nullptr, nullptr, bpart);
  const long long fb = (p.rec + 255) / 256;
  finalize_kernel<<<(int)(fb < 1024 ? fb : 1024), 256, 0, s>>>(
      bpart, (int)p.blocks, p.rec, (float*)out);
  return (int)cudaGetLastError();
}

// x (n,d), mask (n,), centers (k,d), cvalid (k,) or null: float32.
// labels (n,) int64, mind2 (n,) float32, inertia (1,) float32.
int lloyd_assign(const void* x, const void* mask, const void* centers,
                 const void* cvalid, long long n, int d, int k, const void* plan,
                 void* labels, void* mind2, void* scratch, void* inertia,
                 void* stream) {
  const Plan p = *(const Plan*)plan;
  cudaStream_t s = (cudaStream_t)stream;
  float* cn = (float*)scratch;
  float* bpart = cn + k;
  cnorm_kernel<<<(k + 127) / 128, 128, 0, s>>>((const float*)centers, k, d, cn);
  lloyd_kernel<false><<<(int)p.blocks, T, (size_t)p.smem, s>>>(
      (const float*)x, (const float*)mask, (const float*)centers, cn,
      (const float*)cvalid, n, d, k, p, (int64_t*)labels, (float*)mind2, bpart);
  finalize_kernel<<<1, 32, 0, s>>>(bpart, (int)p.blocks, 1, (float*)inertia);
  return (int)cudaGetLastError();
}

}  // extern "C"
