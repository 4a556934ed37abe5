// K9 and K9b for Hopper (sm_90a), plain C ABI: GaussianNB's per-class
// moments and its joint log-likelihood.
//
// K9 replaces dask_ml_tpu/naive_bayes.py:18 _class_moments_fn: with
// w = weight (the mask times sample_weight) and c the row's class,
//   counts_c = Σ w,  means_cj = Σ w·x_j / safe(counts_c),
//   var_cj   = Σ w·(x_j − means_{c j})² / safe(counts_c),
// safe(m) = m where m > 0, else 1.  The row's class mean is selected by its
// label, not weighted (the reference's binary one-hot, :26-31).  Two
// launches of one kernel template (sums, then squared deviations from the
// first launch's means), each followed by a finish.
// K9b replaces :138 _joint_log_likelihood under predict and predict_proba:
//   jll_ic = log prior_c + (−0.5 · Σ_j [log(2π var_cj) + (x_ij − θ_cj)² / var_cj])
// summed over j in order, every operation rounded as its own float32 op
// (__fsub_rn, __fmul_rn, __fdiv_rn, __fadd_rn: no contraction), with
// log(2π var) and log prior taken by the caller; so it gives the bits of
// the plain version, which sums in the same order.  It writes jll (n, k),
// or for predict the index of the first largest (jnp.argmax's rule).
//
// Bounds on an H100 at 11M x 28: each K9 pass reads x, the labels and the
// weights once (1.32 GB, 0.39 ms at 3.35 TB/s); K9b reads x once and writes
// jll (k = 2: 1.32 GB, 0.39 ms; k = 10 with jll: 1.67 GB, 0.50 ms).  Both
// do a few operations a byte: the bytes bound them.  The design:
//   - moments_kernel: a block takes a range of rows and a tile of up to T
//     features; thread (g, jj) of G = T / FT row groups owns feature jj of
//     its tile over rows g, g + G, ... and keeps one partial a class in
//     shared memory (s[c·T + thread]: no atomics, no bank conflicts); the
//     first thread of each group also keeps the weight mass a class.  The
//     block sums the groups in order into its record (k, d + 1).
//   - finish_kernel: a thread an output sums the block records in block
//     order, so the result is deterministic, and divides by safe(count).
//   - jll_kernel: persistent blocks of 128 threads, a row a thread.  θ, var
//     and log(2π var) (k, d) and log prior sit in shared memory; each tile
//     of 128 rows is copied to shared memory with coalesced loads, at an odd
//     row stride so a row a thread reads without bank conflicts.
// What holds them back: the moments' shared read-modify-write an element,
// and K9b's division an element and class (k·d of them a row).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T_MAX = 256;           // threads of moments_kernel at most
constexpr int JLL_T = 128;           // threads (and rows a tile) of jll_kernel
constexpr int MIN_ROWS = 1024;       // rows a moments block at least
constexpr size_t SMEM_CAP = 200 * 1024;

template <bool DEV>
__global__ void __launch_bounds__(T_MAX)
moments_kernel(const float* __restrict__ x, const int* __restrict__ labels,
               const float* __restrict__ w, long long n, int d, int k,
               const float* __restrict__ means, int FT, long long rows_per_block,
               float* __restrict__ records) {
  extern __shared__ float s_part[];  // k x T partials, then k x G weight masses
  const int T = blockDim.x;
  const int G = T / FT;
  float* s_mass = s_part + (long long)k * T;
  for (int i = threadIdx.x; i < k * T + k * G; i += T) s_part[i] = 0.0f;
  __syncthreads();
  const int g = threadIdx.x / FT, jj = threadIdx.x % FT;
  const int j = blockIdx.y * FT + jj;
  const bool mass = !DEV && blockIdx.y == 0 && jj == 0;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  if (g < G && j < d) {
    for (long long r = r0 + g; r < r1; r += G) {
      const int c = labels[r];
      if (c < 0 || c >= k) continue;
      const float wr = w[r];
      const float v = x[r * d + j];
      float t;
      if (DEV) {
        const float dv = __fsub_rn(v, means[(long long)c * d + j]);
        t = __fmul_rn(wr, __fmul_rn(dv, dv));
      } else {
        t = __fmul_rn(wr, v);
      }
      s_part[c * T + threadIdx.x] = __fadd_rn(s_part[c * T + threadIdx.x], t);
      if (mass) s_mass[c * G + g] = __fadd_rn(s_mass[c * G + g], wr);
    }
  }
  __syncthreads();
  float* rec = records + (long long)blockIdx.x * k * (d + 1);
  for (int o = threadIdx.x; o < k * FT; o += T) {
    const int c = o / FT, q = o % FT, jo = blockIdx.y * FT + q;
    if (jo >= d) continue;
    float acc = 0.0f;
    for (int gg = 0; gg < G; ++gg) acc = __fadd_rn(acc, s_part[c * T + gg * FT + q]);
    rec[c * (d + 1) + jo] = acc;
  }
  if (!DEV && blockIdx.y == 0) {
    for (int c = threadIdx.x; c < k; c += T) {
      float acc = 0.0f;
      for (int gg = 0; gg < G; ++gg) acc = __fadd_rn(acc, s_mass[c * G + gg]);
      rec[c * (d + 1) + d] = acc;
    }
  }
}

// DEV false: out = sums / safe(counts) (the means), and counts; DEV true:
// out = squared deviations / safe(counts_in) (the variances).
template <bool DEV>
__global__ void finish_kernel(const float* __restrict__ records, int blocks, int d, int k,
                              const float* __restrict__ counts_in, float* __restrict__ counts,
                              float* __restrict__ out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)k * (d + 1);
  if (o < k * d) {
    const int c = o / d, j = o % d;
    float s = 0.0f, m = 0.0f;
    for (int b = 0; b < blocks; ++b) s = __fadd_rn(s, records[b * stride + c * (d + 1) + j]);
    if (DEV) {
      m = counts_in[c];
    } else {
      for (int b = 0; b < blocks; ++b) m = __fadd_rn(m, records[b * stride + c * (d + 1) + d]);
    }
    out[o] = __fdiv_rn(s, m > 0.0f ? m : 1.0f);
  } else if (!DEV && o < k * d + k) {
    const int c = o - k * d;
    float m = 0.0f;
    for (int b = 0; b < blocks; ++b) m = __fadd_rn(m, records[b * stride + c * (d + 1) + d]);
    counts[c] = m;
  }
}

// A row a thread; tiles of JLL_T rows, the block walking them in turn.
__global__ void __launch_bounds__(JLL_T)
jll_kernel(const float* __restrict__ x, long long n, int d, int k,
           const float* __restrict__ theta, const float* __restrict__ var,
           const float* __restrict__ logterm, const float* __restrict__ logprior,
           int params_shared, int stride, float* __restrict__ jll, long long* __restrict__ pred) {
  extern __shared__ float smem[];
  const long long kd = (long long)k * d;
  const float *th = theta, *vr = var, *lt = logterm, *lp = logprior;
  float* s_x = smem;
  if (params_shared) {
    float* s_th = smem;
    float* s_vr = s_th + kd;
    float* s_lt = s_vr + kd;
    float* s_lp = s_lt + kd;
    for (long long i = threadIdx.x; i < kd; i += JLL_T) {
      s_th[i] = theta[i];
      s_vr[i] = var[i];
      s_lt[i] = logterm[i];
    }
    for (int i = threadIdx.x; i < k; i += JLL_T) s_lp[i] = logprior[i];
    th = s_th;
    vr = s_vr;
    lt = s_lt;
    lp = s_lp;
    s_x = s_lp + ((k + 3) & ~3);
  }
  const long long tiles = (n + JLL_T - 1) / JLL_T;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * JLL_T;
    const int rows = (int)min((long long)JLL_T, n - row0);
    const float* xr;
    if (stride > 0) {
      __syncthreads();  // the last tile's reads are done (and the params are in)
      const float* src = x + row0 * d;
      for (long long i = threadIdx.x; i < (long long)rows * d; i += JLL_T) {
        const int r = (int)(i / d), j = (int)(i % d);
        s_x[r * stride + j] = src[i];
      }
      __syncthreads();
      xr = s_x + threadIdx.x * stride;
    } else {
      if (tile == blockIdx.x) __syncthreads();  // the params are in
      xr = x + (row0 + threadIdx.x) * d;
    }
    if (threadIdx.x >= rows) continue;
    const long long row = row0 + threadIdx.x;
    float best = 0.0f;
    long long arg = 0;
    for (int c = 0; c < k; ++c) {
      const float* tc = th + (long long)c * d;
      const float* vc = vr + (long long)c * d;
      const float* lc = lt + (long long)c * d;
      float acc = 0.0f;
      for (int j = 0; j < d; ++j) {
        const float diff = __fsub_rn(xr[j], tc[j]);
        const float q = __fdiv_rn(__fmul_rn(diff, diff), vc[j]);
        acc = __fadd_rn(acc, __fadd_rn(lc[j], q));
      }
      const float v = __fadd_rn(lp[c], __fmul_rn(-0.5f, acc));
      if (jll) jll[row * k + c] = v;
      if (c == 0 || v > best || (isnan(v) && !isnan(best))) {
        best = v;
        arg = c;
      }
    }
    if (pred) pred[row] = arg;
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

struct MomentsPlan {
  int threads, FT, ftiles;
  long long row_blocks, rows_per_block;
  size_t smem;
  int ok;
  MomentsPlan(long long n, int d, int k, int sms) {
    threads = T_MAX;
    while (threads > 32 && (size_t)k * 2 * threads * sizeof(float) > SMEM_CAP) threads /= 2;
    ok = (size_t)k * 2 * threads * sizeof(float) <= SMEM_CAP;
    FT = d < threads ? d : threads;
    ftiles = (d + FT - 1) / FT;
    const int G = threads / FT;
    smem = (size_t)k * (threads + G) * sizeof(float);
    long long want = (long long)sms * 8 / ftiles;
    want = want < 1 ? 1 : want;
    const long long most = (n + MIN_ROWS - 1) / MIN_ROWS;
    row_blocks = want < most ? want : (most < 1 ? 1 : most);
    rows_per_block = (n + row_blocks - 1) / row_blocks;
  }
};

}  // namespace

extern "C" {

const char* naive_bayes_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Floats of scratch K9's launches need (the block records), or -1 where k
// is more classes than the kernel takes.
long long class_moments_scratch_floats(long long n, int d, int k) {
  int sms = 132;
  if (sm_count(&sms) != 0) return -1;
  MomentsPlan p(n, d, k, sms);
  return p.ok ? p.row_blocks * k * (long long)(d + 1) : -1;
}

// pass 0: x (n, d), labels (n,) int32 in [0, k) (others skipped), w (n,):
// counts (k,) and means (k, d).  pass 1: var (k, d) from means and counts.
int class_moments_pass(int pass, const float* x, const int* labels, const float* w,
                       long long n, int d, int k, float* scratch, float* counts, float* means,
                       float* var, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int sms = 132;
  int err = sm_count(&sms);
  if (err != 0) return err;
  MomentsPlan p(n, d, k, sms);
  if (!p.ok) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)p.row_blocks, (unsigned)p.ftiles);
  const int fin = (k * d + k + 127) / 128;
  if (pass == 0) {
    err = (int)cudaFuncSetAttribute(moments_kernel<false>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_CAP);
    if (err != 0) return err;
    moments_kernel<false><<<grid, p.threads, p.smem, s>>>(x, labels, w, n, d, k, nullptr, p.FT,
                                                          p.rows_per_block, scratch);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    finish_kernel<false><<<fin, 128, 0, s>>>(scratch, (int)p.row_blocks, d, k, nullptr, counts,
                                             means);
  } else {
    err = (int)cudaFuncSetAttribute(moments_kernel<true>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_CAP);
    if (err != 0) return err;
    moments_kernel<true><<<grid, p.threads, p.smem, s>>>(x, labels, w, n, d, k, means, p.FT,
                                                         p.rows_per_block, scratch);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    finish_kernel<true><<<fin, 128, 0, s>>>(scratch, (int)p.row_blocks, d, k, counts, nullptr,
                                            var);
  }
  return (int)cudaGetLastError();
}

// x (n, d); theta, var, logterm = log(2π var) (k, d); logprior (k,).  jll
// (n, k) and/or pred (n,) int64, either may be null.
int gaussian_jll(const float* x, long long n, int d, int k, const float* theta,
                 const float* var, const float* logterm, const float* logprior, float* jll,
                 long long* pred, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return 0;
  const size_t params = ((size_t)3 * k * d + ((k + 3) & ~3)) * sizeof(float);
  const int params_shared = params <= 64 * 1024;
  const int stride = d | 1;  // odd: a row a thread reads without bank conflicts
  const size_t tile = (size_t)JLL_T * stride * sizeof(float);
  const int staged = tile + (params_shared ? params : 0) <= SMEM_CAP;
  const size_t smem = (params_shared ? params : 0) + (staged ? tile : 0);
  int err = (int)cudaFuncSetAttribute(jll_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)SMEM_CAP);
  if (err != 0) return err;
  int sms = 132, per_sm = 1;
  if ((err = sm_count(&sms)) != 0) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, jll_kernel, JLL_T, smem);
  if (err != 0) return err;
  const long long tiles = (n + JLL_T - 1) / JLL_T;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  blocks = blocks < tiles ? blocks : tiles;
  jll_kernel<<<(unsigned)blocks, JLL_T, smem, s>>>(x, n, d, k, theta, var, logterm, logprior,
                                                   params_shared, staged ? stride : 0, jll,
                                                   pred);
  return (int)cudaGetLastError();
}

}  // extern "C"
