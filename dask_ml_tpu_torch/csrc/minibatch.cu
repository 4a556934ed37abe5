// K7b for Hopper (sm_90a), plain C ABI: a whole epoch of MiniBatchKMeans'
// minibatch steps in one launch.  (K7a, the Sculley update of one step, is
// the epilogue of K1a's last launch: csrc/lloyd.cu ::
// lloyd_assign_reduce_update.)
//
// K7b epoch_kernel replaces :124 _mbk_epoch_fn, the lax.scan of
// _mbk_step_fn over contiguous windows: step i takes the bs rows from
// (start + i*bs) mod max(n - bs + 1, 1) of the padded rows, assigns them
// (d2 = max((|x|^2 + |c|^2) - 2 x.c, 0), the first of equal centres), sums
// w*x and w a centre, and updates as K7a (the Kahan pair and Sculley's
// move, each operation rounded on its own).  It returns the centres, the
// pair and the mean of the step inertias.  Bound on an H100: an epoch reads
// the padded rows once (100M x 50: 20.4 GB, 6.09 ms at 3.35 TB/s), but the
// steps are a serial chain (each needs the last one's centres), so the
// floor is the step count times the latency of one step: a window's
// assign, a reduce across SMs and the update.  At bs = 1024 and k = 8 that
// is 97,656 steps of ~0.4 M FMAs each.  The design shortens that chain:
//   - One thread-block cluster of 16 CTAs of 512 threads (a non-portable
//     size) runs the whole epoch; a CTA owns a sixteenth of each window (64
//     rows at bs = 1024).  The windows
//     do not depend on the centres, so the rows of the next two are in
//     flight (cp.async, three stages; a window starts anywhere, so a CTA
//     copies the 16-byte run that covers its rows and reads it at a shift).
//   - Assign: four threads a pair of rows, each over every fourth feature
//     against all the centres (a feature-major copy, float4 reads shared by
//     the two rows), |x|^2 on the way; the four partial sums merge by a
//     shuffle butterfly.  Reduce: lane j of a warp is a column (a feature,
//     or the mass) and walks a group of rows, adding w*x into k register
//     sums under the row's label (one broadcast (label, weight) load a
//     row); the row groups' partials are merged in order in shared memory.
//   - The exchange has no cluster barrier: each CTA pushes its partial of
//     centre c (st.async into distributed shared memory) to CTA c, c's
//     owner (k <= 16), signalling the owner's mbarrier with the bytes; the owner
//     sums the 16 partials in rank order, adds the mass into the Kahan pair
//     (kept in registers), moves the centre and pushes the moved features
//     and the norm into every CTA's copy, signalling each one's mbarrier.
//     A CTA's wait on that mbarrier is the step's only cross-SM wait; the
//     copies of a later window are issued while the centres are in flight.
//     A step has three CTA barriers.
//   - The inertia is summed a thread in double across the steps, and
//     across threads, warps and ranks in a fixed order at the end.
//   - For k <= 16 and d <= 255 (a unit's rows shrink until the shared
//     memory fits), where the card can place a 16-CTA cluster; past that
//     the wrapper steps the epoch through K1a with K7a as its epilogue.
// The dot products, |x|^2, the sums and the centre norms are split across
// threads and merged in a fixed order, so K7b no longer repeats K1a's
// arithmetic bit for bit (the order of those float32 sums differs); it
// holds the centres to 1e-4 of their largest entry and the mean inertia
// to 1e-5 of the plain version's.  What still holds it back: a step is
// still a chain of four phases, each a few hundred to two thousand cycles
// of shared-memory traffic, shuffles and barriers on 16 of the card's SMs
// (assign ~1900, reduce ~1500, merge ~800, the owners' update and the
// centres' delivery ~1800, measured on an H100 by k7k10_variants.py's
// probe).  No float atomics: the same input gives the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

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

// ------------------------------------------------------------------ K7b

constexpr int CL = 16;                  // CTAs in the cluster, one a centre it owns
constexpr int ET = 512;                 // threads a CTA
constexpr int NW = ET / 32;             // warps a CTA
constexpr int STAGES = 3;               // window copies in flight, this one included
constexpr int Q = 4;                    // threads a pair of rows in the assign
constexpr int MAX_UNIT_ROWS = 2 * ET / Q;  // rows a unit: two a thread of the assign
constexpr int MAX_D = 255;              // features K7b takes
constexpr size_t XBUDGET = 150 * 1024;  // bytes of shared memory for the row stages
constexpr long long SMEM_MAX = 232448;  // dynamic shared bytes a CTA may have
constexpr unsigned FULL = 0xffffffffu;

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// The step's exchange: st.async stores into a peer's shared memory, each
// signalling that peer's mbarrier with its bytes; a waiter's acquire at
// cluster scope then sees the data.
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(a), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(a), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("{\n .reg .pred done;\n WAIT:\n"
               " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
               " @!done bra WAIT;\n}\n" :: "r"(a), "r"(parity) : "memory");
}
// The address of this CTA's shared `p` in the shared memory of CTA `rank`.
__device__ __forceinline__ unsigned peer_addr(const void* p, int rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// Butterfly sum over a warp: every lane gets the same bits.
template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

// An epoch launch's plan, made at the launch by plan_epoch.
struct Plan {
  long long kr;    // centre slots of the register sums (8 or 16), 0: no K7b
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

// The reduce's warps: column groups of 32 (a feature, or the mass) by row
// groups; the row groups' partials are merged in order.
__host__ __device__ __forceinline__ int col_groups(int d) { return (d + 1 + 31) / 32; }
__host__ __device__ __forceinline__ int row_groups(int d) { return NW / col_groups(d); }

// Floats of each shared-memory region, in the order they are laid out;
// every region starts on a 16-byte boundary.
struct Layout {
  int sf, rt4, k, d, kr;
  __host__ __device__ Layout(const Plan& p, int k_, int d_)
      : sf((int)p.sf), rt4(round4((int)p.rt)), k(k_), d(d_), kr((int)p.kr) {}
  __host__ __device__ int bars() const { return 0; }                       // 2 mbarriers
  __host__ __device__ int xbuf() const { return bars() + 4; }
  __host__ __device__ int mbuf() const { return xbuf() + STAGES * sf; }
  __host__ __device__ int cs() const { return mbuf() + STAGES * rt4; }     // centres (k, d)
  __host__ __device__ int ct() const { return cs() + round4(k * d); }      // feature-major (d, kr)
  __host__ __device__ int cn() const { return ct() + d * kr; }             // centre norms
  __host__ __device__ int lw() const { return cn() + kr; }                 // (label, weight) a row
  __host__ __device__ int rp() const { return lw() + 2 * rt4; }            // row-group partials
  __host__ __device__ int part() const {  // the step's partial, across units
    return rp() + row_groups(d) * kr * col_groups(d) * 32;
  }
  __host__ __device__ int inbox() const {  // the owned centre's partials (CL, d + 1)
    return part() + round4(k * (d + 1));
  }
  __host__ __device__ int red() const {  // NW + 1 doubles
    return inbox() + round4(CL * (d + 1));
  }
  __host__ __device__ int total() const { return red() + round4(2 * (NW + 1)); }
};

// Where a unit of the epoch is: its step's window offset, its unit in the
// step, its stage.
struct Pos {
  long long off;
  int u, b;
};

template <int KR>
__global__ void __launch_bounds__(ET, 1) epoch_kernel(EpochArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const Layout L(a.p, a.k, a.d);
  const int k = a.k, d = a.d, D1 = d + 1;
  const int t = threadIdx.x, lane = t & 31, wi = t >> 5;
  const int rank = (int)cluster.block_rank();
  float* xbuf = smem + L.xbuf();
  float* mbuf = smem + L.mbuf();
  float* cs = smem + L.cs();
  float* ct = smem + L.ct();
  float* cn = smem + L.cn();
  float2* lw_s = reinterpret_cast<float2*>(smem + L.lw());
  float* rp = smem + L.rp();
  float* part = smem + L.part();
  float* inbox = smem + L.inbox();
  double* red = reinterpret_cast<double*>(smem + L.red());
  unsigned long long* bar_in = reinterpret_cast<unsigned long long*>(smem + L.bars());
  unsigned long long* bar_ctr = bar_in + 1;

  const int R = (int)a.p.rows, RT = (int)a.p.rt, U = (int)a.p.units, SF = (int)a.p.sf;
  const int RT4 = L.rt4, CG = col_groups(d), RGP = row_groups(d);
  const bool owner = rank < k;  // this CTA owns (updates) centre `rank`
  const long long span = a.n - a.bs + 1 > 1 ? a.n - a.bs + 1 : 1;
  const long long step_mod = a.bs % span;
  const int my0 = rank * R;
  const int my_rows = (int)(a.bs - my0 < R ? (a.bs - my0 > 0 ? a.bs - my0 : 0) : R);
  const long long total = a.n_batches * U;
  const float* xend = a.x + a.n * d;
  const long long off0 = (a.start % span + span) % span;

  auto unit_rows = [&](int u) {
    const int rc = my_rows - u * RT;
    return rc < 0 ? 0 : rc > RT ? RT : rc;
  };
  auto first_row = [&](const Pos& p) { return p.off + my0 + (long long)p.u * RT; };
  auto shift_of = [&](long long g0) {
    return (int)(((uintptr_t)(a.x + g0 * d) & 15) / sizeof(float));
  };
  auto advance = [&](Pos& p) {
    p.b = p.b + 1 == STAGES ? 0 : p.b + 1;
    if (++p.u == U) {
      p.u = 0;
      p.off += step_mod;
      if (p.off >= span) p.off -= span;
    }
  };

  Pos pf{off0, 0, 0};  // the next unit to copy
  long long pf_unit = 0;
  auto issue = [&]() {
    const int rc = pf_unit < total ? unit_rows(pf.u) : 0;
    if (rc > 0) {
      const long long g0 = first_row(pf);
      const int shift = shift_of(g0);
      const float* base = a.x + g0 * d - shift;
      const int pieces = (shift + rc * d + 3) / 4;
      float* dst = xbuf + pf.b * SF;
      for (int p = t; p < pieces; p += ET) {
        const float* src = base + 4 * p;
        const long long avail = xend - src;
        cp_async16(dst + 4 * p, src, avail >= 4 ? 16 : (int)avail * 4);
      }
      for (int r = t; r < rc; r += ET) cp_async4(mbuf + pf.b * RT4 + r, a.mask + g0 + r);
    }
    cp_async_commit();
    ++pf_unit;
    advance(pf);
  };

  // the assign's thread: rows r0 and r0 + 1 of the unit, features q, q + Q,
  // ...; a warp's rows are wi*2*32/Q ... (wi+1)*2*32/Q - 1
  const int r0 = 2 * (t / Q), q = t % Q;
  const int warp_row0 = wi * (2 * 32 / Q);
  // warp c < k: centre c's feature-major copy and its norm, from cs
  auto publish = [&](int c) {
    float nrm = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float v = cs[c * d + j];
      ct[j * KR + c] = v;
      nrm = fmaf(v, v, nrm);
    }
    nrm = warp_sum(nrm);
    if (lane == 0) cn[c] = nrm;
  };

  // warp 0 of an owner updates centre `rank`, with its Kahan pair
  const bool updater = owner && wi == 0;
  float hi = 0.f, lo = 0.f;
  if (updater) {
    hi = a.counts[rank];
    lo = a.counts[k + rank];
  }
  // the inbox's mbarrier (the step partials of the owned centre from every
  // rank) and the centres' (every updated centre from its owner)
  const unsigned in_bytes = (unsigned)(owner ? CL * D1 * sizeof(float) : 0);
  const unsigned ctr_bytes = (unsigned)(k * D1 * sizeof(float));
  if (t == 0) {
    mbar_init(bar_in, 1);
    mbar_init(bar_ctr, 1);
  }
  for (int e = t; e < k * d; e += ET) cs[e] = a.centers[e];
  for (int e = t; e < d * KR; e += ET) ct[e] = 0.f;
  for (int c = t; c < KR; c += ET) cn[c] = 0.f;
  for (int s = 0; s < STAGES - 1; ++s) issue();
  __syncthreads();
  if (wi < k) publish(wi);
  cp_async_wait<STAGES - 2>();
  cluster.sync();  // the centres are published, unit 0's rows have landed, every mbarrier is set

  Pos cur{off0, 0, 0};
  long long step = 0;
  double inert = 0.0;

  for (long long unit = 0; unit < total; ++unit) {
    const int rc = unit_rows(cur.u);
    const float* xb = xbuf + cur.b * SF + (rc > 0 ? shift_of(first_row(cur)) : 0);

    if (warp_row0 < rc) {  // assign: threads (rows r0 and r0 + 1, part q)
      float acc0[KR], acc1[KR], xn0 = 0.f, xn1 = 0.f;
#pragma unroll
      for (int c = 0; c < KR; ++c) acc0[c] = acc1[c] = 0.f;
      if (r0 < rc) {
        const float* xr0 = xb + r0 * d;
        const float* xr1 = r0 + 1 < rc ? xr0 + d : xr0;  // a lone last row: read it twice
#pragma unroll 8
        for (int j = q; j < d; j += Q) {
          const float x0 = xr0[j], x1 = xr1[j];
          xn0 = fmaf(x0, x0, xn0);
          xn1 = fmaf(x1, x1, xn1);
          const float4* cj = reinterpret_cast<const float4*>(ct + j * KR);
#pragma unroll
          for (int c4 = 0; c4 < KR / 4; ++c4) {
            const float4 cv = cj[c4];
            acc0[4 * c4] = fmaf(x0, cv.x, acc0[4 * c4]);
            acc0[4 * c4 + 1] = fmaf(x0, cv.y, acc0[4 * c4 + 1]);
            acc0[4 * c4 + 2] = fmaf(x0, cv.z, acc0[4 * c4 + 2]);
            acc0[4 * c4 + 3] = fmaf(x0, cv.w, acc0[4 * c4 + 3]);
            acc1[4 * c4] = fmaf(x1, cv.x, acc1[4 * c4]);
            acc1[4 * c4 + 1] = fmaf(x1, cv.y, acc1[4 * c4 + 1]);
            acc1[4 * c4 + 2] = fmaf(x1, cv.z, acc1[4 * c4 + 2]);
            acc1[4 * c4 + 3] = fmaf(x1, cv.w, acc1[4 * c4 + 3]);
          }
        }
      }
#pragma unroll
      for (int m = 1; m < Q; m <<= 1) {  // the Q parts of each sum, a butterfly
#pragma unroll
        for (int c = 0; c < KR; ++c) {
          acc0[c] += __shfl_xor_sync(FULL, acc0[c], m);
          acc1[c] += __shfl_xor_sync(FULL, acc1[c], m);
        }
        xn0 += __shfl_xor_sync(FULL, xn0, m);
        xn1 += __shfl_xor_sync(FULL, xn1, m);
      }
      const int r = r0 + q;  // lane q < 2 finishes row r0 + q
      if (q < 2 && r < rc) {
        const float xn = q == 0 ? xn0 : xn1, w = mbuf[cur.b * RT4 + r];
        float best = INFINITY;
        int bidx = 0;
#pragma unroll
        for (int c = 0; c < KR; ++c) {
          if (c < k) {
            const float dd = fmaxf((xn + cn[c]) - 2.f * (q == 0 ? acc0[c] : acc1[c]), 0.f);
            if (dd < best) {
              best = dd;
              bidx = c;
            }
          }
        }
        lw_s[r] = make_float2(__int_as_float(bidx), w);
        inert += (double)(w * best);
      }
    }
    __syncthreads();  // every row's label and weight are written

    const bool first = cur.u == 0, last = cur.u == U - 1;
    if (wi < CG * RGP) {  // reduce: lane j of column group cg over the rows of row group rg
      const int cgi = wi % CG, rg = wi / CG;
      const int j = cgi * 32 + lane;
      float racc[KR];
#pragma unroll
      for (int c = 0; c < KR; ++c) racc[c] = 0.f;
      for (int rr = rg; rr < rc; rr += RGP) {
        const float2 lwv = lw_s[rr];
        const int lab = __float_as_int(lwv.x);
        const float v = lwv.y * (j < d ? xb[rr * d + j] : 1.f);  // column d: the mass
#pragma unroll
        for (int c = 0; c < KR; ++c)
          if (lab == c) racc[c] += v;
      }
      float* dst = rp + rg * KR * (CG * 32) + j;
#pragma unroll
      for (int c = 0; c < KR; ++c) dst[c * (CG * 32)] = racc[c];
    }
    __syncthreads();  // every row group's partial is written
    if (last && t == 0) {  // this step's bytes, to come into the inbox and the centres
      mbar_expect(bar_in, in_bytes);
      mbar_expect(bar_ctr, ctr_bytes);
    }
    for (int e = t; e < k * D1; e += ET) {  // the row groups merged in order
      const int c = e / D1, j = e - c * D1;
      float s = 0.f;
      for (int g = 0; g < RGP; ++g) s += rp[(g * KR + c) * (CG * 32) + j];
      s = first ? s : part[e] + s;
      if (!last) {
        part[e] = s;
      } else {  // the step's partial of element (c, j), to CTA c, its owner.  The one
        // inbox is free again: this CTA waited on bar_ctr for the last step, which
        // completes only when every owner has sent its norm, and an owner sends it
        // after its warp_sum, when all its lanes have read the inbox
        st_async(peer_addr(inbox + rank * D1 + j, c), s, peer_addr(bar_in, c));
      }
    }

    const unsigned parity = (unsigned)(step & 1);
    if (last && updater) {  // the update of centre `rank`, sent to every CTA's copy
      mbar_wait(bar_in, parity);
      float bm = 0.f;
#pragma unroll
      for (int rk = 0; rk < CL; ++rk) bm += inbox[rk * D1 + d];  // rank order
      const float inv = kahan_inv(bm, hi, lo);
      float nrm = 0.f;
      for (int j = lane; j < d; j += 32) {
        float s = 0.f;
#pragma unroll
        for (int rk = 0; rk < CL; ++rk) s += inbox[rk * D1 + j];
        const float v = sculley(cs[rank * d + j], s, bm, inv);
        cs[rank * d + j] = v;
        nrm = fmaf(v, v, nrm);
#pragma unroll
        for (int rk = 0; rk < CL; ++rk)
          st_async(peer_addr(ct + j * KR + rank, rk), v, peer_addr(bar_ctr, rk));
      }
      nrm = warp_sum(nrm);  // every lane's reads of the inbox are done
      if (lane < CL) st_async(peer_addr(cn + rank, lane), nrm, peer_addr(bar_ctr, lane));
    }
    issue();  // into the stage the last unit read
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // the next unit's rows have landed; this unit is read
    advance(cur);
    if (last) {
      // every centre of the step has come in; only after this may this CTA push
      // the next step's partials into the owners' inboxes
      mbar_wait(bar_ctr, parity);
      ++step;
    }
  }
  cp_async_wait<0>();

  inert = warp_sum(inert);  // this CTA's inertia: lanes, then warps in order
  if (lane == 0) red[wi] = inert;
  __syncthreads();
  if (t == 0) {
    double s = 0.0;
    for (int w = 0; w < NW; ++w) s += red[w];
    red[NW] = s;
  }
  cluster.sync();  // every CTA's inertia is written
  if (owner)  // the owners' centres and pairs
    for (int j = t; j < d; j += ET) a.centers_out[rank * d + j] = cs[rank * d + j];
  if (updater && lane == 0) {
    a.counts_out[rank] = hi;
    a.counts_out[k + rank] = lo;
  }
  if (rank == 0 && t == 0) {
    double s = 0.0;
    for (int rk = 0; rk < CL; ++rk) s += cluster.map_shared_rank(red, rk)[NW];
    a.inertia_out[0] = (float)(s / (double)a.n_batches);
  }
  cluster.sync();  // no CTA leaves while rank 0 may still read its inertia
}

// Plans an epoch of bs-row windows over d features and k centres.  p.kr ==
// 0: K7b does not take this shape.
Plan plan_epoch(long long bs, int d, int k) {
  Plan p;
  p.kr = (k <= 8 ? 8 : k <= 16 ? 16 : 0);
  if (d > MAX_D || d < 1 || k < 1 || bs < 1) p.kr = 0;
  p.rows = (bs + CL - 1) / CL;
  const long long fit = ((long long)(XBUDGET / sizeof(float)) / STAGES - 8) / (d + 1);
  long long rt = p.rows < MAX_UNIT_ROWS ? p.rows : MAX_UNIT_ROWS;
  if (rt > fit) rt = fit;
  if (rt < 1) p.kr = 0;
  p.rt = rt < 1 ? 1 : rt;
  for (;;) {  // fewer rows a unit until the layout fits
    p.units = (p.rows + p.rt - 1) / p.rt;
    p.sf = (p.rt * d + 3 + 3) / 4 * 4;
    p.smem = p.kr ? (long long)Layout(p, k, d).total() * (long long)sizeof(float) : 0;
    if (p.smem <= SMEM_MAX || p.rt == 1) break;
    p.rt -= p.rt / 8 > 1 ? p.rt / 8 : 1;
  }
  if (p.smem > SMEM_MAX) p.kr = 0;
  return p;
}

// The launch of one cluster of CL CTAs; with query, instead the number of
// such clusters the card can hold at once (0: it cannot place one).
template <int KR>
cudaError_t launch_epoch(const EpochArgs& a, cudaStream_t s, int* query) {
  auto kern = epoch_kernel<KR>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)a.p.smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, 1, 1);
  cfg.blockDim = dim3(ET, 1, 1);
  cfg.dynamicSmemBytes = (size_t)a.p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (query) return cudaOccupancyMaxActiveClusters(query, kern, &cfg);
  return cudaLaunchKernelEx(&cfg, kern, a);
}

cudaError_t launch_epoch_kr(const EpochArgs& a, cudaStream_t s, int* query) {
  return a.p.kr == 8 ? launch_epoch<8>(a, s, query) : launch_epoch<16>(a, s, query);
}

}  // namespace

extern "C" {

enum { MBK_NOT_TAKEN = -1 };  // mbk_epoch: not a CUDA error code

const char* minibatch_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x (n, d) padded rows and mask (n,), 16-byte aligned x; centers (k, d),
// counts (2, k).  One epoch of n_batches windows of bs rows from start.
// Writes centers_out, counts_out and inertia_out (1,): the mean step inertia.
// Returns MBK_NOT_TAKEN, and launches nothing, where K7b does not take the
// shape or the card cannot place a cluster of 16 CTAs (a non-portable size).
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
  a.centers_out = (float*)centers_out;
  a.counts_out = (float*)counts_out;
  a.inertia_out = (float*)inertia_out;
  cudaStream_t s = (cudaStream_t)stream;
  // attributes are set at every launch: launches of other shapes may have set others
  a.p = plan_epoch(bs, d, k);
  if (a.p.kr == 0) return MBK_NOT_TAKEN;
  int clusters = 0;
  const cudaError_t err = launch_epoch_kr(a, s, &clusters);
  if (err != cudaSuccess) return (int)err;
  if (clusters == 0) return MBK_NOT_TAKEN;
  return (int)launch_epoch_kr(a, s, nullptr);
}

}  // extern "C"
