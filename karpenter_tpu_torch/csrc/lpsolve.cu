// Restarted PDHG LP solver on an NVIDIA H100 (sm_90a).
//
// Replaces the JAX package's ops/lpsolve.py `_pdhg_kernel` (:145-329), a
// jit'd XLA program: 8 Ruiz sweeps, 24 power iterations for ||[A;G]||_2,
// then a `while_loop` of PDHG steps with a KKT check every `check_every`
// steps, primal-weight restarts and a per-member `done` freeze.
//
// Design: ONE cooperative persistent launch per solve (per batch).  Every
// phase of the JAX program becomes a grid-stride pass over work items,
// separated by a software grid barrier, so the whole while_loop stays on the
// card with no host round trip:
//   * the x step is a COLUMN pass over the scaled stacked operator
//     Ks = D_r [A;G] D_c: one item is a 32-column tile, the block's 8 warps
//     split the rows (a warp reads 128 contiguous bytes of a row), and the
//     duals are staged in shared memory in chunks;
//   * the y/lambda step is a ROW pass: one item is 8 rows, a warp per row
//     reading float4s along it, the extrapolated primal staged in shared
//     memory in chunks;
//   * a KKT check is one row pass and one column pass over the UNSCALED
//     A, G (both candidates -- current iterate and epoch average -- in the
//     same pass), then per-member scalar phases run by one block each.
// Bound: bytes.  Each step streams Ks twice (25 MB at the 8192 x 256 x 512
// envelope, about the L2's 50 MB, so the scaled copy is the L2-resident
// working set and A, G are streamed from HBM only at the checks).
//
// Reductions are deterministic: per-row and per-column values go to scratch
// at fixed positions and are reduced in a fixed order, so a launch gives the
// same bits on every run and for every grid size.  Float32 sums run in
// another order than XLA's CPU sums, so iterates differ from the reference
// in the last bits; the comparisons are held to the tolerances of
// tests/test_lpsolve.py.
//
// Plain C interface (returns cudaError_t), loaded with ctypes.  Everything
// goes on the caller's stream; nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;       // staged vector chunk, floats
constexpr float kTiny = 1e-12f;
constexpr float kRestartDecay = 0.36f;

// per-member scalar slots (ints stored as float bits)
enum : int {
  S_ETA, S_OMEGA, S_ANC, S_RHSN, S_CN, S_VDIV, S_SIGP, S_PRES, S_DRES, S_GAP,
  S_BSCORE, S_BPRES, S_BDRES, S_BGAP,
  I_DONE, I_ITERS, I_RESTARTS, I_ELEN, I_USEAVG, I_ADOPT, I_NEWLY,
  kSlots = 32
};
// B x n vectors
enum : int { N_DC, N_CS, N_US, N_X, N_XS, N_XA, N_XB };
// B x mt vectors (rows: me equality rows, then mi inequality rows)
enum : int { M_D, M_Q, M_Z, M_ZS, M_ZA, M_W };

struct Params {
  const float *A, *b, *G, *h, *c, *u, *ix, *iy, *il;
  int B, me, mi, n, mt;
  float eps;
  int iters_cap, check_every, restart_len, v4;
  float *ks, *vn, *vm, *rowv, *colv, *scal;
  unsigned* bar;
  float *x_out, *y_out, *l_out;
  int *done, *iters, *restarts;
  float* stats;
};

struct Smem {
  float sv[2][kChunk];
  float red[2][kWarps][32];
  float wbuf[kWarps];
  float col[32];
};

__device__ __forceinline__ float* vecn(const Params& p, int k, int b) {
  return p.vn + ((size_t)k * p.B + b) * p.n;
}
__device__ __forceinline__ float* vecm(const Params& p, int k, int b) {
  return p.vm + ((size_t)k * p.B + b) * p.mt;
}
__device__ __forceinline__ float* scal(const Params& p, int b) {
  return p.scal + (size_t)b * kSlots;
}
__device__ __forceinline__ float ld(const float* a) { return __ldcg(a); }
__device__ __forceinline__ int ldi(const float* a) {
  return __float_as_int(__ldcg(a));
}
__device__ __forceinline__ void sti(float* a, int v) { *a = __int_as_float(v); }
__device__ __forceinline__ bool live(const Params& p, int b) {
  return ldi(scal(p, b) + I_DONE) == 0;
}
__device__ __forceinline__ float* scaled_row(const Params& p, int b, int r) {
  return p.ks + ((size_t)b * p.mt + r) * p.n;
}
__device__ __forceinline__ const float* data_row(const Params& p, int b,
                                                 int r) {
  return r < p.me ? p.A + ((size_t)b * p.me + r) * p.n
                  : p.G + ((size_t)b * p.mi + (r - p.me)) * p.n;
}
__device__ __forceinline__ float rhs(const Params& p, int b, int r) {
  return r < p.me ? __ldg(p.b + (size_t)b * p.me + r)
                  : __ldg(p.h + (size_t)b * p.mi + (r - p.me));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max in a fixed order; every thread gets the result.
__device__ float block_sum(float v, Smem& sm) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.wbuf[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += sm.wbuf[w];
  return t;
}
__device__ float block_max(float v, Smem& sm) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.wbuf[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t = fmaxf(t, sm.wbuf[w]);
  return t;
}

// Software grid barrier (the launch is cooperative, so every block is
// resident).  bar[0] counts arrivals, bar[1] is the generation.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Row pass: for every live member b and row r, acc[k] = sum_j M[r][j] *
// vec(k, b, j), then epi(b, r, acc) on lane 0 of the row's warp.  M is the
// scaled copy (kScaled) or the unscaled A / G.
template <bool kScaled, int NV, class VecF, class Epi>
__device__ void row_pass(const Params& p, Smem& sm, VecF vec, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (p.mt + kWarps - 1) / kWarps;
  for (int item = blockIdx.x; item < p.B * groups; item += gridDim.x) {
    const int b = item / groups, r = (item % groups) * kWarps + warp;
    if (!live(p, b)) continue;
    const float* row = nullptr;
    if (r < p.mt) row = kScaled ? scaled_row(p, b, r) : data_row(p, b, r);
    float acc[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] = 0.f;
    for (int c0 = 0; c0 < p.n; c0 += kChunk) {
      const int len = min(kChunk, p.n - c0);
      __syncthreads();
      for (int j = threadIdx.x; j < len; j += kThreads) {
#pragma unroll
        for (int k = 0; k < NV; ++k) sm.sv[k][j] = vec(k, b, c0 + j);
      }
      __syncthreads();
      if (row == nullptr) continue;
      if (p.v4) {
        const float4* r4 = reinterpret_cast<const float4*>(row + c0);
#pragma unroll 4
        for (int j4 = lane; j4 < (len >> 2); j4 += 32) {
          const float4 a = kScaled ? __ldcg(r4 + j4) : __ldg(r4 + j4);
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const float* s = &sm.sv[k][j4 * 4];
            acc[k] = fmaf(a.x, s[0], acc[k]);
            acc[k] = fmaf(a.y, s[1], acc[k]);
            acc[k] = fmaf(a.z, s[2], acc[k]);
            acc[k] = fmaf(a.w, s[3], acc[k]);
          }
        }
      } else {
#pragma unroll 4
        for (int j = lane; j < len; j += 32) {
          const float a = kScaled ? __ldcg(row + c0 + j) : __ldg(row + c0 + j);
#pragma unroll
          for (int k = 0; k < NV; ++k) acc[k] = fmaf(a, sm.sv[k][j], acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] = warp_sum(acc[k]);
    if (row != nullptr && lane == 0) epi(b, r, acc);
  }
}

// Column pass: for every live member b and column j, acc[k] = sum_r
// M[r][j] * vec(k, b, r), then epi(b, j, acc) on warp 0.
template <bool kScaled, int NV, class VecF, class Epi>
__device__ void col_pass(const Params& p, Smem& sm, VecF vec, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = (p.n + 31) / 32;
  for (int item = blockIdx.x; item < p.B * tiles; item += gridDim.x) {
    const int b = item / tiles, j = (item % tiles) * 32 + lane;
    const bool jok = j < p.n;
    if (!live(p, b)) continue;
    float acc[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] = 0.f;
    for (int r0 = 0; r0 < p.mt; r0 += kChunk) {
      const int len = min(kChunk, p.mt - r0);
      __syncthreads();
      for (int i = threadIdx.x; i < len; i += kThreads) {
#pragma unroll
        for (int k = 0; k < NV; ++k) sm.sv[k][i] = vec(k, b, r0 + i);
      }
      __syncthreads();
      if (!jok) continue;
#pragma unroll 8
      for (int i = warp; i < len; i += kWarps) {
        const float a = kScaled ? __ldcg(scaled_row(p, b, r0 + i) + j)
                                : __ldg(data_row(p, b, r0 + i) + j);
#pragma unroll
        for (int k = 0; k < NV; ++k) acc[k] = fmaf(a, sm.sv[k][i], acc[k]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NV; ++k) sm.red[k][warp][lane] = acc[k];
    __syncthreads();
    if (warp == 0 && jok) {
      float s[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        s[k] = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s[k] += sm.red[k][w][lane];
      }
      epi(b, j, s);
    }
  }
}

// One Ruiz sweep: row scaling by 1/sqrt(row max), then column scaling by
// 1/sqrt(column max) of the row-scaled operator.
__device__ void ruiz_sweep(const Params& p, Smem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = p.n;
  const long long rows = (long long)p.B * p.mt;
  for (long long wr = (long long)blockIdx.x * kWarps + warp; wr < rows;
       wr += (long long)gridDim.x * kWarps) {
    float* row = p.ks + wr * n;
    float m = 0.f;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, fabsf(__ldcg(row + j)));
    m = warp_max(m);
    const float s = m > kTiny ? 1.f / sqrtf(fmaxf(m, kTiny)) : 1.f;
    for (int j = lane; j < n; j += 32) row[j] = __ldcg(row + j) * s;
    if (lane == 0) {
      float* d = vecm(p, M_D, (int)(wr / p.mt)) + (int)(wr % p.mt);
      *d = __ldcg(d) * s;
    }
  }
  grid_sync(p.bar);
  const int tiles = (n + 31) / 32;
  for (int item = blockIdx.x; item < p.B * tiles; item += gridDim.x) {
    const int b = item / tiles, j = (item % tiles) * 32 + lane;
    const bool jok = j < n;
    float m = 0.f;
    if (jok)
      for (int i = warp; i < p.mt; i += kWarps)
        m = fmaxf(m, fabsf(__ldcg(scaled_row(p, b, i) + j)));
    __syncthreads();
    sm.red[0][warp][lane] = m;
    __syncthreads();
    if (warp == 0) {
      float mm = 0.f;
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm.red[0][w][lane]);
      const float s = mm > kTiny ? 1.f / sqrtf(fmaxf(mm, kTiny)) : 1.f;
      sm.col[lane] = s;
      if (jok) {
        float* d = vecn(p, N_DC, b) + j;
        *d = __ldcg(d) * s;
      }
    }
    __syncthreads();
    if (jok) {
      const float s = sm.col[lane];
      for (int i = warp; i < p.mt; i += kWarps) {
        float* a = scaled_row(p, b, i) + j;
        *a = __ldcg(a) * s;
      }
    }
  }
  grid_sync(p.bar);
}

__global__ void __launch_bounds__(kThreads) pdhg_kernel(Params p) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const long long gtid = (long long)blockIdx.x * kThreads + tid;
  const long long gstride = (long long)gridDim.x * kThreads;
  const int B = p.B, n = p.n, mt = p.mt, me = p.me, ce = p.check_every;

  // ---- the scaled copy, unit scalings, every member live
  const long long tot = (long long)B * mt * n;
  for (long long e = gtid; e < tot; e += gstride) {
    const long long bn = e / n;
    p.ks[e] = __ldg(data_row(p, (int)(bn / mt), (int)(bn % mt)) + e % n);
  }
  for (long long e = gtid; e < (long long)B * n; e += gstride)
    vecn(p, N_DC, 0)[e] = 1.f;
  for (long long e = gtid; e < (long long)B * mt; e += gstride)
    vecm(p, M_D, 0)[e] = 1.f;
  for (long long e = gtid; e < B; e += gstride) sti(scal(p, (int)e) + I_DONE, 0);
  grid_sync(p.bar);

  // ---- Ruiz equilibration
  for (int it = 0; it < 8; ++it) ruiz_sweep(p, sm);

  // ---- scaled data, starting iterates, the power iteration's v0
  for (long long e = gtid; e < (long long)B * n; e += gstride) {
    const int j = (int)(e % n);
    const float dc = ld(vecn(p, N_DC, 0) + e);
    vecn(p, N_CS, 0)[e] = __ldg(p.c + e) * dc;
    const float us = __ldg(p.u + e) / fmaxf(dc, kTiny);
    vecn(p, N_US, 0)[e] = us;
    const float x0 = fminf(fmaxf(__ldg(p.ix + e) / fmaxf(dc, kTiny), 0.f), us);
    vecn(p, N_X, 0)[e] = x0;
    vecn(p, N_XA, 0)[e] = x0;
    vecn(p, N_XS, 0)[e] = 0.f;
    vecn(p, N_XB, 0)[e] = 1.f + 0.5f * cosf((float)j * 1.618f);
  }
  for (long long e = gtid; e < (long long)B * mt; e += gstride) {
    const int b = (int)(e / mt), r = (int)(e % mt);
    const float d = ld(vecm(p, M_D, 0) + e);
    vecm(p, M_Q, 0)[e] = rhs(p, b, r) * d;
    const float z0 =
        r < me ? __ldg(p.iy + (size_t)b * me + r) / fmaxf(d, kTiny)
               : fmaxf(__ldg(p.il + (size_t)b * p.mi + (r - me)) /
                           fmaxf(d, kTiny), 0.f);
    vecm(p, M_Z, 0)[e] = z0;
    vecm(p, M_ZA, 0)[e] = z0;
    vecm(p, M_ZS, 0)[e] = 0.f;
  }
  grid_sync(p.bar);

  // ---- per-member scalars: ||v0||, the rhs / cost norms, omega0
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    float vv = 0.f, cc = 0.f, cn = 0.f, qe = 0.f, qi = 0.f, rn = 0.f;
    for (int j = tid; j < n; j += kThreads) {
      const float v = ld(vecn(p, N_XB, b) + j), s = ld(vecn(p, N_CS, b) + j);
      vv += v * v;
      cc += s * s;
      cn = fmaxf(cn, fabsf(__ldg(p.c + (size_t)b * n + j)));
    }
    for (int r = tid; r < mt; r += kThreads) {
      const float q = ld(vecm(p, M_Q, b) + r);
      if (r < me) qe += q * q; else qi += q * q;
      rn = fmaxf(rn, fabsf(rhs(p, b, r)));
    }
    vv = block_sum(vv, sm);
    cc = block_sum(cc, sm);
    qe = block_sum(qe, sm);
    qi = block_sum(qi, sm);
    cn = block_max(cn, sm);
    rn = block_max(rn, sm);
    if (tid == 0) {
      float* s = scal(p, b);
      s[S_VDIV] = sqrtf(vv);
      const float nc = sqrtf(cc), nrhs = sqrtf(qe + qi);
      s[S_OMEGA] = (nc > kTiny && nrhs > kTiny)
                       ? fminf(fmaxf(nc / fmaxf(nrhs, kTiny), 1e-2f), 1e2f)
                       : 1.f;
      s[S_ANC] = INFINITY;
      s[S_RHSN] = rn;
      s[S_CN] = cn;
      s[S_PRES] = s[S_DRES] = s[S_GAP] = 0.f;
      sti(s + I_ITERS, 0);
      sti(s + I_RESTARTS, 0);
      sti(s + I_ELEN, 0);
    }
  }
  grid_sync(p.bar);

  // ---- ||Ks||_2 by power iteration: v <- Ks^T Ks v / ||.||
  for (int it = 0; it < 24; ++it) {
    row_pass<true, 1>(
        p, sm,
        [&](int, int b, int j) {
          return ld(vecn(p, N_XB, b) + j) / ld(scal(p, b) + S_VDIV);
        },
        [&](int b, int r, const float* a) { vecm(p, M_W, b)[r] = a[0]; });
    grid_sync(p.bar);
    col_pass<true, 1>(
        p, sm, [&](int, int b, int r) { return ld(vecm(p, M_W, b) + r); },
        [&](int b, int j, const float* s) { vecn(p, N_XB, b)[j] = s[0]; });
    grid_sync(p.bar);
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      float vv = 0.f;
      for (int j = tid; j < n; j += kThreads) {
        const float v = ld(vecn(p, N_XB, b) + j);
        vv += v * v;
      }
      vv = block_sum(vv, sm);
      if (tid == 0) {
        float* s = scal(p, b);
        const float nrm = sqrtf(vv);
        const float sig = sqrtf(fmaxf(nrm, kTiny));
        s[S_SIGP] = sig;
        s[S_VDIV] = fmaxf(nrm, kTiny);
        s[S_ETA] = 0.9f / fmaxf(sig, 1e-6f);
      }
    }
    grid_sync(p.bar);
  }

  // ---- the restarted loop
  for (int k = 0;; ++k) {
    if (!((long long)k * ce < (long long)p.iters_cap)) break;
    bool any = false;
    for (int b = 0; b < B; ++b) any |= live(p, b);
    if (!any) break;

    for (int step = 0; step < ce; ++step) {
      // x <- clip(x - tau (cs + Ks^T z), 0, us); xb = 2 x+ - x
      col_pass<true, 1>(
          p, sm, [&](int, int b, int r) { return ld(vecm(p, M_Z, b) + r); },
          [&](int b, int j, const float* s) {
            const float* sc = scal(p, b);
            const float tau = ld(sc + S_ETA) / ld(sc + S_OMEGA);
            float* xp = vecn(p, N_X, b) + j;
            const float x = ld(xp);
            const float xn = fminf(
                fmaxf(x - tau * (ld(vecn(p, N_CS, b) + j) + s[0]), 0.f),
                ld(vecn(p, N_US, b) + j));
            vecn(p, N_XB, b)[j] = 2.f * xn - x;
            *xp = xn;
            float* xsp = vecn(p, N_XS, b) + j;
            *xsp = ld(xsp) + xn;
          });
      grid_sync(p.bar);
      // z <- z + sigma (Ks xb - q), projected to >= 0 on the ineq rows
      row_pass<true, 1>(
          p, sm, [&](int, int b, int j) { return ld(vecn(p, N_XB, b) + j); },
          [&](int b, int r, const float* a) {
            const float* sc = scal(p, b);
            const float sig = ld(sc + S_ETA) * ld(sc + S_OMEGA);
            float* zp = vecm(p, M_Z, b) + r;
            float zn = ld(zp) + sig * (a[0] - ld(vecm(p, M_Q, b) + r));
            if (r >= me) zn = fmaxf(zn, 0.f);
            *zp = zn;
            float* zsp = vecm(p, M_ZS, b) + r;
            *zsp = ld(zsp) + zn;
          });
      grid_sync(p.bar);
    }

    // KKT of the current iterate (slot 0) and the epoch average (slot 1),
    // against the unscaled A, G: per-row and per-column terms
    auto divf = [&](int b) {
      return (float)max(ldi(scal(p, b) + I_ELEN) + ce, 1);
    };
    row_pass<false, 2>(
        p, sm,
        [&](int kk, int b, int j) {
          const float dc = ld(vecn(p, N_DC, b) + j);
          return kk == 0 ? dc * ld(vecn(p, N_X, b) + j)
                         : dc * (ld(vecn(p, N_XS, b) + j) / divf(b));
        },
        [&](int b, int r, const float* a) {
          const float q = rhs(p, b, r), d = ld(vecm(p, M_D, b) + r);
          const float div = divf(b);
          float* o = p.rowv + ((size_t)b * mt + r) * 4;
          o[0] = r < me ? fabsf(a[0] - q) : fmaxf(a[0] - q, 0.f);
          o[1] = r < me ? fabsf(a[1] - q) : fmaxf(a[1] - q, 0.f);
          o[2] = q * (d * ld(vecm(p, M_Z, b) + r));
          o[3] = q * (d * (ld(vecm(p, M_ZS, b) + r) / div));
        });
    col_pass<false, 2>(
        p, sm,
        [&](int kk, int b, int r) {
          const float d = ld(vecm(p, M_D, b) + r);
          return kk == 0 ? d * ld(vecm(p, M_Z, b) + r)
                         : d * (ld(vecm(p, M_ZS, b) + r) / divf(b));
        },
        [&](int b, int j, const float* s) {
          const size_t e = (size_t)b * n + j;
          const float cj = __ldg(p.c + e), uj = __ldg(p.u + e);
          const bool ufree = isinf(uj);
          const float ufree_f = ufree ? 1.f : 0.f, ufin = ufree ? 0.f : uj;
          const float dc = ld(vecn(p, N_DC, b) + j);
          const float xo_c = dc * ld(vecn(p, N_X, b) + j);
          const float xo_a = dc * (ld(vecn(p, N_XS, b) + j) / divf(b));
          const float rc_c = cj + s[0], rc_a = cj + s[1];
          float* o = p.colv + e * 6;
          o[0] = fmaxf(-rc_c, 0.f) * ufree_f;
          o[1] = cj * xo_c;
          o[2] = fminf(rc_c, 0.f) * ufin;
          o[3] = fmaxf(-rc_a, 0.f) * ufree_f;
          o[4] = cj * xo_a;
          o[5] = fminf(rc_a, 0.f) * ufin;
        });
    grid_sync(p.bar);

    // scores, adoption and restart decisions
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      if (!live(p, b)) continue;
      float pr[2] = {0.f, 0.f}, te[2] = {0.f, 0.f}, ti[2] = {0.f, 0.f};
      for (int r = tid; r < mt; r += kThreads) {
        const float* o = p.rowv + ((size_t)b * mt + r) * 4;
        pr[0] = fmaxf(pr[0], ld(o));
        pr[1] = fmaxf(pr[1], ld(o + 1));
        if (r < me) { te[0] += ld(o + 2); te[1] += ld(o + 3); }
        else { ti[0] += ld(o + 2); ti[1] += ld(o + 3); }
      }
      float dr[2] = {0.f, 0.f}, po[2] = {0.f, 0.f}, fo[2] = {0.f, 0.f};
      for (int j = tid; j < n; j += kThreads) {
        const float* o = p.colv + ((size_t)b * n + j) * 6;
        dr[0] = fmaxf(dr[0], ld(o));
        po[0] += ld(o + 1);
        fo[0] += ld(o + 2);
        dr[1] = fmaxf(dr[1], ld(o + 3));
        po[1] += ld(o + 4);
        fo[1] += ld(o + 5);
      }
      float score[2], pres[2], dres[2], gap[2];
      const float* sc = scal(p, b);
      const float rhsn = ld(sc + S_RHSN), cn = ld(sc + S_CN);
      for (int kk = 0; kk < 2; ++kk) {
        pres[kk] = block_max(pr[kk], sm) / (1.f + rhsn);
        dres[kk] = block_max(dr[kk], sm) / (1.f + cn);
        const float pobj = block_sum(po[kk], sm);
        const float sbe = block_sum(te[kk], sm), shi = block_sum(ti[kk], sm);
        const float dobj = -sbe - shi + block_sum(fo[kk], sm);
        gap[kk] = fabsf(pobj - dobj) / (1.f + fabsf(pobj) + fabsf(dobj));
        score[kk] = fmaxf(fmaxf(pres[kk], dres[kk]), gap[kk]);
      }
      if (tid == 0) {
        float* s = scal(p, b);
        const int elen = ldi(s + I_ELEN) + ce;
        const bool use_avg = score[1] < score[0];
        const int w = use_avg ? 1 : 0;
        const float bscore = fminf(score[1], score[0]);
        const bool newly = bscore <= p.eps;
        const bool suff = bscore <= kRestartDecay * ld(s + S_ANC);
        const bool longe = elen >= p.restart_len * ce;
        sti(s + I_ELEN, elen);
        sti(s + I_USEAVG, use_avg);
        sti(s + I_NEWLY, newly);
        sti(s + I_ADOPT, suff || longe || newly);
        s[S_BSCORE] = bscore;
        s[S_BPRES] = pres[w];
        s[S_BDRES] = dres[w];
        s[S_BGAP] = gap[w];
      }
    }
    grid_sync(p.bar);

    // the better candidate, its displacement from the anchor, restarts
    for (long long e = gtid; e < (long long)B * n; e += gstride) {
      const int b = (int)(e / n);
      if (!live(p, b)) continue;
      const float* s = scal(p, b);
      const float div = (float)max(ldi(s + I_ELEN), 1);
      const float x = ld(vecn(p, N_X, 0) + e);
      const float bx = ldi(s + I_USEAVG) ? ld(vecn(p, N_XS, 0) + e) / div : x;
      const float d = bx - ld(vecn(p, N_XA, 0) + e);
      p.colv[e * 6] = d * d;
      if (ldi(s + I_ADOPT)) {
        vecn(p, N_X, 0)[e] = bx;
        vecn(p, N_XA, 0)[e] = bx;
        vecn(p, N_XS, 0)[e] = 0.f;
      }
    }
    for (long long e = gtid; e < (long long)B * mt; e += gstride) {
      const int b = (int)(e / mt);
      if (!live(p, b)) continue;
      const float* s = scal(p, b);
      const float div = (float)max(ldi(s + I_ELEN), 1);
      const float z = ld(vecm(p, M_Z, 0) + e);
      const float bz = ldi(s + I_USEAVG) ? ld(vecm(p, M_ZS, 0) + e) / div : z;
      const float d = bz - ld(vecm(p, M_ZA, 0) + e);
      p.rowv[e * 4] = d * d;
      if (ldi(s + I_ADOPT)) {
        vecm(p, M_Z, 0)[e] = bz;
        vecm(p, M_ZA, 0)[e] = bz;
        vecm(p, M_ZS, 0)[e] = 0.f;
      }
    }
    grid_sync(p.bar);

    // primal-weight rebalance and the member's counters
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      if (!live(p, b)) continue;
      float dx = 0.f, dy = 0.f, dl = 0.f;
      for (int j = tid; j < n; j += kThreads)
        dx += ld(p.colv + ((size_t)b * n + j) * 6);
      for (int r = tid; r < mt; r += kThreads) {
        const float v = ld(p.rowv + ((size_t)b * mt + r) * 4);
        if (r < me) dy += v; else dl += v;
      }
      dx = block_sum(dx, sm);
      dy = block_sum(dy, sm);
      dl = block_sum(dl, sm);
      if (tid == 0) {
        float* s = scal(p, b);
        const float dxn = sqrtf(dx), dyn = sqrtf(dy + dl);
        const bool adopt = ldi(s + I_ADOPT), newly = ldi(s + I_NEWLY);
        const bool ok = dxn > kTiny && dyn > kTiny;
        const float omega = ld(s + S_OMEGA);
        if (adopt && ok && !newly) {
          const float om = expf(0.5f * logf(fmaxf(dyn, kTiny) /
                                            fmaxf(dxn, kTiny)) +
                                0.5f * logf(omega));
          s[S_OMEGA] = fminf(fmaxf(om, 1e-3f), 1e3f);
        }
        if (adopt) {
          sti(s + I_ELEN, 0);
          s[S_ANC] = ld(s + S_BSCORE);
        }
        sti(s + I_ITERS, ldi(s + I_ITERS) + ce);
        sti(s + I_RESTARTS, ldi(s + I_RESTARTS) + (adopt && !newly));
        s[S_PRES] = ld(s + S_BPRES);
        s[S_DRES] = ld(s + S_BDRES);
        s[S_GAP] = ld(s + S_BGAP);
        if (newly) sti(s + I_DONE, 1);
      }
    }
    grid_sync(p.bar);
  }

  // ---- unscaled outputs and exit statistics
  for (long long e = gtid; e < (long long)B * n; e += gstride)
    p.x_out[e] = ld(vecn(p, N_DC, 0) + e) * ld(vecn(p, N_X, 0) + e);
  for (long long e = gtid; e < (long long)B * mt; e += gstride) {
    const int b = (int)(e / mt), r = (int)(e % mt);
    const float v = ld(vecm(p, M_D, 0) + e) * ld(vecm(p, M_Z, 0) + e);
    if (r < me) p.y_out[(size_t)b * me + r] = v;
    else p.l_out[(size_t)b * p.mi + (r - me)] = v;
  }
  for (long long e = gtid; e < B; e += gstride) {
    const float* s = scal(p, (int)e);
    p.done[e] = ldi(s + I_DONE);
    p.iters[e] = ldi(s + I_ITERS);
    p.restarts[e] = ldi(s + I_RESTARTS);
    p.stats[e] = ld(s + S_PRES);
    p.stats[B + e] = ld(s + S_DRES);
    p.stats[2 * B + e] = ld(s + S_GAP);
  }
}

}  // namespace

extern "C" {

const char* lp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int lp_scalar_slots() { return kSlots; }

// Shapes (float32, row-major, contiguous): A B x me x n, b B x me, G B x mi
// x n, h B x mi, c / u / ix B x n, iy B x me, il B x mi.  Scratch: ks B x
// (me+mi) x n, vn 8 x B x n, vm 8 x B x (me+mi), rowv B x (me+mi) x 4, colv
// B x n x 6, scal B x lp_scalar_slots(), bar 2 (zeroed).  Outputs: x_out B
// x n, y_out B x me, l_out B x mi, done / iters / restarts B (int32), stats
// 3 x B (pres, dres, gap).
cudaError_t lp_pdhg(const float* A, const float* b, const float* G,
                    const float* h, const float* c, const float* u,
                    const float* ix, const float* iy, const float* il, int B,
                    int me, int mi, int n, float eps, int iters_cap,
                    int check_every, int restart_len, float* ks, float* vn,
                    float* vm, float* rowv, float* colv, float* scal,
                    unsigned* bar, float* x_out, float* y_out, float* l_out,
                    int* done, int* iters, int* restarts, float* stats,
                    cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pdhg_kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  Params p;
  p.A = A; p.b = b; p.G = G; p.h = h; p.c = c; p.u = u;
  p.ix = ix; p.iy = iy; p.il = il;
  p.B = B; p.me = me; p.mi = mi; p.n = n; p.mt = me + mi;
  p.eps = eps;
  p.iters_cap = iters_cap; p.check_every = check_every;
  p.restart_len = restart_len;
  p.v4 = (n % 4 == 0) && (((uintptr_t)A | (uintptr_t)G | (uintptr_t)ks) % 16 == 0);
  p.ks = ks; p.vn = vn; p.vm = vm; p.rowv = rowv; p.colv = colv;
  p.scal = scal; p.bar = bar;
  p.x_out = x_out; p.y_out = y_out; p.l_out = l_out;
  p.done = done; p.iters = iters; p.restarts = restarts; p.stats = stats;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)pdhg_kernel,
                                  dim3(sms * (per_sm < 2 ? per_sm : 2)),
                                  dim3(kThreads), args, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
