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
// card with no host round trip.  The setup (the scaled stacked operator
// Ks = D_r [A;G] D_c in global scratch, Ruiz, the power iteration) and the
// KKT checks' scalar phases are shared by two kernels, chosen by the
// wrapper from shapes and device attributes alone
// (ops/lpsolve_kernels.py:resident_plan):
//
//   * pdhg_kernel<true>, RESIDENT: when B x (me+mi) x n floats fit the SMs'
//     combined shared memory, one block per tile of the plan.  A tile is
//     one member's row band x column band of Ks, copied into the block's
//     dynamic shared memory once after the power iteration, with the
//     band's slices of x, its epoch sum, the extrapolation, the scaled
//     cost and bound (column band) and of z, its epoch sum and the scaled
//     rhs (row band).  A PDHG step is two passes over the resident tile:
//     the column pass writes the tile's partial Ks^T z per column to a
//     fixed slot of global scratch, the row pass its partial Ks xb per row.
//     Instead of a grid barrier, each pass ends at a per-band arrival
//     counter: a block waits only for the blocks of its own column band
//     (row band) whose partials it reads, then sums the partials in band
//     order and updates its slice of x (z).  Blocks of one band update the
//     same slice redundantly and identically; the partials are double
//     buffered by step parity, which the two waits make safe.  At each
//     check the first row band's blocks write x back and the first column
//     band's blocks z, and every block reloads its slices after the restart
//     decisions.  A check's products read each block's own region of the
//     unscaled A, G (from L2) and go through the same band partials.
//     Bound: the shared-memory bandwidth of the two passes per step (128 B
//     per clock per SM); measured, the arrivals, the partial sums from L2
//     and the checks cost more than the passes.
//
//   * pdhg_kernel<false>, STREAMING (the operator does not fit on chip):
//     the x step is a COLUMN pass over Ks in global memory: one item is a
//     32-column tile, the block's 8 warps split the rows (a warp reads 128
//     contiguous bytes of a row), and the duals are staged in shared memory
//     in chunks; the y/lambda step is a ROW pass: one item is 8 rows, a
//     warp per row reading float4s along it, the extrapolated primal staged
//     in chunks.  Bound: bytes, each step streams Ks twice from L2 or HBM.
//
// A KKT check is one row pass and one column pass over the UNSCALED A, G
// (both candidates -- current iterate and epoch average -- in the same
// pass; grid-stride items in the streaming kernel, each block's region in
// the resident one), then per-member scalar phases run by one block each.
//
// Reductions are deterministic: per-row and per-column values go to scratch
// at fixed positions and are reduced in a fixed order, so a launch gives the
// same bits on every run (and, for the streaming kernel, for every grid
// size; the resident kernel sums in its plan's band order).  Float32 sums
// run in another order than XLA's CPU sums, so iterates differ from the reference
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
  // the resident plan: R row bands of bh rows, Q column bands of bw columns
  // per member; partials pc 2 x B x R x n, pr 2 x B x Q x mt; arrival
  // counters cnt: B x Q column bands, then B x R row bands
  int R, Q, bh, bw;
  float *pc, *pr;
  unsigned* cnt;
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

// ---------------------------------------------------------------------------
// The resident path: a block's tile of Ks and its band slices in dynamic
// shared memory (floats, each segment a multiple of 4):
//   tile hp x w | x, xs, xb, cs, us, xo0, xo1: w each |
//   z, zs, q, zo0, zo1: hp each | red 1024
// with hp = h rounded up to 4; rows and columns past the band are zero.
// xo / zo hold the band's unscaled iterates (current and epoch average)
// at a check.
// ---------------------------------------------------------------------------
constexpr int kRedFloats = 1024;  // the column pass's row-group partials

__host__ __device__ __forceinline__ int pad4(int v) { return (v + 3) & ~3; }

__host__ __device__ __forceinline__ size_t resident_smem_bytes(int h, int w) {
  const size_t hp = pad4(h);
  return (hp * w + 7 * (size_t)w + 5 * hp + kRedFloats) * sizeof(float);
}

struct Band {
  int b, rb, cb;    // member, row band, column band
  int r0, hb;       // first row and rows of the band
  int c0, wc;       // first column and columns of the band
  int hp;
  float *tile, *x, *xs, *xb, *cs, *us, *xo0, *xo1, *z, *zs, *q, *zo0, *zo1;
  float* red;
};

__device__ Band band_of(const Params& p) {
  Band t;
  const int per = p.R * p.Q;
  t.b = blockIdx.x / per;
  t.rb = (blockIdx.x % per) / p.Q;
  t.cb = blockIdx.x % p.Q;
  t.r0 = t.rb * p.bh;
  t.hb = min(p.bh, p.mt - t.r0);
  t.c0 = t.cb * p.bw;
  t.wc = min(p.bw, p.n - t.c0);
  t.hp = pad4(p.bh);
  extern __shared__ __align__(16) float dsm[];
  float* s = dsm;
  t.tile = s; s += (size_t)t.hp * p.bw;
  t.x = s; s += p.bw;
  t.xs = s; s += p.bw;
  t.xb = s; s += p.bw;
  t.cs = s; s += p.bw;
  t.us = s; s += p.bw;
  t.xo0 = s; s += p.bw;
  t.xo1 = s; s += p.bw;
  t.z = s; s += t.hp;
  t.zs = s; s += t.hp;
  t.q = s; s += t.hp;
  t.zo0 = s; s += t.hp;
  t.zo1 = s; s += t.hp;
  t.red = s;
  return t;
}

// The tile and the constant band slices, once, after the power iteration
// (every padding entry zero, so the passes need no bounds).
__device__ void load_tile(const Params& p, const Band& t) {
  const int tot = t.hp * p.bw;
  for (int e = threadIdx.x; e < tot; e += kThreads) {
    const int r = e / p.bw, j = e - r * p.bw;
    t.tile[e] = (r < t.hb && j < t.wc)
                    ? __ldcg(scaled_row(p, t.b, t.r0 + r) + t.c0 + j)
                    : 0.f;
  }
  for (int j = threadIdx.x; j < p.bw; j += kThreads) {
    const bool ok = j < t.wc;
    t.cs[j] = ok ? ld(vecn(p, N_CS, t.b) + t.c0 + j) : 0.f;
    t.us[j] = ok ? ld(vecn(p, N_US, t.b) + t.c0 + j) : 0.f;
    t.x[j] = t.xs[j] = t.xb[j] = t.xo0[j] = t.xo1[j] = 0.f;
  }
  for (int i = threadIdx.x; i < t.hp; i += kThreads) {
    t.q[i] = i < t.hb ? ld(vecm(p, M_Q, t.b) + t.r0 + i) : 0.f;
    t.z[i] = t.zs[i] = t.zo0[i] = t.zo1[i] = 0.f;
  }
  __syncthreads();
}

// The iterates and their epoch sums of the band, from global memory (at
// each epoch's start: the restart decisions may have replaced them).
__device__ void load_iterates(const Params& p, const Band& t) {
  for (int j = threadIdx.x; j < t.wc; j += kThreads) {
    t.x[j] = ld(vecn(p, N_X, t.b) + t.c0 + j);
    t.xs[j] = ld(vecn(p, N_XS, t.b) + t.c0 + j);
  }
  for (int i = threadIdx.x; i < t.hb; i += kThreads) {
    t.z[i] = ld(vecm(p, M_Z, t.b) + t.r0 + i);
    t.zs[i] = ld(vecm(p, M_ZS, t.b) + t.r0 + i);
  }
  __syncthreads();
}

// Back to global memory for the check: x by the first row band's blocks,
// z by the first column band's (every block of a band holds the same bits).
__device__ void store_iterates(const Params& p, const Band& t) {
  if (t.rb == 0)
    for (int j = threadIdx.x; j < t.wc; j += kThreads) {
      vecn(p, N_X, t.b)[t.c0 + j] = t.x[j];
      vecn(p, N_XS, t.b)[t.c0 + j] = t.xs[j];
    }
  if (t.cb == 0)
    for (int i = threadIdx.x; i < t.hb; i += kThreads) {
      vecm(p, M_Z, t.b)[t.r0 + i] = t.z[i];
      vecm(p, M_ZS, t.b)[t.r0 + i] = t.zs[i];
    }
}

// Arrive at a band's counter, then wait until `target` arrivals: the
// partials the block reads next are written and visible.  The block's
// writes are ordered before the arrival by the barrier and the release
// add, the other blocks' writes before its reads by the acquire load and
// the barrier.
__device__ __forceinline__ void band_sync(unsigned* cnt, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(cnt)
                 : "memory");
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(cnt)
                   : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// sum_{k < parts} src[k * stride], in k order, the loads issued in batches
// of 8 so that they are in flight together.
__device__ __forceinline__ float sum_partials(const float* src, size_t stride,
                                              int parts) {
  float s = 0.f;
  for (int k0 = 0; k0 < parts; k0 += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = k0 + u < parts ? __ldcg(src + (k0 + u) * stride) : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (k0 + u < parts) s += v[u];
  }
  return s;
}

__device__ __forceinline__ void fma4(float4& acc, const float4 a, float s) {
  acc.x = fmaf(a.x, s, acc.x);
  acc.y = fmaf(a.y, s, acc.y);
  acc.z = fmaf(a.z, s, acc.z);
  acc.w = fmaf(a.w, s, acc.w);
}

__device__ __forceinline__ float dot4(const float4 a, const float4 v,
                                      float acc) {
  acc = fmaf(a.x, v.x, acc);
  acc = fmaf(a.y, v.y, acc);
  acc = fmaf(a.z, v.z, acc);
  return fmaf(a.w, v.w, acc);
}

// One epoch of check_every PDHG steps on the resident tile.  `nstep` counts
// the block's steps over the solve (the arrival targets and the parity).
__device__ void resident_steps(const Params& p, const Band& t, unsigned& nstep,
                               float tau, float sig) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.bw >> 2;                        // float4 column groups
  const int RG = G >= kThreads ? 1 : kThreads / G;  // row groups
  const int chunk = pad4((t.hp + RG - 1) / RG);  // rows per row group
  const float4* tile4 = reinterpret_cast<const float4*>(t.tile);
  const float4* z4 = reinterpret_cast<const float4*>(t.z);
  const float4* xb4 = reinterpret_cast<const float4*>(t.xb);
  float4* red4 = reinterpret_cast<float4*>(t.red);
  unsigned* ccnt = p.cnt + (size_t)t.b * p.Q + t.cb;
  unsigned* rcnt = p.cnt + (size_t)p.B * p.Q + (size_t)t.b * p.R + t.rb;
  for (int step = 0; step < p.check_every; ++step, ++nstep) {
    const size_t par = nstep & 1u;
    float* pc = p.pc + (par * p.B + t.b) * p.R * (size_t)p.n;
    float* pr = p.pr + (par * p.B + t.b) * p.Q * (size_t)p.mt;
    // column pass: the band's rows of Ks^T z, 4 columns and 4 rows at a time
    for (int u = tid; u < RG * G; u += kThreads) {
      const int g = u % G, rg = u / G;
      const int rbeg = rg * chunk, rend = min(rbeg + chunk, t.hp);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = rbeg; r < rend; r += 4) {
        const float4 zz = z4[r >> 2];
        const float4* a = tile4 + (size_t)r * G + g;
        fma4(acc, a[0], zz.x);
        fma4(acc, a[G], zz.y);
        fma4(acc, a[2 * G], zz.z);
        fma4(acc, a[3 * G], zz.w);
      }
      if (RG == 1) {
        float* o = pc + (size_t)t.rb * p.n + t.c0 + 4 * g;
        const int left = t.wc - 4 * g;
        if (left > 0) o[0] = acc.x;
        if (left > 1) o[1] = acc.y;
        if (left > 2) o[2] = acc.z;
        if (left > 3) o[3] = acc.w;
      } else {
        red4[u] = acc;
      }
    }
    if (RG > 1) {
      __syncthreads();
      for (int g = tid; g < G; g += kThreads) {
        float4 s = red4[g];
        for (int k = 1; k < RG; ++k) {
          const float4 v = red4[k * G + g];
          s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
        }
        float* o = pc + (size_t)t.rb * p.n + t.c0 + 4 * g;
        const int left = t.wc - 4 * g;
        if (left > 0) o[0] = s.x;
        if (left > 1) o[1] = s.y;
        if (left > 2) o[2] = s.z;
        if (left > 3) o[3] = s.w;
      }
    }
    band_sync(ccnt, (unsigned)p.R * (nstep + 1));
    // x <- clip(x - tau (cs + Ks^T z), 0, us); xb = 2 x+ - x
    for (int j = tid; j < t.wc; j += kThreads) {
      const float s = sum_partials(pc + t.c0 + j, p.n, p.R);
      const float x = t.x[j];
      const float xn = fminf(fmaxf(x - tau * (t.cs[j] + s), 0.f), t.us[j]);
      t.xb[j] = 2.f * xn - x;
      t.x[j] = xn;
      t.xs[j] += xn;
    }
    __syncthreads();
    // row pass: the band's columns of Ks xb, 4 rows per warp at a time
    for (int r = 4 * warp; r < t.hb; r += 4 * kWarps) {
      const float4* a = tile4 + (size_t)r * G;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int g = lane; g < G; g += 32) {
        const float4 v = xb4[g];
        s0 = dot4(a[g], v, s0);
        s1 = dot4(a[G + g], v, s1);
        s2 = dot4(a[2 * G + g], v, s2);
        s3 = dot4(a[3 * G + g], v, s3);
      }
      s0 = warp_sum(s0);
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      s3 = warp_sum(s3);
      if (lane == 0) {
        float* o = pr + (size_t)t.cb * p.mt + t.r0 + r;
        const int left = t.hb - r;
        o[0] = s0;
        if (left > 1) o[1] = s1;
        if (left > 2) o[2] = s2;
        if (left > 3) o[3] = s3;
      }
    }
    band_sync(rcnt, (unsigned)p.Q * (nstep + 1));
    // z <- z + sigma (Ks xb - q), projected to >= 0 on the ineq rows
    for (int i = tid; i < t.hb; i += kThreads) {
      const float s = sum_partials(pr + t.r0 + i, p.mt, p.Q);
      float zn = t.z[i] + sig * (s - t.q[i]);
      if (t.r0 + i >= p.me) zn = fmaxf(zn, 0.f);
      t.z[i] = zn;
      t.zs[i] += zn;
    }
    __syncthreads();
  }
}

// A check's products over the block's region of the UNSCALED A, G (the
// same rows and columns as its tile): per row of the band, A (dc x) and
// A (dc xs / div) over the band's columns; per column, A^T (d z) and
// A^T (d zs / div) over the band's rows.  Written as partials to slot 0
// (current iterate) and slot 1 (epoch average) of the steps' pr / pc, idle
// at a check; resident_check_epilogue sums them.
__device__ void resident_check_pass(const Params& p, const Band& t,
                                    float div) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < t.wc; j += kThreads) {
    const float dc = ld(vecn(p, N_DC, t.b) + t.c0 + j);
    t.xo0[j] = dc * t.x[j];
    t.xo1[j] = dc * (t.xs[j] / div);
  }
  for (int i = tid; i < t.hb; i += kThreads) {
    const float d = ld(vecm(p, M_D, t.b) + t.r0 + i);
    t.zo0[i] = d * t.z[i];
    t.zo1[i] = d * (t.zs[i] / div);
  }
  __syncthreads();
  const size_t slot_r = (size_t)p.B * p.Q * p.mt;
  const size_t slot_c = (size_t)p.B * p.R * p.n;
  float* pr = p.pr + ((size_t)t.b * p.Q + t.cb) * p.mt + t.r0;
  float* pc = p.pc + ((size_t)t.b * p.R + t.rb) * p.n + t.c0;
  // rows: 4 rows per warp at a time, the lanes along the band's columns
  for (int r = 4 * warp; r < t.hb; r += 4 * kWarps) {
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
    const float* row[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      row[q] = data_row(p, t.b, t.r0 + min(r + q, t.hb - 1)) + t.c0;
    if (p.v4) {
      const float4* u0 = reinterpret_cast<const float4*>(t.xo0);
      const float4* u1 = reinterpret_cast<const float4*>(t.xo1);
      for (int g = lane; g < (t.wc >> 2); g += 32) {
        float4 a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          a[q] = __ldg(reinterpret_cast<const float4*>(row[q]) + g);
        const float4 v0 = u0[g], v1 = u1[g];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s0[q] = dot4(a[q], v0, s0[q]);
          s1[q] = dot4(a[q], v1, s1[q]);
        }
      }
    } else {
      for (int j = lane; j < t.wc; j += 32) {
        float a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) a[q] = __ldg(row[q] + j);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s0[q] = fmaf(a[q], t.xo0[j], s0[q]);
          s1[q] = fmaf(a[q], t.xo1[j], s1[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s0[q] = warp_sum(s0[q]);
      s1[q] = warp_sum(s1[q]);
    }
    if (lane == 0)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (r + q < t.hb) {
          pr[r + q] = s0[q];
          pr[slot_r + r + q] = s1[q];
        }
  }
  // columns: a thread per column (4 columns with float4 loads), its rows
  // in batches of 8 loads in flight
  const int cols = p.v4 ? (t.wc >> 2) : t.wc;
  for (int g = tid; g < cols; g += kThreads) {
    float4 c0 = make_float4(0.f, 0.f, 0.f, 0.f), c1 = c0;
    for (int r0 = 0; r0 < t.hb; r0 += 8) {
      float4 a[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = min(r0 + u, t.hb - 1);
        const float* src = data_row(p, t.b, t.r0 + r) + t.c0;
        if (p.v4) {
          a[u] = __ldg(reinterpret_cast<const float4*>(src) + g);
        } else {
          a[u].x = __ldg(src + g);
          a[u].y = a[u].z = a[u].w = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (r0 + u < t.hb) {
          fma4(c0, a[u], t.zo0[r0 + u]);
          fma4(c1, a[u], t.zo1[r0 + u]);
        }
    }
    const int j = p.v4 ? 4 * g : g;
    const int left = p.v4 ? min(4, t.wc - j) : 1;
    const float v0[4] = {c0.x, c0.y, c0.z, c0.w};
    const float v1[4] = {c1.x, c1.y, c1.z, c1.w};
    for (int e = 0; e < left; ++e) {
      pc[j + e] = v0[e];
      pc[slot_c + j + e] = v1[e];
    }
  }
}

template <bool kResident>
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

  // ---- the resident tile (resident kernel)
  Band band{};
  unsigned nstep = 0;
  if (kResident) {
    band = band_of(p);
    load_tile(p, band);
  }

  // ---- the restarted loop
  for (int k = 0;; ++k) {
    if (!((long long)k * ce < (long long)p.iters_cap)) break;
    bool any = false;
    for (int b = 0; b < B; ++b) any |= live(p, b);
    if (!any) break;

    if (kResident) {
      if (live(p, band.b)) {
        load_iterates(p, band);
        const float* sc = scal(p, band.b);
        const float eta = ld(sc + S_ETA), omega = ld(sc + S_OMEGA);
        resident_steps(p, band, nstep, eta / omega, eta * omega);
        store_iterates(p, band);
      }
      grid_sync(p.bar);
    }
    if (!kResident)  // the streaming kernel's steps
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
    auto row_epi = [&](int b, int r, const float* a) {
      const float q = rhs(p, b, r), d = ld(vecm(p, M_D, b) + r);
      const float div = divf(b);
      float* o = p.rowv + ((size_t)b * mt + r) * 4;
      o[0] = r < me ? fabsf(a[0] - q) : fmaxf(a[0] - q, 0.f);
      o[1] = r < me ? fabsf(a[1] - q) : fmaxf(a[1] - q, 0.f);
      o[2] = q * (d * ld(vecm(p, M_Z, b) + r));
      o[3] = q * (d * (ld(vecm(p, M_ZS, b) + r) / div));
    };
    auto col_epi = [&](int b, int j, const float* s) {
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
    };
    if (kResident) {
      // each block over its own region of A, G; then the first column
      // band's blocks finish the rows and the first row band's the columns
      if (live(p, band.b)) resident_check_pass(p, band, divf(band.b));
      grid_sync(p.bar);
      if (live(p, band.b)) {
        const size_t slot_r = (size_t)B * p.Q * mt, slot_c = (size_t)B * p.R * n;
        if (band.cb == 0)
          for (int i = tid; i < band.hb; i += kThreads) {
            const float* src =
                p.pr + (size_t)band.b * p.Q * mt + band.r0 + i;
            const float a[2] = {sum_partials(src, mt, p.Q),
                                sum_partials(src + slot_r, mt, p.Q)};
            row_epi(band.b, band.r0 + i, a);
          }
        if (band.rb == 0)
          for (int j = tid; j < band.wc; j += kThreads) {
            const float* src =
                p.pc + (size_t)band.b * p.R * n + band.c0 + j;
            const float s[2] = {sum_partials(src, n, p.R),
                                sum_partials(src + slot_c, n, p.R)};
            col_epi(band.b, band.c0 + j, s);
          }
      }
    } else {
      row_pass<false, 2>(
          p, sm,
          [&](int kk, int b, int j) {
            const float dc = ld(vecn(p, N_DC, b) + j);
            return kk == 0 ? dc * ld(vecn(p, N_X, b) + j)
                           : dc * (ld(vecn(p, N_XS, b) + j) / divf(b));
          },
          row_epi);
      col_pass<false, 2>(
          p, sm,
          [&](int kk, int b, int r) {
            const float d = ld(vecm(p, M_D, b) + r);
            return kk == 0 ? d * ld(vecm(p, M_Z, b) + r)
                           : d * (ld(vecm(p, M_ZS, b) + r) / divf(b));
          },
          col_epi);
    }
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

// What the resident plan may use on this device: the SM count, the opt-in
// shared memory per block, and the dynamic shared memory one block of the
// resident kernel can hold (the opt-in maximum less the kernel's static
// shared memory).
cudaError_t lp_resident_budget(int* sms, int* optin, int* smem_per_block) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, pdhg_kernel<true>);
  if (e != cudaSuccess) return e;
  *smem_per_block = *optin - (int)attr.sharedSizeBytes;
  return cudaSuccess;
}

// Dynamic shared memory of one resident block for a plan's band sizes.
long long lp_resident_smem(int h, int w) {
  return (long long)resident_smem_bytes(h, w);
}

// Shapes (float32, row-major, contiguous): A B x me x n, b B x me, G B x mi
// x n, h B x mi, c / u / ix B x n, iy B x me, il B x mi.  Scratch: ks B x
// (me+mi) x n, vn 8 x B x n, vm 8 x B x (me+mi), rowv B x (me+mi) x 4, colv
// B x n x 6, scal B x lp_scalar_slots(), bar 2 + B x (R + Q) (zeroed).
// Outputs: x_out B x n, y_out B x me, l_out B x mi, done / iters / restarts
// B (int32), stats 3 x B (pres, dres, gap).
//
// R = 0: the streaming kernel.  R > 0: the resident kernel on the plan of
// R row bands of h rows and Q column bands of w columns (w a multiple of
// 4) per member, one block per tile, B x R x Q blocks; pc (2 x B x R x n)
// and pr (2 x B x Q x (me+mi)) are its partials.  A plan that does not
// cover the operator exactly, or whose tiles do not fit, is refused.
cudaError_t lp_pdhg(const float* A, const float* b, const float* G,
                    const float* h, const float* c, const float* u,
                    const float* ix, const float* iy, const float* il, int B,
                    int me, int mi, int n, float eps, int iters_cap,
                    int check_every, int restart_len, float* ks, float* vn,
                    float* vm, float* rowv, float* colv, float* scal,
                    unsigned* bar, float* x_out, float* y_out, float* l_out,
                    int* done, int* iters, int* restarts, float* stats,
                    int R, int Q, int bh, int bw, float* pc, float* pr,
                    cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  const int mt = me + mi;
  const bool res = R > 0;
  size_t smem = 0;
  long long blocks = 0;
  if (res) {
    if (Q <= 0 || bh <= 0 || bw <= 0 || bw % 4 || pc == nullptr ||
        pr == nullptr || (long long)R * bh < mt ||
        (long long)(R - 1) * bh >= mt || (long long)Q * bw < n ||
        (long long)(Q - 1) * bw >= n)
      return cudaErrorInvalidValue;
    smem = resident_smem_bytes(bh, bw);
    e = cudaFuncSetAttribute(pdhg_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pdhg_kernel<true>, kThreads, smem);
    blocks = (long long)B * R * Q;
    if (e == cudaSuccess && (per_sm < 1 || blocks > (long long)per_sm * sms))
      return cudaErrorCooperativeLaunchTooLarge;
  } else {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pdhg_kernel<false>, kThreads, 0);
    if (e == cudaSuccess && per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks = (long long)sms * (per_sm < 2 ? per_sm : 2);
  }
  if (e != cudaSuccess) return e;
  Params p;
  p.A = A; p.b = b; p.G = G; p.h = h; p.c = c; p.u = u;
  p.ix = ix; p.iy = iy; p.il = il;
  p.B = B; p.me = me; p.mi = mi; p.n = n; p.mt = mt;
  p.eps = eps;
  p.iters_cap = iters_cap; p.check_every = check_every;
  p.restart_len = restart_len;
  p.v4 = (n % 4 == 0) && (((uintptr_t)A | (uintptr_t)G | (uintptr_t)ks) % 16 == 0);
  p.ks = ks; p.vn = vn; p.vm = vm; p.rowv = rowv; p.colv = colv;
  p.scal = scal; p.bar = bar;
  p.x_out = x_out; p.y_out = y_out; p.l_out = l_out;
  p.done = done; p.iters = iters; p.restarts = restarts; p.stats = stats;
  p.R = R; p.Q = Q; p.bh = bh; p.bw = bw; p.pc = pc; p.pr = pr;
  p.cnt = bar + 2;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(
      res ? (const void*)pdhg_kernel<true> : (const void*)pdhg_kernel<false>,
      dim3((unsigned)blocks), dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
