// Pod-granular first-fit-decreasing packing on an NVIDIA H100 (sm_90a).
//
// K7 ffd_scan replaces the jit'd XLA program of the JAX package's
// ops/ffd.py:ffd_pack_kernel (:43-118), a lax.scan over FFD-sorted pod rows.
// Each step:
//   1. first fit over the K open slots, at the lowest index: the slot's
//      option is compatible with the row, its per-class pod count is under
//      the row's node cap, and used + request <= allocatable on every axis;
//   2. with no fit and a free slot left, the new node: among the options
//      that are compatible, fit the request and have a finite price, the
//      best pool rank, then the least min(price * ceil(max(tail, 1) / m),
//      SCORE_CAP) (m = pods of the row's shape per node, clipped to
//      [1, max(cap, 1)]), ties to the lowest index;
//   3. the state update, with the per-class counters reset at a class
//      boundary.
//
// Bound on this card: neither bytes nor operations but the sequential
// dependency from row to row (each row reads the state the previous one
// wrote), so the scan runs as ONE persistent block, and what a row costs is
// the latency of its step.  The design keeps that step on one warp:
//
//   * One warp walks the rows.  It tests 32 slots a step from a cursor
//     (below), takes the first set bit of a __ballot_sync, updates the slot
//     with one lane per resource axis and moves on after a __syncwarp: no
//     block barrier per row.  Rows are read 32 at a time into registers one
//     chunk ahead of their use, and each is compared there with the row
//     before it, so a step waits on no global load and does no comparison.
//   * The first-fit cursor.  Call two valid rows IDENTICAL when they have
//     the same class (no class boundary between them, valid or not), the
//     same compat row, the same node cap and bit-equal requests; `tail`
//     does not enter the fit test.  Between two consecutive identical rows
//     only one slot changes: the one the earlier row took (a fit, or the
//     node it opened).  Every other slot gives the later row the answer it
//     gave the earlier one.  So no slot below the earlier row's slot can
//     fit the later row, and if the earlier row placed nothing, no open
//     slot can.  A run is a sequence of consecutive valid rows, each
//     identical to the one before it (checked at run time, bit for bit);
//     inside a run the search resumes at the previous row's slot (past
//     every open slot when it placed nothing), and every other row starts
//     a run with a search from slot 0.  The result is exact for any input,
//     not only for class-contiguous rows.  The same argument fills a slot
//     in one step: the identical rows after a row that took slot k go to
//     k for as long as it takes them, which each axis counts with its own
//     float32 adds (the reference's adds, in order) and the node cap
//     bounds; after a row that placed nothing, its identical rows place
//     nothing either.
//   * The block joins only where the work is wide.  At the first row of a
//     run the whole block (512 threads) zeroes the class counters after a
//     class boundary, stages the run's compat row in shared memory and
//     searches every open slot from 0 (thousands of existing nodes on a
//     live cluster).  At the run's first row that fits no open slot, the
//     block lists the new-node candidates once: the options with the
//     compat bit, req <= alloc and a finite price, restricted to the best
//     pool rank among them, in option order, each with its price and its
//     m.  Each new node of the run is then one block phase over that list
//     (thousands of options at full width): min(price * ceil(max(tail, 1)
//     / m), SCORE_CAP), the least score, ties to the lowest index.  The
//     scores are never NaN (a finite price times a finite ceiling, m
//     clamped to [1, max(cap, 1)] by fminf / fmaxf), so that order is
//     total and any reduction order gives the reference's choice.  A few
//     block barriers per run and per new node, against five per row
//     before.
//   * The slot state (used and each slot's allocatable, K x R float32,
//     option and class count, K ints) and the candidate list live in
//     shared memory when they fit (K = 2048, R = 7 with 4096 options: 211
//     KB), else in global scratch, where the scan stays exact and only its
//     steps slow down.
//
// Exactness: the state is float32 and must match the reference bit for
// bit, so every add, divide and product is the IEEE round-to-nearest
// intrinsic (__fadd_rn, __fdiv_rn, __fmul_rn) in the reference's order.
// nvcc never contracts these into an FMA, and they do not depend on
// -prec-div or --use_fast_math, so the source needs no flag of its own.
// Each slot's allocatable is a copy of its option's row, taken when the
// slot opens, so the fit compares the same floats.
//
// Plain C interface (returns cudaError_t), loaded with ctypes; the launch
// goes on the caller's stream; nothing here synchronises or allocates.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 16;
constexpr int kIBig = 1 << 30;
constexpr unsigned kAll = 0xffffffffu;
constexpr float kScoreCap = 3.38e38f;       // ops/ffd.py SCORE_CAP as float32
// opt-in dynamic shared memory (227 KB), less room for the static arrays
constexpr size_t kSmemMax = 220 * 1024;
// the candidate list is built over tiles of kThreads options, at most
// kTiles of them (a bit each in a thread's mask) per pass
constexpr int kTiles = 32;
// a chunk's requests, 32 rows x kMaxR, staged for the walking warp
constexpr size_t kStageBytes = 32 * kMaxR * 4;

enum Cmd { kNewRun, kCandidates, kScore, kDone };

__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// the kernel's bound on the axes, a template argument: 4, 8 or kMaxR
__host__ __device__ constexpr int axis_bound(int R) {
  return R <= 4 ? 4 : R <= 8 ? 8 : kMaxR;
}

// the row stride of the state in shared memory: the axis bound, the axes
// past R held at 0 (0 + 0 <= 0 fits), plus one, so that 32 slots' entries
// of one axis fall in 32 banks
__host__ __device__ constexpr int smem_stride(int R) {
  return axis_bound(R) + 1;
}

__host__ __device__ constexpr size_t state_bytes(int K, int R) {
  return (size_t)K * smem_stride(R) * 8 + (size_t)K * 8;
}

__host__ __device__ constexpr size_t cand_bytes(int O) {
  return (size_t)O * 12;
}

__device__ __forceinline__ int compat_bit(const uint8_t* row, int o) {
  // np.packbits order: column o is byte o >> 3, bit 7 - (o & 7)
  return (row[o >> 3] >> (7 - (o & 7))) & 1;
}

// the minimum over the block of every thread's v, to every thread
__device__ int block_min(int v, int* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_min_sync(kAll, v);
  __syncthreads();  // s_red may still be read from a previous call
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  return __reduce_min_sync(kAll, lane < kWarps ? s_red[lane] : kIBig);
}

// exclusive prefix over the block (threads in order) of v; the sum to *total
__device__ int block_exclusive_scan(int v, int* s_red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x += y;
  }
  __syncthreads();
  if (lane == 31) s_red[warp] = x;
  __syncthreads();
  int w = lane < kWarps ? s_red[lane] : 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAll, w, d);
    if (lane >= d) w += y;
  }
  *total = __shfl_sync(kAll, w, 31);
  const int before = __shfl_sync(kAll, w, warp) - s_red[warp];
  return before + x - v;
}

// (score, option) of a new node: the least score, ties to the lowest index
__device__ __forceinline__ bool lower(float sa, int ia, float sb, int ib) {
  return sa < sb || (sa == sb && ia < ib);
}

// The loops over the resource axes run to the compile-time bound kR with
// no branch inside: fully unrolled, every load of a test goes out before
// the first is used.  (A branch per axis, or a loop to the run-time R,
// waits on each load in turn: a row's step then costs a shared-memory
// round trip per axis.)  Requests past R are staged as 0; the state in
// shared memory holds 0 past R; a row of `alloc` is read at min(r, R - 1)
// and the axes past R masked off.

// slot s takes the row: open, compatible, under the cap, and
// used + req <= alloc on every axis (the reference's float32 adds)
template <bool kSmem, int kR>
__device__ __forceinline__ bool slot_fits(int s, const int* opt,
                                          const int* cls, const float* used,
                                          const float* salloc, int RS,
                                          const uint8_t* comp,
                                          const float* rq, int R, int cap) {
  const int o = opt[s];
  bool ok = o >= 0 && cls[s] < cap;
  const float* u = used + (size_t)s * RS;
  const float* a = salloc + (size_t)s * RS;
  if (kSmem) {
#pragma unroll
    for (int r = 0; r < kR; ++r) ok &= __fadd_rn(u[r], rq[r]) <= a[r];
  } else {  // the state is the outputs, R to a row
    for (int r = 0; r < R; ++r) ok &= __fadd_rn(u[r], rq[r]) <= a[r];
  }
  return ok && compat_bit(comp, max(o, 0));
}

// option o may open a node for the run's row (`rq`, `comp`): compatible,
// a finite price, req <= alloc on every axis
template <int kR>
__device__ __forceinline__ bool new_ok(int o, const uint8_t* comp,
                                       const float* price,
                                       const float* alloc, const float* rq,
                                       int R) {
  bool ok = compat_bit(comp, o) && isfinite(price[o]);
  const float* a = alloc + (size_t)o * R;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float ar = a[min(r, R - 1)];
    ok &= (r >= R) | (rq[r] <= ar);
  }
  return ok;
}

// pods of the row's shape a fresh option-o node holds, clipped to
// [1, max(cap, 1)] (fminf / fmaxf: never NaN)
template <int kR>
__device__ __forceinline__ float pods_per_node(int o, const float* alloc,
                                               const float* rq, int R,
                                               int cap) {
  float m = (float)kIBig;
  const float* a = alloc + (size_t)o * R;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float d = floorf(__fdiv_rn(a[min(r, R - 1)], rq[r] > 0.0f ? rq[r] : 1.0f));
    m = rq[r] > 0.0f ? fminf(m, d) : m;
  }
  return fminf(fmaxf(m, 1.0f), fmaxf((float)cap, 1.0f));
}

template <bool kSmem, int kR>
__global__ void __launch_bounds__(kThreads, 1)
ffd_scan_kernel(const float* __restrict__ req, const uint8_t* __restrict__ compat,
                const int* __restrict__ compat_row,
                const int* __restrict__ class_id,
                const uint8_t* __restrict__ valid,
                const int* __restrict__ node_cap, const int* __restrict__ rem,
                const float* __restrict__ alloc,
                const float* __restrict__ price, const int* __restrict__ rank,
                const int* __restrict__ init_option,
                const float* __restrict__ init_used, int P, int O, int R,
                int K, int OB, bool cand_smem, unsigned char* scratch,
                int* __restrict__ assignment, int* slot_option,
                float* slot_used, int* __restrict__ n_open_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // shared: the chunk's requests, the run's compat row, then (kSmem) the
  // slot state and (cand_smem) the candidate list; the rest in scratch
  float* s_rreq = reinterpret_cast<float*>(smem);
  uint8_t* s_comp = smem + kStageBytes;
  unsigned char* tail = smem + kStageBytes + align16(OB);
  const int RS = kSmem ? smem_stride(R) : R;
  float* used;
  float* salloc;
  int* opt;
  int* cls;
  if (kSmem) {
    used = reinterpret_cast<float*>(tail);
    salloc = used + (size_t)K * RS;
    opt = reinterpret_cast<int*>(salloc + (size_t)K * RS);
    cls = opt + K;
    tail = reinterpret_cast<unsigned char*>(cls + K);
  } else {  // the outputs double as the state
    used = slot_used;
    opt = slot_option;
    salloc = reinterpret_cast<float*>(scratch);
    cls = reinterpret_cast<int*>(salloc + (size_t)K * R);
    scratch = reinterpret_cast<unsigned char*>(cls + K);
  }
  int* c_idx = reinterpret_cast<int*>(cand_smem ? tail : scratch);
  float* c_p = reinterpret_cast<float*>(c_idx + O);
  float* c_m = c_p + O;

  __shared__ float s_runreq[kMaxR];
  __shared__ int s_red[kWarps];
  __shared__ float s_red_s[kWarps];
  __shared__ int s_wcnt[kTiles * kWarps];   // candidates per (tile, warp)
  __shared__ int s_cmd, s_fit, s_nopen, s_hi, s_ncand, s_reset, s_crow,
      s_cap, s_tail, s_built, s_best;

  // the initial state; n_open and hi (one past the last open slot)
  int local_open = 0, local_hi = 0;
  for (int k = t; k < K; k += kThreads) {
    const int o = init_option ? init_option[k] : -1;
    opt[k] = o;
    cls[k] = 0;
    for (int r = 0; r < (kSmem ? RS : R); ++r) {
      const bool axis = r < R;
      used[(size_t)k * RS + r] =
          init_used && axis ? init_used[(size_t)k * R + r] : 0.0f;
      salloc[(size_t)k * RS + r] =
          o >= 0 && axis ? alloc[(size_t)o * R + r] : 0.0f;
    }
    if (o >= 0) {
      local_open += 1;
      local_hi = k + 1;
    }
  }
  int total_open;
  block_exclusive_scan(local_open, s_red, &total_open);
  const int hi0 = -block_min(-local_hi, s_red);

  // the walking warp's state (registers of warp 0)
  int n_open = total_open, hi = hi0, cursor = 0, prev_cid = 0;
  bool started = false, in_run = false, cls_dirty = false, cand_ready = false;
  int ncand = 0, pre_fit = -1, pre_best = -1, row = 0, c0 = -32;
  int a_reg = -1;
  // row c0 + lane of the current chunk (r_*) and of the next one (n_*);
  // r_same: the row is valid and identical to the valid row before it
  int r_cid = 0, r_valid = 0, r_cap = 0, r_crow = 0, r_tail = 0;
  bool r_same = false;
  int n_cid = 0, n_valid = 0, n_cap = 0, n_crow = 0, n_tail = 0;
  float n_req[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) n_req[r] = 0.0f;

  auto fetch = [&](int base) {  // rows base .. base + 31 into n_*
    const int i = base + lane;
    n_valid = 0;  // past P: no row, never part of a run or a padding run
    n_cid = INT_MIN;
    if (i < P) {
      n_cid = class_id[i];
      n_valid = valid[i];
      n_cap = node_cap[i];
      n_crow = compat_row[i];
      n_tail = rem[i];
#pragma unroll
      for (int r = 0; r < kMaxR; ++r)
        if (r < R) n_req[r] = req[(size_t)i * R + r];
    }
  };
  if (warp == 0) fetch(0);

  for (;;) {
    // ---- the walk: warp 0 alone, until a row needs the block ----------
    if (warp == 0) {
      int cmd = kDone;
      while (row < P) {
        if (row >= c0 + 32) {  // next chunk: write back, compare, stage
          if (c0 >= 0 && c0 + lane < P) assignment[c0 + lane] = a_reg;
          // each row against the row before it (lane 0: the last chunk's)
          int p_cid = __shfl_up_sync(kAll, n_cid, 1);
          int p_valid = __shfl_up_sync(kAll, n_valid, 1);
          int p_cap = __shfl_up_sync(kAll, n_cap, 1);
          int p_crow = __shfl_up_sync(kAll, n_crow, 1);
          const int l_cid = __shfl_sync(kAll, r_cid, 31);
          const int l_valid = __shfl_sync(kAll, r_valid, 31);
          const int l_cap = __shfl_sync(kAll, r_cap, 31);
          const int l_crow = __shfl_sync(kAll, r_crow, 31);
          if (lane == 0) {
            p_cid = l_cid;
            p_valid = c0 >= 0 && l_valid;
            p_cap = l_cap;
            p_crow = l_crow;
          }
          bool same = n_valid && p_valid && n_cid == p_cid &&
                      n_cap == p_cap && n_crow == p_crow;
#pragma unroll
          for (int r = 0; r < kMaxR; ++r)
            if (r < R) {
              float q = __shfl_up_sync(kAll, n_req[r], 1);
              if (lane == 0) q = s_rreq[31 * kMaxR + r];
              same &= __float_as_uint(q) == __float_as_uint(n_req[r]);
            }
          c0 += 32;
          __syncwarp();
#pragma unroll
          for (int r = 0; r < kMaxR; ++r) s_rreq[lane * kMaxR + r] = n_req[r];
          r_cid = n_cid;
          r_valid = n_valid;
          r_cap = n_cap;
          r_crow = n_crow;
          r_tail = n_tail;
          r_same = same;
          a_reg = -1;
          fetch(c0 + 32);
          __syncwarp();
        }
        const int j = row - c0;
        const int cid = __shfl_sync(kAll, r_cid, j);
        const int vld = __shfl_sync(kAll, r_valid, j);
        const int cap = __shfl_sync(kAll, r_cap, j);
        const bool same = __shfl_sync(kAll, (int)r_same, j);
        if (!started || cid != prev_cid) {  // a class boundary
          started = true;
          prev_cid = cid;
          cls_dirty = true;
          in_run = false;
        }
        if (!vld) {  // padding: nothing placed, and none by the invalid
          in_run = false;  // rows of the same class right after it
          const unsigned pad = __ballot_sync(kAll, !r_valid && r_cid == cid);
          row += j < 31 ? __ffs(~(pad >> (j + 1))) : 1;
          continue;
        }
        const float* rq = s_rreq + j * kMaxR;
        int fit;
        if (pre_fit >= 0) {  // the block searched this row
          fit = pre_fit;
          pre_fit = -1;
        } else {
          if (!(in_run && same)) {
            // a new run: the block searches from slot 0
            const int crow = __shfl_sync(kAll, r_crow, j);
            const int tl = __shfl_sync(kAll, r_tail, j);
            if (lane < kMaxR) s_runreq[lane] = rq[lane];
            if (lane == 0) {
              s_crow = crow;
              s_cap = cap;
              s_reset = cls_dirty;
              s_hi = hi;
              s_nopen = n_open;
              s_tail = max(tl, 1);
            }
            in_run = true;
            cls_dirty = false;
            cand_ready = false;
            cursor = 0;
            cmd = kNewRun;
            break;
          }
          fit = kIBig;  // the search from the cursor, 32 slots a step
          for (int s0 = cursor; s0 < hi; s0 += 32) {
            const int s = s0 + lane;
            const bool ok = s < hi && slot_fits<kSmem, kR>(
                                          s, opt, cls, used, salloc, RS,
                                          s_comp, rq, R, cap);
            const unsigned b = __ballot_sync(kAll, ok);
            if (b) {
              fit = s0 + __ffs(b) - 1;
              break;
            }
          }
        }
        int k = -1;
        if (fit < kIBig) {
          k = fit;
        } else if (n_open < K && (!cand_ready || ncand > 0)) {
          if (pre_best < 0) {  // the block lists and scores the candidates
            const int tl = __shfl_sync(kAll, r_tail, j);
            if (lane == 0) {
              s_hi = hi;
              s_nopen = n_open;
              s_tail = max(tl, 1);
            }
            cmd = cand_ready ? kScore : kCandidates;
            break;
          }
          const int best = pre_best;
          pre_best = -1;
          if (best < kIBig) {
            k = n_open;
            if (lane == 0) opt[k] = best;
            if (lane < R)
              salloc[(size_t)k * RS + lane] = alloc[(size_t)best * R + lane];
            n_open += 1;
            hi = max(hi, k + 1);
          }
        }
        if (k >= 0) {
          if (lane < R)
            used[(size_t)k * RS + lane] =
                __fadd_rn(used[(size_t)k * RS + lane], rq[lane]);
          if (lane == 0) cls[k] += 1;
          cursor = k;
        } else {
          cursor = hi;
        }
        if (lane == j) a_reg = k;
        // the identical rows right after this one, in this chunk, get its
        // answer in one step: slot k for as long as it still takes them
        // (they search from k, so k is their first fit while it fits;
        // each axis counts its own float32 adds, the cap its pods), or
        // nothing when this row placed nothing (the state is unchanged)
        const unsigned later =
            j < 31 ? __ballot_sync(kAll, r_same) >> (j + 1) : 0u;
        const int avail = __ffs(~later) - 1;
        if (avail > 0) {
          int more = avail;
          if (k >= 0) {
            __syncwarp();
            float u = 0.0f, q = 0.0f;
            int fits = avail;
            if (lane < R) {
              u = used[(size_t)k * RS + lane];
              q = rq[lane];
              const float a = salloc[(size_t)k * RS + lane];
              float v = u;
              for (fits = 0; fits < avail; ++fits) {
                const float v2 = __fadd_rn(v, q);
                if (!(v2 <= a)) break;
                v = v2;
              }
            }
            const int room = __shfl_sync(kAll, lane == 0 ? cap - cls[k] : 0, 0);
            more = min(__reduce_min_sync(kAll, fits), max(room, 0));
            if (more > 0) {
              if (lane < R) {
                for (int m = 0; m < more; ++m) u = __fadd_rn(u, q);
                used[(size_t)k * RS + lane] = u;
              }
              if (lane == 0) cls[k] += more;
            }
          }
          if (lane > j && lane <= j + more) a_reg = k;
          row += more;
        }
        __syncwarp();
        ++row;
      }
      if (cmd == kDone) {
        if (c0 >= 0 && c0 + lane < P) assignment[c0 + lane] = a_reg;
        if (lane == 0) s_nopen = n_open;
      }
      if (lane == 0) s_cmd = cmd;
    }
    __syncthreads();
    const int cmd = s_cmd;
    if (cmd == kDone) break;

    // ---- the block's part ---------------------------------------------
    const int hi_b = s_hi, nopen_b = s_nopen, cap_b = s_cap;
    int fit_b = kIBig;
    if (cmd == kNewRun) {  // the run's first row: every open slot from 0
      if (s_reset)
        for (int k = t; k < K; k += kThreads) cls[k] = 0;
      const uint8_t* crow_p = compat + (size_t)s_crow * OB;
      for (int b = t; b < OB; b += kThreads) s_comp[b] = crow_p[b];
      __syncthreads();
      int f = kIBig;
      for (int s = t; s < hi_b; s += kThreads)
        if (slot_fits<kSmem, kR>(s, opt, cls, used, salloc, RS, s_comp,
                                 s_runreq, R, cap_b)) {
          f = s;
          break;
        }
      fit_b = block_min(f, s_red);
      if (t == 0) s_fit = fit_b;
    }
    const bool build =
        cmd == kCandidates || (cmd == kNewRun && fit_b >= kIBig && nopen_b < K);
    if (build) {
      // the best pool rank among the options that may open a node
      int br = kIBig;
#pragma unroll 4
      for (int o = t; o < O; o += kThreads)
        if (new_ok<kR>(o, s_comp, price, alloc, s_runreq, R)) br = min(br, rank[o]);
      br = block_min(br, s_red);
      // the candidates (that rank's options) in option order: tile i of a
      // pass holds options base + i * kThreads + t, so option order is
      // (tile, warp, lane) order; each candidate's place is the count of
      // the earlier (tile, warp) pairs' candidates plus its rank in its
      // warp's ballot
      int count = 0;
      for (int base = 0; base < O; base += kTiles * kThreads) {
        const int tiles = min(kTiles, (O - base + kThreads - 1) / kThreads);
        unsigned mine = 0;
#pragma unroll 4
        for (int i = 0; i < tiles; ++i) {
          const int o = base + i * kThreads + t;
          if (o < O && rank[o] == br &&
              new_ok<kR>(o, s_comp, price, alloc, s_runreq, R))
            mine |= 1u << i;
        }
        for (int i = 0; i < tiles; ++i) {
          const unsigned b = __ballot_sync(kAll, (mine >> i) & 1);
          if (lane == 0) s_wcnt[i * kWarps + warp] = __popc(b);
        }
        __syncthreads();
        const int pairs = tiles * kWarps;
        const int v = t < pairs ? s_wcnt[t] : 0;
        int total;
        const int before = block_exclusive_scan(v, s_red, &total);
        if (t < pairs) s_wcnt[t] = count + before;
        __syncthreads();
        for (int i = 0; i < tiles; ++i) {
          const unsigned b = __ballot_sync(kAll, (mine >> i) & 1);
          if ((mine >> i) & 1) {
            const int o = base + i * kThreads + t;
            const int at = s_wcnt[i * kWarps + warp] +
                           __popc(b & ((1u << lane) - 1u));
            c_idx[at] = o;
            c_p[at] = price[o];
            c_m[at] = pods_per_node<kR>(o, alloc, s_runreq, R, cap_b);
          }
        }
        count += total;
        __syncthreads();  // the list is written; s_wcnt is free
      }
      if (t == 0) s_ncand = count;
      __syncthreads();
    }
    if (build || cmd == kScore) {
      // the new node: min(price * ceil(tail / m), SCORE_CAP) over the list,
      // the least score, ties to the lowest index (the list is in option
      // order, so each thread's first of equal scores is its lowest)
      const int nc = s_ncand;
      const float tl = (float)s_tail;
      float bs = INFINITY;
      int bi = kIBig;
#pragma unroll 4
      for (int c = t; c < nc; c += kThreads) {
        const float sc = fminf(
            __fmul_rn(c_p[c], ceilf(__fdiv_rn(tl, c_m[c]))), kScoreCap);
        if (sc < bs) {
          bs = sc;
          bi = c_idx[c];
        }
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const float s2 = __shfl_xor_sync(kAll, bs, d);
        const int i2 = __shfl_xor_sync(kAll, bi, d);
        if (lower(s2, i2, bs, bi)) {
          bs = s2;
          bi = i2;
        }
      }
      if (lane == 0) {
        s_red_s[warp] = bs;
        s_red[warp] = bi;
      }
      __syncthreads();
      if (t == 0) {
        for (int w = 1; w < kWarps; ++w)
          if (lower(s_red_s[w], s_red[w], bs, bi)) {
            bs = s_red_s[w];
            bi = s_red[w];
          }
        s_best = bi;  // kIBig: no option can take the row
      }
    }
    if (t == 0) s_built = build;
    __syncthreads();
    if (warp == 0) {
      pre_fit = cmd == kNewRun ? s_fit : kIBig;
      if (s_built) {
        cand_ready = true;
        ncand = s_ncand;
      }
      if (s_built || cmd == kScore) pre_best = s_best;
    }
  }

  if (kSmem) {
    for (int k = t; k < K; k += kThreads) {
      slot_option[k] = opt[k];
#pragma unroll
      for (int r = 0; r < kMaxR; ++r)
        if (r < R) slot_used[(size_t)k * R + r] = used[(size_t)k * RS + r];
    }
  }
  if (t == 0) *n_open_out = s_nopen;
}

// The latency of the scan's dependent steps on this card, for K7's bound
// (chip_smoke.py): one warp runs a chain of `steps` least row steps -- a
// shared-memory load at the index the step before chose, a float32 add and
// compare, a __ballot_sync whose first set bit moves the index -- and then a
// chain of `steps` dependent float32 adds (a slot's fill, one add a row).
// cycles[0], cycles[1]: the SM cycles (clock64) of each chain; cycles[2]
// keeps both chains' results live, and `period` (every period-th entry
// passes the test) comes in at run time, so the compiler folds neither.
__global__ void step_cycles_kernel(int steps, int period,
                                   long long* cycles) {
  __shared__ float s[1024];
  const int lane = threadIdx.x;
  for (int i = lane; i < 1024; i += 32) s[i] = i % period ? 2.0f : 0.0f;
  __syncwarp();
  int at = 0;
  const long long t0 = clock64();
  for (int i = 0; i < steps; ++i) {
    const float u = s[(at + lane) & 1023];
    const unsigned b = __ballot_sync(kAll, __fadd_rn(u, 1.0f) <= 1.5f);
    at = (at + __ffs(b)) & 1023;
  }
  const long long t1 = clock64();
  float v = s[at];
  const float q = __fadd_rn(s[(at + 1) & 1023], 0.25f);
  const long long t2 = clock64();
  for (int i = 0; i < steps; ++i) v = __fadd_rn(v, q);
  const long long t3 = clock64();
  if (lane == 0) {
    cycles[0] = t1 - t0;
    cycles[1] = t3 - t2;
    cycles[2] = at + (long long)v;
  }
}

// dynamic shared memory and scratch of a launch; false if even the global
// layout does not fit
bool plan(int O, int R, int K, int OB, bool* state_smem, bool* cand_smem,
          size_t* smem, size_t* scratch) {
  const size_t base = kStageBytes + align16(OB);
  if (base > kSmemMax) return false;
  *state_smem = base + state_bytes(K, R) <= kSmemMax;
  const size_t used = base + (*state_smem ? state_bytes(K, R) : 0);
  *cand_smem = used + cand_bytes(O) <= kSmemMax;
  *smem = used + (*cand_smem ? cand_bytes(O) : 0);
  *scratch = (*state_smem ? 0 : (size_t)K * R * 4 + (size_t)K * 4) +
             (*cand_smem ? 0 : cand_bytes(O));
  return true;
}

}  // namespace

extern "C" {

const char* ffd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ffd_max_r() { return kMaxR; }

// step_cycles_kernel on one warp; cycles: 3 long longs on the device
cudaError_t ffd_step_cycles(int steps, long long* cycles,
                            cudaStream_t stream) {
  if (steps <= 0 || cycles == nullptr) return cudaErrorInvalidValue;
  step_cycles_kernel<<<1, 32, 0, stream>>>(steps, 5, cycles);
  return cudaGetLastError();
}

// bytes of global scratch a launch needs (0 when the state and the
// candidate list fit shared memory), or -1 past the kernel's limits
long long ffd_scratch_bytes(int O, int R, int K, int T) {
  bool ss, cs;
  size_t smem, scratch;
  if (R <= 0 || R > kMaxR || K <= 0 || O <= 0 || T <= 0 ||
      !plan(O, R, K, (O + 7) / 8, &ss, &cs, &smem, &scratch))
    return -1;
  return (long long)scratch;
}

// req: P x R, compat: T x ceil(O/8) (np.packbits order), compat_row /
// class_id / node_cap / rem: P, valid: P bools, alloc: O x R, price / rank:
// O, init_option / init_used: K / K x R or both null (all slots closed).
// scratch: ffd_scratch_bytes() bytes, 16-aligned (null when 0).  Outputs:
// assignment P, slot_option K, slot_used K x R, n_open (one int).
cudaError_t ffd_scan(const float* req, const uint8_t* compat,
                     const int* compat_row, const int* class_id,
                     const uint8_t* valid, const int* node_cap,
                     const int* rem, const float* alloc, const float* price,
                     const int* rank, const int* init_option,
                     const float* init_used, int P, int O, int R, int K,
                     int T, void* scratch, int* assignment, int* slot_option,
                     float* slot_used, int* n_open, cudaStream_t stream) {
  const int OB = (O + 7) / 8;
  bool ss, cs;
  size_t smem, need;
  if (R <= 0 || R > kMaxR || K <= 0 || O <= 0 || T <= 0 || P < 0 ||
      !plan(O, R, K, OB, &ss, &cs, &smem, &need) ||
      (need > 0 && scratch == nullptr))
    return cudaErrorInvalidValue;
  const int kr = axis_bound(R);
  auto kernel = ss ? (kr == 4 ? ffd_scan_kernel<true, 4>
                      : kr == 8 ? ffd_scan_kernel<true, 8>
                                : ffd_scan_kernel<true, kMaxR>)
                   : (kr == 4 ? ffd_scan_kernel<false, 4>
                      : kr == 8 ? ffd_scan_kernel<false, 8>
                                : ffd_scan_kernel<false, kMaxR>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, kThreads, smem, stream>>>(
      req, compat, compat_row, class_id, valid, node_cap, rem, alloc, price,
      rank, init_option, init_used, P, O, R, K, OB, cs,
      static_cast<unsigned char*>(scratch), assignment, slot_option,
      slot_used, n_open);
  return cudaGetLastError();
}

}  // extern "C"
