// Class-granular first-fit-decreasing packing on an NVIDIA H100 (sm_90a).
//
// Replaces the jit'd XLA programs of the JAX package's ops/classpack.py:
//   class_pack_kernel[_packed]                 -> K1 classpack_precompute + K2 classpack_scan
//   class_pack_assign_kernel[_fresh]           -> K1 + K2 (emitting takes) + K3 classpack_assign_decode
//   class_pack_aggregate_kernel[_packed|_fresh] -> K1 + K2 + K4 classpack_aggregate
//   class_pack_sweep_kernel                    -> K1 + K5 classpack_sweep
//   class_pack_assign_slab_kernel[_fresh]      -> K1 + K2 + K3 + K6 classpack_slab
// and the per-shard programs of the mesh drivers, parallel/sharded.py and
// parallel/driver.py (rows 13-17 of PERF.md's table):
//   _sharded_pack, _partitioned_pack            -> K1 + K2 + K4, then K8 shard_psum
//   _sharded_assign, _partitioned_assign[_donate] -> K1 + K2 + K3
//   _partitioned_assign_slab[_donate]           -> K1 + K2 + K3 + K6
//
// The shard axis.  shard_map runs n copies of the single-device program on
// their own slices with the catalog replicated; here K1-K4 and K6 take a
// shard count n and run it as one launch, the shard as a grid axis
// (blockIdx.y, or one block per shard for the one-block kernels K2 and
// K4).  Shard s reads its inputs at base + s * stride
// (ShardStrides; a stride of 0 shares one copy, as the replicated operands
// of rows 13-14 are shared) and writes its own outputs and scratch at
// base + s * (the output's size).  The single-device programs are the same
// launches with n = 1.  Shards never exchange data: the flat aggregates are
// summed afterwards by K8 in the mesh's reduction order.
//
// Plain C interface (each entry returns cudaError_t), loaded with ctypes.
// Every launch goes on the caller's stream; nothing here synchronises or
// allocates: the Python wrappers allocate outputs and scratch.
//
// Arithmetic follows the reference exactly: int32 state with two's
// complement wrap (sums are taken in uint32), floor division (C++ `/`
// truncates, and slot free space goes negative when existing usage exceeds
// the lowered allocatable), and the float32 score price * float(nodes)
// rounded to nearest with no contraction, clamped at SCORE_CAP.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr float kScoreCap = 3.38e38f;  // ops/ffd.py SCORE_CAP as float32
constexpr int kMaxR = 32;

// Per-shard element strides of a shard-batched launch (see the header).
// The host entries take them as an array of 8 long longs in this order, or
// null for n = 1.
struct ShardStrides {
  long long req, cnt, compat, cap, m, ok, iopt, iused;
};

ShardStrides strides_from(const long long* ss) {
  ShardStrides out = {0, 0, 0, 0, 0, 0, 0, 0};
  if (ss) {
    out.req = ss[0]; out.cnt = ss[1]; out.compat = ss[2]; out.cap = ss[3];
    out.m = ss[4]; out.ok = ss[5]; out.iopt = ss[6]; out.iused = ss[7];
  }
  return out;
}

__device__ __forceinline__ int floordiv(int a, int b) {
  // b > 0 always (requests <= 0 are masked out before dividing)
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int compat_bit(const uint8_t* row, int o) {
  // np.packbits order: option o is byte o >> 3, bit 7 - (o & 7)
  return (row[o >> 3] >> (7 - (o & 7))) & 1;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// Block-wide exclusive prefix sum (uint32, wrapping) of one value per
// thread; also returns the block total.  `warp_buf` holds >= 32 entries.
__device__ unsigned block_exclusive_scan(unsigned v, unsigned* warp_buf,
                                         unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  unsigned x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    unsigned y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  __syncthreads();  // warp_buf may still be read from a previous call
  if (lane == 31) warp_buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < nwarps ? warp_buf[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      unsigned y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nwarps) warp_buf[lane] = w;  // inclusive warp prefix
  }
  __syncthreads();
  unsigned before = warp ? warp_buf[warp - 1] : 0u;
  *total = warp_buf[nwarps - 1];
  return before + x - v;
}

__device__ unsigned block_sum(unsigned v, unsigned* warp_buf) {
  unsigned total;
  block_exclusive_scan(v, warp_buf, &total);
  return total;
}

// ---------------------------------------------------------------------------
// K1 classpack_precompute  (replaces ops/classpack.py class_pack_kernel
// :75-85, the per-(class x option) precompute hoisted out of the scan)
//
// One block per (class, shard), threads stride over options.  m[c,o] = pods
// of class c a fresh option-o node holds; ok[c,o] = launchable and compatible, then
// restricted to the class's best pool-weight rank.  Bound on this card:
// bytes (it writes 5 bytes per (class, option) and does ~R integer divides
// for each); the design reads each packed compat byte and each option row
// straight from L2 and writes m/ok coalesced along options.
// ---------------------------------------------------------------------------
__global__ void precompute_kernel(const int* __restrict__ req,
                                  const int* __restrict__ node_cap,
                                  const uint8_t* __restrict__ compat_packed,
                                  const int* __restrict__ alloc,
                                  const float* __restrict__ price,
                                  const int* __restrict__ rank, int C, int O,
                                  int R, int OB, ShardStrides ss,
                                  int* __restrict__ m_out,
                                  uint8_t* __restrict__ ok_out) {
  __shared__ int s_req[kMaxR];
  __shared__ int s_best;
  const int c = blockIdx.x;
  const long long sh = blockIdx.y;
  req += sh * ss.req;
  node_cap += sh * ss.cap;
  compat_packed += sh * ss.compat;
  m_out += sh * C * O;
  ok_out += sh * C * O;
  if (threadIdx.x < R) s_req[threadIdx.x] = req[(size_t)c * R + threadIdx.x];
  if (threadIdx.x == 0) s_best = kBig;
  __syncthreads();
  const int cap = node_cap[c];
  const uint8_t* crow = compat_packed + (size_t)c * OB;
  int best = kBig;
  for (int o = threadIdx.x; o < O; o += blockDim.x) {
    int m = kBig;
    for (int r = 0; r < R; ++r) {
      const int q = s_req[r];
      if (q > 0) m = min(m, floordiv(alloc[(size_t)o * R + r], q));
    }
    m = min(m, cap);
    const bool ok = compat_bit(crow, o) && m > 0 && isfinite(price[o]);
    m_out[(size_t)c * O + o] = m;
    ok_out[(size_t)c * O + o] = ok ? 1 : 0;
    if (ok) best = min(best, rank[o]);
  }
  atomicMin(&s_best, best);
  __syncthreads();
  best = s_best;
  for (int o = threadIdx.x; o < O; o += blockDim.x) {
    // each thread re-reads only what it wrote itself
    if (ok_out[(size_t)c * O + o] && rank[o] != best)
      ok_out[(size_t)c * O + o] = 0;
  }
}

// ---------------------------------------------------------------------------
// K2 classpack_scan  (replaces ops/classpack.py class_pack_kernel :87-152,
// the lax.scan over classes; the _fresh variants build the all-closed init
// state in-kernel)
//
// The scan is a sequential carry over classes, so it runs as ONE persistent
// block of 1024 threads per shard (n shards: n blocks on n SMs, the mesh's
// copies side by side); thread t owns the S contiguous slots
// [t*S, t*S+S) (S = ceil(K/1024), a template parameter so the per-slot fit
// and take stay in registers).  Slot state (option, free[R]) lives in a
// global scratch buffer that stays resident in L2 (K*R*4 = 229 KB at the
// headline shape, just over one block's shared memory).  Per class step:
// per-slot fit, a block-wide exclusive scan for the greedy first-fit fill,
// a block-wide argmin over the options' new-node score (ties to the lowest
// index), then the opening of n_new slots.  Bound on this card: the
// sequential dependency over classes (latency of ~6 block barriers and the
// L2 round trips per class), not bytes or operations: one SM does the
// whole scan.
// ---------------------------------------------------------------------------
constexpr int kScanThreads = 1024;

template <int S>
__global__ void __launch_bounds__(kScanThreads, 1)
scan_kernel(const int* __restrict__ req, const int* __restrict__ counts,
            const uint8_t* __restrict__ compat_packed,
            const int* __restrict__ node_cap, const int* __restrict__ alloc,
            const float* __restrict__ price, const int* __restrict__ m_all,
            const uint8_t* __restrict__ ok_all,
            const int* __restrict__ init_option,
            const int* __restrict__ init_used, int C, int O, int R, int OB,
            int K, int emit, ShardStrides ss, int* __restrict__ slot_option,
            int* __restrict__ slot_free, int* __restrict__ slot_used,
            int* __restrict__ scalars, int* __restrict__ takes) {
  __shared__ unsigned s_warp[32];
  __shared__ float s_sc[32];
  __shared__ int s_ix[32];
  __shared__ int s_req[kMaxR];
  __shared__ int s_j;
  __shared__ float s_score;
  const int t = threadIdx.x;
  const int k0 = t * S;
  // this block's shard: its own inputs (or the shared copy, stride 0), its
  // own slot state, scalars and takes
  const long long sh = blockIdx.x;
  req += sh * ss.req;
  counts += sh * ss.cnt;
  compat_packed += sh * ss.compat;
  node_cap += sh * ss.cap;
  m_all += sh * ss.m;
  ok_all += sh * ss.ok;
  if (init_option) init_option += sh * ss.iopt;
  if (init_used) init_used += sh * ss.iused;
  slot_option += sh * K;
  slot_free += sh * K * R;
  slot_used += sh * K * R;
  scalars += 2 * sh;
  takes += sh * (emit ? (long long)C * K : (long long)C);

  // ---- init state: closed slots, or the pre-opened existing columns ----
  unsigned opened = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int k = k0 + i;
    if (k >= K) break;
    const int opt = init_option ? init_option[k] : -1;
    slot_option[k] = opt;
    for (int r = 0; r < R; ++r) {
      const size_t kr = (size_t)k * R + r;
      slot_free[kr] = opt >= 0 ? wrap_sub(alloc[(size_t)opt * R + r],
                                          init_used[kr])
                               : 0;
    }
    opened += opt >= 0;
  }
  int n_open = (int)block_sum(opened, s_warp);
  int n_unsched = 0;

  for (int c = 0; c < C; ++c) {
    __syncthreads();  // s_req / s_j of the previous class are consumed
    if (t < R) s_req[t] = req[(size_t)c * R + t];
    __syncthreads();
    const int cnt = counts[c];
    const int cap = node_cap[c];
    const uint8_t* crow = compat_packed + (size_t)c * OB;

    // 1. per-slot fit
    int fit[S];
    unsigned fsum = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int k = k0 + i;
      int f = 0;
      if (k < K) {
        const int opt = slot_option[k];
        if (opt >= 0 && compat_bit(crow, opt)) {
          int v = kBig;
          for (int r = 0; r < R; ++r) {
            const int q = s_req[r];
            if (q > 0) v = min(v, floordiv(slot_free[(size_t)k * R + r], q));
          }
          v = min(v, cap);
          f = max(v, 0);
        }
      }
      fit[i] = f;
      fsum += (unsigned)f;
    }
    // 2. exclusive prefix over slots, 3. greedy first-fit fill
    unsigned total_fit;
    unsigned run = block_exclusive_scan(fsum, s_warp, &total_fit);
    int take[S];
    unsigned tsum = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int d = wrap_sub(cnt, (int)run);
      take[i] = min(max(d, 0), fit[i]);
      tsum += (unsigned)take[i];
      run += (unsigned)fit[i];
    }
    const int taken = (int)block_sum(tsum, s_warp);
    const int remaining = wrap_sub(cnt, taken);

    // 4. new-node option: argmin of min(price * ceil(rem/m), SCORE_CAP)
    float best_sc = INFINITY;
    int best_ix = 0x7fffffff;
    const int rem1 = max(remaining, 1);
    for (int o = t; o < O; o += kScanThreads) {
      const size_t co = (size_t)c * O + o;
      if (!ok_all[co]) continue;  // score +inf never beats the running min
      const int ms = max(m_all[co], 1);
      const int nn = floordiv(wrap_add(rem1, ms - 1), ms);
      const float sc = fminf(__fmul_rn(price[o], __int2float_rn(nn)),
                             kScoreCap);
      if (sc < best_sc) {  // strict: the lowest index wins ties
        best_sc = sc;
        best_ix = o;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, best_sc, d);
      const int oi = __shfl_down_sync(0xffffffffu, best_ix, d);
      if (os < best_sc || (os == best_sc && oi < best_ix)) {
        best_sc = os;
        best_ix = oi;
      }
    }
    if ((t & 31) == 0) {
      s_sc[t >> 5] = best_sc;
      s_ix[t >> 5] = best_ix;
    }
    __syncthreads();
    if (t < 32) {
      best_sc = s_sc[t];
      best_ix = s_ix[t];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const float os = __shfl_down_sync(0xffffffffu, best_sc, d);
        const int oi = __shfl_down_sync(0xffffffffu, best_ix, d);
        if (os < best_sc || (os == best_sc && oi < best_ix)) {
          best_sc = os;
          best_ix = oi;
        }
      }
      if (t == 0) {
        // all scores +inf: jnp.argmin answers index 0 and `can` is false
        s_j = isfinite(best_sc) ? best_ix : 0;
        s_score = best_sc;
      }
    }
    __syncthreads();
    const int j = s_j;
    const bool can = isfinite(s_score);

    // 5. open n_new slots of option j, the last one partial
    const int m_sel = max(m_all[(size_t)c * O + j], 1);
    const int needed = (can && remaining > 0)
                           ? floordiv(wrap_add(remaining, m_sel - 1), m_sel)
                           : 0;
    const int n_new = min(needed, K - n_open);
    const int sched_new = min(remaining, n_new * m_sel);
    const int rem_last = sched_new - (n_new - 1) * m_sel;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int k = k0 + i;
      if (k >= K) break;
      int placed = take[i];
      if (k >= n_open && k < n_open + n_new) {
        const int pods_on = (k == n_open + n_new - 1) ? rem_last : m_sel;
        slot_option[k] = j;
        for (int r = 0; r < R; ++r)
          slot_free[(size_t)k * R + r] =
              alloc[(size_t)j * R + r] - pods_on * s_req[r];
        placed += pods_on;  // new slots were closed, so take[i] == 0
      } else if (take[i]) {
        for (int r = 0; r < R; ++r)
          slot_free[(size_t)k * R + r] -= take[i] * s_req[r];
      }
      if (emit) takes[(size_t)c * K + k] = placed;
    }
    if (!emit && t == 0) takes[c] = taken;  // per-class sum(take)
    n_open += n_new;
    n_unsched = wrap_add(n_unsched, remaining - sched_new);
  }

  // ---- outputs: slot_used = alloc[opt] - free on open slots ----
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int k = k0 + i;
    if (k >= K) break;
    const int opt = slot_option[k];
    for (int r = 0; r < R; ++r) {
      const size_t kr = (size_t)k * R + r;
      slot_used[kr] =
          opt >= 0 ? wrap_sub(alloc[(size_t)opt * R + r], slot_free[kr]) : 0;
    }
  }
  if (t == 0) {
    scalars[0] = n_open;
    scalars[1] = n_unsched;
  }
}

// ---------------------------------------------------------------------------
// K3 classpack_assign_decode  (replaces ops/classpack.py
// class_pack_assign_kernel :228-245: the global cumsum of the C x K takes,
// the pod -> class repeat and the searchsorted to a per-pod slot)
//
// One launch, one block per (class, shard) (blockIdx.x, blockIdx.y).  The
// block copies class c's K takes into shared memory, scans them there
// (each warp a contiguous segment in 32-wide shuffle scans with a carry,
// then the warp totals), sums counts[<c] for the class's first pod row, and
// decodes each pod row of the class by a binary search of its rank in the
// row's inclusive scan.  The block of class C-1 also decodes the padded
// rows past the last pod (jnp.repeat's total_repeat_length pad gives them
// class C-1), so every one of the n_pods rows is written once.
//
// Equivalence with the reference's global int32 cumsum + searchsorted
// rests on what K2 guarantees of its takes: every take is >= 0 and a
// class's row total is <= counts[c] <= n_pods < 2^31, so the global scan
// never wraps and is non-decreasing.  A scheduled pod (rank < row total)
// then has flat[row-1] = base <= base + rank < flat[row+K-1], the global
// search lands inside class c's row, and the base cancels: the slot is the
// first k whose within-row inclusive scan exceeds the rank.
//
// Bound on this card: bytes (each take read once, each pod row written
// once); the scan and the searches stay in shared memory.
// ---------------------------------------------------------------------------
constexpr int kDecThreads = 512;
constexpr int kDecWarps = kDecThreads / 32;

template <typename OutT>
__global__ void __launch_bounds__(kDecThreads)
assign_decode_kernel(const int* __restrict__ takes,
                     const int* __restrict__ counts, long long cnt_ss, int C,
                     int K, int n_pods, OutT* __restrict__ out) {
  extern __shared__ int s_incl[];  // K: class c's within-row inclusive scan
  __shared__ unsigned s_warp[kDecWarps];
  __shared__ unsigned s_cnt[kDecWarps];
  const int c = blockIdx.x;
  const long long sh = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* row = takes + (sh * C + c) * (long long)K;
  counts += sh * cnt_ss;
  out += sh * n_pods;
  for (int k = threadIdx.x; k < K; k += kDecThreads) s_incl[k] = __ldg(row + k);
  // counts[<c] (the class's first pod row), in a fixed order
  unsigned cs = 0;
  for (int j = threadIdx.x; j < c; j += kDecThreads) cs += (unsigned)__ldg(counts + j);
#pragma unroll
  for (int d = 16; d; d >>= 1) cs += __shfl_xor_sync(0xffffffffu, cs, d);
  if (lane == 0) s_cnt[warp] = cs;
  __syncthreads();
  // each warp scans its segment [k0, k1) in place, carrying the prefix
  const int seg = ((K + kDecWarps - 1) / kDecWarps + 31) & ~31;
  const int k0 = min(warp * seg, K), k1 = min(k0 + seg, K);
  unsigned carry = 0;
  for (int b = k0; b < k1; b += 32) {
    const int k = b + lane;
    unsigned x = k < k1 ? (unsigned)s_incl[k] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    x += carry;
    if (k < k1) s_incl[k] = (int)x;
    carry = __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();
  unsigned before = 0, excl = 0;
  for (int w = 0; w < kDecWarps; ++w) {
    if (w < warp) before += s_warp[w];
    excl += s_cnt[w];
  }
  if (before)
    for (int k = k0 + lane; k < k1; k += 32)
      s_incl[k] = (int)((unsigned)s_incl[k] + before);
  __syncthreads();
  // pod rows [excl, excl + counts[c]) of class c; class C-1 also takes the
  // padded rows up to n_pods
  const int total = s_incl[K - 1];
  const long long lo = (long long)(int)excl;
  long long hi = c == C - 1 ? (long long)n_pods
                            : lo + (long long)__ldg(counts + c);
  if (hi > n_pods) hi = n_pods;
  for (long long i = (lo < 0 ? 0 : lo) + threadIdx.x; i < hi;
       i += kDecThreads) {
    const int rk = (int)(i - lo);
    int a = -1;
    if (rk < total) {
      int l = 0, r = K;
      while (l < r) {
        const int mid = (l + r) >> 1;
        if (s_incl[mid] <= rk) l = mid + 1; else r = mid;
      }
      a = l;
    }
    out[i] = (OutT)a;
  }
}

// ---------------------------------------------------------------------------
// K4 classpack_aggregate  (replaces ops/classpack.py
// class_pack_aggregate_kernel :169-178)
//
// One block per shard: an exact integer histogram of launched slots per
// option in shared memory, and the float32 sum of their prices (thread partials, then
// a fixed-order tree, so the result is deterministic).  Output layout
// [total_cost, n_open, n_unsched, nodes_per_option...] as float32.  Bound on
// this card: bytes, and at 64 KB of input it is launch latency in practice.
// ---------------------------------------------------------------------------
constexpr int kAggThreads = 1024;

__global__ void __launch_bounds__(kAggThreads)
aggregate_kernel(const int* __restrict__ slot_option,
                 const float* __restrict__ price,
                 const int* __restrict__ n_open,
                 const int* __restrict__ n_unsched, long long sc_ss, int K,
                 int O, float* __restrict__ out) {
  extern __shared__ int s_hist[];
  __shared__ float s_part[kAggThreads];
  const long long sh = blockIdx.x;
  slot_option += sh * K;
  n_open += sh * sc_ss;
  n_unsched += sh * sc_ss;
  out += sh * (3 + O);
  for (int o = threadIdx.x; o < O; o += blockDim.x) s_hist[o] = 0;
  __syncthreads();
  float acc = 0.0f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int opt = slot_option[k];
    if (opt >= 0) {
      const float p = price[opt];
      if (isfinite(p)) {
        atomicAdd(&s_hist[opt], 1);
        acc += p;
      }
    }
  }
  s_part[threadIdx.x] = acc;
  __syncthreads();
  for (int w = blockDim.x >> 1; w > 0; w >>= 1) {
    if (threadIdx.x < w) s_part[threadIdx.x] += s_part[threadIdx.x + w];
    __syncthreads();
  }
  for (int o = threadIdx.x; o < O; o += blockDim.x)
    out[3 + o] = (float)s_hist[o];
  if (threadIdx.x == 0) {
    out[0] = s_part[0];
    out[1] = (float)*n_open;
    out[2] = (float)*n_unsched;
  }
}

// ---------------------------------------------------------------------------
// K5 classpack_sweep  (replaces ops/classpack.py class_pack_sweep_kernel
// :332-363, the consolidation sweep: B masked aggregate solves under vmap)
//
// Row b is class_pack_aggregate_kernel with compat & colmask_b and the price
// pr_b = where(colmask_b & (price < cap_b), price, inf); it answers
// [sum of pr_b over launched slots, launched slots, n_unsched].  m_all
// (pods per fresh node, C x O) depends only on the shared arrays and comes
// from ONE unbatched K1 launch; K1's `ok` is not valid per row, so each row
// recomputes launchability on the fly: compat bit & its own mask bit &
// m > 0 & finite pr_b, then its OWN best pool rank (masking a column can
// remove the best pool), then the score argmin, ties to the lowest index.
//
// One block of 256 threads per row; thread t owns the S contiguous slots
// [t*S, t*S+S) (S = ceil(K/256), a template parameter), as in K2.  A row's
// slot state (option K, free K x R) is private to its block and lives in
// dynamic shared memory when it fits in 40 KB (K <= 1280 at R = 7; with
// the ~2.6 KB of static shared memory that stays under the 48 KB a block
// gets without opting in), else in a global scratch slice.  Class counts are staged 256 at a time in
// shared memory; a class with count 0 in row b is skipped, which is exact
// (nothing is taken and no node opens), and the option pass runs only when
// the class has pods left after the fill (`remaining` > 0), where the
// reference's argmin is read at all.  Bound on this card: the sequential
// dependency over classes inside each row (a few block barriers per class
// step), not bytes or operations; rows run in parallel, one block per row,
// so B >= 132 rows fill the SMs and the prefix frontier (B = 32) does not.
// ---------------------------------------------------------------------------
constexpr int kSweepThreads = 256;
constexpr size_t kSweepSmemMax = 40 * 1024;

__device__ __forceinline__ float masked_price(const float* __restrict__ price,
                                              const uint8_t* mrow, float cap,
                                              int o) {
  // strict float32 compare: a NaN price or one at/above the cap is +inf
  const float p = price[o];
  return (compat_bit(mrow, o) && p < cap) ? p : INFINITY;
}

__device__ __forceinline__ void warp_argmin(float& sc, int& ix) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, sc, d);
    const int oi = __shfl_down_sync(0xffffffffu, ix, d);
    if (os < sc || (os == sc && oi < ix)) {
      sc = os;
      ix = oi;
    }
  }
}

// Block-wide argmin of (score, index): the lowest score, ties to the lowest
// index.  Every thread returns with the block's answer.
__device__ void block_argmin(float& sc, int& ix, float* s_sc, int* s_ix) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  warp_argmin(sc, ix);
  __syncthreads();  // s_sc / s_ix may still be read from a previous call
  if (lane == 0) {
    s_sc[warp] = sc;
    s_ix[warp] = ix;
  }
  __syncthreads();
  if (warp == 0) {
    sc = lane < nwarps ? s_sc[lane] : INFINITY;
    ix = lane < nwarps ? s_ix[lane] : 0x7fffffff;
    warp_argmin(sc, ix);
    if (lane == 0) {
      s_sc[0] = sc;
      s_ix[0] = ix;
    }
  }
  __syncthreads();
  sc = s_sc[0];
  ix = s_ix[0];
}

template <int S>
__global__ void __launch_bounds__(kSweepThreads)
sweep_kernel(const int* __restrict__ req, const int* __restrict__ counts_b,
             const uint8_t* __restrict__ compat_packed,
             const int* __restrict__ node_cap, const int* __restrict__ alloc,
             const float* __restrict__ price, const int* __restrict__ rank,
             const uint8_t* __restrict__ mask_packed,
             const float* __restrict__ cap_b,
             const int* __restrict__ init_option,
             const int* __restrict__ init_used,
             const int* __restrict__ m_all, int C, int O, int R, int OB,
             int K, int use_smem, int* __restrict__ g_option,
             int* __restrict__ g_free, float* __restrict__ out) {
  extern __shared__ int s_dyn[];
  __shared__ unsigned s_warp[32];
  __shared__ float s_sc[32];
  __shared__ int s_ix[32];
  __shared__ int s_req[kMaxR];
  __shared__ int s_cnt[kSweepThreads];
  __shared__ float s_part[kSweepThreads];
  __shared__ int s_best;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int k0 = t * S;
  int* sopt = use_smem ? s_dyn : g_option + (size_t)b * K;
  int* sfree = use_smem ? s_dyn + K : g_free + (size_t)b * K * R;
  const uint8_t* mrow = mask_packed + (size_t)b * OB;
  const float cap = cap_b[b];
  const int* row_cnt = counts_b + (size_t)b * C;

  // ---- init state: the pre-opened columns (existing nodes) ----
  unsigned opened = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int k = k0 + i;
    if (k >= K) break;
    const int opt = init_option[k];
    sopt[k] = opt;
    for (int r = 0; r < R; ++r) {
      const size_t kr = (size_t)k * R + r;
      sfree[kr] = opt >= 0 ? wrap_sub(alloc[(size_t)opt * R + r],
                                      init_used[kr])
                           : 0;
    }
    opened += opt >= 0;
  }
  int n_open = (int)block_sum(opened, s_warp);
  int n_unsched = 0;

  for (int c0 = 0; c0 < C; c0 += kSweepThreads) {
    __syncthreads();  // the previous tile of counts is consumed
    s_cnt[t] = c0 + t < C ? row_cnt[c0 + t] : 0;
    __syncthreads();
    const int n_tile = min(kSweepThreads, C - c0);
    for (int ci = 0; ci < n_tile; ++ci) {
      const int cnt = s_cnt[ci];
      if (cnt == 0) continue;  // exact no-op: nothing taken, nothing opened
      const int c = c0 + ci;
      __syncthreads();  // s_req of the previous class is consumed
      if (t < R) s_req[t] = req[(size_t)c * R + t];
      __syncthreads();
      const int ncap = node_cap[c];
      const uint8_t* crow = compat_packed + (size_t)c * OB;

      // 1. per-slot fit: open, compatible, and the column kept in this row
      int fit[S];
      unsigned fsum = 0;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int k = k0 + i;
        int f = 0;
        if (k < K) {
          const int opt = sopt[k];
          if (opt >= 0 && compat_bit(crow, opt) && compat_bit(mrow, opt)) {
            int v = kBig;
            for (int r = 0; r < R; ++r) {
              const int q = s_req[r];
              if (q > 0) v = min(v, floordiv(sfree[(size_t)k * R + r], q));
            }
            v = min(v, ncap);
            f = max(v, 0);
          }
        }
        fit[i] = f;
        fsum += (unsigned)f;
      }
      // 2. exclusive prefix over slots, 3. greedy first-fit fill
      unsigned total_fit;
      unsigned run = block_exclusive_scan(fsum, s_warp, &total_fit);
      int take[S];
      unsigned tsum = 0;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int d = wrap_sub(cnt, (int)run);
        take[i] = min(max(d, 0), fit[i]);
        tsum += (unsigned)take[i];
        run += (unsigned)fit[i];
      }
      const int taken = (int)block_sum(tsum, s_warp);
      const int remaining = wrap_sub(cnt, taken);

      // 4. new-node option for the tail, this row's launchable set only
      int j = 0;
      bool can = false;
      if (remaining > 0) {
        const size_t co = (size_t)c * O;
        int best = kBig;
        for (int o = t; o < O; o += kSweepThreads) {
          if (compat_bit(crow, o) && m_all[co + o] > 0 &&
              isfinite(masked_price(price, mrow, cap, o)))
            best = min(best, rank[o]);
        }
        __syncthreads();  // s_best of the previous class is consumed
        if (t == 0) s_best = kBig;
        __syncthreads();
        atomicMin(&s_best, best);
        __syncthreads();
        best = s_best;
        if (best < kBig) {
          float best_sc = INFINITY;
          int best_ix = 0x7fffffff;
          for (int o = t; o < O; o += kSweepThreads) {
            if (rank[o] != best || !compat_bit(crow, o)) continue;
            const int m = m_all[co + o];
            if (m <= 0) continue;
            const float p = masked_price(price, mrow, cap, o);
            if (!isfinite(p)) continue;
            const int ms = max(m, 1);
            const int nn = floordiv(wrap_add(remaining, ms - 1), ms);
            const float sc = fminf(__fmul_rn(p, __int2float_rn(nn)),
                                   kScoreCap);
            if (sc < best_sc) {  // strict: the lowest index wins ties
              best_sc = sc;
              best_ix = o;
            }
          }
          block_argmin(best_sc, best_ix, s_sc, s_ix);
          can = isfinite(best_sc);
          j = can ? best_ix : 0;
        }
      }

      // 5. open n_new slots of option j, the last one partial
      const int m_sel = max(m_all[(size_t)c * O + j], 1);
      const int needed = (can && remaining > 0)
                             ? floordiv(wrap_add(remaining, m_sel - 1), m_sel)
                             : 0;
      const int n_new = min(needed, K - n_open);
      const int sched_new = min(remaining, n_new * m_sel);
      const int rem_last = sched_new - (n_new - 1) * m_sel;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int k = k0 + i;
        if (k >= K) break;
        if (k >= n_open && k < n_open + n_new) {
          const int pods_on = (k == n_open + n_new - 1) ? rem_last : m_sel;
          sopt[k] = j;
          for (int r = 0; r < R; ++r)
            sfree[(size_t)k * R + r] =
                alloc[(size_t)j * R + r] - pods_on * s_req[r];
        } else if (take[i]) {
          for (int r = 0; r < R; ++r)
            sfree[(size_t)k * R + r] -= take[i] * s_req[r];
        }
      }
      n_open += n_new;
      n_unsched = wrap_add(n_unsched, wrap_sub(remaining, sched_new));
    }
  }

  // ---- the row's aggregate: launched slots are open with a finite pr_b
  // (pre-opened existing columns carry +inf and never count) ----
  unsigned launched = 0;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int k = k0 + i;
    if (k >= K) break;
    const int opt = sopt[k];
    if (opt >= 0) {
      const float p = masked_price(price, mrow, cap, opt);
      if (isfinite(p)) {
        ++launched;
        acc += p;
      }
    }
  }
  const unsigned n_launched = block_sum(launched, s_warp);
  s_part[t] = acc;
  __syncthreads();
  for (int w = kSweepThreads >> 1; w > 0; w >>= 1) {
    if (t < w) s_part[t] += s_part[t + w];
    __syncthreads();
  }
  if (t == 0) {
    out[(size_t)b * 3 + 0] = s_part[0];
    out[(size_t)b * 3 + 1] = (float)n_launched;
    out[(size_t)b * 3 + 2] = (float)n_unsched;
  }
}

// ---------------------------------------------------------------------------
// K6 classpack_slab  (replaces the sort half of ops/classpack.py
// class_pack_assign_slab_kernel :280-297: the stable sort of the padded pod
// rows by slot, key = slot or K for unplaced and padded rows, and the K+1
// bin histogram)
//
// A stable counting sort, which fits the output exactly: the histogram IS
// slot_counts, its exclusive scan gives each key's first position, and a
// row goes to first[key] + (rows of its key before it).  The reference
// sorts either the composite key * n + row or, past the int32 guard
// (K + 1) * n >= 2^31, argsort(key); both give this one order.
//
// Bound on this card: bytes (read the slots, write the order and the
// counts once), far below three launches' latency at the main paths'
// shapes; what costs is the work per key (K + 1 of them) done once per
// block.  So each shard's rows are cut into a few large blocks (the host's
// slab_plan: about one block per SM over all shards, each at least K + 1
// rows), each block keeps its histogram in shared memory, and the table of
// per-block counts stays a few dozen rows per shard.  Three launches, each
// with the shard as a grid axis (blockIdx.y):
//   1. count: one block per (row block, shard), a shared-memory histogram
//      (each warp's lanes of one key add once, through __match_any_sync),
//      written as the block's row of the table;
//   2. scan: one block per (256 keys, shard), one thread per key: the
//      key's exclusive scan over the row blocks, in place; the key totals
//      (slot_counts), their exclusive scan inside the tile (key_first) and
//      the tile's total;
//   3. scatter: one block per (row block, shard), W warps, each warp owning
//      a contiguous W-th of the block's rows.  Each warp counts its rows
//      per key in a table of its own; the block turns the W tables into
//      each warp's first position per key (the key's first position in the
//      shard, plus the earlier tiles' totals, plus the earlier row blocks'
//      count, plus the earlier warps' counts); then each warp walks its
//      rows in order, 32 a step: the lanes of one key are peers under
//      __match_any_sync, the lowest takes the base and adds their number,
//      and each row's place is the base plus its rank among its peers.  No
//      block barrier inside the walk, and no warp waits for another.
// The count and both walks load eight steps of rows before using them, so
// eight loads per thread are in flight instead of one.
// ---------------------------------------------------------------------------

constexpr int kSlabThreads = 256;   // count and scan blocks
constexpr int kSlabTile = 256;      // keys per scan block
constexpr int kSlabMaxWarps = 8;    // warps of a scatter block
constexpr int kSlabBatch = 8;       // row loads in flight per thread

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

template <typename T>
__device__ __forceinline__ int slab_key(const T* a, int i, int K) {
  const int v = (int)a[i];
  return v >= 0 ? v : K;
}

template <typename T>
__global__ void __launch_bounds__(kSlabThreads)
slab_count_kernel(const T* __restrict__ assignment, int n, int K, int seg,
                  int* __restrict__ chunk_counts) {
  extern __shared__ int s_hist[];  // K + 1
  const int keys = K + 1, t = threadIdx.x;
  const long long sh = blockIdx.y;
  assignment += sh * n;
  int* out = chunk_counts + (sh * gridDim.x + blockIdx.x) * (long long)keys;
  for (int k = t; k < keys; k += blockDim.x) s_hist[k] = 0;
  __syncthreads();
  const int r0 = blockIdx.x * seg, r1 = min(n, r0 + seg);
  for (int i0 = r0; i0 < r1; i0 += kSlabBatch * blockDim.x) {
    int key[kSlabBatch];
#pragma unroll
    for (int u = 0; u < kSlabBatch; ++u) {
      const int i = i0 + u * blockDim.x + t;
      key[u] = i < r1 ? slab_key(assignment, i, K) : -1;
    }
#pragma unroll
    for (int u = 0; u < kSlabBatch; ++u) {
      const unsigned peers = __match_any_sync(0xffffffffu, key[u]);
      if (key[u] >= 0 && (peers & lanes_below()) == 0)
        atomicAdd(&s_hist[key[u]], __popc(peers));
    }
  }
  __syncthreads();
  for (int k = t; k < keys; k += blockDim.x) out[k] = s_hist[k];
}

__global__ void __launch_bounds__(kSlabTile)
slab_scan_kernel(int* __restrict__ chunk_counts, int blocks, int K,
                 int* __restrict__ key_first, int* __restrict__ tile_sum,
                 int* __restrict__ slot_counts) {
  __shared__ unsigned warp_buf[32];
  const int keys = K + 1, t = threadIdx.x;
  const long long sh = blockIdx.y;
  chunk_counts += sh * blocks * (long long)keys;
  key_first += sh * keys;
  tile_sum += sh * gridDim.x;
  slot_counts += sh * K;
  const int k = blockIdx.x * kSlabTile + t;
  int run = 0;
  if (k < keys) {
    int* col = chunk_counts + k;
    int b = 0;
    for (; b + 8 <= blocks; b += 8) {  // eight loads in flight
      int v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = col[(size_t)(b + u) * keys];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        col[(size_t)(b + u) * keys] = run;
        run += v[u];
      }
    }
    for (; b < blocks; ++b) {
      const int v = col[(size_t)b * keys];
      col[(size_t)b * keys] = run;
      run += v;
    }
    if (k < K) slot_counts[k] = run;
  }
  unsigned total;
  const unsigned before = block_exclusive_scan((unsigned)run, warp_buf, &total);
  if (k < keys) key_first[k] = (int)before;
  if (t == 0) tile_sum[blockIdx.x] = (int)total;
}

template <typename T>
__global__ void __launch_bounds__(kSlabMaxWarps * 32)
slab_scatter_kernel(const T* __restrict__ assignment, int n, int K, int seg,
                    int tiles, const int* __restrict__ chunk_counts,
                    const int* __restrict__ key_first,
                    const int* __restrict__ tile_sum, int* __restrict__ order) {
  extern __shared__ int s_cnt[];  // W x (K + 1), then the tile prefixes
  const int keys = K + 1, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int W = blockDim.x >> 5;
  const long long sh = blockIdx.y;
  assignment += sh * n;
  order += sh * n;
  chunk_counts += (sh * gridDim.x + blockIdx.x) * (long long)keys;
  key_first += sh * keys;
  tile_sum += sh * tiles;
  int* s_tpre = s_cnt + (size_t)W * keys;
  for (int i = t; i < W * keys; i += blockDim.x) s_cnt[i] = 0;
  if (warp == 0) {  // the exclusive prefix of the tiles' totals
    int run = 0;
    for (int q0 = 0; q0 < tiles; q0 += 32) {
      const int q = q0 + lane;
      const int v = q < tiles ? tile_sum[q] : 0;
      int x = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      if (q < tiles) s_tpre[q] = run + x - v;
      run += __shfl_sync(0xffffffffu, x, 31);
    }
  }
  __syncthreads();
  // this warp's rows, and its own count of them per key
  const int r0 = blockIdx.x * seg, r1 = min(n, r0 + seg);
  const int sub = (seg + W - 1) / W;
  const int w0 = min(r1, r0 + warp * sub), w1 = min(r1, w0 + sub);
  int* mine = s_cnt + (size_t)warp * keys;
  for (int i0 = w0; i0 < w1; i0 += 32 * kSlabBatch) {
    int key[kSlabBatch];
#pragma unroll
    for (int u = 0; u < kSlabBatch; ++u) {
      const int i = i0 + 32 * u + lane;
      key[u] = i < w1 ? slab_key(assignment, i, K) : -1;
    }
#pragma unroll
    for (int u = 0; u < kSlabBatch; ++u) {
      const unsigned peers = __match_any_sync(0xffffffffu, key[u]);
      if (key[u] >= 0 && (peers & lanes_below()) == 0)
        mine[key[u]] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  // each warp's first position per key
  for (int k0 = t; k0 < keys; k0 += 4 * blockDim.x) {
    int base[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * blockDim.x;
      base[u] = k < keys ? key_first[k] + s_tpre[k / kSlabTile] +
                               chunk_counts[k]
                         : 0;
    }
    for (int w = 0; w < W; ++w) {  // four keys' loads, then their stores
      int v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + u * blockDim.x;
        v[u] = k < keys ? s_cnt[(size_t)w * keys + k] : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + u * blockDim.x;
        if (k < keys) s_cnt[(size_t)w * keys + k] = base[u];
        base[u] += v[u];
      }
    }
  }
  __syncthreads();
  // the walk: rows in order, 32 a step, the peers of a key ranked by lane
  for (int i0 = w0; i0 < w1; i0 += 32 * kSlabBatch) {
    int key[kSlabBatch];
#pragma unroll
    for (int u = 0; u < kSlabBatch; ++u) {
      const int i = i0 + 32 * u + lane;
      key[u] = i < w1 ? slab_key(assignment, i, K) : -1;
    }
#pragma unroll
    for (int u = 0; u < kSlabBatch; ++u) {
      const unsigned peers = __match_any_sync(0xffffffffu, key[u]);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (key[u] >= 0 && lane == leader) {
        base = mine[key[u]];
        mine[key[u]] = base + __popc(peers);
      }
      base = __shfl_sync(0xffffffffu, base, leader);
      if (key[u] >= 0)
        order[base + __popc(peers & lanes_below())] = i0 + 32 * u + lane;
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// K8 shard_psum  (replaces the hierarchical jax.lax.psum of
// parallel/sharded.py _sharded_pack :142-146 and parallel/driver.py
// _partitioned_pack :90-91: `for ax in reversed(axes): psum(flat, ax)`)
//
// On one card the mesh's collective is this reduction of the n per-shard
// flat vectors [cost, n_open, n_unsched, nodes per column...] (float32,
// n = hosts x chips, host-major).  One thread per element j, in a fixed
// order: the innermost mesh axis first — for each host h, the left fold
// v[h,0] + v[h,1] + ... + v[h,chips-1] — then the left fold of the host
// partials over h (a 1-D mesh is hosts = 1).  Every add is __fadd_rn, so
// the result is deterministic and bit-equal to the plain version's adds in
// the same order; the integer fields (all below 2^24) come out exact, the
// float32 cost is a sum in this order.  Bound on this card: bytes (read
// n x L floats once, write L), far below a launch's latency at n <= 8.
// ---------------------------------------------------------------------------
__global__ void shard_psum_kernel(const float* __restrict__ v, int hosts,
                                  int chips, int L, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= L) return;
  float total = 0.0f;
  for (int h = 0; h < hosts; ++h) {
    const float* row = v + (size_t)h * chips * L + j;
    float part = row[0];
    for (int c = 1; c < chips; ++c) part = __fadd_rn(part, row[(size_t)c * L]);
    total = h ? __fadd_rn(total, part) : part;
  }
  out[j] = total;
}

template <typename T>
cudaError_t launch_slab(const T* assignment, int n_shards, int n, int K,
                        int blocks, int seg, int warps, int* chunk_counts,
                        int* key_first, int* tile_sum, int* order,
                        int* slot_counts, cudaStream_t stream) {
  const int keys = K + 1, tiles = (keys + kSlabTile - 1) / kSlabTile;
  const size_t hist = (size_t)keys * sizeof(int);
  const size_t cnt = ((size_t)warps * keys + tiles) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      slab_count_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)hist);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(slab_scatter_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)cnt);
  if (err != cudaSuccess) return err;
  slab_count_kernel<T><<<dim3(blocks, n_shards), kSlabThreads, hist, stream>>>(
      assignment, n, K, seg, chunk_counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  slab_scan_kernel<<<dim3(tiles, n_shards), kSlabTile, 0, stream>>>(
      chunk_counts, blocks, K, key_first, tile_sum, slot_counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  slab_scatter_kernel<T><<<dim3(blocks, n_shards), warps * 32, cnt, stream>>>(
      assignment, n, K, seg, tiles, chunk_counts, key_first, tile_sum, order);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_sweep(const int* req, const int* counts_b,
                         const uint8_t* compat_packed, const int* node_cap,
                         const int* alloc, const float* price,
                         const int* rank, const uint8_t* mask_packed,
                         const float* cap_b, const int* init_option,
                         const int* init_used, const int* m_all, int B, int C,
                         int O, int R, int OB, int K, int* g_option,
                         int* g_free, float* out, cudaStream_t stream) {
  const size_t smem = (size_t)K * (R + 1) * sizeof(int);
  const int use_smem = smem <= kSweepSmemMax;
  sweep_kernel<S><<<B, kSweepThreads, use_smem ? smem : 0, stream>>>(
      req, counts_b, compat_packed, node_cap, alloc, price, rank, mask_packed,
      cap_b, init_option, init_used, m_all, C, O, R, OB, K, use_smem,
      g_option, g_free, out);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_scan(const int* req, const int* counts,
                        const uint8_t* compat_packed, const int* node_cap,
                        const int* alloc, const float* price,
                        const int* m_all, const uint8_t* ok_all,
                        const int* init_option, const int* init_used, int n,
                        int C, int O, int R, int OB, int K, int emit,
                        ShardStrides ss, int* slot_option, int* slot_free,
                        int* slot_used, int* scalars, int* takes,
                        cudaStream_t stream) {
  scan_kernel<S><<<n, kScanThreads, 0, stream>>>(
      req, counts, compat_packed, node_cap, alloc, price, m_all, ok_all,
      init_option, init_used, C, O, R, OB, K, emit, ss, slot_option,
      slot_free, slot_used, scalars, takes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int kp_max_r() { return kMaxR; }
int kp_max_slots() { return kScanThreads * 32; }

// n shards (n = 1: the single-device program); ss: 8 per-shard strides in
// ShardStrides order (req, compat and cap read here), or null for n = 1.
// m_out / ok_out: n x C x O.
cudaError_t kp_precompute(const int* req, const int* node_cap,
                          const uint8_t* compat_packed, const int* alloc,
                          const float* price, const int* rank, int n, int C,
                          int O, int R, const long long* ss, int* m_out,
                          uint8_t* ok_out, cudaStream_t stream) {
  if (R > kMaxR || C <= 0 || n <= 0 || n > 65535) return cudaErrorInvalidValue;
  const int OB = (O + 7) / 8;
  precompute_kernel<<<dim3(C, n), 256, 0, stream>>>(
      req, node_cap, compat_packed, alloc, price, rank, C, O, R, OB,
      strides_from(ss), m_out, ok_out);
  return cudaGetLastError();
}

// init_option / init_used may be null: the all-closed (_fresh) init state
// is then built in-kernel.  n shards, one block each; ss as kp_precompute's
// (all eight read here).  Outputs per shard: slot_option K, slot_free
// (scratch) and slot_used K x R, scalars [n_open, n_unsched], takes C x K
// when emit, else C (per-class sum of fills), each n times, shard-major.
cudaError_t kp_scan(const int* req, const int* counts,
                    const uint8_t* compat_packed, const int* node_cap,
                    const int* alloc, const float* price, const int* m_all,
                    const uint8_t* ok_all, const int* init_option,
                    const int* init_used, int n, int C, int O, int R, int K,
                    int emit, const long long* ss, int* slot_option,
                    int* slot_free, int* slot_used, int* scalars, int* takes,
                    cudaStream_t stream) {
  if (R > kMaxR || K <= 0 || C <= 0 || n <= 0) return cudaErrorInvalidValue;
  const int OB = (O + 7) / 8;
  const int S = (K + kScanThreads - 1) / kScanThreads;
  const ShardStrides st = strides_from(ss);
#define KP_SCAN(SS)                                                          \
  return launch_scan<SS>(req, counts, compat_packed, node_cap, alloc, price, \
                         m_all, ok_all, init_option, init_used, n, C, O, R,  \
                         OB, K, emit, st, slot_option, slot_free, slot_used, \
                         scalars, takes, stream)
  if (S <= 1) KP_SCAN(1);
  if (S <= 2) KP_SCAN(2);
  if (S <= 4) KP_SCAN(4);
  if (S <= 8) KP_SCAN(8);
  if (S <= 16) KP_SCAN(16);
  if (S <= 32) KP_SCAN(32);
#undef KP_SCAN
  return cudaErrorInvalidValue;
}

// n shards, one block per (class, shard).  takes: n x C x K int32;
// counts: shard s's at s * cnt_ss.  out: n x n_pods of int16 (out_int16)
// or int32.  No scratch.
cudaError_t kp_assign_decode(const int* takes, const int* counts,
                             long long cnt_ss, int n_sh, int C, int K,
                             int n_pods, int out_int16, void* out,
                             cudaStream_t stream) {
  if (C <= 0 || K <= 0 || K > kp_max_slots() || n_sh <= 0 || n_sh > 65535)
    return cudaErrorInvalidValue;
  if (n_pods <= 0) return cudaSuccess;
  const size_t smem = (size_t)K * sizeof(int);
  const dim3 grid(C, n_sh);
  cudaError_t err;
  if (out_int16) {
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(assign_decode_kernel<int16_t>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return err;
    assign_decode_kernel<int16_t><<<grid, kDecThreads, smem, stream>>>(
        takes, counts, cnt_ss, C, K, n_pods, static_cast<int16_t*>(out));
  } else {
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(assign_decode_kernel<int>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return err;
    assign_decode_kernel<int><<<grid, kDecThreads, smem, stream>>>(
        takes, counts, cnt_ss, C, K, n_pods, static_cast<int*>(out));
  }
  return cudaGetLastError();
}

// n shards, one block each.  slot_option: n x K; n_open / n_unsched: the
// scan's device scalars, shard s's at s * sc_ss.  out: n x (3 + O) floats.
cudaError_t kp_aggregate(const int* slot_option, const float* price,
                         const int* n_open, const int* n_unsched,
                         long long sc_ss, int n, int K, int O, float* out,
                         cudaStream_t stream) {
  const size_t smem = (size_t)O * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (n <= 0) return cudaErrorInvalidValue;
  aggregate_kernel<<<n, kAggThreads, smem, stream>>>(
      slot_option, price, n_open, n_unsched, sc_ss, K, O, out);
  return cudaGetLastError();
}

// v: hosts x chips x L floats (shard-major, host-major).  out: L floats.
cudaError_t kp_shard_psum(const float* v, int hosts, int chips, int L,
                          float* out, cudaStream_t stream) {
  if (hosts <= 0 || chips <= 0 || L <= 0) return cudaErrorInvalidValue;
  shard_psum_kernel<<<(L + 255) / 256, 256, 0, stream>>>(v, hosts, chips, L,
                                                          out);
  return cudaGetLastError();
}

int kp_sweep_max_slots() { return kSweepThreads * 32; }
int kp_sweep_smem_max() { return (int)kSweepSmemMax; }

// One row per block.  counts_b: B x C, mask_packed: B x ceil(O/8) (the
// column masks, np.packbits order), cap_b: B, m_all: C x O from K1,
// init_option / init_used: K / K x R (shared by every row).  g_option
// (B x K) and g_free (B x K x R) are scratch, needed (and else may be
// null) only when a row's slot state, K x (R + 1) ints, exceeds
// kp_sweep_smem_max() bytes.  out: B x 3 floats [cost, n_new, n_unsched].
cudaError_t kp_sweep(const int* req, const int* counts_b,
                     const uint8_t* compat_packed, const int* node_cap,
                     const int* alloc, const float* price, const int* rank,
                     const uint8_t* mask_packed, const float* cap_b,
                     const int* init_option, const int* init_used,
                     const int* m_all, int B, int C, int O, int R, int K,
                     int* g_option, int* g_free, float* out,
                     cudaStream_t stream) {
  if (R > kMaxR || K <= 0 || C <= 0 || B <= 0 || O <= 0)
    return cudaErrorInvalidValue;
  if ((size_t)K * (R + 1) * sizeof(int) > kSweepSmemMax &&
      (g_option == nullptr || g_free == nullptr))
    return cudaErrorInvalidValue;
  const int OB = (O + 7) / 8;
  const int S = (K + kSweepThreads - 1) / kSweepThreads;
#define KP_SWEEP(SS)                                                         \
  return launch_sweep<SS>(req, counts_b, compat_packed, node_cap, alloc,     \
                          price, rank, mask_packed, cap_b, init_option,      \
                          init_used, m_all, B, C, O, R, OB, K, g_option,     \
                          g_free, out, stream)
  if (S <= 1) KP_SWEEP(1);
  if (S <= 2) KP_SWEEP(2);
  if (S <= 4) KP_SWEEP(4);
  if (S <= 8) KP_SWEEP(8);
  if (S <= 16) KP_SWEEP(16);
  if (S <= 32) KP_SWEEP(32);
#undef KP_SWEEP
  return cudaErrorInvalidValue;
}

// The device's SM count and the shared memory one block may opt into: the
// inputs of the host's slab_plan.
cudaError_t kp_slab_budget(int* sms, int* smem) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

// n_sh shards of n rows each.  assignment: n_sh x n int16 (is16) or int32
// slots, -1 unplaced, each < K.  The plan (slab_plan): `blocks` row blocks
// of `seg` rows per shard (the last may hold fewer, none is empty), scatter
// blocks of `warps` warps.  Scratch per shard: chunk_counts blocks x
// (K + 1), key_first K + 1, tile_sum ceil((K + 1) / 256).  Outputs per
// shard: order n (rows stable-sorted by key = slot, or K for unplaced
// rows), slot_counts K.
cudaError_t kp_slab(const void* assignment, int is16, int n_sh, int n, int K,
                    int blocks, int seg, int warps, int* chunk_counts,
                    int* key_first, int* tile_sum, int* order,
                    int* slot_counts, cudaStream_t stream) {
  const long long keys = (long long)K + 1;
  const long long tiles = (keys + kSlabTile - 1) / kSlabTile;
  if (n <= 0 || K <= 0 || n_sh <= 0 || n_sh > 65535 || blocks <= 0 ||
      blocks > 65535 || seg <= 0 || (long long)blocks * seg < n ||
      (long long)(blocks - 1) * seg >= n || warps < 1 ||
      warps > kSlabMaxWarps ||
      ((long long)warps * keys + tiles) * 4 > 227 * 1024)
    return cudaErrorInvalidValue;
  if (is16)
    return launch_slab(static_cast<const int16_t*>(assignment), n_sh, n, K,
                       blocks, seg, warps, chunk_counts, key_first, tile_sum,
                       order, slot_counts, stream);
  return launch_slab(static_cast<const int*>(assignment), n_sh, n, K, blocks,
                     seg, warps, chunk_counts, key_first, tile_sum, order,
                     slot_counts, stream);
}

}  // extern "C"
