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
// (blockIdx.y, or blockIdx.z for K1; one cluster of CTAs per shard for K2
// and K4).  Shard s reads its inputs at base + s * stride
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// The class step shared by K2 and K5
//
// Both kernels walk classes one after another; what a class step needs of
// the card is latency, not bandwidth.  The pieces below keep a step's
// critical path inside the SM:
//   * slot state in shared memory (or, past the budget, in a global slice
//     laid out the same way), thread t owning the S contiguous slots
//     [t*S, t*S+S) of its block, stored at i*T + t so a warp's accesses to
//     its lanes' i-th slots are consecutive words (no bank conflicts,
//     coalesced in the global layout);
//   * the class's rows (compat, m, ok) staged one class ahead by TMA bulk
//     copies into a ring of three buffers, each completing on its own
//     mbarrier, and its requests, cap and divisors (a multiplier per
//     positive axis, so the fit divides by multiply and shift) written by
//     warp 0 into a static ring beside them, so a step reads no global
//     memory on its critical path; the next class after that is found in
//     counts prefetched a step ahead;
//   * classes with a count <= 0 skipped: the reference's step is then an
//     exact no-op (nothing taken, needed = 0, sched_new = remaining);
//   * one exchange for the fill (see `exchange_scan`: warp shuffles, one
//     block barrier, and across a cluster one round of st.async stores on
//     mbarriers).  When every thread's fits sum below 2^31 / threads no
//     prefix wraps and the fill takes min(count, total) pods in all, so
//     the sum of the takes needs no second exchange (past it, 64-bit
//     exchanges give the reference's uint32 numbers);
//   * the option argmin as one block reduction of redux.sync minima (one
//     barrier), run only when pods remain and a slot is free: otherwise
//     the reference reads nothing of the chosen option.
// ---------------------------------------------------------------------------

typedef unsigned long long u64;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  const unsigned adr = smem_addr(bar);
  for (long long i = 0;; ++i) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(adr), "r"(parity)
        : "memory");
    if (done) return;
    if (i > (1ll << 24)) __trap();  // a lost arrival: fail, never hang
  }
}

// One arrival on `bar` that expects `bytes` of transactions.
__device__ __forceinline__ void mbar_expect(u64* bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// A TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to this CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// Floor division by a class's invariant request q > 0 with a multiplier
// computed once per class (Granlund and Montgomery, "Division by invariant
// integers using multiplication", 1994, theorem 4.2, for 31-bit
// numerators): l = ceil(log2 q), m = ceil(2^(31+l) / q) < 2^32, and for
// 0 <= x < 2^31, x / q = (x * m) >> (31 + l); one correction step guards
// the quotient.  m itself comes from float32 estimates made exact in
// integers (no 64-bit division on the step's path).  A negative a is floored through x = -1 - a >= 0:
// floor(a / q) = -1 - (x / q), which also covers INT_MIN.  q <= 0 gives
// shift 0 (the axis is skipped, as the reference masks it).  The host's
// floordiv_magic_model repeats this arithmetic.
struct Magic {
  unsigned m;
  int shift;
  int q;
};

__device__ __forceinline__ Magic magic_of(int q) {
  Magic g = {0u, 0, q};
  if (q > 0) {
    const int l = q == 1 ? 0 : 32 - __clz((unsigned)(q - 1));
    // m = ceil(2^(31+l) / q) = floor(M / q): a float32 estimate (within
    // about 800), one float32 correction of the remainder (within 1), then
    // one exact step in integers
    const long long M = (1ll << (31 + l)) + q - 1;
    const float rq = __frcp_rn((float)q);
    long long m = (long long)__fmul_rn((float)M, rq);
    long long r = M - m * q;
    m += (long long)floorf(__fmul_rn((float)r, rq));
    r = M - m * q;
    m += (r >= q) - (r < 0);
    g.m = (unsigned)m;
    g.shift = 31 + l;
  }
  return g;
}

__device__ __forceinline__ int floordiv_magic(int a, Magic g) {
  const int q = g.q;
  const unsigned x = a >= 0 ? (unsigned)a : (unsigned)(-1 - a);
  long long d = (long long)(((u64)x * g.m) >> g.shift);
  const long long r = (long long)x - d * q;
  d += (r >= q) - (r < 0);
  return a >= 0 ? (int)d : -1 - (int)d;
}

// A class's requests (all R axes), its positive axes with their divisors
// (the fit's divisions; axes with a request <= 0 are skipped, as the
// reference masks them), its non-zero axes (the only ones a take
// changes) and its node cap, in a static ring beside the staged rows.
// Written by warp 0, lane r holding request r (0 past R).
struct ClassAxes {
  int req[kMaxR];
  Magic mg[kMaxR];
  unsigned char ax[kMaxR];
  unsigned char nz[kMaxR];
  int nax, nnz;
  int cap;
};

__device__ __forceinline__ void set_class(ClassAxes* d, int q, int R,
                                          int cap) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const unsigned pos = __ballot_sync(0xffffffffu, lane < R && q > 0);
  const unsigned nonzero = __ballot_sync(0xffffffffu, lane < R && q != 0);
  if (lane < R) d->req[lane] = q;
  if (lane < R && q > 0) {
    const int k = __popc(pos & below);
    d->ax[k] = (unsigned char)lane;
    d->mg[k] = magic_of(q);
  }
  if (lane < R && q != 0) d->nz[__popc(nonzero & below)] = (unsigned char)lane;
  if (lane == 0) {
    d->nax = __popc(pos);
    d->nnz = __popc(nonzero);
    d->cap = cap;
  }
}

// The takes of a thread's S slots out of their free space, over the
// class's non-zero axes (axes outer: one read of each axis and request,
// then the slots), skipping the slots opened this step (n_open <= k <
// n_open + n_new, written whole) and those past the CTA's `n_mine`.
template <int S>
__device__ __forceinline__ void take_slots(int* st_free, const int* take,
                                           const ClassAxes& ca, int t, int T,
                                           int n_open, int n_new, int k_lo,
                                           int n_mine) {
  const int nnz = ca.nnz;
  for (int z = 0; z < nnz; ++z) {
    const int r = ca.nz[z];
    const int q = ca.req[r];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int l = t * S + i, k = k_lo + l;
      if (take[i] && l < n_mine && !(k >= n_open && k < n_open + n_new))
        st_free[(r * S + i) * T + t] -= take[i] * q;
    }
  }
}

// Store a thread's S contiguous values (the first `valid` of them) at dst:
// 16- or 8-byte stores where aligned, so a warp's lanes write one run.
template <int S>
__device__ __forceinline__ void store_slots(int* dst, const int* v,
                                            int valid) {
  const size_t adr = (size_t)dst;
  if (valid >= S && S >= 4 && (adr & 15) == 0) {
#pragma unroll
    for (int i = 0; i < S; i += 4)
      *(int4*)(dst + i) = make_int4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if (valid >= S && S == 2 && (adr & 7) == 0) {
    *(int2*)dst = make_int2(v[0], v[S > 1 ? 1 : 0]);
  } else {
#pragma unroll
    for (int i = 0; i < S; ++i)
      if (i < valid) dst[i] = v[i];
  }
}

__device__ __forceinline__ int alloc_at(const int* __restrict__ alloc, int opt,
                                        int R, int r) {
  return __ldg(alloc + (size_t)opt * R + r);
}

// Zero takes for the classes [c0, c1), which take nothing: the rows of
// this CTA's slots (emit), or one count each (rank 0 of the cluster).
__device__ __noinline__ void zero_takes(int* takes, int c0, int c1, int K,
                                           int k_lo, int n_mine, int emit,
                                           int rank) {
  if (emit) {
    for (int c = c0; c < c1; ++c)
      for (int l = threadIdx.x; l < n_mine; l += blockDim.x)
        takes[(size_t)c * K + k_lo + l] = 0;
  } else if (rank == 0) {
    for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) takes[c] = 0;
  }
}

// The first class at or after `from` whose count is > 0 (C if none), and
// its count; every lane of the calling warp returns the same answer.
__device__ __noinline__ int next_class(const int* __restrict__ counts,
                                          int from, int C, int* cnt) {
  const int lane = threadIdx.x & 31;
  for (int base = from; base < C; base += 32) {
    const int c = base + lane;
    const int v = c < C ? __ldg(counts + c) : 0;
    const unsigned hit = __ballot_sync(0xffffffffu, v > 0);
    if (hit) {
      const int l = __ffs(hit) - 1;
      *cnt = __shfl_sync(0xffffffffu, v, l);
      return base + l;
    }
  }
  *cnt = 0;
  return C;
}

// ---- the exchange: a scan of one value a thread over the cluster ----
//
// Each warp scans its lanes with shuffles and leaves its total in a small
// table; one block barrier; each warp then reads the table (redux.sync).
// Across a cluster, warp 0 of each CTA then sends its CTA's total to every
// CTA's cluster table by st.async, which completes its 8 bytes on that
// CTA's mbarrier (transaction count); each CTA's mbarrier expects cs x 8
// bytes a use, and every thread waits on its own CTA's mbarrier.  So a
// step pays one block barrier and one round of one-way remote stores, not
// a cluster-wide barrier of every thread.  Tables and mbarriers alternate
// between two buffers: a buffer is written again two exchanges later,
// after every thread of every CTA has passed the exchange between (its
// reads done).

struct Exchange {
  u64* wtab;   // [2][32]: this CTA's warp totals
  u64* ctab;   // [2][kMaxCluster]: the cluster's CTA totals
  u64* mbar;   // [2]: the CTA totals' arrivals (clusters of 2 or more)
  int cs, rank, n;
};

constexpr int kMaxCluster = 16;

__device__ __forceinline__ void mbar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ unsigned mapa(const void* p, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}

// This CTA's mbarrier of buffer b expects the cs stores of one exchange
// (its one arrival); posted by thread 0 before the exchange's block
// barrier, so before this CTA sends, though another CTA's store may land
// first (the transaction count then waits for the arrival).
__device__ __forceinline__ void expect_sends(const Exchange& x, int b) {
  if (threadIdx.x == 0 && x.cs > 1) mbar_expect(x.mbar + b, 8 * x.cs);
}

__device__ __forceinline__ void publish(const Exchange& x, int b, u64 v) {
  // lane r of warp 0 sends this CTA's value to CTA r
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32 && lane < x.cs) {
    const unsigned dst = mapa(x.ctab + b * kMaxCluster + x.rank, lane);
    const unsigned bar = mapa(x.mbar + b, lane);
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.u64 [%0], %1, "
        "[%2];\n" ::"r"(dst),
        "l"(v), "r"(bar)
        : "memory");
  }
  // every thread: the cs stores of this use of buffer b
  mbar_wait(x.mbar + b, (x.n >> 1) & 1);
}

// Before the first exchange (then a cluster barrier, so that no CTA
// sends to another's mbarrier before it is initialised).
__device__ __forceinline__ void exchange_init(const Exchange& x) {
  if (threadIdx.x == 0 && x.cs > 1) {
    mbar_init(x.mbar, 1);
    mbar_init(x.mbar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// (The rare paths — the 64-bit scan, the search past a prefetched window,
// the empty classes' takes — are out of line: a class step's code stays
// small.)
//
// Exclusive prefix and total, over the cluster's threads in order (CTA
// rank, then thread), of one uint32 a thread, wrapping; `*any` tells
// whether any thread of the cluster passed `flag`.
__device__ __forceinline__ void exchange_scan(Exchange& x, unsigned v,
                                              bool flag, unsigned* pre,
                                              unsigned* tot, bool* any) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b = x.n & 1;
  expect_sends(x, b);
  unsigned s = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, s, d);
    if (lane >= d) s += y;
  }
  const unsigned wsum = __shfl_sync(0xffffffffu, s, 31);
  const unsigned wflag = __any_sync(0xffffffffu, flag);
  if (lane == 0) x.wtab[b * 32 + warp] = (u64)wsum | ((u64)wflag << 32);
  __syncthreads();
  const u64 e = lane < nwarps ? x.wtab[b * 32 + lane] : 0ull;
  const unsigned w = (unsigned)e;
  const unsigned w_lt = __reduce_add_sync(0xffffffffu, lane < warp ? w : 0u);
  unsigned all = __reduce_add_sync(0xffffffffu, w);
  unsigned flags = __reduce_or_sync(0xffffffffu, (unsigned)(e >> 32));
  unsigned c_lt = 0;
  if (x.cs > 1) {
    publish(x, b, (u64)all | ((u64)flags << 32));
    const u64 f = lane < x.cs ? x.ctab[b * kMaxCluster + lane] : 0ull;
    c_lt = __reduce_add_sync(0xffffffffu,
                             lane < x.rank ? (unsigned)f : 0u);
    all = __reduce_add_sync(0xffffffffu, (unsigned)f);
    flags = __reduce_or_sync(0xffffffffu, (unsigned)(f >> 32));
  }
  ++x.n;
  *pre = c_lt + w_lt + s - v;
  *tot = all;
  *any = flags != 0;
}

// The minimum over the cluster of one u64 a CTA (every thread of the CTA
// holding it): each CTA's value to every CTA's table, then a minimum.
__device__ __forceinline__ u64 exchange_min(Exchange& x, u64 v) {
  const int lane = threadIdx.x & 31;
  const int b = x.n & 1;
  expect_sends(x, b);
  publish(x, b, v);
  const u64 e = lane < x.cs ? x.ctab[b * kMaxCluster + lane] : ~0ull;
  const unsigned hi = __reduce_min_sync(0xffffffffu, (unsigned)(e >> 32));
  const unsigned lo = __reduce_min_sync(
      0xffffffffu, (unsigned)(e >> 32) == hi ? (unsigned)e : 0xffffffffu);
  ++x.n;
  return ((u64)hi << 32) | lo;
}

__device__ __forceinline__ u64 warp_sum64(u64 v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// The same scan exactly, in 64 bits (the sums past 2^31).
__device__ __noinline__ void exchange_scan64(Exchange& x, u64 v, u64* pre,
                                                u64* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b = x.n & 1;
  expect_sends(x, b);
  u64 s = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u64 y = __shfl_up_sync(0xffffffffu, s, d);
    if (lane >= d) s += y;
  }
  if (lane == 31) x.wtab[b * 32 + warp] = s;
  __syncthreads();
  const u64 w = lane < nwarps ? x.wtab[b * 32 + lane] : 0ull;
  const u64 w_lt = warp_sum64(lane < warp ? w : 0ull);
  u64 all = warp_sum64(w), c_lt = 0;
  if (x.cs > 1) {
    publish(x, b, all);
    const u64 f = lane < x.cs ? x.ctab[b * kMaxCluster + lane] : 0ull;
    c_lt = warp_sum64(lane < x.rank ? f : 0ull);
    all = warp_sum64(f);
  }
  ++x.n;
  *pre = c_lt + w_lt + s - v;
  *tot = all;
}

// The lexicographic minimum of (rank, score, index) over the block: the
// lowest rank, then the lowest score, ties to the lowest index, as three
// uint32 keys (an order-preserving rank, the score's ordered bits with
// -0.0 read as 0.0, the index), each a redux.sync minimum.  One barrier;
// every thread returns with the keys.  `s_key` holds 3 x 32 entries, read
// only between this call's barrier and the caller's next barrier.
__device__ __forceinline__ bool key_less(int r1, float s1, int i1, int r2,
                                         float s2, int i2) {
  return r1 < r2 || (r1 == r2 && (s1 < s2 || (s1 == s2 && i1 < i2)));
}

__device__ __forceinline__ unsigned score_key(float f) {
  const unsigned u = __float_as_uint(__fadd_rn(f, 0.0f));  // -0.0 -> 0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

constexpr unsigned kInfKey = 0xff800000u;  // score_key(+inf)

__device__ __forceinline__ void warp_keymin(unsigned& r, unsigned& f,
                                            unsigned& i) {
  const unsigned r1 = __reduce_min_sync(0xffffffffu, r);
  const unsigned f1 =
      __reduce_min_sync(0xffffffffu, r == r1 ? f : 0xffffffffu);
  i = __reduce_min_sync(0xffffffffu,
                        (r == r1 && f == f1) ? i : 0xffffffffu);
  r = r1;
  f = f1;
}

__device__ __forceinline__ void block_keymin(int rk, float sc, int ix,
                                             unsigned* s_key,
                                             unsigned* f_out,
                                             unsigned* i_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned r = (unsigned)rk ^ 0x80000000u, f = score_key(sc),
           i = (unsigned)ix;
  warp_keymin(r, f, i);
  if (lane == 0) {
    s_key[warp] = r;
    s_key[32 + warp] = f;
    s_key[64 + warp] = i;
  }
  __syncthreads();
  r = lane < nwarps ? s_key[lane] : 0xffffffffu;
  f = lane < nwarps ? s_key[32 + lane] : 0xffffffffu;
  i = lane < nwarps ? s_key[64 + lane] : 0xffffffffu;
  warp_keymin(r, f, i);
  *f_out = f;
  *i_out = i;
}

// A class's rows in shared memory (one buffer of the ring of three); its
// requests, divisors and node cap live in small static rings beside it.
struct ClassBuf {
  uint8_t* compat;   // OB (a multiple of 16)
  int* m;            // O   (K2: K1's m row; K5: m_all's)
  uint8_t* ok;       // O   (K2 only: K1's ok row)
};

// Buffer `slot` of the ring at `base` (16-byte aligned): compat, m, ok.
__device__ __forceinline__ ClassBuf ring_at(unsigned char* base, int slot,
                                            int OB, int O, bool with_ok) {
  unsigned char* p =
      base + (size_t)slot * (OB + (size_t)O * 4 + (with_ok ? O : 0));
  ClassBuf b;
  b.compat = p;
  b.m = (int*)(p + OB);
  b.ok = with_ok ? p + OB + (size_t)O * 4 : nullptr;
  return b;
}

// Thread 0 stages class c's rows into `b` by TMA bulk copies completing on
// `bar` (with `extra` more bytes of a copy issued beside them, or 0).
// Sizes are multiples of 16 bytes (O % 128 == 0 on the staged layouts).
__device__ __forceinline__ void stage_rows(const ClassBuf& b, u64* bar,
                                           const uint8_t* compat,
                                           const int* m, const uint8_t* ok,
                                           int c, int OB, int O,
                                           unsigned extra) {
  mbar_expect(bar, OB + O * 4 + (ok ? O : 0) + extra);
  bulk_copy(b.compat, compat + (size_t)c * OB, OB, bar);
  bulk_copy(b.m, m + (size_t)c * O, O * 4, bar);
  if (ok) bulk_copy(b.ok, ok + (size_t)c * O, O, bar);
}

// ---------------------------------------------------------------------------
// For K1 and K4: cluster barriers split in two (arrive, then wait), loads
// from another CTA's shared memory, and 4-byte asynchronous copies from
// global to shared memory (cp.async: a loop issues every copy without
// waiting on any; cp_async_wait_all waits for all of this thread's).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ unsigned ld_cluster(const void* p, unsigned rank) {
  unsigned v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(mapa(p, rank))
               : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// K1 classpack_precompute  (replaces ops/classpack.py class_pack_kernel
// :75-85, the per-(class x option) precompute hoisted out of the scan)
//
// m[c,o] = pods of class c a fresh option-o node holds; ok[c,o] =
// launchable and compatible, then restricted to the class's best
// pool-weight rank.  Bound on this card: bytes (5 written per (class,
// option)), a few microseconds at the main paths' shapes, so what a launch
// pays is the divisions, the catalog reads and the rank reduction.  The
// host's precompute_plan cuts the C x O work into tiles of `ct` classes x
// `ot` options (grid x: class tiles; grid y: the cs CTAs of a cluster,
// along the options; grid z: the shard):
//   * one catalog read a tile: the CTA stages its options' alloc rows once
//     (cp.async, stored axis-major [r][o] with a row pad, so a thread reads
//     its 4 options of one axis as one 16-byte word) and reuses them over
//     its classes; each thread keeps its options' ranks and finiteness in
//     registers;
//   * divisors once a class: its positive axes' multipliers (K2's
//     set_class / magic_of), so a division is a 32-bit multiply-high and a
//     shift (floordiv_magic32); the axes with a request <= 0 are skipped,
//     as the reference masks them;
//   * thread t owns G groups of 4 consecutive options (group g at
//     4 (t + g T)): m and ok go out as 16- and 4-byte stores, a warp's
//     lanes on one run (scalar stores on a ragged row, O % 4 != 0);
//   * the best rank on chip: each thread's ranks stay in registers and its
//     ok bits in one word of shared memory a class; a class's minimum of
//     where(ok, rank, BIG) is a redux.sync a warp, a pass over the warps
//     and, where the class's options span the cs CTAs of a cluster, an
//     exchange of the CTAs' minima in distributed shared memory; then ok is
//     written once.  with_ok = 0 (the sweep, which reads only m) computes
//     and writes no ok and takes no reduction;
//   * small code: the classes run in a loop that is not unrolled (each
//     class's code runs once a launch; the unrolled form measured slower on
//     an H100) and the staging is cp.async, with no register round trip.
// ---------------------------------------------------------------------------
constexpr int kPreMaxThreads = 1024;
constexpr int kPreMaxClasses = 8;   // classes a tile

// K1's floor division by a class's request through its multiplier (K2's
// magic_of), in 32-bit steps: for 0 <= x < 2^31 and shift = 32 + s >= 32,
// x / q = umulhi(x, m) >> s exactly (Granlund and Montgomery's theorem
// for 31-bit numerators, m = ceil(2^shift / q)); a request of 1 (shift
// 31) takes m = 0, s = 0 and adds x itself (`add`, all ones for it, else
// zero).  A negative a is floored through x = ~a = -1 - a, and the
// quotient's bits flipped back.  The host's floordiv_magic_np repeats
// these steps.
struct Magic32 {
  unsigned m, add;
  int s;
};

__device__ __forceinline__ Magic32 magic32_of(const Magic& g) {
  Magic32 h;
  h.m = g.shift == 31 ? 0u : g.m;
  h.add = g.shift == 31 ? 0xffffffffu : 0u;
  h.s = g.shift == 31 ? 0 : g.shift - 32;
  return h;
}

__device__ __forceinline__ int floordiv_magic32(int a, const Magic32& h) {
  const unsigned sign = (unsigned)(a >> 31);  // all ones for a < 0
  const unsigned x = (unsigned)a ^ sign;
  return (int)(((__umulhi(x, h.m) + (x & h.add)) >> h.s) ^ sign);
}

struct PrecomputeArgs {
  const int* req;
  const int* node_cap;
  const uint8_t* compat;
  const int* alloc;
  const float* price;
  const int* rank;
  int C, O, R, OB;
  int ct;       // classes a tile
  int ot;       // options a CTA: 4 * G * threads
  int stage;    // alloc rows staged in shared memory (else read in place)
  int with_ok;
  int vec;      // O % 4 == 0 and aligned outputs: vector stores
  ShardStrides ss;
  int* m_out;
  uint8_t* ok_out;
};

template <int G>
__global__ void __launch_bounds__(kPreMaxThreads)
precompute_tile_kernel(const PrecomputeArgs a) {
  // dynamic: ct x T words of ok bits, then (staged) the R x (ot + 4) slice
  extern __shared__ __align__(16) int s_pre[];
  __shared__ ClassAxes s_cls[kPreMaxClasses];
  __shared__ int s_wmin[kPreMaxClasses * 32];
  __shared__ int s_min[kPreMaxClasses];   // this CTA's minima
  __shared__ int s_best[kPreMaxClasses];  // the classes' best ranks
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = T >> 5, cs = gridDim.y, crank = blockIdx.y;
  const long long sh = blockIdx.z;
  const int c0 = blockIdx.x * a.ct, nc = min(a.ct, a.C - c0);
  const int o_lo = crank * a.ot, nvalid = max(0, min(a.ot, a.O - o_lo));
  const int ld = a.ot + 4;
  unsigned* s_bits = reinterpret_cast<unsigned*>(s_pre);
  int* s_alloc = s_pre + a.ct * T;
  const int* req = a.req + sh * a.ss.req;
  const int* node_cap = a.node_cap + sh * a.ss.cap;
  const uint8_t* compat = a.compat + sh * a.ss.compat;
  const long long base = sh * (long long)a.C * a.O + o_lo;
  // the catalog slice by cp.async, the transpose to axis-major in the
  // copies' addresses (option o's axis r at r * ld + o, ld = ot + 4: a
  // warp's lanes write consecutive words); the loop issues every copy
  // without waiting on any
  if (a.stage) {
    const int* src = a.alloc + (size_t)o_lo * a.R;
    for (int o = t; o < nvalid; o += T)
      for (int r = 0; r < a.R; ++r)
        cp_async4(s_alloc + r * ld + o, src + (size_t)o * a.R + r);
  }
  // the tile's classes: warp w sets up classes w, w + nwarps, ...
  for (int i = warp; i < nc; i += nwarps) {
    const int c = c0 + i;
    const int q = lane < a.R ? __ldg(req + (size_t)c * a.R + lane) : 0;
    set_class(&s_cls[i], q, a.R, __ldg(node_cap + c));
  }
  int rk[G][4];
  unsigned fin = 0;  // bit 4g + v: option (g, v) exists and its price is finite
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int oi = 4 * (t + g * T) + v;
      const bool here = a.with_ok && oi < nvalid;
      rk[g][v] = here ? __ldg(a.rank + o_lo + oi) : 0;
      if (here && isfinite(__ldg(a.price + o_lo + oi)))
        fin |= 1u << (4 * g + v);
    }
  if (a.stage) cp_async_wait_all();
  __syncthreads();
  // one class at a time (a loop, not unrolled)
#pragma unroll 1
  for (int i = 0; i < nc; ++i) {
    const ClassAxes& ca = s_cls[i];
    const int c = c0 + i;
    // this class's compat nibbles, loaded ahead of the divisions
    unsigned nib = 0;
    if (a.with_ok) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int o = o_lo + 4 * (t + g * T);
        if (o < o_lo + nvalid)
          nib |= ((__ldg(compat + (size_t)c * a.OB + (o >> 3)) >>
                   (4 - (o & 4))) & 0xfu) << (4 * g);
      }
    }
    int m[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int v = 0; v < 4; ++v) m[g][v] = kBig;
    const int nax = ca.nax;
    for (int z = 0; z < nax; ++z) {
      const int r = ca.ax[z];
      const Magic32 mg = magic32_of(ca.mg[z]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int oi = 4 * (t + g * T);
        if (oi >= nvalid) break;
        int4 al;
        if (a.stage) {
          al = *reinterpret_cast<const int4*>(s_alloc + r * ld + oi);
        } else {
          const int* p = a.alloc + (size_t)(o_lo + oi) * a.R + r;
          const int left = nvalid - oi;
          al.x = __ldg(p);
          al.y = left > 1 ? __ldg(p + a.R) : 0;
          al.z = left > 2 ? __ldg(p + 2 * a.R) : 0;
          al.w = left > 3 ? __ldg(p + 3 * a.R) : 0;
        }
        m[g][0] = min(m[g][0], floordiv_magic32(al.x, mg));
        m[g][1] = min(m[g][1], floordiv_magic32(al.y, mg));
        m[g][2] = min(m[g][2], floordiv_magic32(al.z, mg));
        m[g][3] = min(m[g][3], floordiv_magic32(al.w, mg));
      }
    }
    int tmin = INT_MAX;
    unsigned bits = 0;  // bit 4g + v: ok before the rank filter
    int* mrow = a.m_out + base + (size_t)c * a.O;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int oi = 4 * (t + g * T);
      if (oi >= nvalid) break;
#pragma unroll
      for (int v = 0; v < 4; ++v) m[g][v] = min(m[g][v], ca.cap);
      if (a.vec && oi + 4 <= nvalid) {
        *reinterpret_cast<int4*>(mrow + oi) =
            make_int4(m[g][0], m[g][1], m[g][2], m[g][3]);
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (oi + v < nvalid) mrow[oi + v] = m[g][v];
      }
      if (a.with_ok) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (oi + v >= nvalid) break;
          const bool ok = ((fin >> (4 * g + v)) & 1u) &&
                          ((nib >> (4 * g + 3 - v)) & 1u) && m[g][v] > 0;
          bits |= (unsigned)ok << (4 * g + v);
          tmin = min(tmin, ok ? rk[g][v] : kBig);
        }
      }
    }
    if (a.with_ok) {
      s_bits[i * T + t] = bits;
      tmin = __reduce_min_sync(0xffffffffu, tmin);
      if (lane == 0) s_wmin[i * 32 + warp] = tmin;
    }
  }
  if (!a.with_ok) return;
  __syncthreads();
  if (t < nc) {
    int v = INT_MAX;
    for (int w = 0; w < nwarps; ++w) v = min(v, s_wmin[t * 32 + w]);
    s_min[t] = v;
  }
  if (cs > 1) {
    cluster_arrive();  // this CTA's minima are written
    cluster_wait();
    if (t < nc) {
      int v = INT_MAX;
      for (int r = 0; r < cs; ++r) v = min(v, (int)ld_cluster(s_min + t, r));
      s_best[t] = v;
    }
    cluster_arrive();  // ... and read; the wait is at the end
  } else if (t < nc) {
    s_best[t] = s_min[t];
  }
  __syncthreads();
#pragma unroll 1
  for (int i = 0; i < nc; ++i) {
    const int best = s_best[i];
    const unsigned bits = s_bits[i * T + t];
    uint8_t* orow = a.ok_out + base + (size_t)(c0 + i) * a.O;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int oi = 4 * (t + g * T);
      if (oi >= nvalid) break;
      unsigned word = 0;
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (((bits >> (4 * g + v)) & 1u) && rk[g][v] == best)
          word |= 1u << (8 * v);
      if (a.vec && oi + 4 <= nvalid) {
        *reinterpret_cast<unsigned*>(orow + oi) = word;
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (oi + v < nvalid) orow[oi + v] = (uint8_t)((word >> (8 * v)) & 1u);
      }
    }
  }
  // no CTA leaves while another of its cluster may still read its minima
  if (cs > 1) cluster_wait();
}

// ---------------------------------------------------------------------------
// K2 classpack_scan  (replaces ops/classpack.py class_pack_kernel :87-152,
// the lax.scan over classes; the _fresh variants build the all-closed init
// state in-kernel)
//
// One thread-block cluster per shard (n shards: the shard a grid axis,
// blockIdx.y); the cluster's cs CTAs split the K slots into contiguous
// ranges of `per` slots, each CTA keeping its range's option and free[R]
// (the slot state) in its own shared memory, or past the budget in a
// global slice of the same layout.  Each CTA also holds the class inputs
// (the packed compat row, K1's m and ok rows, the price vector) in shared
// memory, staged one class ahead.  A class step: each thread's fits over
// its slots (in registers), the cluster scan of the fits (one exchange
// through distributed shared memory), the greedy first-fit takes, then —
// when pods remain and a slot is free — the option argmin (each CTA over
// every cs-th option, one block reduction, then the cluster's minimum: a
// second exchange of one value a CTA), and the opening of the new slots.
// Bound on this card: the dependency from class to class (an exchange and
// a block reduction a step), not bytes or operations.  The host's
// scan_plan picks the cluster size, the threads, the slots per thread and
// the layouts from the shapes and the card's attributes.
// ---------------------------------------------------------------------------
constexpr int kScanThreads = 1024;   // threads of a CTA at 32 slots a thread
constexpr int kScanCtaThreads = 512; // ... and below

struct ScanArgs {
  const int* req;
  const int* counts;
  const uint8_t* compat;
  const int* node_cap;
  const int* alloc;
  const float* price;
  const int* m_all;
  const uint8_t* ok_all;
  const int* init_option;
  const int* init_used;
  int C, O, R, OB, K, emit;
  int per;         // slots per CTA
  int state_smem;  // slot state in shared memory (else in g_state)
  int stage;       // class inputs staged in shared memory (else read in place)
  ShardStrides ss;
  int* slot_option;
  int* g_state;    // n x cs x S*T*(R+1) ints, when !state_smem
  int* slot_used;
  int* scalars;
  int* takes;
};

template <int S>
__global__ void __launch_bounds__(S < 32 ? kScanCtaThreads : kScanThreads, 1)
cluster_scan_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ u64 s_wtab[2 * 32];
  __shared__ u64 s_ctab[2 * kMaxCluster];
  __shared__ u64 s_mbar[2];
  __shared__ unsigned s_key[3 * 32];
  // each class's requests, divisors and node cap, one class ahead, and the
  // arrivals of its staged rows
  __shared__ ClassAxes s_cls[3];
  __shared__ u64 s_stage[3];
  const int t = threadIdx.x, T = blockDim.x, lane = t & 31;
  const int cs = gridDim.x, rank = blockIdx.x;
  const long long sh = blockIdx.y;
  const int C = a.C, O = a.O, R = a.R, OB = a.OB, K = a.K;
  // this shard's inputs (or the shared copy, stride 0) and outputs
  const int* req = a.req + sh * a.ss.req;
  const int* counts = a.counts + sh * a.ss.cnt;
  const uint8_t* compat = a.compat + sh * a.ss.compat;
  const int* node_cap = a.node_cap + sh * a.ss.cap;
  const int* m_all = a.m_all + sh * a.ss.m;
  const uint8_t* ok_all = a.ok_all + sh * a.ss.ok;
  const int* init_option =
      a.init_option ? a.init_option + sh * a.ss.iopt : nullptr;
  const int* init_used = a.init_used ? a.init_used + sh * a.ss.iused : nullptr;
  int* slot_option = a.slot_option + sh * K;
  int* slot_used = a.slot_used + sh * (long long)K * R;
  int* takes = a.takes + sh * (a.emit ? (long long)C * K : (long long)C);
  Exchange x = {s_wtab, s_ctab, s_mbar, cs, rank, 0};
  exchange_init(x);
  if (t == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(s_stage + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // ---- shared memory: the slot state, then the staging ----
  size_t off = 0;
  const size_t cells = (size_t)S * T;
  int* st;
  if (a.state_smem) {
    st = (int*)s_dyn;
    off += cells * (R + 1) * sizeof(int);
  } else {
    st = a.g_state + (sh * cs + rank) * (long long)(cells * (R + 1));
  }
  int* st_opt = st;             // [i*T + t]
  int* st_free = st + cells;    // [(r*S + i)*T + t]
  const float* price = a.price;
  unsigned char* ring = nullptr;  // three staged classes' rows
  if (a.stage) {
    price = (const float*)(s_dyn + off);
    off += (size_t)O * sizeof(float);
    ring = s_dyn + off;
  }

  // ---- this CTA's slots and the init state (closed, or pre-opened) ----
  const int k_lo = rank * a.per;
  const int n_mine = max(0, min(a.per, K - k_lo));
  unsigned opened = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int l = t * S + i;
    if (l >= n_mine) break;
    const int k = k_lo + l;
    const int opt = init_option ? init_option[k] : -1;
    st_opt[i * T + t] = opt;
    for (int r = 0; r < R; ++r)
      st_free[(r * S + i) * T + t] =
          opt >= 0 ? wrap_sub(alloc_at(a.alloc, opt, R, r),
                              init_used[(size_t)k * R + r])
                   : 0;
    opened += opt >= 0;
  }
  // the first two non-empty classes; the first one staged (with the
  // price vector)
  int cnt, cnt1;
  int c = next_class(counts, 0, C, &cnt);
  int c1 = c < C ? next_class(counts, c + 1, C, &cnt1) : C;
  zero_takes(takes, 0, c, K, k_lo, n_mine, a.emit, rank);
  if (c < C) {
    if (t < 32)
      set_class(s_cls, t < R ? __ldg(req + (size_t)c * R + t) : 0, R,
                __ldg(node_cap + c));
    if (a.stage && t == 0) {
      stage_rows(ring_at(ring, 0, OB, O, true), s_stage, compat, m_all,
                 ok_all, c, OB, O, O * 4);
      bulk_copy((void*)price, a.price, O * 4, s_stage);
    }
  }
  if (cs > 1) cg::this_cluster().sync();  // every CTA's mbarriers are live
  unsigned pre32, tot32;
  bool big;
  exchange_scan(x, opened, false, &pre32, &tot32, &big);
  int n_open = (int)tot32;
  int n_unsched = 0;
  // a thread's fits below this keep every prefix and the total below 2^31
  const u64 lim = (1ull << 31) / ((u64)cs * T);

  for (int step = 0; c < C; ++step) {
    // the next class staged, its requests, cap and the class after it
    // fetched, all while this one runs
    const int sb = step % 3, nb = (step + 1) % 3;
    const int q1 = c1 < C && t < R ? __ldg(req + (size_t)c1 * R + t) : 0;
    const int capn = c1 < C && t == 0 ? __ldg(node_cap + c1) : 0;
    const int pf = c1 + 1 + lane < C ? __ldg(counts + c1 + 1 + lane) : 0;
    if (a.stage && t == 0 && c1 < C)
      stage_rows(ring_at(ring, nb, OB, O, true), s_stage + nb, compat, m_all,
                 ok_all, c1, OB, O, 0);
    if (a.stage) mbar_wait(s_stage + sb, (step / 3) & 1);
    const ClassAxes& ca = s_cls[sb];
    const int* rq = ca.req;
    const int cap = ca.cap, nax = ca.nax;
    const ClassBuf b = ring_at(ring, sb, OB, O, true);
    const uint8_t* crow = a.stage ? b.compat : compat + (size_t)c * OB;
    const int* mrow = a.stage ? b.m : m_all + (size_t)c * O;
    const uint8_t* okrow = a.stage ? b.ok : ok_all + (size_t)c * O;

    // 1. per-slot fit
    int fit[S];
    u64 fsum = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      int f = 0;
      if (t * S + i < n_mine) {
        const int opt = st_opt[i * T + t];
        if (opt >= 0 && compat_bit(crow, opt)) {
          int v = kBig;
          for (int k = 0; k < nax; ++k)
            v = min(v, floordiv_magic(st_free[(ca.ax[k] * S + i) * T + t],
                                      ca.mg[k]));
          f = max(min(v, cap), 0);
        }
      }
      fit[i] = f;
      fsum += (unsigned)f;
    }
    // 2. exclusive prefix over the cluster's slots (exact in 32 bits unless
    // a thread's fits reach `lim`), 3. greedy first fit
    u64 pre, tot;
    exchange_scan(x, (unsigned)fsum, fsum >= lim, &pre32, &tot32, &big);
    if (big) {
      exchange_scan64(x, fsum, &pre, &tot);
    } else {
      pre = pre32;
      tot = tot32;
    }
    if (c1 < C && t < 32)  // the next class's requests, divisors and cap
      set_class(s_cls + nb, q1, R, capn);
    unsigned run = (unsigned)pre;
    int take[S];
    unsigned tsum = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int d = wrap_sub(cnt, (int)run);
      take[i] = min(max(d, 0), fit[i]);
      tsum += (unsigned)take[i];
      run += (unsigned)fit[i];
    }
    int taken;
    if (tot < 0x80000000ull) {
      taken = min(cnt, (int)tot);  // no prefix wrapped: exact
    } else {
      u64 p2, t2;
      exchange_scan64(x, tsum, &p2, &t2);
      taken = (int)(unsigned)t2;  // the reference's int32 sum
    }
    const int remaining = wrap_sub(cnt, taken);
    // the class after the next one, from the prefetched counts
    int cnt2 = 0, c2 = C;
    if (c1 < C) {
      const unsigned hit = __ballot_sync(0xffffffffu, pf > 0);
      if (hit) {
        c2 = c1 + __ffs(hit);
        cnt2 = __shfl_sync(0xffffffffu, pf, __ffs(hit) - 1);
      } else {
        c2 = next_class(counts, c1 + 33, C, &cnt2);
      }
    }

    // 4. new-node option: argmin of min(price * ceil(rem/m), SCORE_CAP),
    // each CTA over every cs-th option, then the cluster's minimum
    int j = 0;
    bool can = false;
    if (remaining > 0 && n_open < K) {
      float best_sc = INFINITY;
      int best_ix = 0x7fffffff;
      for (int o = rank + cs * t; o < O; o += cs * T) {
        if (!okrow[o]) continue;  // score +inf never beats the running min
        const int ms = max(mrow[o], 1);
        const int nn = floordiv(wrap_add(remaining, ms - 1), ms);
        const float sc = fminf(__fmul_rn(price[o], __int2float_rn(nn)),
                               kScoreCap);
        if (sc < best_sc) {  // strict: the lowest index wins ties
          best_sc = sc;
          best_ix = o;
        }
      }
      unsigned fk, ik;
      block_keymin(0, best_sc, best_ix, s_key, &fk, &ik);
      if (cs > 1) {
        const u64 w = exchange_min(x, ((u64)fk << 32) | ik);
        fk = (unsigned)(w >> 32);
        ik = (unsigned)w;
      }
      // all scores +inf: jnp.argmin answers index 0 and `can` is false
      can = fk < kInfKey;
      j = can ? (int)ik : 0;
      if (can && t < R) prefetch_l1(a.alloc + (size_t)j * R + t);
    } else {
      __syncthreads();  // the next class's requests, divisors, cap visible
    }

    // 5. open n_new slots of option j, the last one partial
    const int m_sel = max(mrow[j], 1);
    const int needed = (can && remaining > 0)
                           ? floordiv(wrap_add(remaining, m_sel - 1), m_sel)
                           : 0;
    const int n_new = min(needed, K - n_open);
    const int sched_new = min(remaining, n_new * m_sel);
    const int rem_last = sched_new - (n_new - 1) * m_sel;
    int placed[S];
    bool any_take = false;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int l = t * S + i;
      placed[i] = 0;
      if (l >= n_mine) continue;
      const int k = k_lo + l;
      placed[i] = take[i];
      if (k >= n_open && k < n_open + n_new) {
        // a closed slot: take[i] == 0 (its fit is 0), so the take below
        // changes nothing
        const int pods_on = (k == n_open + n_new - 1) ? rem_last : m_sel;
        st_opt[i * T + t] = j;
        for (int r = 0; r < R; ++r)
          st_free[(r * S + i) * T + t] =
              alloc_at(a.alloc, j, R, r) - pods_on * rq[r];
        placed[i] += pods_on;
      } else {
        any_take |= take[i] != 0;
      }
    }
    if (any_take)
      take_slots<S>(st_free, take, ca, t, T, n_open, n_new, k_lo, n_mine);
    if (a.emit && t * S < n_mine)
      store_slots<S>(takes + (size_t)c * K + k_lo + t * S, placed,
                     n_mine - t * S);
    if (!a.emit && rank == 0 && t == 0) takes[c] = taken;  // sum(take)
    n_open += n_new;
    n_unsched = wrap_add(n_unsched, remaining - sched_new);
    // the empty classes up to the next one take nothing
    if (c + 1 < c1) zero_takes(takes, c + 1, c1, K, k_lo, n_mine, a.emit, rank);
    c = c1;
    cnt = cnt1;
    c1 = c2;
    cnt1 = cnt2;
  }

  // ---- outputs: slot_used = alloc[opt] - free on open slots ----
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int l = t * S + i;
    if (l >= n_mine) break;
    const int k = k_lo + l;
    const int opt = st_opt[i * T + t];
    slot_option[k] = opt;
    for (int r = 0; r < R; ++r)
      slot_used[(size_t)k * R + r] =
          opt >= 0 ? wrap_sub(alloc_at(a.alloc, opt, R, r),
                              st_free[(r * S + i) * T + t])
                   : 0;
  }
  if (rank == 0 && t == 0) {
    a.scalars[2 * sh] = n_open;
    a.scalars[2 * sh + 1] = n_unsched;
  }
  // no CTA leaves while another may still reach its shared memory
  if (cs > 1) cg::this_cluster().sync();
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
// Output layout [total_cost, n_open, n_unsched, nodes_per_option...] as
// float32, one row per shard.  Bound on this card: bytes (64 KB at the
// headline), far below a launch; what a launch pays past its floor is the
// histogram's shared-memory atomics and the reductions' barriers.  One
// cluster of cs CTAs per shard (grid (cs, n); the host's aggregate_plan
// sizes it from K and O) splits the K slots into runs of `per`:
//   * each CTA counts its run into a histogram of all O options in its own
//     shared memory: a thread reads kAggBatch slots and their prices before
//     counting any (the loads in flight together), and the lanes of a warp
//     that hold one option add once (__match_any_sync); since the scan
//     opens a class's new slots as one run of one option, a warp mostly
//     makes one add.  Each slot is read from HBM once; staging the run and
//     the prices in shared memory first (cp.async, TMA) measured no faster;
//   * the CTAs' histograms are summed through distributed shared memory,
//     each CTA writing its ceil(O / cs) share of the bins (exact integers);
//   * the cost is a float32 sum in a fixed order: each thread's slots in
//     order, a butterfly of warp shuffles, the warps' partials by a
//     butterfly on warp 0, then the CTAs' partials in rank order on rank 0.
//     A plan gives the same bits on every launch; the host's
//     aggregate_sum_model repeats the order.
// ---------------------------------------------------------------------------
constexpr int kAggMaxThreads = 1024;
constexpr int kAggBatch = 4;   // slots a thread reads before counting them


struct AggregateArgs {
  const int* slot_option;
  const float* price;
  const int* n_open;
  const int* n_unsched;
  long long sc_ss;
  int K, O;
  int per;    // slots a CTA
  float* out;
};

__global__ void __launch_bounds__(kAggMaxThreads)
aggregate_cluster_kernel(const AggregateArgs a) {
  extern __shared__ __align__(16) int s_hist[];  // O bins
  __shared__ float s_wsum[32];
  __shared__ float s_part;
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = T >> 5, cs = gridDim.x, rank = blockIdx.x;
  const long long sh = blockIdx.y;
  // the header's scalars, loaded first (volatile: issued here, not where
  // rank 0's thread 0 writes them at the end)
  const bool head = rank == 0 && t == 0;
  const int n_open =
      head ? *(const volatile int*)(a.n_open + sh * a.sc_ss) : 0;
  const int n_unsched =
      head ? *(const volatile int*)(a.n_unsched + sh * a.sc_ss) : 0;
  const int k_lo = rank * a.per;
  const int cnt = max(0, min(a.per, a.K - k_lo));
  const int* run = a.slot_option + sh * a.K + k_lo;
  for (int o = t; o < a.O; o += T) s_hist[o] = 0;
  __syncthreads();
  // kAggBatch slots a thread at a time, read before any is counted;
  // thread t adds its slots t, t + T, ... in order
  float acc = 0.0f;
  for (int k0 = 0; k0 < cnt; k0 += kAggBatch * T) {
    int key[kAggBatch];
    float p[kAggBatch];
#pragma unroll
    for (int u = 0; u < kAggBatch; ++u) {
      const int k = k0 + u * T + t;
      key[u] = k < cnt ? __ldg(run + k) : -1;
    }
#pragma unroll
    for (int u = 0; u < kAggBatch; ++u)
      p[u] = key[u] >= 0 ? __ldg(a.price + key[u]) : 0.0f;
#pragma unroll
    for (int u = 0; u < kAggBatch; ++u) {
      if (key[u] >= 0 && isfinite(p[u]))
        acc = __fadd_rn(acc, p[u]);
      else
        key[u] = -1;
      const unsigned peers = __match_any_sync(0xffffffffu, key[u]);
      if (key[u] >= 0 && (peers & ((1u << lane) - 1u)) == 0)
        atomicAdd(&s_hist[key[u]], __popc(peers));
    }
  }
#pragma unroll
  for (int d = 16; d; d >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, d));
  if (lane == 0) s_wsum[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? s_wsum[lane] : 0.0f;
#pragma unroll
    for (int d = 16; d; d >>= 1)
      w = __fadd_rn(w, __shfl_xor_sync(0xffffffffu, w, d));
    if (lane == 0) s_part = w;
  }
  if (cs > 1) {
    cluster_arrive();  // every CTA's histogram and partial are complete
    cluster_wait();
  } else {
    __syncthreads();
  }
  float* out = a.out + sh * (3ll + a.O);
  const int ob = (a.O + cs - 1) / cs;
  const int o0 = min(a.O, rank * ob), o1 = min(a.O, o0 + ob);
  if (cs == 1) {
    for (int o = t; o < a.O; o += T) out[3 + o] = (float)s_hist[o];
  } else {
    for (int o = o0 + t; o < o1; o += T) {
      int v = 0;  // every CTA's count, its own too (integers: any order)
#pragma unroll 4
      for (int r = 0; r < cs; ++r) v += (int)ld_cluster(s_hist + o, r);
      out[3 + o] = (float)v;
    }
  }
  if (head) {
    // the other CTAs' partials, all loaded before they are added in rank
    // order
    unsigned part[kMaxCluster];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      part[r] = r < cs ? ld_cluster(&s_part, r) : 0u;
    float total = s_part;
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < cs) total = __fadd_rn(total, __uint_as_float(part[r]));
    out[0] = total;
    out[1] = (float)n_open;
    out[2] = (float)n_unsched;
  }
  // no CTA leaves while another may still read its bins
  if (cs > 1) {
    cluster_arrive();
    cluster_wait();
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
// decides launchability itself: compat bit & its own mask bit & m > 0 &
// finite pr_b, then its OWN best pool rank (masking a column can remove
// the best pool), then the score argmin, ties to the lowest index.
//
// One block per row, the class step of the header: the slot state in
// shared memory up to the opt-in budget (else a global slice), the row's
// invariants (pr_b and the ranks) computed once, the next non-empty
// class's compat and m rows staged ahead, and the option choice as ONE
// lexicographic minimum over (rank, score, index), where a launchable
// option o is (rank[o], score, o) and a non-launchable one is (BIG, +inf,
// last): the reference's `where(ok, rank, BIG).min()` is the minimum's
// rank, and within that rank the lowest score, ties to the lowest index,
// is its argmin; a minimum of score +inf (no launchable option at the
// best rank) is "index 0, can false".  A step is one block scan and, when
// pods remain and a slot is free, one block reduction.  Bound on this
// card: the dependency over a row's classes (rows run side by side); the
// host's sweep_plan picks the layouts.
// ---------------------------------------------------------------------------
constexpr int kSweepMaxThreads = 512;

struct SweepArgs {
  const int* req;
  const int* counts_b;
  const uint8_t* compat;
  const int* node_cap;
  const int* alloc;
  const float* price;
  const int* rank;
  const uint8_t* mask;
  const float* cap_b;
  const int* init_option;
  const int* init_used;
  const int* m_all;
  int C, O, R, OB, K;
  int state_smem;  // slot state in shared memory (else in g_state)
  int inv_smem;    // the row's invariants in shared memory (else in g_inv)
  int stage;       // class inputs staged in shared memory (else in place)
  int* g_state;    // B x S*T*(R+1) ints, when !state_smem
  int* g_inv;      // B x 2*O, when !inv_smem
  float* out;
};

template <int S>
__global__ void __launch_bounds__(kSweepMaxThreads, 2)
row_sweep_kernel(const SweepArgs a) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ u64 s_wtab[2 * 32];
  __shared__ unsigned s_key[3 * 32];
  __shared__ float s_part[kSweepMaxThreads];
  // each class's requests, divisors and node cap, one class ahead, and the
  // arrivals of its staged rows
  __shared__ ClassAxes s_cls[3];
  __shared__ u64 s_stage[3];
  const int t = threadIdx.x, T = blockDim.x, lane = t & 31;
  const long long b = blockIdx.x;
  const int C = a.C, O = a.O, R = a.R, OB = a.OB, K = a.K;
  const int* counts = a.counts_b + b * C;
  const float cap_row = a.cap_b[b];
  Exchange x = {s_wtab, nullptr, nullptr, 1, 0, 0};
  if (t == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(s_stage + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  size_t off = 0;
  const size_t cells = (size_t)S * T;
  int* st;
  if (a.state_smem) {
    st = (int*)s_dyn;
    off += cells * (R + 1) * sizeof(int);
  } else {
    st = a.g_state + b * (long long)(cells * (R + 1));
  }
  int* st_opt = st;
  int* st_free = st + cells;
  float* pm;
  int* rk;
  if (a.inv_smem) {
    pm = (float*)(s_dyn + off);
    rk = (int*)(s_dyn + off + (size_t)O * 4);
    off += (size_t)O * 8;
  } else {
    pm = (float*)(a.g_inv + b * 2 * (long long)O);
    rk = a.g_inv + b * 2 * (long long)O + O;
  }
  const uint8_t* mrow = a.mask + b * OB;
  unsigned char* ring = nullptr;  // three staged classes' rows
  if (a.stage) {
    mrow = s_dyn + off;
    off += OB;
    ring = s_dyn + off;
  }

  // ---- the row's invariants: pr_b and the ranks.  Thread t owns options
  // t, t+T, ..., as in the option pass, so only the aggregate reads
  // another's (after a barrier).
  const uint8_t* mask_g = a.mask + b * OB;
  for (int o = t; o < O; o += T) {
    const float p = a.price[o];
    // strict float32 compare: a NaN price or one at/above the cap is +inf
    pm[o] = (compat_bit(mask_g, o) && p < cap_row) ? p : INFINITY;
    rk[o] = a.rank[o];
  }

  // ---- init state: the pre-opened columns (existing nodes) ----
  unsigned opened = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int k = t * S + i;
    if (k >= K) break;
    const int opt = a.init_option[k];
    st_opt[i * T + t] = opt;
    for (int r = 0; r < R; ++r)
      st_free[(r * S + i) * T + t] =
          opt >= 0 ? wrap_sub(alloc_at(a.alloc, opt, R, r),
                              a.init_used[(size_t)k * R + r])
                   : 0;
    opened += opt >= 0;
  }
  // this row's first two non-empty classes; the first one staged (with
  // the row's mask)
  int cnt, cnt1;
  int c = next_class(counts, 0, C, &cnt);
  int c1 = c < C ? next_class(counts, c + 1, C, &cnt1) : C;
  if (c < C) {
    if (t < 32)
      set_class(s_cls, t < R ? __ldg(a.req + (size_t)c * R + t) : 0, R,
                __ldg(a.node_cap + c));
    if (a.stage && t == 0) {
      stage_rows(ring_at(ring, 0, OB, O, false), s_stage, a.compat, a.m_all,
                 nullptr, c, OB, O, OB);
      bulk_copy((void*)mrow, mask_g, OB, s_stage);
    }
  }
  unsigned pre32, tot32;
  bool big;
  exchange_scan(x, opened, false, &pre32, &tot32, &big);
  int n_open = (int)tot32;
  int n_unsched = 0;
  const u64 lim = (1ull << 31) / (u64)T;

  for (int step = 0; c < C; ++step) {
    const int sb = step % 3, nb = (step + 1) % 3;
    const int q1 = c1 < C && t < R ? __ldg(a.req + (size_t)c1 * R + t) : 0;
    const int capn = c1 < C && t == 0 ? __ldg(a.node_cap + c1) : 0;
    const int pf = c1 + 1 + lane < C ? __ldg(counts + c1 + 1 + lane) : 0;
    if (a.stage && t == 0 && c1 < C)
      stage_rows(ring_at(ring, nb, OB, O, false), s_stage + nb, a.compat,
                 a.m_all, nullptr, c1, OB, O, 0);
    if (a.stage) mbar_wait(s_stage + sb, (step / 3) & 1);
    const ClassAxes& ca = s_cls[sb];
    const int* rq = ca.req;
    const int cap = ca.cap, nax = ca.nax;
    const ClassBuf cb = ring_at(ring, sb, OB, O, false);
    const uint8_t* crow = a.stage ? cb.compat : a.compat + (size_t)c * OB;
    const int* mr = a.stage ? cb.m : a.m_all + (size_t)c * O;

    // 1. per-slot fit: open, compatible, and the column kept in this row
    int fit[S];
    u64 fsum = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      int f = 0;
      if (t * S + i < K) {
        const int opt = st_opt[i * T + t];
        if (opt >= 0 && compat_bit(crow, opt) && compat_bit(mrow, opt)) {
          int v = kBig;
          for (int k = 0; k < nax; ++k)
            v = min(v, floordiv_magic(st_free[(ca.ax[k] * S + i) * T + t],
                                      ca.mg[k]));
          f = max(min(v, cap), 0);
        }
      }
      fit[i] = f;
      fsum += (unsigned)f;
    }
    // 2. exclusive prefix over slots, 3. greedy first-fit fill
    u64 pre, tot;
    exchange_scan(x, (unsigned)fsum, fsum >= lim, &pre32, &tot32, &big);
    if (big) {
      exchange_scan64(x, fsum, &pre, &tot);
    } else {
      pre = pre32;
      tot = tot32;
    }
    if (c1 < C && t < 32)  // the next class's requests, divisors and cap
      set_class(s_cls + nb, q1, R, capn);
    unsigned run = (unsigned)pre;
    int take[S];
    unsigned tsum = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int d = wrap_sub(cnt, (int)run);
      take[i] = min(max(d, 0), fit[i]);
      tsum += (unsigned)take[i];
      run += (unsigned)fit[i];
    }
    int taken;
    if (tot < 0x80000000ull) {
      taken = min(cnt, (int)tot);
    } else {
      u64 p2, t2;
      exchange_scan64(x, tsum, &p2, &t2);
      taken = (int)(unsigned)t2;
    }
    const int remaining = wrap_sub(cnt, taken);
    int cnt2 = 0, c2 = C;
    if (c1 < C) {
      const unsigned hit = __ballot_sync(0xffffffffu, pf > 0);
      if (hit) {
        c2 = c1 + __ffs(hit);
        cnt2 = __shfl_sync(0xffffffffu, pf, __ffs(hit) - 1);
      } else {
        c2 = next_class(counts, c1 + 33, C, &cnt2);
      }
    }

    // 4. new-node option for the tail: min of (rank, score, index) over
    // this row's options, a non-launchable one being (BIG, +inf, last)
    int j = 0;
    bool can = false;
    if (remaining > 0 && n_open < K) {
      int best_rk = 0x7fffffff, best_ix = 0x7fffffff;
      float best_sc = INFINITY;
      for (int o = t; o < O; o += T) {
        const float p = pm[o];
        const int m = mr[o];
        if (!isfinite(p) || m <= 0 || !compat_bit(crow, o)) {
          if (kBig < best_rk) {  // not launchable: the key (BIG, +inf)
            best_rk = kBig;
            best_sc = INFINITY;
            best_ix = 0x7fffffff;
          }
          continue;
        }
        const int r = rk[o];
        const int nn = floordiv(wrap_add(remaining, m - 1), m);
        const float sc = fminf(__fmul_rn(p, __int2float_rn(nn)), kScoreCap);
        if (key_less(r, sc, o, best_rk, best_sc, best_ix)) {
          best_rk = r;
          best_sc = sc;
          best_ix = o;
        }
      }
      unsigned fk, ik;
      block_keymin(best_rk, best_sc, best_ix, s_key, &fk, &ik);
      // a launchable option's score is finite (a finite price times a
      // node count, clamped at SCORE_CAP); a minimum of +inf: index 0,
      // `can` false
      can = fk < kInfKey;
      j = can ? (int)ik : 0;
      if (can && t < R) prefetch_l1(a.alloc + (size_t)j * R + t);
    } else {
      __syncthreads();  // the next class's requests, divisors, cap visible
    }

    // 5. open n_new slots of option j, the last one partial
    const int m_sel = max(mr[j], 1);
    const int needed = (can && remaining > 0)
                           ? floordiv(wrap_add(remaining, m_sel - 1), m_sel)
                           : 0;
    const int n_new = min(needed, K - n_open);
    const int sched_new = min(remaining, n_new * m_sel);
    const int rem_last = sched_new - (n_new - 1) * m_sel;
    bool any_take = false;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int k = t * S + i;
      if (k >= K) break;
      if (k >= n_open && k < n_open + n_new) {
        const int pods_on = (k == n_open + n_new - 1) ? rem_last : m_sel;
        st_opt[i * T + t] = j;
        for (int r = 0; r < R; ++r)
          st_free[(r * S + i) * T + t] =
              alloc_at(a.alloc, j, R, r) - pods_on * rq[r];
      } else {
        any_take |= take[i] != 0;
      }
    }
    if (any_take)
      take_slots<S>(st_free, take, ca, t, T, n_open, n_new, 0, K);
    n_open += n_new;
    n_unsched = wrap_add(n_unsched, wrap_sub(remaining, sched_new));
    c = c1;
    cnt = cnt1;
    c1 = c2;
    cnt1 = cnt2;
  }

  // ---- the row's aggregate: launched slots are open with a finite pr_b
  // (pre-opened existing columns carry +inf and never count) ----
  __syncthreads();  // pm of every option is written (the global layout)
  unsigned launched = 0;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int k = t * S + i;
    if (k >= K) break;
    const int opt = st_opt[i * T + t];
    if (opt >= 0) {
      const float p = pm[opt];
      if (isfinite(p)) {
        ++launched;
        acc += p;
      }
    }
  }
  exchange_scan(x, launched, false, &pre32, &tot32, &big);
  s_part[t] = acc;
  __syncthreads();
  for (int w = T >> 1; w > 0; w >>= 1) {
    if (t < w) s_part[t] += s_part[t + w];
    __syncthreads();
  }
  if (t == 0) {
    a.out[b * 3 + 0] = s_part[0];
    a.out[b * 3 + 1] = (float)tot32;
    a.out[b * 3 + 2] = (float)n_unsched;
  }
}

// ---------------------------------------------------------------------------
// The least class step, measured: a chain of `steps` dependent exchanges
// (exchange_scan at cluster size cs), each followed by a block reduction
// (block_keymin) when `with_min`, timed by clock64 on thread 0 of rank 0.
// A measurement for the bounds of K2 and K5, not a kernel of the port.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kScanThreads, 1)
step_probe_kernel(int steps, int with_min, long long* cycles) {
  __shared__ u64 s_wtab[2 * 32];
  __shared__ u64 s_ctab[2 * kMaxCluster];
  __shared__ u64 s_mbar[2];
  __shared__ unsigned s_key[3 * 32];
  const int cs = gridDim.x, rank = blockIdx.x, t = threadIdx.x;
  Exchange x = {s_wtab, s_ctab, s_mbar, cs, rank, 0};
  exchange_init(x);
  if (cs > 1) cg::this_cluster().sync();
  unsigned v = t & 1, pre, tot;
  bool any;
  exchange_scan(x, v, false, &pre, &tot, &any);
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) {
    exchange_scan(x, v, false, &pre, &tot, &any);
    v = (tot + pre + t) & 1;
    if (with_min) {
      unsigned f, i;
      block_keymin((int)(v + (tot & 3)), (float)(pre & 7), t, s_key, &f, &i);
      v = (v + i) & 1;
    }
  }
  const long long t1 = clock64();
  if (rank == 0 && t == 0) {
    cycles[0] = t1 - t0;
    cycles[1] = (long long)v;  // keeps the chain's result live
  }
  if (cs > 1) cg::this_cluster().sync();
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

// The dynamic shared memory of one ring buffer, a K2 block and a K5 block:
// the kernels' carves, byte for byte (the host's plans compute the same).
size_t ring_bytes(int O, bool with_ok) {
  return (size_t)(O + 7) / 8 + (size_t)O * 4 + (with_ok ? (size_t)O : 0);
}

size_t scan_smem(int cs, int T, int S, int R, int O, int state_smem,
                 int stage) {
  size_t n = 0;
  if (state_smem) n += (size_t)S * T * (R + 1) * sizeof(int);
  if (stage) n += (size_t)O * sizeof(float) + 3 * ring_bytes(O, true);
  return n;
}

size_t sweep_smem(int T, int S, int R, int O, int state_smem, int inv_smem,
                  int stage) {
  size_t n = 0;
  if (state_smem) n += (size_t)S * T * (R + 1) * sizeof(int);
  if (inv_smem) n += (size_t)O * 8;
  if (stage) n += (size_t)(O + 7) / 8 + 3 * ring_bytes(O, false);
  return n;
}

// A launch configuration of `cs`-CTA clusters (cs = 1: a plain launch
// unless `always` asks for the attribute, as the occupancy query does).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int cs, int n, int T, size_t smem, cudaStream_t stream,
                bool always) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(cs, n, 1);
    cfg.blockDim = dim3(T, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = (cs > 1 || always) ? 1 : 0;
  }
};

// A refused call leaves its error as the thread's last error, which the
// next launch's cudaGetLastError would report: clear it where it is
// returned.
cudaError_t refused(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

template <typename Kern>
cudaError_t cluster_attrs(Kern kern, int cs, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || cs <= 8) return refused(err);
  return refused(cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
}

template <int S>
cudaError_t launch_cluster_scan(const ScanArgs& a, int n, int cs, int T,
                                size_t smem, cudaStream_t stream) {
  cudaError_t err = cluster_attrs(cluster_scan_kernel<S>, cs, smem);
  if (err != cudaSuccess) return err;
  ClusterLaunch l(cs, n, T, smem, stream, false);
  err = cudaLaunchKernelEx(&l.cfg, cluster_scan_kernel<S>, a);
  if (err != cudaSuccess) return refused(err);
  return cudaGetLastError();
}

template <int S>
cudaError_t scan_clusters(int cs, int T, size_t smem, int* out) {
  cudaError_t err = cluster_attrs(cluster_scan_kernel<S>, cs, smem);
  if (err != cudaSuccess) return err;
  ClusterLaunch l(cs, 1, T, smem, nullptr, true);
  return refused(
      cudaOccupancyMaxActiveClusters(out, cluster_scan_kernel<S>, &l.cfg));
}

template <int S>
cudaError_t launch_row_sweep(const SweepArgs& a, int B, int T, size_t smem,
                             cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      row_sweep_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return refused(err);
  row_sweep_kernel<S><<<B, T, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int S>
cudaError_t sweep_blocks(int T, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      row_sweep_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return refused(err);
  return refused(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, row_sweep_kernel<S>, T, smem));
}

bool valid_slots_per_thread(int S) {
  return S == 1 || S == 2 || S == 4 || S == 8 || S == 16 || S == 32;
}

// The S instantiation of a templated call: `fn` is a generic lambda taking
// std::integral_constant<int, S>.
template <typename F>
cudaError_t with_s(int S, F fn) {
  switch (S) {
    case 1: return fn(std::integral_constant<int, 1>());
    case 2: return fn(std::integral_constant<int, 2>());
    case 4: return fn(std::integral_constant<int, 4>());
    case 8: return fn(std::integral_constant<int, 8>());
    case 16: return fn(std::integral_constant<int, 16>());
    case 32: return fn(std::integral_constant<int, 32>());
  }
  return cudaErrorInvalidValue;
}

// K1's and K4's shared-memory attribute, for a launch or a query: raised to
// a carve past the default 48 KB, never set below it (a query for a small
// carve must not refuse a later launch of a larger one that sets nothing).
template <typename Kern>
cudaError_t raise_attrs(Kern kern, int cs, size_t smem) {
  return cluster_attrs(kern, cs, smem > 48 * 1024 ? smem : 48 * 1024);
}

// A launch of K1's tile kernel: grid (class tiles, cs, n), clusters of cs
// CTAs along y (the options); `always` asks for the cluster attribute at
// cs = 1 too, as the occupancy query does.
struct TileLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  TileLaunch(int tiles, int cs, int n, int T, size_t smem,
             cudaStream_t stream, bool always) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(tiles, cs, n);
    cfg.blockDim = dim3(T, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = cs;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = (cs > 1 || always) ? 1 : 0;
  }
};

template <int G>
cudaError_t launch_precompute(const PrecomputeArgs& a, int tiles, int cs,
                              int n, int T, size_t smem,
                              cudaStream_t stream) {
  cudaError_t err;
  if (smem > 48 * 1024 || cs > 8) {
    err = raise_attrs(precompute_tile_kernel<G>, cs, smem);
    if (err != cudaSuccess) return err;
  }
  TileLaunch l(tiles, cs, n, T, smem, stream, false);
  err = cudaLaunchKernelEx(&l.cfg, precompute_tile_kernel<G>, a);
  if (err != cudaSuccess) return refused(err);
  return cudaGetLastError();
}

template <int G>
cudaError_t precompute_clusters(int cs, int T, size_t smem, int* out) {
  cudaError_t err = raise_attrs(precompute_tile_kernel<G>, cs, smem);
  if (err != cudaSuccess) return err;
  TileLaunch l(1, cs, 1, T, smem, nullptr, true);
  return refused(cudaOccupancyMaxActiveClusters(
      out, precompute_tile_kernel<G>, &l.cfg));
}

// The G instantiation of K1's tile kernel (groups of 4 options a thread).
template <typename F>
cudaError_t with_g(int G, F fn) {
  switch (G) {
    case 1: return fn(std::integral_constant<int, 1>());
    case 2: return fn(std::integral_constant<int, 2>());
    case 4: return fn(std::integral_constant<int, 4>());
    case 8: return fn(std::integral_constant<int, 8>());
  }
  return cudaErrorInvalidValue;
}

bool valid_tile(int cs, int T) {
  return cs >= 1 && cs <= kMaxCluster && T >= 32 && T <= kPreMaxThreads &&
         T % 32 == 0;
}

bool valid_aggregate(int cs, int T) {
  return cs >= 1 && cs <= kMaxCluster && T >= 32 && T <= kAggMaxThreads &&
         T % 32 == 0;
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
// The plan (the host's precompute_plan): tiles of ct classes, clusters of
// cs CTAs of T threads along the options, each thread G groups of 4
// options (a CTA's options: 4 G T, and cs of them cover O), the alloc rows
// staged in shared memory or read in place, `smem` dynamic bytes (checked
// against the kernel's carve).  m_out: n x C x O; ok_out: n x C x O, or
// null when !with_ok (then no ok is computed).
cudaError_t kp_precompute(const int* req, const int* node_cap,
                          const uint8_t* compat_packed, const int* alloc,
                          const float* price, const int* rank, int n, int C,
                          int O, int R, const long long* ss, int ct, int cs,
                          int T, int G, int stage, int with_ok, int smem,
                          int* m_out, uint8_t* ok_out, cudaStream_t stream) {
  const long long ot = 4ll * G * T;
  if (R < 0 || R > kMaxR || C <= 0 || O <= 0 || n <= 0 || n > 65535 ||
      ct < 1 || ct > kPreMaxClasses || !valid_tile(cs, T) ||
      !(G == 1 || G == 2 || G == 4 || G == 8) || cs * ot < O ||
      (cs - 1) * ot >= O || (with_ok && !ok_out) ||
      (size_t)smem != ((size_t)ct * T + (stage ? (size_t)R * (ot + 4) : 0)) *
                          sizeof(int))
    return cudaErrorInvalidValue;
  PrecomputeArgs a;
  a.req = req; a.node_cap = node_cap; a.compat = compat_packed;
  a.alloc = alloc; a.price = price; a.rank = rank;
  a.C = C; a.O = O; a.R = R; a.OB = (O + 7) / 8;
  a.ct = ct; a.ot = (int)ot; a.stage = stage; a.with_ok = with_ok;
  a.vec = O % 4 == 0 && (size_t)m_out % 16 == 0 &&
          (!ok_out || (size_t)ok_out % 4 == 0);
  a.ss = strides_from(ss);
  a.m_out = m_out; a.ok_out = ok_out;
  const int tiles = (C + ct - 1) / ct;
  return with_g(G, [&](auto g) {
    return launch_precompute<decltype(g)::value>(a, tiles, cs, n, T,
                                                  (size_t)smem, stream);
  });
}

// The most clusters of cs CTAs (T threads, G groups, smem dynamic bytes)
// of K1 the card holds at once (0: it cannot run one): an input of the
// host's precompute_plan.
cudaError_t kp_precompute_clusters(int cs, int T, int G, int smem, int* out) {
  *out = 0;
  if (!valid_tile(cs, T)) return cudaErrorInvalidValue;
  return with_g(G, [&](auto g) {
    return precompute_clusters<decltype(g)::value>(cs, T, (size_t)smem, out);
  });
}

// init_option / init_used may be null: the all-closed (_fresh) init state
// is then built in-kernel.  n shards, one cluster of cs CTAs each; ss as
// kp_precompute's (all eight read here).  The plan (the host's scan_plan):
// cs CTAs of T threads, S slots a thread, `per` slots a CTA, the slot state
// in shared memory or in g_state (n x cs x S*T*(R+1) ints), the class
// inputs staged or read in place, `smem` dynamic bytes (checked against the
// kernel's carve).  Outputs per shard: slot_option K, slot_used K x R,
// scalars [n_open, n_unsched], takes C x K when emit, else C (per-class
// sum of fills), each n times, shard-major.
cudaError_t kp_scan(const int* req, const int* counts,
                    const uint8_t* compat_packed, const int* node_cap,
                    const int* alloc, const float* price, const int* m_all,
                    const uint8_t* ok_all, const int* init_option,
                    const int* init_used, int n, int C, int O, int R, int K,
                    int emit, const long long* ss, int cs, int T, int S,
                    int per, int state_smem, int stage, int smem,
                    int* slot_option, int* g_state, int* slot_used,
                    int* scalars, int* takes, cudaStream_t stream) {
  if (R <= 0 || R > kMaxR || K <= 0 || K > kp_max_slots() || C <= 0 ||
      O <= 0 || n <= 0 || n > 65535 ||
      !(cs == 1 || cs == 2 || cs == 4 || cs == 8 || cs == 16) || T < 32 ||
      T > (S < 32 ? kScanCtaThreads : kScanThreads) || T % 32 ||
      !valid_slots_per_thread(S) || per <= 0 ||
      (long long)per * cs < K || per > S * T || (stage && O % 128) ||
      (!state_smem && !g_state) ||
      (size_t)smem != scan_smem(cs, T, S, R, O, state_smem, stage))
    return cudaErrorInvalidValue;
  ScanArgs a;
  a.req = req; a.counts = counts; a.compat = compat_packed;
  a.node_cap = node_cap; a.alloc = alloc; a.price = price; a.m_all = m_all;
  a.ok_all = ok_all; a.init_option = init_option; a.init_used = init_used;
  a.C = C; a.O = O; a.R = R; a.OB = (O + 7) / 8; a.K = K; a.emit = emit;
  a.per = per; a.state_smem = state_smem; a.stage = stage;
  a.ss = strides_from(ss);
  a.slot_option = slot_option; a.g_state = g_state; a.slot_used = slot_used;
  a.scalars = scalars; a.takes = takes;
  return with_s(S, [&](auto s) {
    return launch_cluster_scan<decltype(s)::value>(a, n, cs, T, smem, stream);
  });
}

// The most clusters of cs CTAs (T threads, S slots a thread, smem dynamic
// bytes) of K2 the card holds at once (0: it cannot run one): an input of
// the host's scan_plan.
cudaError_t kp_scan_clusters(int cs, int T, int S, int smem, int* out) {
  *out = 0;
  if (!(cs == 1 || cs == 2 || cs == 4 || cs == 8 || cs == 16) || T < 32 ||
      T > (S < 32 ? kScanCtaThreads : kScanThreads) || T % 32)
    return cudaErrorInvalidValue;
  return with_s(S, [&](auto s) {
    return scan_clusters<decltype(s)::value>(cs, T, (size_t)smem, out);
  });
}

// The least class step of K2 / K5 on this card (step_probe_kernel): one
// cluster of cs CTAs of T threads; cycles[0] the clock64 cycles of `steps`
// dependent exchanges (each with a block reduction when with_min).
cudaError_t kp_step_cycles(int cs, int T, int steps, int with_min,
                           long long* cycles, cudaStream_t stream) {
  if (!(cs == 1 || cs == 2 || cs == 4 || cs == 8 || cs == 16) || T < 32 ||
      T > kScanThreads || T % 32 || steps <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cluster_attrs(step_probe_kernel, cs, 0);
  if (err != cudaSuccess) return err;
  ClusterLaunch l(cs, 1, T, 0, stream, false);
  err = cudaLaunchKernelEx(&l.cfg, step_probe_kernel, steps, with_min,
                           cycles);
  if (err != cudaSuccess) return refused(err);
  return cudaGetLastError();
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

// n shards, one cluster of cs CTAs (T threads) each, `per` slots a CTA
// (the host's aggregate_plan); O bins of dynamic shared memory a CTA.
// slot_option: n x K; n_open / n_unsched: the scan's device scalars, shard
// s's at s * sc_ss.  out: n x (3 + O) floats.
cudaError_t kp_aggregate(const int* slot_option, const float* price,
                         const int* n_open, const int* n_unsched,
                         long long sc_ss, int n, int K, int O, int cs, int T,
                         int per, float* out, cudaStream_t stream) {
  if (n <= 0 || n > 65535 || K < 0 || O <= 0 || !valid_aggregate(cs, T) ||
      per < 1 || (long long)per * cs < K ||
      (K > 0 && (long long)per * (cs - 1) >= K))
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)O * sizeof(int);
  AggregateArgs a;
  a.slot_option = slot_option; a.price = price; a.n_open = n_open;
  a.n_unsched = n_unsched; a.sc_ss = sc_ss; a.K = K; a.O = O; a.per = per;
  a.out = out;
  cudaError_t err;
  if (smem > 48 * 1024 || cs > 8) {
    err = raise_attrs(aggregate_cluster_kernel, cs, smem);
    if (err != cudaSuccess) return err;
  }
  ClusterLaunch l(cs, n, T, smem, stream, false);
  err = cudaLaunchKernelEx(&l.cfg, aggregate_cluster_kernel, a);
  if (err != cudaSuccess) return refused(err);
  return cudaGetLastError();
}

// The most clusters of cs CTAs (T threads, smem dynamic bytes) of K4 the
// card holds at once: an input of the host's aggregate_plan.
cudaError_t kp_aggregate_clusters(int cs, int T, int smem, int* out) {
  *out = 0;
  if (!valid_aggregate(cs, T)) return cudaErrorInvalidValue;
  cudaError_t err = raise_attrs(aggregate_cluster_kernel, cs, (size_t)smem);
  if (err != cudaSuccess) return err;
  ClusterLaunch l(cs, 1, T, (size_t)smem, nullptr, true);
  return refused(
      cudaOccupancyMaxActiveClusters(out, aggregate_cluster_kernel, &l.cfg));
}

// v: hosts x chips x L floats (shard-major, host-major).  out: L floats.
cudaError_t kp_shard_psum(const float* v, int hosts, int chips, int L,
                          float* out, cudaStream_t stream) {
  if (hosts <= 0 || chips <= 0 || L <= 0) return cudaErrorInvalidValue;
  shard_psum_kernel<<<(L + 255) / 256, 256, 0, stream>>>(v, hosts, chips, L,
                                                          out);
  return cudaGetLastError();
}

int kp_sweep_max_slots() { return 8192; }

// One row per block.  counts_b: B x C, mask_packed: B x ceil(O/8) (the
// column masks, np.packbits order), cap_b: B, m_all: C x O from K1,
// init_option / init_used: K / K x R (shared by every row).  The plan (the
// host's sweep_plan): T threads (a power of two, at most 512), S slots a
// thread, the slot state in shared memory or in g_state (B x S*T*(R+1)
// ints), the row's invariants in shared memory or in g_inv (B x 2*O), the
// class inputs staged or read in place, `smem` dynamic bytes (checked
// against the kernel's carve).  out: B x 3 floats [cost, n_new, n_unsched].
cudaError_t kp_sweep(const int* req, const int* counts_b,
                     const uint8_t* compat_packed, const int* node_cap,
                     const int* alloc, const float* price, const int* rank,
                     const uint8_t* mask_packed, const float* cap_b,
                     const int* init_option, const int* init_used,
                     const int* m_all, int B, int C, int O, int R, int K,
                     int T, int S, int state_smem, int inv_smem, int stage,
                     int smem, int* g_state, int* g_inv, float* out,
                     cudaStream_t stream) {
  if (R <= 0 || R > kMaxR || K <= 0 || K > kp_sweep_max_slots() || C <= 0 ||
      B <= 0 || O <= 0 || T < 64 || T > kSweepMaxThreads || (T & (T - 1)) ||
      !valid_slots_per_thread(S) || S * T < K || (stage && O % 128) ||
      (!state_smem && !g_state) || (!inv_smem && !g_inv) ||
      (size_t)smem != sweep_smem(T, S, R, O, state_smem, inv_smem, stage))
    return cudaErrorInvalidValue;
  SweepArgs a;
  a.req = req; a.counts_b = counts_b; a.compat = compat_packed;
  a.node_cap = node_cap; a.alloc = alloc; a.price = price; a.rank = rank;
  a.mask = mask_packed; a.cap_b = cap_b; a.init_option = init_option;
  a.init_used = init_used; a.m_all = m_all;
  a.C = C; a.O = O; a.R = R; a.OB = (O + 7) / 8; a.K = K;
  a.state_smem = state_smem; a.inv_smem = inv_smem; a.stage = stage;
  a.g_state = g_state; a.g_inv = g_inv; a.out = out;
  return with_s(S, [&](auto s) {
    return launch_row_sweep<decltype(s)::value>(a, B, T, smem, stream);
  });
}

// The most K5 blocks (T threads, S slots a thread, smem dynamic bytes) one
// SM holds at once (0: none): an input of the host's sweep_plan.
cudaError_t kp_sweep_blocks(int T, int S, int smem, int* out) {
  *out = 0;
  if (T < 64 || T > kSweepMaxThreads || (T & (T - 1)))
    return cudaErrorInvalidValue;
  return with_s(S, [&](auto s) {
    return sweep_blocks<decltype(s)::value>(T, (size_t)smem, out);
  });
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
