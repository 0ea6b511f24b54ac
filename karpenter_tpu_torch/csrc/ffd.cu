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
// wrote), so the whole scan runs as ONE persistent block of 1024 threads.
// The slot state (used K x R float32, option K, class count K) lives in
// shared memory (K = 2048 at R = 7: 72 KB; above 48 KB through the opt-in
// limit) and spills to global scratch only past the block's budget.  Row
// inputs are staged into shared memory a chunk at a time, so a step waits
// on no global load of its own; the compat matrix is the class-level
// packed table plus a per-row index (no P x O matrix).  A step costs three
// block barriers (the fit reduction, its broadcast, the update) and two
// more when it has to choose a new node.
//
// Exactness: the state is float32 and must match the reference bit for
// bit, so every add, divide and product is the IEEE round-to-nearest
// intrinsic (__fadd_rn, __fdiv_rn, __fmul_rn) in the reference's order.
// nvcc never contracts these into an FMA, and they do not depend on
// -prec-div or --use_fast_math, so the source needs no flag of its own.
//
// Plain C interface (returns cudaError_t), loaded with ctypes; the launch
// goes on the caller's stream; nothing here synchronises or allocates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 16;
constexpr int kChunk = 256;                 // rows staged per refill
constexpr int kIBig = 1 << 30;
constexpr float kScoreCap = 3.38e38f;       // ops/ffd.py SCORE_CAP as float32
// opt-in dynamic shared memory (227 KB), less room for the static arrays
constexpr size_t kSmemMax = 224 * 1024;
// the staged rows: requests (kChunk x kMaxR) + five int columns
constexpr size_t kStageBytes = (size_t)kChunk * (kMaxR + 5) * 4;

__device__ __forceinline__ int compat_bit(const uint8_t* row, int o) {
  // np.packbits order: column o is byte o >> 3, bit 7 - (o & 7)
  return (row[o >> 3] >> (7 - (o & 7))) & 1;
}

// lexicographic (rank, score, index) order of the new-node choice: the
// best pool rank first, then the least score, then the lowest index
__device__ __forceinline__ bool better(int ra, float sa, int ia, int rb,
                                       float sb, int ib) {
  if (ra != rb) return ra < rb;
  if (sa != sb) return sa < sb;
  return ia < ib;
}

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
                int K, int OB, int* g_cls, int* __restrict__ assignment,
                int* slot_option, float* slot_used, int* __restrict__ n_open_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // the staged row chunk, then (in shared mode) the slot state
  float* s_rreq = reinterpret_cast<float*>(smem);
  int* s_rcid = reinterpret_cast<int*>(s_rreq + kChunk * kMaxR);
  int* s_rvalid = s_rcid + kChunk;
  int* s_rcap = s_rvalid + kChunk;
  int* s_rcrow = s_rcap + kChunk;
  int* s_rtail = s_rcrow + kChunk;
  float* used;
  int* opt;
  int* cls;
  if (g_cls == nullptr) {
    used = reinterpret_cast<float*>(smem + kStageBytes);
    opt = reinterpret_cast<int*>(used + (size_t)K * R);
    cls = opt + K;
  } else {  // the outputs double as the state
    used = slot_used;
    opt = slot_option;
    cls = g_cls;
  }

  __shared__ int s_red_i[kWarps];
  __shared__ int s_red_r[kWarps];
  __shared__ float s_red_s[kWarps];
  __shared__ int s_fit, s_new, s_nopen;

  int local_open = 0;
  for (int k = t; k < K; k += kThreads) {
    const int o = init_option ? init_option[k] : -1;
    opt[k] = o;
    cls[k] = 0;
    for (int r = 0; r < R; ++r)
      used[(size_t)k * R + r] = init_used ? init_used[(size_t)k * R + r] : 0.0f;
    local_open += o >= 0;
  }
  local_open = __reduce_add_sync(0xffffffffu, (unsigned)local_open);
  if (lane == 0) s_red_i[warp] = local_open;
  __syncthreads();
  if (t == 0) {
    int n = 0;
    for (int w = 0; w < kWarps; ++w) n += s_red_i[w];
    s_nopen = n;
  }
  __syncthreads();

  int prev_cid = -1;
  for (int i0 = 0; i0 < P; i0 += kChunk) {
    const int nrows = min(kChunk, P - i0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int j = t; j < nrows; j += kThreads) {
      const int i = i0 + j;
      s_rcid[j] = class_id[i];
      s_rvalid[j] = valid[i];
      s_rcap[j] = node_cap[i];
      s_rcrow[j] = compat_row[i];
      s_rtail[j] = rem[i];
    }
    for (int j = t; j < nrows * R; j += kThreads)
      s_rreq[(j / R) * kMaxR + j % R] = req[(size_t)i0 * R + j];
    __syncthreads();

    for (int j = 0; j < nrows; ++j) {
      const int i = i0 + j;
      const int cid = s_rcid[j];
      if (cid != prev_cid) {
        for (int k = t; k < K; k += kThreads) cls[k] = 0;
        __syncthreads();
      }
      prev_cid = cid;
      if (!s_rvalid[j]) {  // padding: nothing placed, state unchanged
        if (t == 0) assignment[i] = -1;
        continue;
      }
      const float* rq = s_rreq + j * kMaxR;
      const int cap = s_rcap[j];
      const uint8_t* crow = compat + (size_t)s_rcrow[j] * OB;

      // 1. first fit: each thread's lowest fitting slot, then the block min
      int fit = kIBig;
      for (int k = t; k < K; k += kThreads) {
        const int o = opt[k];
        if (o < 0 || !compat_bit(crow, o) || cls[k] >= cap) continue;
        bool ok = true;
        for (int r = 0; r < R; ++r)
          if (!(__fadd_rn(used[(size_t)k * R + r], rq[r]) <=
                alloc[(size_t)o * R + r])) {
            ok = false;
            break;
          }
        if (ok) {
          fit = k;
          break;
        }
      }
      fit = (int)__reduce_min_sync(0xffffffffu, (unsigned)fit);
      if (lane == 0) s_red_i[warp] = fit;
      __syncthreads();
      if (warp == 0) {
        int f = (int)__reduce_min_sync(0xffffffffu, (unsigned)s_red_i[lane]);
        if (lane == 0) s_fit = f;
      }
      __syncthreads();
      const int k_fit = s_fit;
      const int n_open = s_nopen;

      // 2. the new node, only where the reference would open one
      if (k_fit >= kIBig && n_open < K) {
        int br = kIBig, bi = kIBig;
        float bs = INFINITY;
        const float tail = (float)max(s_rtail[j], 1);
        const float hi = fmaxf((float)cap, 1.0f);
        for (int o = t; o < O; o += kThreads) {
          if (!compat_bit(crow, o)) continue;
          const float p = price[o];
          if (!isfinite(p)) continue;
          bool ok = true;
          float m = (float)kIBig;
          for (int r = 0; r < R; ++r) {
            const float a = alloc[(size_t)o * R + r];
            if (!(rq[r] <= a)) ok = false;
            if (rq[r] > 0.0f) m = fminf(m, floorf(__fdiv_rn(a, rq[r])));
          }
          if (!ok) continue;
          m = fminf(fmaxf(m, 1.0f), hi);
          const float s =
              fminf(__fmul_rn(p, ceilf(__fdiv_rn(tail, m))), kScoreCap);
          const int ro = rank[o];
          if (better(ro, s, o, br, bs, bi)) {
            br = ro;
            bs = s;
            bi = o;
          }
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          const int r2 = __shfl_xor_sync(0xffffffffu, br, d);
          const float s2 = __shfl_xor_sync(0xffffffffu, bs, d);
          const int i2 = __shfl_xor_sync(0xffffffffu, bi, d);
          if (better(r2, s2, i2, br, bs, bi)) {
            br = r2;
            bs = s2;
            bi = i2;
          }
        }
        if (lane == 0) {
          s_red_r[warp] = br;
          s_red_s[warp] = bs;
          s_red_i[warp] = bi;
        }
        __syncthreads();
        if (t == 0) {
          for (int w = 1; w < kWarps; ++w)
            if (better(s_red_r[w], s_red_s[w], s_red_i[w], br, bs, bi)) {
              br = s_red_r[w];
              bs = s_red_s[w];
              bi = s_red_i[w];
            }
          s_new = bi;  // kIBig: no option can take the row
        }
        __syncthreads();
      }

      // 3. the update (one thread), then a barrier before the next step
      if (t == 0) {
        int k = -1;
        if (k_fit < kIBig) {
          k = k_fit;
        } else if (n_open < K && s_new < kIBig) {
          k = n_open;
          opt[k] = s_new;
          s_nopen = n_open + 1;
        }
        if (k >= 0) {
          for (int r = 0; r < R; ++r)
            used[(size_t)k * R + r] = __fadd_rn(used[(size_t)k * R + r], rq[r]);
          cls[k] += 1;
        }
        assignment[i] = k;
      }
      __syncthreads();
    }
  }

  if (g_cls == nullptr) {
    for (int k = t; k < K; k += kThreads) {
      slot_option[k] = opt[k];
      for (int r = 0; r < R; ++r)
        slot_used[(size_t)k * R + r] = used[(size_t)k * R + r];
    }
  }
  if (t == 0) *n_open_out = s_nopen;
}

}  // namespace

extern "C" {

const char* ffd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ffd_max_r() { return kMaxR; }

// the bytes of slot state the kernel keeps in shared memory, at most
int ffd_smem_max() { return (int)(kSmemMax - kStageBytes); }

// req: P x R, compat: T x ceil(O/8) (np.packbits order), compat_row /
// class_id / node_cap / rem: P, valid: P bools, alloc: O x R, price / rank:
// O, init_option / init_used: K / K x R or both null (all slots closed).
// g_cls: K ints of scratch when K x (R + 2) x 4 bytes exceed
// ffd_smem_max(), else null.  Outputs: assignment P, slot_option K,
// slot_used K x R, n_open (one int).
cudaError_t ffd_scan(const float* req, const uint8_t* compat,
                     const int* compat_row, const int* class_id,
                     const uint8_t* valid, const int* node_cap,
                     const int* rem, const float* alloc, const float* price,
                     const int* rank, const int* init_option,
                     const float* init_used, int P, int O, int R, int K,
                     int T, int* g_cls, int* assignment, int* slot_option,
                     float* slot_used, int* n_open, cudaStream_t stream) {
  if (R <= 0 || R > kMaxR || K <= 0 || O <= 0 || T <= 0 || P < 0)
    return cudaErrorInvalidValue;
  const size_t state = (size_t)K * (R + 2) * 4;
  if (state > (size_t)ffd_smem_max() && g_cls == nullptr)
    return cudaErrorInvalidValue;
  const size_t smem = kStageBytes + (g_cls == nullptr ? state : 0);
  cudaError_t err = cudaFuncSetAttribute(
      ffd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ffd_scan_kernel<<<1, kThreads, smem, stream>>>(
      req, compat, compat_row, class_id, valid, node_cap, rem, alloc, price,
      rank, init_option, init_used, P, O, R, K, (O + 7) / 8, g_cls,
      assignment, slot_option, slot_used, n_open);
  return cudaGetLastError();
}

}  // extern "C"
