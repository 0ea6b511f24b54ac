// Native host-side FFD bin-packer.
//
// A copy of the JAX package's native/csrc/ffd.cc, code unchanged: the host
// fallback for the packing hot loop (designs/bin-packing.md:16-43
// first-fit-decreasing with per-pod cheapest new node), with slot
// semantics identical to the scan kernel K7 (karpenter_tpu_torch/csrc/
// ffd.cu, ops/ffd_kernels.py) and its plain version, so every backend
// shares one decoder.  The degradation ladder's "native" rung runs it.
//
// Build: karpenter_tpu_torch/native/__init__.py compiles it with
// g++ -O3 -shared -fPIC -std=c++17 into build/native/ffd-<hash>.so.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Pack P pre-sorted pod rows into at most K node slots.
//
// Inputs (row-major):
//   requests   P×R  float   per-row resource demand
//   compat     P×A  uint8   row × option feasibility, A = O + E
//   class_ids  P    int32   contiguous per class (stable FFD sort)
//   caps       P    int32   max pods of the row's class per node
//   rem        P    int32   rows of the row's class still unplaced
//                           (this row included) — the tail the new-node
//                           score amortizes over
//   alloc      A×R  float   allocatable per option (existing appended)
//   price      A    float   hourly price per option (existing entries
//                           ignored: they never open new nodes)
//   rank       A    int32   pool-weight rank (0 = highest-weight pool);
//                           new nodes come from the best-ranked pool
//                           with any fitting option
//   E existing nodes occupy slots [0, E) with option O+e and initial use
//   existing_used E×R float (may be null when E == 0)
//
// Outputs:
//   assignment  P   int32   slot per row, -1 == unschedulable
//   slot_option K   int32   option per open slot (-1 == never opened)
//   slot_used   K×R float   resources consumed per slot
//
// Returns the number of open slots, or -1 on bad arguments.
int32_t ffd_pack(int32_t P, int32_t R, int32_t O, int32_t E, int32_t K,
                 const float* requests, const uint8_t* compat,
                 const int32_t* class_ids, const int32_t* caps,
                 const int32_t* rem,
                 const float* alloc, const float* price,
                 const int32_t* rank,
                 const float* existing_used,
                 int32_t* assignment, int32_t* slot_option,
                 float* slot_used) {
  const int32_t A = O + E;
  if (P < 0 || R <= 0 || O < 0 || E < 0 || K < E) return -1;

  for (int32_t k = 0; k < K; ++k) slot_option[k] = -1;
  std::memset(slot_used, 0, sizeof(float) * (size_t)K * R);
  int32_t n_open = E;
  for (int32_t e = 0; e < E; ++e) {
    slot_option[e] = O + e;
    if (existing_used)
      std::memcpy(slot_used + (size_t)e * R, existing_used + (size_t)e * R,
                  sizeof(float) * R);
  }

  // per-slot count of the *current* class; classes arrive contiguously, so
  // one counter array reset on class change implements the per-class node
  // cap (hostname anti-affinity / spread, tensorize._node_cap)
  std::vector<int32_t> class_count(K, 0);
  int32_t cur_class = -2;

  for (int32_t row = 0; row < P; ++row) {
    if (class_ids[row] != cur_class) {
      cur_class = class_ids[row];
      std::fill(class_count.begin(), class_count.end(), 0);
    }
    const float* req = requests + (size_t)row * R;
    const uint8_t* crow = compat + (size_t)row * A;
    const int32_t cap = caps[row];
    int32_t placed = -1;

    for (int32_t k = 0; k < n_open; ++k) {
      const int32_t oi = slot_option[k];
      if (!crow[oi] || class_count[k] >= cap) continue;
      const float* a = alloc + (size_t)oi * R;
      float* u = slot_used + (size_t)k * R;
      bool fits = true;
      for (int32_t r = 0; r < R; ++r)
        if (u[r] + req[r] > a[r]) { fits = false; break; }
      if (!fits) continue;
      for (int32_t r = 0; r < R; ++r) u[r] += req[r];
      placed = k;
      break;
    }

    if (placed < 0 && n_open < K) {
      // new node: the option minimizing price × ceil(rem / m) — the
      // tail-aware amortized cost of absorbing the class's unplaced rows,
      // the same score the class-granular kernel uses.  A per-pod
      // cheapest rule degenerates on catalogs with cheap tiny types
      // (one pod per node at ~2× the blended optimum, review r5); ties
      // break toward the lower index, which is pre-sorted by pool rank
      // then price (tensorize.build_options).
      int32_t best = -1;
      float best_score = 0.0f;
      int32_t best_r = INT32_MAX;   // pool-weight precedence: lowest rank
      const float tail = (float)(rem[row] < 1 ? 1 : rem[row]);
      for (int32_t j = 0; j < O; ++j) {
        if (!crow[j] || cap < 1) continue;
        if (rank[j] > best_r) continue;   // a better-ranked pool already fits
        const float* a = alloc + (size_t)j * R;
        bool fits = true;
        float m = 3.4e38f;
        for (int32_t r = 0; r < R; ++r) {
          if (req[r] > a[r]) { fits = false; break; }
          if (req[r] > 0.0f) {
            float mr = std::floor(a[r] / req[r]);
            if (mr < m) m = mr;
          }
        }
        if (!fits) continue;
        if (m < 1.0f) m = 1.0f;
        if ((float)cap < m) m = (float)cap;
        float score = price[j] * std::ceil(tail / m);
        // overflow clamp, identical to the JAX kernel's SCORE_CAP
        // (ops/ffd.py): keep float32 math, then cap — the !(<=) form
        // also catches +inf so clamped candidates stay comparable and
        // ties break to the lower index on both backends.
        if (!(score <= 3.38e38f)) score = 3.38e38f;
        if (rank[j] < best_r || best < 0 || score < best_score) {
          best = j;
          best_score = score;
          best_r = rank[j];
        }
      }
      if (best >= 0) {
        placed = n_open++;
        slot_option[placed] = best;
        float* u = slot_used + (size_t)placed * R;
        for (int32_t r = 0; r < R; ++r) u[r] = req[r];
      }
    }

    if (placed >= 0) {
      class_count[placed] += 1;
      assignment[row] = placed;
    } else {
      assignment[row] = -1;
    }
  }
  return n_open;
}

}  // extern "C"
