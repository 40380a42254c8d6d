// The shared epilogue of every dissatisfaction kernel (sm_90a): the cost
// assembly and the per-row Eq.-4 reduction, in one place, as the
// reference keeps them in one place (repro/kernels/dissatisfaction.py,
// reduce_dissat_tile).  Included by dissatisfaction.cu and edge_block.cu;
// both are compiled with -fmad=false, so every multiply and add below
// rounds on its own, as the reference and the PyTorch twins round them.
//
// Cost assembly (framework 0 = Eq. 1 "c", 1 = Eq. 6 "ct"), per row i and
// machine k, in the reference's op order:
//   degree   = A[i,0] + A[i,1] + ... + A[i,K-1]        (k ascending)
//   others_k = L_k - b_i * own_k
//   cut_k    = (0.5 * mu) * (degree - A[i,k])
//   c:   cost_k = (b_i * inv_w_k) * others_k + cut_k
//   ct:  cost_k = (((b*b)*iw)*iw + (((2b)*iw)*iw)*others_k) - ((2b)*iw)*B + cut_k
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace repro {

constexpr int kMaxK = 128;

__device__ __forceinline__ float assemble_cost(float a_k, float degree,
                                               float b, float own,
                                               float load_k, float inv_w_k,
                                               float half_mu, float total_b,
                                               int framework) {
  float others = load_k - b * own;
  float cut = half_mu * (degree - a_k);
  if (framework == 0) {
    return (b * inv_w_k) * others + cut;
  }
  float two_b = 2.0f * b;
  float t1 = ((b * b) * inv_w_k) * inv_w_k;
  float t2 = ((two_b * inv_w_k) * inv_w_k) * others;
  float t3 = (two_b * inv_w_k) * total_b;
  return ((t1 + t2) - t3) + cut;
}

// The machine table every block needs: loads and 1/speeds in shared
// memory.  The caller synchronises the block afterwards.
__device__ __forceinline__ void load_machine_table(const float* loads,
                                                   const float* speeds, int k,
                                                   float* s_loads,
                                                   float* s_inv_w) {
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    s_loads[t] = loads[t];
    s_inv_w[t] = 1.0f / speeds[t];
  }
}

struct RowDissat {
  float dissat;  // current - best, before theta
  int best;      // lowest-index arg-best machine, K when a cost is NaN
};

// One row's reduction from its aggregate row a[0], a[stride], ...,
// a[(k-1)*stride]: the degree is one pass over the K entries, the costs a
// second pass keeping the running minimum, the lowest index reaching it
// and the cost on the row's own machine r, so no per-K array exists.
// Machines k >= K are never visited, which is what the reference's finite
// _BIG mask achieves.  A NaN cost makes the minimum NaN and the index K,
// as the reference's min and iota-min do.  `current` is a single term
// (exact), 0 for an r outside [0, K) as in the reference's masked sum.
__device__ __forceinline__ RowDissat reduce_dissat_row(
    const float* a, int stride, int k, float b, int r, const float* s_loads,
    const float* s_inv_w, float half_mu, float total_b, int framework) {
  float degree = a[0];
  for (int kk = 1; kk < k; ++kk) degree = degree + a[kk * stride];

  float best_val = 0.0f;
  int best_idx = k;
  float current = 0.0f;
  bool saw_nan = false;
  for (int kk = 0; kk < k; ++kk) {
    const float own = (kk == r) ? 1.0f : 0.0f;
    const float cost = assemble_cost(a[kk * stride], degree, b, own,
                                     s_loads[kk], s_inv_w[kk], half_mu,
                                     total_b, framework);
    if (isnan(cost)) saw_nan = true;
    if (kk == 0 || cost < best_val) {
      best_val = cost;
      best_idx = kk;
    }
    if (kk == r) current = cost;
  }
  if (saw_nan) {
    best_val = nanf("");
    best_idx = k;
  }
  return RowDissat{current - best_val, best_idx};
}

}  // namespace repro
