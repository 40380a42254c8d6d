// Edge-block kernels for Hopper (sm_90a), plain C interface: the sparse
// runtime's per-sweep reductions straight from the CSR edge list, with no
// (N, K) aggregate or cost matrix ever written to device memory.
//
// Built by repro_torch/kernels/_build.py (nvcc -O3 -fmad=false, bound
// with ctypes) like dissatisfaction.cu; both end in the shared epilogue of
// reduce_dissat.cuh.  Every entry point launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError().
//
// Kernel 4 (dissat_from_edges) replaces the TPU kernel
// dissatisfaction_from_edges_pallas, and kernel 5
// (sweep_candidates_from_edges) replaces sweep_candidates_from_edges_pallas
// (both repro/kernels/edge_block.py).
//
// What bounds them on an H100: bytes.  At N=10^6, E=9.0M padded directed
// edges, K=8 they read the receivers and weights once (72 MB), the row
// offsets, node weights and assignment (12 MB; the assignment's gathers
// through the receivers hit a 4 MB array that the 50 MB L2 holds), and
// kernel 4 writes 8 MB -- about 28 us at 3.35 TB/s.  The arithmetic (one
// add per edge, ~12 flops per (row, machine)) is far below the f32 rate.
//
// Design.  The TPU kernel re-blocks the edges into row-tile slabs and
// forms a one-hot product on the matrix unit; here each thread owns one
// row and walks the CSR slab the SparseProblem already has,
// [row_start[i], row_start[i+1]) (to E for the last row, whose tail is
// zero-weight padding), adding each edge's weight into the row's slot for
// the receiver's machine.  The K slots live in thread-private shared
// memory, slot k of thread t at s_acc[k * blockDim + t], so a warp's
// accesses to one slot fall in distinct banks.  Each slot is summed in
// ascending edge order from 0 -- the order of the reference's segment_sum
// -- with no atomics, and the epilogue (reduce_dissat_row) reads the slots
// as kernel 1 reads an aggregate row.  So kernel 4 is bitwise kernel 1 on
// the window-summed aggregate.  A receiver on a machine outside [0, K)
// adds nothing.  Kernel 5 then elects, per block and per machine, the
// owned row of largest net dissatisfaction (lowest row on ties) and its
// best machine; the wrapper combines the (T, K) partials by a first
// maximum over blocks, which yields the globally lowest node on ties.
// Staging the slabs with cp.async/TMA and a warp per long row is left for
// a later change.

#include "reduce_dissat.cuh"

namespace {

using repro::kMaxK;

constexpr int kRows = 128;          // rows (threads) per block
constexpr float kNegBig = -3.0e38f;  // the reference's -_BIG: owns nothing

// Each thread's row: accumulate its slab into its K shared-memory slots and
// reduce them.  Rows >= n return best = -1 and leave their slots alone.
__device__ __forceinline__ repro::RowDissat edge_row(
    int i, const int* __restrict__ row_start,
    const int* __restrict__ receivers, const float* __restrict__ weights,
    const int* __restrict__ assignment, const float* __restrict__ b_rows,
    const float* __restrict__ theta, const float* s_loads,
    const float* s_inv_w, float* s_acc, float half_mu, float total_b, int n,
    int e_total, int k, int framework) {
  float* acc = s_acc + threadIdx.x;
  for (int kk = 0; kk < k; ++kk) acc[kk * kRows] = 0.0f;
  const int start = row_start[i];
  const int end = (i + 1 < n) ? row_start[i + 1] : e_total;
  const unsigned uk = static_cast<unsigned>(k);
  for (int e = start; e < end; ++e) {
    const unsigned m = static_cast<unsigned>(assignment[receivers[e]]);
    if (m < uk) acc[m * kRows] = acc[m * kRows] + weights[e];
  }
  repro::RowDissat row = repro::reduce_dissat_row(
      acc, kRows, k, b_rows[i], assignment[i], s_loads, s_inv_w, half_mu,
      total_b, framework);
  if (theta != nullptr) row.dissat = row.dissat - theta[i];
  return row;
}

__global__ void __launch_bounds__(kRows) dissat_from_edges_kernel(
    const int* __restrict__ row_start, const int* __restrict__ receivers,
    const float* __restrict__ weights, const int* __restrict__ assignment,
    const float* __restrict__ b_rows, const float* __restrict__ theta,
    const float* __restrict__ loads, const float* __restrict__ speeds,
    const float* __restrict__ mu_p, const float* __restrict__ total_b_p,
    float* __restrict__ dissat, int* __restrict__ best, int n, int e_total,
    int k, int framework) {
  extern __shared__ float smem[];
  float* s_loads = smem;                 // [k]
  float* s_inv_w = s_loads + k;          // [k]
  float* s_acc = s_inv_w + k;            // [k][kRows]
  repro::load_machine_table(loads, speeds, k, s_loads, s_inv_w);
  __syncthreads();
  const int i = blockIdx.x * kRows + threadIdx.x;
  if (i >= n) return;
  const repro::RowDissat row = edge_row(
      i, row_start, receivers, weights, assignment, b_rows, theta, s_loads,
      s_inv_w, s_acc, 0.5f * mu_p[0], total_b_p[0], n, e_total, k,
      framework);
  dissat[i] = row.dissat;
  best[i] = row.best;
}

__global__ void __launch_bounds__(kRows) sweep_candidates_from_edges_kernel(
    const int* __restrict__ row_start, const int* __restrict__ receivers,
    const float* __restrict__ weights, const int* __restrict__ assignment,
    const float* __restrict__ b_rows, const float* __restrict__ theta,
    const float* __restrict__ loads, const float* __restrict__ speeds,
    const float* __restrict__ mu_p, const float* __restrict__ total_b_p,
    float* __restrict__ tile_gain, int* __restrict__ tile_node,
    int* __restrict__ tile_dest, int n, int e_total, int k, int framework) {
  extern __shared__ float smem[];
  float* s_loads = smem;                         // [k]
  float* s_inv_w = s_loads + k;                  // [k]
  float* s_acc = s_inv_w + k;                    // [k][kRows]
  float* s_dissat = s_acc + k * kRows;           // [kRows]
  int* s_best = reinterpret_cast<int*>(s_dissat + kRows);   // [kRows]
  int* s_owner = s_best + kRows;                 // [kRows]
  repro::load_machine_table(loads, speeds, k, s_loads, s_inv_w);
  __syncthreads();
  const int t = threadIdx.x;
  const int i = blockIdx.x * kRows + t;
  int owner = -1;                                // rows >= n own nothing
  repro::RowDissat row{0.0f, 0};
  if (i < n) {
    row = edge_row(i, row_start, receivers, weights, assignment, b_rows,
                   theta, s_loads, s_inv_w, s_acc, 0.5f * mu_p[0],
                   total_b_p[0], n, e_total, k, framework);
    owner = assignment[i];
  }
  s_dissat[t] = row.dissat;
  s_best[t] = row.best;
  s_owner[t] = owner;
  __syncthreads();
  // Per machine: the block's owned row of largest gain, the lowest row on
  // ties (strict >), and that row's best machine.  A machine owning no
  // row here keeps -_BIG at row 0, as the reference's masked max and
  // first-winner min leave it.
  for (int m = t; m < k; m += kRows) {
    float gain = kNegBig;
    int win = 0;
    for (int j = 0; j < kRows; ++j) {
      if (s_owner[j] == m && s_dissat[j] > gain) {
        gain = s_dissat[j];
        win = j;
      }
    }
    const size_t out = static_cast<size_t>(blockIdx.x) * k + m;
    tile_gain[out] = gain;
    tile_node[out] = blockIdx.x * kRows + win;
    tile_dest[out] = s_best[win];
  }
}

size_t edge_smem_bytes(int k, bool sweep) {
  size_t floats = 2 * static_cast<size_t>(k) + static_cast<size_t>(k) * kRows;
  if (sweep) floats += 3 * kRows;
  return sizeof(float) * floats;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

int edge_block_rows() { return kRows; }

int dissat_from_edges(const int* row_start, const int* receivers,
                      const float* weights, const int* assignment,
                      const float* b_rows, const float* theta,
                      const float* loads, const float* speeds,
                      const float* mu, const float* total_b, float* dissat,
                      int* best, int n, int e_total, int k, int framework,
                      void* stream) {
  if (k < 1 || k > kMaxK || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = edge_smem_bytes(k, false);
  cudaError_t err = set_smem(dissat_from_edges_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kRows - 1) / kRows;
  dissat_from_edges_kernel<<<blocks, kRows, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      row_start, receivers, weights, assignment, b_rows, theta, loads,
      speeds, mu, total_b, dissat, best, n, e_total, k, framework);
  return static_cast<int>(cudaGetLastError());
}

int sweep_candidates_from_edges(const int* row_start, const int* receivers,
                                const float* weights, const int* assignment,
                                const float* b_rows, const float* theta,
                                const float* loads, const float* speeds,
                                const float* mu, const float* total_b,
                                float* tile_gain, int* tile_node,
                                int* tile_dest, int n, int e_total, int k,
                                int framework, void* stream) {
  if (k < 1 || k > kMaxK || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = edge_smem_bytes(k, true);
  cudaError_t err = set_smem(sweep_candidates_from_edges_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kRows - 1) / kRows;
  sweep_candidates_from_edges_kernel<<<blocks, kRows, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
      row_start, receivers, weights, assignment, b_rows, theta, loads,
      speeds, mu, total_b, tile_gain, tile_node, tile_dest, n, e_total, k,
      framework);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
