// Refinement hot-spot kernels for Hopper (sm_90a), plain C interface.
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// and bound with ctypes.  -fmad=false is load-bearing: the reference
// epilogue (repro/kernels/dissatisfaction.py, reduce_dissat_tile) rounds
// after every multiply and every add, and so do the PyTorch twins in
// dissatisfaction.py; a contracted multiply-add would round once.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so the wrapper can raise on a refused
// launch.  The cost assembly and the per-row reduction that kernels 1
// and 3 end in live in reduce_dissat.cuh, shared with edge_block.cu.

#include "reduce_dissat.cuh"

namespace {

using repro::assemble_cost;
using repro::kMaxK;

// ---------------------------------------------------------------------------
// Kernel 1: (dissat, best) straight from the carried (rows, K) aggregate.
//
// Replaces the TPU kernel dissatisfaction_from_aggregate_pallas
// (repro/kernels/dissatisfaction.py).  Bound on an H100: bytes, and below
// that launch latency -- at N=16384, K=16 it reads 1.05 MB of aggregate
// plus O(N) vectors and writes 128 KB, about 0.4 us at 3.35 TB/s, far
// under the few microseconds a launch costs.  Design: one thread per row;
// the row's degree is one pass over its K entries, the costs a second
// pass (the row is in L1 by then) that keeps the running minimum, the
// lowest index reaching it, and the cost on the row's own machine, so no
// (rows, K) cost block and no per-K register array exists.  Machines
// k >= K are never visited, which is what the reference's finite _BIG
// mask achieves.  A NaN cost makes the minimum NaN and the index K, as
// the reference's min and iota-min do.
// ---------------------------------------------------------------------------

__global__ void dissat_from_aggregate_kernel(
    const float* __restrict__ agg, const int* __restrict__ r_rows,
    const float* __restrict__ b_rows, const float* __restrict__ theta,
    const float* __restrict__ loads, const float* __restrict__ speeds,
    const float* __restrict__ mu_p, const float* __restrict__ total_b_p,
    float* __restrict__ dissat, int* __restrict__ best, int rows, int k,
    int framework) {
  __shared__ float s_loads[kMaxK];
  __shared__ float s_inv_w[kMaxK];
  repro::load_machine_table(loads, speeds, k, s_loads, s_inv_w);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const repro::RowDissat row = repro::reduce_dissat_row(
      agg + static_cast<size_t>(i) * k, 1, k, b_rows[i], r_rows[i], s_loads,
      s_inv_w, 0.5f * mu_p[0], total_b_p[0], framework);
  float d = row.dissat;
  if (theta != nullptr) d = d - theta[i];
  dissat[i] = d;
  best[i] = row.best;
}

// ---------------------------------------------------------------------------
// Kernel 3: kernel 1 over a fleet, a (B, rows, K) aggregate stack.
//
// Replaces the TPU kernel dissatisfaction_from_aggregate_batched_pallas
// (repro/kernels/dissatisfaction.py, body _dissat_kernel_batched), which
// the batched refinement reaches on every turn.  Bound on an H100: bytes,
// and below that launch latency -- at B=32, N=4096, K=16 it reads 8.39 MB
// of aggregate plus 1.05 MB of (r, b) and writes 1.05 MB, about 3.1 us at
// 3.35 TB/s.  Design: the grid is (ceil(rows/128), B), one thread per row;
// block (x, e) reads element e's slab at agg + (e*rows + i)*K and element
// e's own loads, speeds, mu and B, and ends in kernel 1's epilogue
// (reduce_dissat.cuh), so every element is bitwise kernel 1 on that
// element by construction.  No row of one element is ever read by a block
// of another.
// ---------------------------------------------------------------------------

__global__ void dissat_from_aggregate_batched_kernel(
    const float* __restrict__ agg, const int* __restrict__ r_rows,
    const float* __restrict__ b_rows, const float* __restrict__ theta,
    const float* __restrict__ loads, const float* __restrict__ speeds,
    const float* __restrict__ mu_p, const float* __restrict__ total_b_p,
    float* __restrict__ dissat, int* __restrict__ best, int rows, int k,
    int framework) {
  __shared__ float s_loads[kMaxK];
  __shared__ float s_inv_w[kMaxK];
  const int e = blockIdx.y;
  repro::load_machine_table(loads + static_cast<size_t>(e) * k,
                            speeds + static_cast<size_t>(e) * k, k, s_loads,
                            s_inv_w);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const size_t row = static_cast<size_t>(e) * rows + i;
  const repro::RowDissat out = repro::reduce_dissat_row(
      agg + row * k, 1, k, b_rows[row], r_rows[row], s_loads, s_inv_w,
      0.5f * mu_p[e], total_b_p[e], framework);
  float d = out.dissat;
  if (theta != nullptr) d = d - theta[row];
  dissat[row] = d;
  best[row] = out.best;
}

// ---------------------------------------------------------------------------
// Kernel 2: the (rows, K) cost block of a (rows, N) adjacency row block.
//
// Replaces the TPU kernel cost_matrix_pallas (repro/kernels/
// dissatisfaction.py).  Bound on an H100: bytes -- one read of the f32
// adjacency, 1.07 GB at N=16384, about 0.32 ms at 3.35 TB/s; the K-way
// accumulation is a handful of shared-memory adds per nonzero.  Design:
// one warp per row, kWarps rows per block.  Lane l reads columns
// j = l, l+32, l+64, ... (each step one coalesced 128-byte line per warp,
// four steps in flight) and adds each nonzero c_ij into its own
// shared-memory slot part[l][r_j], so every sum has a fixed order and no
// atomics are needed.  The warp then folds the 32 lane slots of each
// machine in lane order, sums the degree k ascending, and assembles the
// costs.  Skipping zero entries changes no value (x + 0 == x).  There is
// no tensor-core product: a one-hot operand would make TF32 rounding the
// only thing it adds.
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;

__global__ void cost_matrix_kernel(
    const float* __restrict__ adj, const int* __restrict__ r_cols,
    const int* __restrict__ r_rows, const float* __restrict__ b_rows,
    const float* __restrict__ loads, const float* __restrict__ speeds,
    const float* __restrict__ mu_p, const float* __restrict__ total_b_p,
    float* __restrict__ out, int rows, int cols, int k, int framework) {
  extern __shared__ float smem[];
  float* s_loads = smem;                       // [k]
  float* s_inv_w = s_loads + k;                // [k]
  float* s_acc = s_inv_w + k;                  // [kWarps][k]
  float* s_part = s_acc + kWarps * k;          // [kWarps][32][k]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  repro::load_machine_table(loads, speeds, k, s_loads, s_inv_w);
  float* part = s_part + (warp * 32 + lane) * k;
  for (int kk = 0; kk < k; ++kk) part[kk] = 0.0f;
  __syncthreads();

  const int i = blockIdx.x * kWarps + warp;
  if (i >= rows) return;  // whole warp leaves together; no later barrier

  // A column whose machine lies outside [0, K) adds nothing, as its
  // all-zero one-hot row does in the reference.
  const unsigned uk = static_cast<unsigned>(k);
  const float* row = adj + static_cast<size_t>(i) * cols;
  int j = lane;
  for (; j + 96 < cols; j += 128) {
    const float c[4] = {row[j], row[j + 32], row[j + 64], row[j + 96]};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c[u] != 0.0f) {
        const unsigned rj = static_cast<unsigned>(r_cols[j + 32 * u]);
        if (rj < uk) part[rj] += c[u];
      }
    }
  }
  for (; j < cols; j += 32) {
    const float c = row[j];
    if (c != 0.0f) {
      const unsigned rj = static_cast<unsigned>(r_cols[j]);
      if (rj < uk) part[rj] += c;
    }
  }
  __syncwarp();

  float* acc = s_acc + warp * k;
  const float* warp_part = s_part + warp * 32 * k;
  for (int kk = lane; kk < k; kk += 32) {
    float s = warp_part[kk];
    for (int l = 1; l < 32; ++l) s = s + warp_part[l * k + kk];
    acc[kk] = s;
  }
  __syncwarp();

  float degree = acc[0];
  for (int kk = 1; kk < k; ++kk) degree = degree + acc[kk];
  const float half_mu = 0.5f * mu_p[0];
  const float total_b = total_b_p[0];
  const float b = b_rows[i];
  const int r = r_rows[i];
  float* out_row = out + static_cast<size_t>(i) * k;
  for (int kk = lane; kk < k; kk += 32) {
    const float own = (kk == r) ? 1.0f : 0.0f;
    out_row[kk] = assemble_cost(acc[kk], degree, b, own, s_loads[kk],
                                s_inv_w[kk], half_mu, total_b, framework);
  }
}

size_t cost_matrix_smem_bytes(int k) {
  return sizeof(float) * static_cast<size_t>(2 * k + kWarps * k +
                                             kWarps * 32 * k);
}

}  // namespace

extern "C" {

int dissat_from_aggregate(const float* agg, const int* r_rows,
                          const float* b_rows, const float* theta,
                          const float* loads, const float* speeds,
                          const float* mu, const float* total_b,
                          float* dissat, int* best, int rows, int k,
                          int framework, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  const int blocks = (rows + threads - 1) / threads;
  dissat_from_aggregate_kernel<<<blocks, threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      agg, r_rows, b_rows, theta, loads, speeds, mu, total_b, dissat, best,
      rows, k, framework);
  return static_cast<int>(cudaGetLastError());
}

int dissat_from_aggregate_batched(const float* agg, const int* r_rows,
                                  const float* b_rows, const float* theta,
                                  const float* loads, const float* speeds,
                                  const float* mu, const float* total_b,
                                  float* dissat, int* best, int batch,
                                  int rows, int k, int framework,
                                  void* stream) {
  if (k < 1 || k > kMaxK || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  const dim3 blocks((rows + threads - 1) / threads, batch);
  dissat_from_aggregate_batched_kernel<<<blocks, threads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
      agg, r_rows, b_rows, theta, loads, speeds, mu, total_b, dissat, best,
      rows, k, framework);
  return static_cast<int>(cudaGetLastError());
}

int cost_matrix(const float* adj, const int* r_cols, const int* r_rows,
                const float* b_rows, const float* loads, const float* speeds,
                const float* mu, const float* total_b, float* out, int rows,
                int cols, int k, int framework, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = cost_matrix_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      cost_matrix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (rows + kWarps - 1) / kWarps;
  cost_matrix_kernel<<<blocks, kWarps * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      adj, r_cols, r_rows, b_rows, loads, speeds, mu, total_b, out, rows,
      cols, k, framework);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
