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

#include <stdint.h>

#include "reduce_dissat.cuh"

namespace {

using repro::assemble_cost;
using repro::kMaxK;

// ---------------------------------------------------------------------------
// Kernels 1 and 3: (dissat, best) straight from the carried aggregate, one
// kernel body for both.
//
// Kernel 1 (dissat_from_aggregate) replaces the TPU kernel
// dissatisfaction_from_aggregate_pallas, kernel 3
// (dissat_from_aggregate_batched) replaces
// dissatisfaction_from_aggregate_batched_pallas (both
// repro/kernels/dissatisfaction.py).  Kernel 1 is kernel 3 at B = 1: the
// grid is (row blocks, B), block (x, e) reads element e's rows, loads,
// speeds, mu and B, so every element of kernel 3 is kernel 1 on that
// element by construction.
//
// What bounds them on an H100: bytes, and below a few MB the launch.  At
// N=16384, K=16 kernel 1 reads 1.05 MB of aggregate plus O(N) vectors and
// writes 128 KB, about 0.4 us at 3.35 TB/s, under the launch floor; at the
// sparse refine's N=10^6, K=8 it moves 48 MB, about 14 us; kernel 3 at
// B=32, N=4096, K=16 moves 10.5 MB, about 3.1 us.  The arithmetic (~12
// flops per (row, machine)) is far below the f32 rate.
//
// Design.  Each thread owns one row, a block kRows consecutive rows (128
// blocks at N=16384 on 132 SMs); the row's b, r and theta are read before
// anything else, so their latency hides under the row's.  K is a template
// constant for the K the repo runs (the cases of launch_dissat), so both
// passes of reduce_dissat_row unroll; every other K up to kMaxK takes the
// runtime-K instance.  Up to kRegK machines the row lives in registers:
// each thread loads it with 16-byte loads where it is 16-byte aligned (K
// a multiple of 4), else float by float.  Wider K, and the runtime-K
// instance, read the row from device memory in both passes (no path runs
// them; tools/dissat_ablation.py's "direct" variant is that pattern at
// every K).  No shared memory beyond the machine table.  The order of
// every add and multiply is reduce_dissat_row's, unchanged: the degree k
// ascending, lowest-index ties, NaN -> index K, theta subtracted once.
// (tools/dissat_ablation.py times the alternatives.)
// ---------------------------------------------------------------------------

constexpr int kRows = 128;  // rows (threads) a block
constexpr int kRegK = 32;   // K up to which a row lives in registers

// Whether the instance for K = KT (0: runtime K) keeps a row in registers.
template <int KT>
constexpr bool kInRegisters = KT > 0 && KT <= kRegK;

struct RowsArgs {
  const float* agg;      // (B, rows, K)
  const int* r_rows;     // (B, rows)
  const float* b_rows;   // (B, rows)
  const float* theta;    // (B, rows) or null
  const float* loads;    // (B, K)
  const float* speeds;   // (B, K)
  const float* mu;       // (B,)
  const float* total_b;  // (B,)
  float* dissat;         // (B, rows)
  int* best;             // (B, rows)
  int rows;
  int k;
  int framework;
};

// Loads the KT floats of one row into registers.
template <int KT>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         float (&row)[KT]) {
  if (KT % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll
    for (int c = 0; c < KT; c += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + c));
      row[c] = v.x;
      row[c + 1] = v.y;
      row[c + 2] = v.z;
      row[c + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < KT; ++c) row[c] = __ldg(src + c);
  }
}

// KT > 0: K is the constant KT; KT == 0: K is a.k.
template <int KT>
__global__ void __launch_bounds__(kRows)
    dissat_from_aggregate_kernel(const RowsArgs a) {
  __shared__ float s_loads[kMaxK];
  __shared__ float s_inv_w[kMaxK];
  const int k = KT > 0 ? KT : a.k;
  const int e = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const size_t i = static_cast<size_t>(e) * a.rows + row;
  const bool live = row < a.rows;
  const float b = live ? __ldg(a.b_rows + i) : 0.0f;
  const int r = live ? __ldg(a.r_rows + i) : 0;
  const float th = live && a.theta != nullptr ? __ldg(a.theta + i) : 0.0f;
  const float half_mu = 0.5f * __ldg(a.mu + e);
  const float total_b = __ldg(a.total_b + e);
  repro::load_machine_table(a.loads + static_cast<size_t>(e) * k,
                            a.speeds + static_cast<size_t>(e) * k, k, s_loads,
                            s_inv_w);
  float regs[kInRegisters<KT> ? KT : 1];
  const float* a_row = a.agg + i * k;
  if constexpr (kInRegisters<KT>) {
    if (live) load_row<KT>(a_row, regs);
    a_row = regs;
  }
  __syncthreads();
  if (!live) return;
  const repro::RowDissat out = repro::reduce_dissat_row(
      a_row, 1, k, b, r, s_loads, s_inv_w, half_mu, total_b, a.framework);
  float d = out.dissat;
  if (a.theta != nullptr) d = d - th;
  a.dissat[i] = d;
  a.best[i] = out.best;
}

template <int KT>
int launch_rows(const RowsArgs& a, int batch, cudaStream_t stream) {
  const dim3 grid((a.rows + kRows - 1) / kRows, batch);
  dissat_from_aggregate_kernel<KT><<<grid, kRows, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The K with a compile-time instance (SPECIALISED_K in dissatisfaction.py);
// any other K takes the runtime-K instance.
int launch_dissat(const RowsArgs& a, int batch, void* stream) {
  if (a.k < 1 || a.k > kMaxK || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.k) {
    case 2: return launch_rows<2>(a, batch, s);
    case 4: return launch_rows<4>(a, batch, s);
    case 8: return launch_rows<8>(a, batch, s);
    case 16: return launch_rows<16>(a, batch, s);
    case 32: return launch_rows<32>(a, batch, s);
    case 64: return launch_rows<64>(a, batch, s);
    case 128: return launch_rows<128>(a, batch, s);
    default: return launch_rows<0>(a, batch, s);
  }
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
  return launch_dissat({agg, r_rows, b_rows, theta, loads, speeds, mu,
                        total_b, dissat, best, rows, k, framework},
                       1, stream);
}

int dissat_from_aggregate_batched(const float* agg, const int* r_rows,
                                  const float* b_rows, const float* theta,
                                  const float* loads, const float* speeds,
                                  const float* mu, const float* total_b,
                                  float* dissat, int* best, int batch,
                                  int rows, int k, int framework,
                                  void* stream) {
  return launch_dissat({agg, r_rows, b_rows, theta, loads, speeds, mu,
                        total_b, dissat, best, rows, k, framework},
                       batch, stream);
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
