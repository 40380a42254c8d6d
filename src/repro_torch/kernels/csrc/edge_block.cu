// Edge-block kernels for Hopper (sm_90a), plain C interface: the sparse
// runtime's per-sweep reductions straight from the CSR edge list, with no
// (N, K) aggregate or cost matrix ever written to device memory.
//
// Built by repro_torch/kernels/_build.py (nvcc -O3 -fmad=false, bound
// with ctypes) like dissatisfaction.cu; both end in the shared epilogue of
// reduce_dissat.cuh.  Every entry point launches on the caller's stream,
// allocates nothing (kernel 5's scratch and ticket come from the wrapper,
// repro_torch/kernels/edge_block.py), and returns cudaGetLastError(), or
// cudaErrorInvalidValue for what it does not take.
//
// Kernel 4 (dissat_from_edges) replaces the TPU kernel
// dissatisfaction_from_edges_pallas, and kernel 5
// (sweep_candidates_from_edges) replaces sweep_candidates_from_edges_pallas
// (both repro/kernels/edge_block.py).
//
// What bounds them on an H100.  Bytes: at N=10^6, E=9,002,624 padded
// directed edges, K=8 they read the receivers and weights once (72.0 MB),
// the row offsets, node weights and assignment (12 MB), and kernel 4
// writes 8 MB: 92.0 MB, 27.5 us at 3.35 TB/s (kernel 5 writes three (K,)
// vectors).  Beyond the byte bound, every edge gathers its receiver's
// machine, assignment[receivers[e]]: 9.0M random reads into a 4 MB array
// that the 50 MB L2 holds, but each costs a whole 32-byte sector, a floor
// the byte bound does not count: a kernel that does nothing but those
// gathers takes ~71 us on an H100 (tools/edge_block_ablation.py, "gather
// floor").  The arithmetic (one add per edge, ~12 flops per (row,
// machine)) is far below the f32 rate.
//
// Design.  A block owns kRows consecutive rows and so one contiguous edge
// range, [row_start[first], row_start[first + kRows]) (to E for the last
// block).  It stages that range through shared memory in chunks of
// kChunk edges: each thread loads receivers and weights of consecutive
// edges (coalesced) and gathers their machines -- all of a thread's loads
// of a chunk, then all its gathers, independent and in flight together --
// and writes each machine beside its weight.  (Bulk async copies,
// cp.async.bulk on an mbarrier, were slower on the H100: see
// tools/edge_block_ablation.py.)  Then each thread walks its
// own row's edges of the chunk from shared memory, in ascending edge
// order, adding each weight into K accumulators: registers for the K of
// SPECIALISED_K (a template constant, the slot picked by an unrolled
// compare so it stays a register), thread-private shared-memory slots for
// every other K up to kMaxK.  The accumulators persist across chunks, so
// a row of any degree (a hub spanning many chunks) sums in order.  Each
// slot is summed in ascending edge order from +0.0 with no atomics -- the
// order of the reference's segment_sum -- a receiver on a machine outside
// [0, K) adds nothing, and the epilogue (reduce_dissat_row) reads the
// slots as kernel 1 reads an aggregate row: kernel 4 is bitwise kernel 1
// on the window-summed aggregate.
//
// Kernel 5 then elects, per tile of kRows rows and per machine, the owned
// row of largest net dissatisfaction and that row's best machine.  Its key
// is (gain, row): larger gain first, then lower row.  That is a total order
// (a NaN or a gain not above -_BIG never enters; such a machine keeps
// -_BIG at the tile's first row), so any reduction tree gives the winner
// of a strict-> scan.  A warp finds its first by two warp reductions
// (redux.sync): the largest order_key of the gain, then the lowest row
// holding it; the tile takes its warps' firsts in order.  Kernel 5's grid
// is the blocks that fit on the card at once, each walking tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... and merging their firsts in
// tile order.  A block then publishes each machine's first: its gain and
// dest as partials, its (key, row) packed as key << 32 | ~row into the
// machine's running maximum by an integer atomicMax (the maximum is the
// same in any order).  The last block to finish -- found by an integer
// ticket, atomicAdd after __threadfence -- reads the K maxima, the winning
// rows' partials, writes the (K,) gains, picks and dests, and leaves the
// ticket and the maxima at zero.  No float atomics, one launch a call, the
// same bits from run to run.

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "reduce_dissat.cuh"

namespace {

using repro::kMaxK;

constexpr int kRows = 128;      // rows (threads) a block
constexpr int kChunk = 1024;    // edges a stage holds
constexpr int kWarps = kRows / 32;
constexpr int kPerThread = kChunk / kRows;  // edges a thread gathers a chunk
// Whether the instance for K = KT (0: runtime K) keeps a row's K
// accumulators in registers; otherwise in shared-memory slots.
template <int KT>
constexpr bool kInRegisters = KT > 0;
constexpr float kNegBig = -3.0e38f;  // the reference's -_BIG: owns nothing
constexpr unsigned kAll = 0xffffffffu;

struct EdgeArgs {
  const int* row_start;   // (N,)
  const int* receivers;   // (E,)
  const float* weights;   // (E,)
  const int* assignment;  // (N,)
  const float* b_rows;    // (N,)
  const float* theta;     // (N,) or null
  const float* loads;     // (K,)
  const float* speeds;    // (K,)
  const float* mu;        // ()
  const float* total_b;   // ()
  float* dissat;          // kernel 4: (N,)
  int* best;              // kernel 4: (N,)
  float* gains;           // kernel 5: (K,)
  int* picks;             // kernel 5: (K,)
  int* dests;             // kernel 5: (K,)
  int* partial;           // kernel 5: 2 x (blocks, K): gains (f32), dests
  int* ticket;            // kernel 5: the ticket, a pad int, then K u64
                          // maxima; all zero between calls
  int n;
  int e_total;
  int k;
  int framework;
};

struct Row {
  bool live;     // the thread's row is < n
  int owner;     // its machine, assignment[i]
  float dissat;  // net of theta
  int best;
};

// Shared-memory bytes past the static arrays: the stage, then the
// accumulator slots where they are not in registers.
constexpr size_t smem_bytes(bool regs, int k) {
  return sizeof(int) * 2 * kChunk +
         (regs ? 0 : sizeof(float) * static_cast<size_t>(k) * kRows);
}

// Tile `tile`'s rows, one a thread: stage the tile's edge range chunk by
// chunk, gather the machines, accumulate each row in ascending edge order
// and reduce it.  KT > 0: K is the constant KT, and the accumulators live
// in registers; KT == 0: K is a.k, and slot k of thread t is
// s_acc[k * kRows + t].
template <int KT>
__device__ __forceinline__ Row block_rows(const EdgeArgs& a, int tile,
                                          int* s_stage, const float* s_loads,
                                          const float* s_inv_w) {
  constexpr bool kRegs = kInRegisters<KT>;
  const int k = KT > 0 ? KT : a.k;
  const int t = threadIdx.x;
  const int r0 = tile * kRows;
  const int i = r0 + t;
  const bool live = i < a.n;
  // the row's slab and operands
  const int beg = live ? __ldg(a.row_start + i) : 0;
  const int end = live ? (i + 1 < a.n ? __ldg(a.row_start + i + 1)
                                      : a.e_total)
                       : 0;
  const float b = live ? __ldg(a.b_rows + i) : 0.0f;
  const int r = live ? __ldg(a.assignment + i) : -1;
  const float th = live && a.theta != nullptr ? __ldg(a.theta + i) : 0.0f;
  // the tile's edge range
  const int e0 = __ldg(a.row_start + r0);
  const int e1 = r0 + kRows < a.n ? __ldg(a.row_start + r0 + kRows)
                                  : a.e_total;
  const int chunks = (e1 - e0 + kChunk - 1) / kChunk;
  int* m_c = s_stage;                                  // [kChunk] machines
  float* w_c = reinterpret_cast<float*>(s_stage + kChunk);  // [kChunk]
  float* s_acc = w_c + kChunk;                         // slots, if not kRegs

  float regs[kRegs ? KT : 1];
  if constexpr (kRegs) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) regs[kk] = 0.0f;
  } else {
    for (int kk = 0; kk < k; ++kk) s_acc[kk * kRows + t] = 0.0f;
  }

  for (int c = 0; c < chunks; ++c) {
    const int lo = e0 + c * kChunk;
    const int len = min(kChunk, e1 - lo);
    // the chunk's receivers and weights, coalesced, then their machines,
    // edge-parallel: every load, then every gather of a thread in flight
    // before the first store
    int recv[kPerThread];
    float wts[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int j = t + u * kRows;
      recv[u] = j < len ? __ldg(a.receivers + lo + j) : 0;
      wts[u] = j < len ? __ldg(a.weights + lo + j) : 0.0f;
    }
    int m[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int j = t + u * kRows;
      m[u] = j < len ? __ldg(a.assignment + recv[u]) : 0;
      if (j < len) w_c[j] = wts[u];
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int j = t + u * kRows;
      if (j < len) m_c[j] = m[u];
    }
    __syncthreads();
    // this row's edges in the chunk, ascending
    const int to = min(end, lo + len);
    for (int e = max(beg, lo); e < to; ++e) {
      const int mach = m_c[e - lo];
      const float w = w_c[e - lo];
      if constexpr (kRegs) {
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          if (mach == kk) regs[kk] = regs[kk] + w;
      } else {
        if (static_cast<unsigned>(mach) < static_cast<unsigned>(k))
          s_acc[mach * kRows + t] = s_acc[mach * kRows + t] + w;
      }
    }
    __syncthreads();  // the stage is free again
  }

  Row out{live, r, 0.0f, 0};
  if (live) {
    const float* acc;
    if constexpr (kRegs) {
      acc = regs;
    } else {
      acc = s_acc + t;
    }
    const repro::RowDissat row = repro::reduce_dissat_row(
        acc, kRegs ? 1 : kRows, k, b, r, s_loads, s_inv_w,
        0.5f * __ldg(a.mu), __ldg(a.total_b), a.framework);
    out.dissat = row.dissat;
    if (a.theta != nullptr) out.dissat = out.dissat - th;
    out.best = row.best;
  }
  return out;
}

// Machines a kernel's shared arrays hold.
template <int KT>
constexpr int kMachines = KT > 0 ? KT : kMaxK;

template <int KT>
__global__ void __launch_bounds__(kRows)
    dissat_from_edges_kernel(const EdgeArgs a) {
  __shared__ float s_loads[kMachines<KT>];
  __shared__ float s_inv_w[kMachines<KT>];
  extern __shared__ __align__(16) int s_stage[];
  repro::load_machine_table(a.loads, a.speeds, KT > 0 ? KT : a.k, s_loads,
                            s_inv_w);
  __syncthreads();
  const Row row = block_rows<KT>(a, blockIdx.x, s_stage, s_loads, s_inv_w);
  if (!row.live) return;
  const int i = blockIdx.x * kRows + threadIdx.x;
  a.dissat[i] = row.dissat;
  a.best[i] = row.best;
}

// A gain's place in the election's order as an unsigned key: for floats
// that are not NaN, a > b iff order_key(a) > order_key(b), and a == b iff
// their keys are equal (-0 and +0 share one); every such key is above 0,
// which stands for "no candidate".
__device__ __forceinline__ unsigned order_key(float g) {
  const unsigned u = __float_as_uint(g == 0.0f ? 0.0f : g);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A warp's first (key, idx) for machine m -- the largest key, then the
// lowest idx -- by two warp reductions; lane 0 leaves it in s_key[w][m],
// s_idx[w][m] for warp w.
template <int KC>
__device__ __forceinline__ void warp_first(unsigned key, int idx, int m,
                                           unsigned (*s_key)[KC],
                                           int (*s_idx)[KC]) {
  const unsigned top = __reduce_max_sync(kAll, key);
  const int first = __reduce_min_sync(kAll, key == top ? idx : INT_MAX);
  if (threadIdx.x % 32 == 0) {
    s_key[threadIdx.x / 32][m] = top;
    s_idx[threadIdx.x / 32][m] = first;
  }
}

// The block's first (key, idx) for machine m over its warps' firsts;
// returns idx and leaves the key in `key`.
template <int KC>
__device__ __forceinline__ int block_first(unsigned (*s_key)[KC],
                                           int (*s_idx)[KC], int m,
                                           unsigned& key) {
  key = s_key[0][m];
  int idx = s_idx[0][m];
  for (int w = 1; w < kWarps; ++w) {
    if (s_key[w][m] > key || (s_key[w][m] == key && s_idx[w][m] < idx)) {
      key = s_key[w][m];
      idx = s_idx[w][m];
    }
  }
  return idx;
}

template <int KT>
__global__ void __launch_bounds__(kRows)
    sweep_candidates_from_edges_kernel(const EdgeArgs a) {
  constexpr int KC = kMachines<KT>;
  __shared__ float s_loads[KC];
  __shared__ float s_inv_w[KC];
  __shared__ unsigned s_key[kWarps][KC];
  __shared__ int s_idx[kWarps][KC];
  __shared__ float s_dissat[kRows];
  __shared__ int s_best[kRows];
  __shared__ float s_run_gain[KC];
  __shared__ int s_run_row[KC];
  __shared__ int s_run_dest[KC];
  __shared__ unsigned s_run_key[KC];
  __shared__ int s_last;
  extern __shared__ __align__(16) int s_stage[];
  const int k = KT > 0 ? KT : a.k;
  const int t = threadIdx.x;
  const int tiles = (a.n + kRows - 1) / kRows;
  const int blocks = gridDim.x;
  float* part_gain = reinterpret_cast<float*>(a.partial);
  int* part_dest = a.partial + static_cast<size_t>(blocks) * k;
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(a.ticket + 2);
  repro::load_machine_table(a.loads, a.speeds, k, s_loads, s_inv_w);
  __syncthreads();

  // ---- the block's tiles blockIdx.x, blockIdx.x + blocks, ... in order,
  // each one's election merged into the block's: per machine, the owned
  // row of largest gain, the lowest on ties (a later tile replaces only a
  // strictly smaller key); a gain not above -_BIG (or NaN) never wins, and
  // a machine with no such row keeps -_BIG at the block's first row
  for (int tile = blockIdx.x; tile < tiles; tile += blocks) {
    const Row row = block_rows<KT>(a, tile, s_stage, s_loads, s_inv_w);
    s_dissat[t] = row.dissat;
    s_best[t] = row.best;
    const unsigned key = row.live && row.dissat > kNegBig
                             ? order_key(row.dissat) : 0u;
    if constexpr (KT > 0) {
#pragma unroll
      for (int m = 0; m < KT; ++m)
        warp_first(row.owner == m ? key : 0u, t, m, s_key, s_idx);
    } else {
      for (int m = 0; m < k; ++m)
        warp_first(row.owner == m ? key : 0u, t, m, s_key, s_idx);
    }
    __syncthreads();
    for (int m = t; m < k; m += kRows) {
      unsigned top;
      const int j = block_first(s_key, s_idx, m, top);
      if (tile == static_cast<int>(blockIdx.x) || top > s_run_key[m]) {
        s_run_key[m] = top;
        s_run_gain[m] = top != 0u ? s_dissat[j] : kNegBig;
        s_run_row[m] = tile * kRows + j;
        s_run_dest[m] = s_best[j];
      }
    }
    __syncthreads();  // the tile's shared arrays are free again
  }
  // ---- publish the block's firsts: each machine's gain and dest as a
  // partial, and its (key, row) into the machine's running maximum of
  // key << 32 | ~row -- the larger gain, then the lower row -- by an
  // integer atomicMax (any order of them gives the same maximum)
  for (int m = t; m < k; m += kRows) {
    const size_t o = static_cast<size_t>(blockIdx.x) * k + m;
    part_gain[o] = s_run_gain[m];
    part_dest[o] = s_run_dest[m];
    atomicMax(keys + m, static_cast<unsigned long long>(s_run_key[m]) << 32 |
                            (0xFFFFFFFFu - static_cast<unsigned>(s_run_row[m])));
    __threadfence();
  }

  // ---- the last block to finish reads the maxima: the barrier orders the
  // block's fenced partials before thread 0's ticket
  __syncthreads();
  if (t == 0) {
    __threadfence();
    const int last = atomicAdd(a.ticket, 1) == blocks - 1;
    if (last) *a.ticket = 0;  // ready for the next call
    s_last = last;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int m = t; m < k; m += kRows) {
    // read the maximum and leave 0 for the next call
    const unsigned long long top = atomicExch(keys + m, 0ull);
    const int row = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(top));
    const size_t o = static_cast<size_t>(row / kRows % blocks) * k + m;
    a.gains[m] = __ldcg(part_gain + o);
    a.picks[m] = row;
    a.dests[m] = __ldcg(part_dest + o);
  }
}

// Blocks that fit on the card at once for `kernel` (its rows a block and
// `smem` bytes of dynamic shared memory) on device `dev`, into `blocks`:
// kernel 5's grid, so each block merges several tiles' elections before it
// publishes them.
cudaError_t resident_blocks(void (*kernel)(EdgeArgs), size_t smem, int dev,
                            int* blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kRows, smem);
  *blocks = sms * per_sm;
  if (err == cudaSuccess && *blocks < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

// Devices whose resident-block counts launch<> keeps; beyond them it asks
// the runtime on every launch.
constexpr int kMaxDevices = 64;

template <int KT>
int launch(const EdgeArgs& a, bool sweep, cudaStream_t stream) {
  void (*kernel)(EdgeArgs) = sweep ? sweep_candidates_from_edges_kernel<KT>
                                   : dissat_from_edges_kernel<KT>;
  const size_t smem = smem_bytes(kInRegisters<KT>, a.k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (a.n + kRows - 1) / kRows;
  int grid = tiles;
  if (sweep) {
    // the count for this device and K (smem varies with the runtime K),
    // kept after the first launch; a race stores the same value twice
    static std::atomic<int> known[kMaxDevices][kMaxK + 1];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    std::atomic<int>* slot =
        dev < kMaxDevices ? &known[dev][a.k] : nullptr;
    int blocks = slot != nullptr ? slot->load(std::memory_order_relaxed) : 0;
    if (blocks == 0) {
      err = resident_blocks(kernel, smem, dev, &blocks);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (slot != nullptr) slot->store(blocks, std::memory_order_relaxed);
    }
    grid = min(tiles, blocks);
  }
  kernel<<<grid, kRows, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Checks the operands and launches on the instance of a.k: the K with a
// compile-time instance are SPECIALISED_K in edge_block.py, any other K
// takes the runtime-K instance.
int launch_edges(const EdgeArgs& a, bool sweep, void* stream) {
  if (a.k < 1 || a.k > kMaxK || a.n < 1 || a.e_total < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.k) {
    case 8: return launch<8>(a, sweep, s);
    case 16: return launch<16>(a, sweep, s);
    default: return launch<0>(a, sweep, s);
  }
}

}  // namespace

extern "C" {

int dissat_from_edges(const int* row_start, const int* receivers,
                      const float* weights, const int* assignment,
                      const float* b_rows, const float* theta,
                      const float* loads, const float* speeds,
                      const float* mu, const float* total_b, float* dissat,
                      int* best, int n, int e_total, int k, int framework,
                      void* stream) {
  return launch_edges({row_start, receivers, weights, assignment, b_rows,
                       theta, loads, speeds, mu, total_b, dissat, best,
                       nullptr, nullptr, nullptr, nullptr, nullptr, n,
                       e_total, k, framework},
                      false, stream);
}

int sweep_candidates_from_edges(const int* row_start, const int* receivers,
                                const float* weights, const int* assignment,
                                const float* b_rows, const float* theta,
                                const float* loads, const float* speeds,
                                const float* mu, const float* total_b,
                                float* gains, int* picks, int* dests,
                                int* partial, int* ticket, int n,
                                int e_total, int k, int framework,
                                void* stream) {
  if (partial == nullptr || ticket == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_edges({row_start, receivers, weights, assignment, b_rows,
                       theta, loads, speeds, mu, total_b, nullptr, nullptr,
                       gains, picks, dests, partial, ticket, n, e_total, k,
                       framework},
                      true, stream);
}

}  // extern "C"
