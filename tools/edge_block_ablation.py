"""Where kernels 4 and 5 spend their time on the card: text variants of
``src/repro_torch/kernels/csrc/edge_block.cu`` built side by side with the
repo's nvcc flags and timed in turns (CUDA events around loops that only
call the C entry points, then each variant's device time and device
launches a call by the profiler) on the sparse path's million-node
instance (N=10^6, E=9,002,624, K=8; also K=16 on the same graph):

* how a block stages its edges: plain coalesced loads (the kernel) against
  bulk async copies into a ring of two chunks or one, and chunks of 512 or
  2048 edges against 1024;
* where a row's accumulators live: registers (template K) against
  shared-memory slots, and the runtime-K instance;
* kernel 5's per-warp election by two warp reductions against an xor
  butterfly of shuffles;
* rows a block (64 / 128 / 256);
* ``baseline``: the design this one replaced, copied below; its kernel 5
  timed as its wrapper ran it, the kernel's (T, K) partials then ``max``,
  ``argmax`` and two ``gather`` calls;
* two floors: a kernel that only sums ``assignment[receivers[e]]`` over
  every edge (the gathers any design makes), and one that only reads the
  receivers and weights.

The 92 MB of inputs exceed the H100's 50 MB L2, so a call finds little of
them left by the call before; the loops do not cycle copies.  Every
variant's outputs are held bitwise against the twins.

  python3 tools/edge_block_ablation.py [variant ...]     # one CUDA card, nvcc
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.core.problem import machine_loads  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import dissatisfaction as D  # noqa: E402
from repro_torch.kernels import edge_block as E  # noqa: E402

ROUNDS = 3
ITERS = 50
KS = (8, 16)
PEAK_BYTES_S = 3.35e12
MIN_ROWS = 64            # the fewest rows a block of any variant


def _rows(n):
    return [("constexpr int kRows = 128;", f"constexpr int kRows = {n};")]


def _chunk(n):
    return [("constexpr int kChunk = 1024;", f"constexpr int kChunk = {n};")]


# Staging by 1-D bulk async copies (cp.async.bulk) instead of plain loads:
# thread 0 lands each chunk's receivers and weights in a ring of kStages
# stages, each completing on its mbarrier (initialised per tile, then
# invalidated), chunk c + kStages issued as soon as chunk c's stage is
# free; the tile's range starts 16-byte aligned, and a copy rounds its
# length up to whole 16-byte units (inside the arrays: E % 4 == 0, and
# the instance's arrays are 16-byte aligned).
_BULK = [
    ('#include "reduce_dissat.cuh"\n',
     '#include "hopper.cuh"\n#include "reduce_dissat.cuh"\n'),
    ("using repro::kMaxK;\n", """using repro::kMaxK;

__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
"""),
    ("constexpr int kChunk = 1024;    // edges a stage holds\n",
     "constexpr int kChunk = 1024;    // edges a stage holds\n"
     "constexpr int kStages = 2;      // chunks in flight\n"),
    ("  return sizeof(int) * 2 * kChunk +",
     "  return sizeof(int) * 2 * kChunk * kStages +"),
    ("  const int e0 = __ldg(a.row_start + r0);",
     "  const int e0 = __ldg(a.row_start + r0) & ~3;"),
    ("""  int* m_c = s_stage;                                  // [kChunk] machines
  float* w_c = reinterpret_cast<float*>(s_stage + kChunk);  // [kChunk]
  float* s_acc = w_c + kChunk;                         // slots, if not kRegs
""", """  int* s_m = s_stage;                                  // [kStages][kChunk]
  float* s_w = reinterpret_cast<float*>(s_stage + kStages * kChunk);
  float* s_acc = s_w + kStages * kChunk;               // slots, if not kRegs
  __shared__ uint64_t s_bar[kStages];
  auto issue = [&](int c) {
    const int lo = e0 + c * kChunk;
    const int len = min(kChunk, e1 - lo);
    const uint32_t bytes = static_cast<uint32_t>((len + 3) & ~3) * 4u;
    const int slot = c % kStages;
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    mbar_expect_tx(&s_bar[slot], 2u * bytes);
    bulk_load_1d(s_m + slot * kChunk, a.receivers + lo, bytes, &s_bar[slot]);
    bulk_load_1d(s_w + slot * kChunk, a.weights + lo, bytes, &s_bar[slot]);
  };
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&s_bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
    for (int c = 0; c < min(chunks, kStages); ++c) issue(c);
  }
  __syncthreads();
"""),
    ("""    int recv[kPerThread];
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
""", """    const int slot = c % kStages;
    int* m_c = s_m + slot * kChunk;
    const float* w_c = s_w + slot * kChunk;
    mbar_wait(&s_bar[slot], (c / kStages) & 1);
    int m[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int j = t + u * kRows;
      m[u] = j < len ? __ldg(a.assignment + m_c[j]) : 0;
    }
"""),
    ("""    __syncthreads();  // the stage is free again
  }
""", """    __syncthreads();  // the stage is free again
    if (t == 0 && c + kStages < chunks) issue(c + kStages);
  }
  if (t == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.inval.shared::cta.b64 [%0];\\n" ::"r"(
                       smem_u32(&s_bar[s]))
                   : "memory");
  }
"""),
]
# the warp's first key by a five-step xor butterfly over (key, idx) pairs
# instead of two warp reductions
_SHUFFLE = [("""  const unsigned top = __reduce_max_sync(kAll, key);
  const int first = __reduce_min_sync(kAll, key == top ? idx : INT_MAX);
""", """  unsigned top = key;
  int first = idx;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned k2 = __shfl_xor_sync(kAll, top, off);
    const int i2 = __shfl_xor_sync(kAll, first, off);
    if (k2 > top || (k2 == top && i2 < first)) {
      top = k2;
      first = i2;
    }
  }
""")]

# name -> (what it changes, [(old text, new text), ...])
VARIANTS = {
    "kernel": ("the source as it is: plain coalesced loads, accumulators in "
               "registers, template K, the election by warp reductions", []),
    "bulk": ("bulk async copies (cp.async.bulk) into a ring of two chunks",
             _BULK),
    "bulk_one_stage": ("bulk async copies, one chunk in flight",
                       _BULK + [("constexpr int kStages = 2; ",
                                 "constexpr int kStages = 1; ")]),
    "chunk_512": ("chunks of 512 edges", _chunk(512)),
    "chunk_2048": ("chunks of 2048 edges", _chunk(2048)),
    "smem_acc": ("accumulators in thread-private shared-memory slots "
                 "(template K kept)",
                 [("constexpr bool kInRegisters = KT > 0;",
                   "constexpr bool kInRegisters = false;")]),
    "runtime_k": ("every K on the runtime-K instance (shared-memory slots)",
                  [("  switch (a.k) {", "  switch (0) {")]),
    "shuffle_election": ("kernel 5's warp firsts by an xor butterfly of "
                         "shuffles", _SHUFFLE),
    "rows_64": ("64 rows a block", _rows(64)),
    "rows_256": ("256 rows a block", _rows(256)),
}

# The floors: only sum assignment[receivers[e]] over every edge (the
# gathers every design must make, and the receivers' read), and only sum
# the receivers and the weights (the edge arrays' read); one int atomicAdd
# a block.
FLOORS = r"""
#include <cuda_runtime.h>
template <bool kGather>
__global__ void floor_kernel(const int* __restrict__ receivers,
                             const int* __restrict__ assignment,
                             const float* __restrict__ weights,
                             int e_total, int* out) {
  int s = 0;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < e_total;
       e += gridDim.x * blockDim.x) {
    const int r = __ldg(receivers + e);
    s += kGather ? __ldg(assignment + r)
                 : r + __float_as_int(__ldg(weights + e));
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(~0u, s, off);
  __shared__ int part[32];
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < blockDim.x / 32; ++w) s += part[w];
    atomicAdd(out, s);
  }
}
extern "C" int edge_floor(const int* receivers, const int* assignment,
                          const float* weights, int e_total, int* out,
                          int blocks, int gather, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gather)
    floor_kernel<true><<<blocks, 256, 0, s>>>(receivers, assignment, weights,
                                              e_total, out);
  else
    floor_kernel<false><<<blocks, 256, 0, s>>>(receivers, assignment,
                                               weights, e_total, out);
  return static_cast<int>(cudaGetLastError());
}
"""

# The design this PR replaced, as it stood: one thread a row walking its
# CSR slab in device memory, K slots in shared memory, K threads electing
# per block, the (T, K) partials combined by the wrapper.
BASELINE = r"""
#include "reduce_dissat.cuh"
namespace {
using repro::kMaxK;
constexpr int kRows = 128;
constexpr float kNegBig = -3.0e38f;
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
  float* s_loads = smem;
  float* s_inv_w = s_loads + k;
  float* s_acc = s_inv_w + k;
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
  float* s_loads = smem;
  float* s_inv_w = s_loads + k;
  float* s_acc = s_inv_w + k;
  float* s_dissat = s_acc + k * kRows;
  int* s_best = reinterpret_cast<int*>(s_dissat + kRows);
  int* s_owner = s_best + kRows;
  repro::load_machine_table(loads, speeds, k, s_loads, s_inv_w);
  __syncthreads();
  const int t = threadIdx.x;
  const int i = blockIdx.x * kRows + t;
  int owner = -1;
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
"""

_P, _I = ctypes.c_void_p, ctypes.c_int
BASELINE_SWEEP_ARGS = [_P] * 13 + [_I] * 4 + [_P]


def _variant_source(src: str, edits) -> str:
    for old, new in edits:
        if new in src and old not in src:     # the source has it already
            continue
        if old not in src:
            raise SystemExit(f"edge_block_ablation: the source no longer "
                             f"holds {old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def _build_all(texts: dict, out: Path) -> dict:
    """One library per source text, all built in parallel; returns name ->
    ctypes library."""
    procs = {}
    for name, text in texts.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out / f"{name}.so"), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"edge_block_ablation: {name} did not build\n"
                             f"{log}")
        regs = [line.strip() for line in log.splitlines() if "Used" in line]
        print(f"  [{name}] {len(regs)} kernels; registers: "
              f"{sorted({line.split('Used ')[1].split(' registers')[0] for line in regs}, key=int)}",
              flush=True)
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def _events_ms(fn, iters) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _profiled_us(fn, key, reps=20):
    """Mean device time (us) of the kernels whose name holds ``key`` per
    call of ``fn``, and the device kernels launched per call, by
    torch.profiler; (None, count) when it recorded no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) is not None
           and str(e.device_type).endswith("CUDA")
           and e.self_device_time_total > 0]
    hits = [e for e in dev if key in e.key]
    total = sum(e.self_device_time_total for e in dev) / reps
    per_call = sum(e.count for e in dev) / reps
    return (total if hits else None), per_call


def _nbytes(n, e, k, sweep) -> int:
    """Each input read once, each output written once."""
    reads = 4 * (n + 2 * e + 2 * n) + 4 * (2 * k + 2)
    return reads + (3 * 4 * k if sweep else 8 * n)


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("variants", nargs="*")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("edge_block_ablation: needs a CUDA card")
    names = args.variants or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: "
                         f"{list(VARIANTS)}")
    names = ["kernel"] + [n for n in names if n != "kernel"]
    import chip_smoke
    card = chip_smoke.smi()
    src = (_build.CSRC / "edge_block.cu").read_text()
    texts = {name: _variant_source(src, VARIANTS[name][1]) for name in names}
    texts["baseline"] = BASELINE
    texts["floors"] = FLOORS
    dev = torch.device("cuda", torch.cuda.current_device())
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_all(texts, Path(tmp))
        sig = _build.SIGNATURES["edge_block"]
        for name in names + ["baseline"]:
            lib = libs[name]
            lib.dissat_from_edges.argtypes = sig["dissat_from_edges"]
            lib.sweep_candidates_from_edges.argtypes = (
                BASELINE_SWEEP_ARGS if name == "baseline"
                else sig["sweep_candidates_from_edges"])
        libs["floors"].edge_floor.argtypes = [_P, _P, _P, _I, _P, _I, _I,
                                              _P]
        sp, r = chip_smoke.sparse_instance(chip_smoke.SPARSE_N,
                                           chip_smoke.SPARSE_K)
        n, e = sp.num_nodes, sp.num_edges
        stream = D._stream(dev)
        sink = torch.zeros(1, dtype=torch.int32, device=dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        floors = {
            f"{kind} floor": (lambda g=gather: libs["floors"].edge_floor(
                sp.receivers.data_ptr(), r.data_ptr(),
                sp.edge_weights.data_ptr(), e, sink.data_ptr(), 8 * sms, g,
                stream))
            for kind, gather in (("gather", 1), ("stream", 0))}
        for k in KS:
            r_k = r if k == chip_smoke.SPARSE_K else torch.as_tensor(
                np.random.default_rng(k).integers(0, k, n).astype(np.int32),
                device=dev)
            b = sp.node_weights
            loads = machine_loads(b, r_k, k)
            speeds = torch.full((k,), 1.0 / k, device=dev)
            sp_k = dataclasses.replace(sp, speeds=speeds)
            mu = D._scalar(sp.mu, dev)
            total = torch.sum(b)
            twin4 = E.dissatisfaction_from_edges_plain(
                sp_k, r_k, b, loads, speeds, mu, "c", total_weight=total)
            twin5 = E.sweep_candidates_from_edges_plain(
                sp_k, r_k, b, loads, speeds, mu, "c", total_weight=total)
            ins = [sp.row_start.data_ptr(), sp.receivers.data_ptr(),
                   sp.edge_weights.data_ptr(), r_k.data_ptr(), b.data_ptr(),
                   None, loads.data_ptr(), speeds.data_ptr(), mu.data_ptr(),
                   total.data_ptr()]
            tail = [n, e, k, 0, stream]
            calls, errs = {}, {}
            for name in names + ["baseline"]:
                lib = libs[name]
                d4 = torch.full_like(b, float("nan"))
                b4 = torch.full_like(r_k, -1)
                a4 = ins + [d4.data_ptr(), b4.data_ptr()] + tail
                if name == "baseline":
                    tg = torch.empty((-(-n // 128), k), device=dev)
                    tn = torch.empty_like(tg, dtype=torch.int32)
                    td = torch.empty_like(tg, dtype=torch.int32)
                    a5 = ins + [tg.data_ptr(), tn.data_ptr(),
                                td.data_ptr()] + tail

                    def k5(lib=lib, a5=a5, tg=tg, tn=tn, td=td):
                        lib.sweep_candidates_from_edges(*a5)
                        win = torch.argmax(tg, dim=0, keepdim=True)
                        return (torch.max(tg, dim=0).values,
                                tn.gather(0, win)[0], td.gather(0, win)[0])
                else:
                    # partials for the most blocks any variant launches
                    a5, views = E.sweep_candidates_args(
                        tuple(ins), n, e, k, 0, stream, dev, rows=MIN_ROWS)

                    def k5(lib=lib, a5=a5, views=views):
                        lib.sweep_candidates_from_edges(*a5)
                        return views
                if lib.dissat_from_edges(*a4) != 0:
                    raise SystemExit(f"edge_block_ablation: {name} did not "
                                     f"launch")
                got5 = k5()
                torch.cuda.synchronize()
                same4 = (torch.equal(d4, twin4[0])
                         and torch.equal(b4, twin4[1]))
                same5 = all(torch.equal(x, y) for x, y in zip(got5, twin5))
                errs[name] = ("bitwise" if same4 and same5 else
                              f"kernel 4 {'bitwise' if same4 else 'DIFFERS'}"
                              f", kernel 5 "
                              f"{'bitwise' if same5 else 'DIFFERS'}")
                calls[f"{name} k4"] = (lambda lib=lib, a4=a4:
                                       lib.dissat_from_edges(*a4))
                calls[f"{name} k5"] = k5
            if errs["kernel"] != "bitwise":
                raise SystemExit(f"edge_block_ablation: the kernel is not "
                                 f"bitwise its twins at K={k}: "
                                 f"{errs['kernel']}")
            calls.update(floors)
            times = {name: [] for name in calls}
            for rnd in range(ROUNDS):
                order = list(calls) if rnd % 2 == 0 else list(calls)[::-1]
                for name in order:
                    times[name].append(_events_ms(calls[name], ITERS))
            b4, b5 = _nbytes(n, e, k, False), _nbytes(n, e, k, True)
            print(f"(N, E, K)=({n}, {e}, {k}): bounds {1e3 * b4 / PEAK_BYTES_S:.5f} "
                  f"ms (kernel 4, {b4 / 1e6:.2f} MB), "
                  f"{1e3 * b5 / PEAK_BYTES_S:.5f} ms (kernel 5, "
                  f"{b5 / 1e6:.2f} MB); C entry-point calls in CUDA-event "
                  f"loops of {ITERS}, {ROUNDS} rounds in turns; device time "
                  f"and device launches a call by the profiler over 20 "
                  f"calls [{card}]", flush=True)
            for name in calls:
                t = times[name]
                key = ("floor_kernel" if name.endswith("floor") else
                       "dissat_from_edges" if name.endswith("k4") else
                       "sweep_candidates")
                us, per_call = _profiled_us(calls[name], key)
                variant = name.rsplit(" ", 1)[0]
                what = ("PR 12's design (kernel 5 with its wrapper's "
                        "combine)" if variant == "baseline" else
                        "sum of assignment[receivers[e]] over all edges"
                        if name == "gather floor" else
                        "sum of receivers and weights (72 MB)"
                        if name == "stream floor" else VARIANTS[variant][0])
                bound = (b4 if name.endswith("k4") else b5) / PEAK_BYTES_S
                print(f"  {name:16s} {np.mean(t):.5f} ms "
                      f"({' '.join(f'{x:.5f}' for x in t)})  bound share "
                      f"{1e3 * bound / np.mean(t):.3f}  profiler "
                      f"{'no record' if us is None else f'{us:.2f} us'}, "
                      f"{per_call:.1f} launches a call  "
                      f"{errs.get(variant, '')}  {what}", flush=True)
            for kind in ("gather", "stream"):
                ms = float(np.mean(times[f"{kind} floor"]))
                print(f"  {kind} floor: {e} edges, {e / ms / 1e6:.2f} G "
                      f"edges/s, {8 * e / ms / 1e6:.1f} GB/s of 8 bytes an "
                      f"edge", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
