"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch twin, drives the dense partition game
end to end at N=16384, K=16, the sparse sweep runtime at the reference's
million-node instance (N=10^6, E=9,002,624, K=8), the batched fleets
(32 dense problems of N=4096, K=16; 4 sparse ones of N=65536, K=8), the
dense LM serving path (qwen1.5-4b at full width, 48 requests through the
continuous-batching engine) and the SSM serving path (mamba2-1.3b at full
width, the same traffic), times every kernel, and checks the results.

  python3 chip_smoke.py          # needs one CUDA card and nvcc

Phases (any failure exits non-zero; there is no CPU fallback):
  1. device — the card, its power limit, provenance, and the kernels'
     build report (registers, shared memory, spills);
  2. dense kernels vs twins on the card — kernel 1 (dissatisfaction from
     the aggregate) bitwise against its twin, kernel 2 (cost matrix)
     within a stated tolerance; full N, a ragged N and a row block; kernel
     1 also at every K it has an instance for (2, 4, ..., 128, and 3, 17,
     100 on the runtime-K one) with rows on and off the 16-byte grid, and
     at the sparse refine's (N, K) = (10^6, 8);
  3. the dense main path — problem from seeds, Appendix-A initial
     partition, incremental ``refine`` (kernel 1) to a checked
     equilibrium, then the recompute path (kernel 2) for a bounded number
     of turns from the same start, with each kernel's launch count;
  4. dense times — CUDA events per kernel at the main path's shapes,
     beside its twin, the least time the card could take (bound), and a
     library call; kernel 1 three ways (events over wrapper calls, events
     over C entry-point calls, the profiler's device time), each loop
     cycling through operand copies four times the L2, also at (10^6, 8)
     beside its bound;
  5. where a dense turn's time goes (torch.profiler);
  6. sparse set-up — the reference's million-node instance
     (``benchmarks/sparse_bench.py``: ``random_degree_graph_edges(10^6,
     seed=0)``, weights seed 1, K=8 equal speeds, mu=8, r0 from
     ``default_rng(2)``), checked against the reference's edge count and
     max degree;
  7. edge kernels vs twins on the card — kernel 4 (dissatisfaction from
     edges) bitwise against its twin and against kernel 1 on the sparse
     aggregate, kernel 5 (sweep election) bitwise against its twin and the
     first-maximum election from kernel 4; full N and a ragged N;
  8. the sparse main path — (a) unbounded ``refine_sweeps`` with the
     adaptive coin (kernel 4 per sweep) to an ε-equilibrium, twice with
     the same seed (bitwise equal; the second run profiled for the device's
     busy share); (b) 256 degenerate sweeps on kernel 5 against the same
     sweeps on kernel 4; (c) sparse ``refine`` (kernel 1 over the carried
     aggregate) for 2048 turns with ``verify_every``;
  9. sparse times — kernels 4 and 5 at N=10^6, K=8;
 10. fleet set-up and kernel 3 — 32 dense problems of N=4096, K=16 with
     ``benchmarks/batch_study.py``'s per-element draws, stacked on the
     card; kernel 3 (dissatisfaction over a (B, rows, K) stack) bitwise
     against its twin and against kernel 1 on every element, at the fleet
     shape, a ragged (3, 1003, 8), (2, 300, 128) and (2, 129, 17), both
     frameworks, θ absent and 0.5; its times, three ways as kernel 1's;
 11. the dense fleet — ``run_sweep(mode="refine", use_kernel=True)``
     (one batched loop, kernel 3 per turn) to 32 checked equilibria;
     elements 0, 13 and 31 run alone through ``refine`` equal the fleet
     bitwise; kernel 3 launched once per batched turn and kernel 1 never;
     element-turns per second batched against looped; a profiled window
     of 256 batched turns;
 12. the sparse fleet — 4 weightings of ``random_degree_graph_edges(65536,
     seed=0)``: kernel 3 bitwise against its twin and kernel 1 on the
     fleet's initial sparse carry; 2048 batched ``refine`` turns, each
     element bitwise its looped run; then the same cases under ``mode="multimove"``
     (unbounded, move_prob 0.5, ε=1e-3, 24 sweeps), each bitwise a lone
     ``refine_sweeps`` with the generator derived for its index;
 13. attention kernels vs twins on the card — kernel 6 (decode attention,
     split over the cache's positions) at (B, H, Hkv, D, S) = (16, 20, 20,
     128, 4096), (4, 32, 8, 128, 1000), (3, 8, 1, 64, 777) and (16, 32, 32,
     112, 4096) with ragged lengths (one above S, clamped), then at G = 7
     (8, 56, 8, 128, 4096), G = 8 with D = 112 (4, 64, 8, 112, 1500), G =
     48 (4, 48, 1, 128, 4096) and D = 100 (8, 16, 16, 100, 777; the
     instance without TMA)
     with lengths of one split, on a split border and one past it, 1 and
     above S, each called twice and the two outputs equal bitwise; kernel
     7 (causal flash attention; bf16
     on the tensor-core kernel, f32 on the CUDA-core one) at (B, S, H, Hkv,
     D) = (1, 3072, 20, 20, 128), (2, 1000, 32, 8, 128), (1, 333, 8, 1,
     64), (1, 3072, 32, 32, 112), (2, 1000, 32, 8, 96) and (1, 130, 14, 2,
     100); f32 and bf16 within stated tolerances; refused launches raise;
 14. full-width serving — qwen1.5-4b's published config (40 layers,
     d_model 2560, vocab 151936, f32 parameters, bf16 compute), weights
     from ``init_params`` with a seeded generator on the card,
     ``ServeConfig(max_batch=16, max_len=4096, cache_dtype="bfloat16")``,
     48 greedy requests with prompts of 512-3072 tokens from
     ``default_rng(0)`` and 64 new tokens each: every request complete,
     every logit finite, kernel 7 launched 40 x 48 times, kernel 6 40 x
     decode steps, no twin; prefill tokens/s, ms per decode step,
     generated tok/s, and a profiled window of 8 decode steps;
 15. kernel path vs plain path at full width — one bf16 decode step of
     phase 14's engine on both paths; then f32 compute, the same weights,
     2 slots, max_len 1024, prompts of 500 and 900 tokens, 16 new tokens:
     equal tokens, logits within a stated tolerance;
 16. attention times — kernels 6 and 7 at the serving shapes beside their
     bound, their twins and ``scaled_dot_product_attention``, measured in
     turns; the device time of each from CUDA events around a loop that
     only calls the kernel's C entry point; kernel 6's split, blocks
     launched and live blocks at the serving shape, and its time at
     yi-34b's heads (16, 56, 8, 128, 4096) for information; kernel 7's f32
     instance at the same shape;
 17. kernel 8 (the SSD scan) vs its twin on the card — (B, L, H, P, N) =
     (1, 3072, 64, 64, 128) with bf16 x/bm/cm (the serving shape; on the
     tensor-core kernel) from zeros and from an initial state, (2, 1001,
     ...) in f32 (the CUDA-core kernel), (2, 777, ...) from an initial
     state, L = 1, 255, 256 and 257 around the bf16 kernel's chunk, P = 33
     with N = 24 and N = 5 (padded by the wrapper), with the Mamba2
     initialisation's decays, within a tolerance relative to the largest
     value; refused launches raise (the bf16 kernel's width limit among
     them), and the next one is clean in f32 and in bf16;
 18. full-width SSM serving — mamba2-1.3b's published config (48 layers,
     d_model 2048, 64 heads of 64, state 128, chunk 256, vocab 50280,
     tied embeddings, f32 parameters, bf16 compute), weights from
     ``init_params`` with a seeded generator on the card, phase 14's
     ``ServeConfig`` and traffic: every request complete, every logit
     finite, kernel 8 launched 48 x prefills times, no twin; prefill
     tokens/s, ms per decode step, generated tok/s, and a profiled window
     of 8 decode steps;
 19. SSM kernel path vs plain path at full width — f32 compute, the same
     weights, prompts of 500 and 900 tokens: equal tokens, logits within a
     stated tolerance; one bf16 prefill of 3072 tokens and one decode step
     on both paths, no further apart than bf16 compute moves the plain
     path from f32 compute on the same input; kernel 8's times at the
     serving shape beside its bound (bytes; its products at the bf16
     tensor-core peak) and its twin, the device time of its three passes
     from CUDA events around a loop that only calls the C entry point, each
     pass's share by the profiler, and the f32 instance at the same shape.

Each path's launch counts are set to 0 just before it and read just after.
The line before the last two is the kernels' JSON record; then the card's
name and power limit; the last line is ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

N = 16384                 # nodes of the main path
K = 16                    # machines
MU = 8.0
SEED = 0
RECOMPUTE_TURNS = 200     # bounded recompute-path run (kernel 2 per turn)
KERNEL2_RTOL = 1e-5       # kernel 2 vs twin: |got - want| <= rtol*max(|want|, 1)

# the sparse path: the reference's million-node row (BENCH_sparse.json)
SPARSE_N = 1_000_000
SPARSE_K = 8
SPARSE_EDGES = 9_002_624  # padded directed edges the reference recorded
SPARSE_MAX_DEGREE = 24
SWEEP_CFG = dict(moves_per_machine=None, move_prob=0.5, epsilon=1e-3)
SWEEP_CAP = 24            # sweeps allowed to reach the ε-equilibrium
DEGENERATE_SWEEPS = 256   # run (b): kernel 5 against kernel 4
SPARSE_TURNS = 2048       # run (c): sparse refine, kernel 1 per turn
SPARSE_VERIFY = 512
# bytes of operand copies a timing loop of kernels 1 and 3 cycles
# through: four times the H100's 50 MB L2, so no call finds its inputs
# left in L2 by the call before
COLD_BYTES = 200_000_000

# the fleets: benchmarks/batch_study.py's per-element draws at the repo's
# dense width
FLEET_B = 32
FLEET_N = 4096
FLEET_K = 16
FLEET_MAX_TURNS = 10_000
FLEET_LOOPED = (0, 13, 31)       # elements also run alone through refine
FLEET_PROFILE_TURNS = 256
SPARSE_FLEET_B = 4
SPARSE_FLEET_N = 65536
SPARSE_FLEET_K = 8
SPARSE_FLEET_TURNS = 2048
SPARSE_FLEET_SWEEPS = 24

# the dense LM serving path: qwen1.5-4b's published config unchanged
LM_ARCH = "qwen1.5-4b"
SERVE_SLOTS = 16
SERVE_MAX_LEN = 4096
SERVE_REQUESTS = 48
SERVE_PROMPT = (512, 3072)  # prompt lengths, uniform, from default_rng(SEED)
SERVE_NEW = 64
PROFILE_STEPS = 8           # profiled engine decode steps at full occupancy
PARITY_PROMPTS = (500, 900)  # phase 15, f32 compute, kernel vs plain path
PARITY_NEW = 16
PARITY_MAX_LEN = 1024
# (B, H, Hkv, D, S) and (B, S, H, Hkv, D) of phase 13; head_dim 112 is
# zamba2-7b's, 96 is not a power of two and 100 not a multiple of 8 (the
# bf16 kernel 7 then pads it)
DECODE_SHAPES = ((16, 20, 20, 128, 4096), (4, 32, 8, 128, 1000),
                 (3, 8, 1, 64, 777), (16, 32, 32, 112, 4096))
# kernel 6's split-S cases of phase 13, (B, H, Hkv, D, S): G = 7 (yi-34b's
# head layout), G = 8 at zamba2-7b's D = 112, G = 48 (granite-34b's: each
# warp keeps several (row, part) states in shared memory), and D = 100 (no
# multiple of 8: the instance that stages without TMA); each row's length
# is one split, a split border, one past it, 1, above S, S, ...
DECODE_SPLIT_SHAPES = ((8, 56, 8, 128, 4096), (4, 64, 8, 112, 1500),
                       (4, 48, 1, 128, 4096), (8, 16, 16, 100, 777))
# kernel 6 at a GQA shape in phase 16, for information: yi-34b's heads
DECODE_GQA_SHAPE = (16, 56, 8, 128, 4096)
FLASH_SHAPES = ((1, 3072, 20, 20, 128), (2, 1000, 32, 8, 128),
                (1, 333, 8, 1, 64), (1, 3072, 32, 32, 112),
                (2, 1000, 32, 8, 96), (1, 130, 14, 2, 100))
# kernel vs twin, |diff| <= atol + rtol * |want|: f32 sums the same
# products in another order; bf16 adds one rounding of the output (2^-7
# relative at most)
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 1e-3)}
# logits of the kernel path vs the plain path, as max |diff| over
# max(1, max |logit|): f32 compute (rounding order only), and one bf16
# decode step (bf16 rounding of the attention output, through 40 layers)
F32_LOGIT_TOL = 1e-3
BF16_STEP_TOL = 5e-2

# the SSM serving path: mamba2-1.3b's published config unchanged, phase
# 14's traffic
SSM_ARCH = "mamba2-1.3b"
SSD_CHUNK = 256             # the config's ssm_chunk: the twin's chunk
# (B, L, H, P, N, dtype of x/bm/cm, initial state) of phase 17; the first
# is the serving shape (the longest prompt at mamba2-1.3b's widths).  The
# bf16 kernel's chunk is 256 steps: L = 1, 255, 256, 257 straddle it; P =
# 33, N = 24 and N = 5 are widths the wrapper pads to multiples of 8
SSD_SHAPES = ((1, 3072, 64, 64, 128, torch.bfloat16, False),
              (2, 1001, 64, 64, 128, torch.float32, False),
              (2, 777, 64, 64, 128, torch.bfloat16, True),
              (1, 3072, 64, 64, 128, torch.bfloat16, True),
              (2, 500, 8, 33, 24, torch.bfloat16, True),
              (1, 300, 8, 64, 5, torch.bfloat16, False),
              (1, 1, 64, 64, 128, torch.bfloat16, True),
              (1, 255, 64, 64, 128, torch.bfloat16, True),
              (1, 256, 64, 64, 128, torch.bfloat16, False),
              (1, 257, 64, 64, 128, torch.bfloat16, True))
# kernel 8 vs twin: max |diff| <= SSD_TOL * max(1, max |want|), for y and
# the final state each -- the reference's tolerance between two chunkings
# of the scan (tests/test_kernels.py), against the largest value; bf16
# inputs are widened exactly on both sides, so they need no more
SSD_TOL = 3e-4

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
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


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain twin on the card
# ---------------------------------------------------------------------------

def check_kernel1(D, agg, r, b, loads, speeds, mu, total_b, theta, label):
    """Kernel 1 vs twin: best exactly equal, dissat bitwise equal."""
    err = 0.0
    for fw in ("c", "ct"):
        for th in (None, theta):
            got = D.dissatisfaction_from_aggregate_cuda(
                agg, r, b, loads, speeds, mu, fw, theta=th,
                total_weight=total_b)
            want = D.dissatisfaction_from_aggregate_plain(
                agg, r, b, loads, speeds, mu, fw, theta=th,
                total_weight=total_b)
            torch.cuda.synchronize()
            if not torch.equal(got[1], want[1]):
                fail(f"kernel 1 best != twin ({label}, {fw}, "
                     f"theta={th is not None})")
            if not torch.equal(got[0], want[0]):
                fail(f"kernel 1 dissat not bitwise equal to twin ({label}, "
                     f"{fw}, theta={th is not None}): max |diff| "
                     f"{float((got[0] - want[0]).abs().max())}")
            err = max(err, float((got[0] - want[0]).abs().max()))
    log(f"  kernel 1 {label}: rows={agg.shape[0]} K={agg.shape[1]}: best "
        f"equal, dissat bitwise equal (c, ct; theta absent and 0.5)")
    return err


def check_kernel2(D, adj, r_cols, r_rows, b, loads, speeds, mu, total_b,
                  label):
    """Kernel 2 vs twin, within KERNEL2_RTOL: the twin's aggregate is a
    cuBLAS product, the kernel's a lane-strided fixed-order sum, so the
    two round differently."""
    err = 0.0
    for fw in ("c", "ct"):
        got = D.cost_matrix_cuda(adj, r_cols, b, loads, speeds, mu, fw,
                                 row_assignment=r_rows, total_weight=total_b)
        want = D.cost_matrix_plain(adj, r_cols, b, loads, speeds, mu, fw,
                                   row_assignment=r_rows,
                                   total_weight=total_b)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        bound = KERNEL2_RTOL * want.abs().clamp(min=1.0)
        if not bool(torch.isfinite(got).all()) or bool((diff > bound).any()):
            fail(f"kernel 2 vs twin beyond tolerance ({label}, {fw}): max "
                 f"|diff| {float(diff.max())}")
        err = max(err, float(diff.max()))
        log(f"  kernel 2 {label} {fw}: {tuple(got.shape)} max |diff| "
            f"{float(diff.max()):.3e}, max rel "
            f"{float((diff / want.abs().clamp(min=1.0)).max()):.3e} "
            f"(tolerance rtol {KERNEL2_RTOL})")
    return err


def _random_rows(rng, n, k, offset=0, device="cuda"):
    """Kernel 1's operands from ``rng``: a random (n, K) aggregate whose
    data starts ``offset`` floats into its buffer (an offset that is not a
    multiple of 4 puts every row off the 16-byte grid), the loads of a
    random assignment, random speeds, mu and theta = 0.5."""
    from repro_torch.core.problem import machine_loads
    flat = torch.as_tensor(rng.uniform(0, 50, n * k + offset)
                           .astype(np.float32), device=device)
    agg = flat[offset:].view(n, k)
    r = torch.as_tensor(rng.integers(0, k, n).astype(np.int32),
                        device=device)
    b = torch.as_tensor(rng.uniform(0.1, 10, n).astype(np.float32),
                        device=device)
    sp = rng.uniform(0.5, 2.0, k)
    speeds = torch.as_tensor((sp / sp.sum()).astype(np.float32),
                             device=device)
    mu = torch.tensor(MU, dtype=torch.float32, device=device)
    theta = torch.full((n,), 0.5, device=device)
    return (agg, r, b, machine_loads(b, r, k), speeds, mu, torch.sum(b),
            theta)


def dissat_entry(D, agg, r, b, loads, speeds, mu, total_b):
    """A launch of kernel 1 (2-D ``agg``) or kernel 3 (3-D) through its C
    entry point alone, framework c, no theta: returns (call, outputs); the
    call skips the wrapper and adds nothing to the launch counts."""
    batched = agg.ndim == 3
    out = (torch.empty_like(b), torch.empty_like(r))
    args = ([t.data_ptr() for t in (agg, r, b)] + [None]
            + [t.data_ptr() for t in (loads, speeds, mu, total_b, *out)]
            + [*agg.shape, 0, torch.cuda.current_stream().cuda_stream])
    fn = D._entry_point("dissat_from_aggregate_batched" if batched
                        else "dissat_from_aggregate")

    def call():
        if fn(*args) != 0:
            fail("a launch-only call of kernel 1 or 3 was refused")
    return call, out


def phase_kernels(D, ops, problem, rng):
    dev = problem.device
    r = torch.as_tensor(rng.integers(0, K, N).astype(np.int32), device=dev)
    b = problem.node_weights
    total_b = torch.sum(b)
    from repro_torch.core.problem import machine_loads
    loads = machine_loads(b, r, K)
    agg = problem.adjacency @ (r.long()[:, None] == torch.arange(
        K, device=dev)).float()
    theta = torch.full((N,), 0.5, device=dev)
    err1 = check_kernel1(D, agg, r, b, loads, problem.speeds, problem.mu,
                         total_b, theta, "full N")
    lo, hi = 4096, 4096 + 3001                       # ragged row block
    err1 = max(err1, check_kernel1(
        D, agg[lo:hi].contiguous(), r[lo:hi].contiguous(),
        b[lo:hi].contiguous(), loads, problem.speeds, problem.mu, total_b,
        theta[lo:hi].contiguous(), "row block [4096, 7097) with global B"))
    # a ragged N of its own, random aggregate
    n2 = 1003
    agg2 = torch.as_tensor(rng.uniform(0, 50, (n2, K)).astype(np.float32),
                           device=dev)
    r2 = torch.as_tensor(rng.integers(0, K, n2).astype(np.int32), device=dev)
    b2 = torch.as_tensor(rng.uniform(0.1, 10, n2).astype(np.float32),
                         device=dev)
    loads2 = machine_loads(b2, r2, K)
    err1 = max(err1, check_kernel1(
        D, agg2, r2, b2, loads2, problem.speeds, problem.mu, torch.sum(b2),
        torch.full((n2,), 0.5, device=dev), "ragged N=1003"))

    # every instance: the specialised K and the runtime-K one, rows on and
    # off the 16-byte grid
    for k in sorted(set(D.SPECIALISED_K) | {3, 17, 100}):
        for offset in (0, 1):
            *ops_k, th_k = _random_rows(rng, n2, k, offset)
            err1 = max(err1, check_kernel1(D, *ops_k, th_k,
                                           f"N={n2} K={k} offset {offset}"))
    # the sparse refine's shape (phase 8c)
    *ops_s, th_s = _random_rows(rng, SPARSE_N, SPARSE_K)
    err1 = max(err1, check_kernel1(D, *ops_s, th_s,
                                   f"(N, K)=({SPARSE_N}, {SPARSE_K})"))
    del ops_s, th_s

    err2 = check_kernel2(D, problem.adjacency, r, r, b, loads,
                         problem.speeds, problem.mu, total_b, "full (N, N)")
    rows = slice(2048, 2048 + 1500)
    err2 = max(err2, check_kernel2(
        D, problem.adjacency[rows].contiguous(), r, r[rows].contiguous(),
        b[rows].contiguous(), loads, problem.speeds, problem.mu, total_b,
        "row block (1500, N) with global B"))
    ref = ops.cost_matrix_reference(problem.adjacency, r, b, loads,
                                    problem.speeds, problem.mu, "c")
    got = ops.cost_matrix(problem.adjacency, r, b, loads, problem.speeds,
                          problem.mu, "c")
    rel = float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())
    if rel > KERNEL2_RTOL:
        fail(f"kernel 2 vs the reference oracle: max rel {rel}")
    log(f"  kernel 2 vs cost_matrix_ref (c): max rel {rel:.3e}")
    return err1, err2


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

class Recording:
    """Wraps a refine seam (``dissat_fn`` or ``cost_matrix_fn``) and keeps a
    device copy of the assignment each of the first ``limit`` turns sees,
    so the per-turn moves can be read back after the run."""

    def __init__(self, fn, limit: int, state_arg: bool):
        self.fn, self.limit, self.state_arg = fn, limit, state_arg
        self.seen: list[torch.Tensor] = []
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1
        if len(self.seen) < self.limit:
            r = args[1].assignment if self.state_arg else args[1]
            self.seen.append(r.clone())
        return self.fn(*args)

    def moves(self, final: torch.Tensor) -> list[tuple[int, int] | None]:
        """(node, dest) per recorded turn, None where nothing moved.  The
        run's ``final`` assignment follows the last recorded turn only if
        every turn was recorded."""
        seq = self.seen + ([final] if self.calls == len(self.seen) else [])
        out = []
        for before, after in zip(seq[:-1], seq[1:]):
            changed = torch.nonzero(before != after).flatten().tolist()
            if len(changed) > 1:
                fail(f"one turn moved {len(changed)} nodes")
            out.append((changed[0], int(after[changed[0]])) if changed
                       else None)
        return out


def phase_main(D, ops, problem):
    from repro_torch.core import costs
    from repro_torch.core.initial import initial_partition
    from repro_torch.core.problem import PartitionProblem, make_state
    from repro_torch.core.refine import DEFAULT_TOL, refine

    D.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r0 = initial_partition(problem.adjacency, K, generator=SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    sizes = torch.bincount(r0.long(), minlength=K).tolist()
    log(f"  initial_partition: {t_init:.3f} s, cluster sizes {sizes}")
    c0_0 = float(costs.global_cost_c0(problem, r0))
    ct0_0 = float(costs.global_cost_ct0(problem, r0))
    log(f"  initial  C_0 = {c0_0:.6e}  Ct_0 = {ct0_0:.6e}")

    inc = Recording(ops.make_aggregate_dissat_fn(), RECOMPUTE_TURNS + 1,
                    state_arg=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = refine(problem, r0, "c", max_turns=400_000, dissat_fn=inc)
    moves, turns = int(res.num_moves), int(res.num_turns)
    converged = bool(res.converged)
    wall = time.perf_counter() - t0
    r = res.assignment
    c0_1 = float(costs.global_cost_c0(problem, r))
    ct0_1 = float(costs.global_cost_ct0(problem, r))
    log(f"  refine (incremental, kernel 1): {moves} moves in {turns} turns, "
        f"converged={converged}, {wall:.3f} s, "
        f"{1e3 * wall / max(turns, 1):.4f} ms per turn")
    log(f"  refined  C_0 = {c0_1:.6e}  Ct_0 = {ct0_1:.6e}")
    if not converged:
        fail("incremental refine did not converge")
    if not (c0_1 < c0_0):
        fail("C_0 did not descend")
    # Nash (Eq. 3) on a fresh rebuild: the carried aggregate and a rebuilt
    # one differ by f32 rounding, so allow 4 ULP of the largest cost
    cost = costs.cost_matrix(problem, make_state(problem, r), "c")
    dis, _ = costs.dissatisfaction_from_cost(cost, r)
    worst = float(dis.max())
    slack = DEFAULT_TOL + 4 * float(torch.finfo(torch.float32).eps) \
        * float(cost.abs().max())
    log(f"  Nash check: max dissatisfaction {worst:.3e} (bound {slack:.3e})")
    if not worst <= slack:
        fail("the refined assignment is not an equilibrium")

    rec = Recording(ops.make_core_cost_matrix_fn(), RECOMPUTE_TURNS,
                    state_arg=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res2 = refine(problem, r0, "c", max_turns=RECOMPUTE_TURNS,
                  cost_matrix_fn=rec)
    moves2, turns2 = int(res2.num_moves), int(res2.num_turns)
    wall2 = time.perf_counter() - t0
    log(f"  refine (recompute, kernel 2): {moves2} moves in {turns2} turns, "
        f"{1e3 * wall2 / max(turns2, 1):.4f} ms per turn")
    # C_0 must descend on every accepted move; evaluated in float64 so the
    # sum over N node costs does not round away a small gain
    p64 = PartitionProblem(problem.adjacency.double(),
                           problem.node_weights.double(),
                           problem.speeds.double(), problem.mu.double())
    seq = rec.seen + [res2.assignment]
    c0s = [float(costs.global_cost_c0(p64, a)) for a in seq]
    rec_moves = rec.moves(res2.assignment)
    for t, mv in enumerate(rec_moves):
        if mv is not None and not c0s[t + 1] < c0s[t]:
            fail(f"recompute path: C_0 rose on the move at turn {t}: "
                 f"{c0s[t]} -> {c0s[t + 1]}")
    inc_moves = inc.moves(r)[:len(rec_moves)]
    same = 0
    for a, b in zip(rec_moves, inc_moves):
        if a != b:
            break
        same += 1
    log(f"  recompute path: C_0 descended on all "
        f"{sum(m is not None for m in rec_moves)} moves; first {same} of "
        f"{len(rec_moves)} turns equal the incremental path's")
    launches = dict(D.launches)
    log(f"  launches over the main path: {launches}")
    for name in ("dissat_from_aggregate", "cost_matrix"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    return {"r": r, "r0": r0, "launches": launches, "moves": moves,
            "turns": turns,
            "wall_s": wall, "ms_per_turn": 1e3 * wall / max(turns, 1),
            "recompute_ms_per_turn": 1e3 * wall2 / max(turns2, 1),
            "equal_leading_turns": same, "init_s": t_init,
            "c0": (c0_0, c0_1), "ct0": (ct0_0, ct0_1), "nash": worst}


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

def kernel_device_us(calls: dict, attempts: int = 3,
                     keys: dict | None = None) -> dict:
    """Mean device time (us) of each kernel, by the profiler: ``calls``
    maps a kernel name to (function launching it, repetitions), and the
    profiler's record is the one whose key holds ``keys[name]`` (default
    ``<name>_kernel``).  A window in which the profiler recorded none of
    the kernel's launches is taken again, up to ``attempts`` windows;
    after that the time is None and the device keys of the last window are
    logged."""
    from torch.profiler import ProfilerActivity, profile
    keys = keys or {}
    out = {}
    for name, (fn, reps) in calls.items():
        key = keys.get(name, f"{name}_kernel")
        fn()
        torch.cuda.synchronize()
        out[name] = None
        for _ in range(attempts):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            hits = [e for e in prof.key_averages() if key in e.key]
            count = sum(e.count for e in hits)
            if count:
                out[name] = sum(e.self_device_time_total
                                for e in hits) / count
                break
        else:
            seen = [(e.key[:60], e.count) for e in prof.key_averages()
                    if e.self_device_time_total > 0]
            log(f"  the profiler saw no {key} in {attempts} "
                f"window(s); device keys of the last: {seen}")
    return out


def _rows_bytes(bsz, n, k) -> int:
    """Kernels 1 and 3: A, r, b, loads, speeds, mu and B read once, dissat
    and best written once (B = 1 for kernel 1)."""
    f4, i4 = 4, 4
    return f4 * bsz * n * k + i4 * bsz * n + f4 * bsz * n \
        + 2 * f4 * bsz * k + 2 * f4 * bsz + f4 * bsz * n + i4 * bsz * n


def _bound_ms(byt, flops):
    t_bytes = 1e3 * byt / PEAK_BYTES_S
    t_ops = 1e3 * flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def cold_sets(args, nbytes):
    """``args`` and copies of it, enough that a loop cycling through them
    moves COLD_BYTES: each call then reads its inputs from device memory."""
    copies = max(1, math.ceil(COLD_BYTES / nbytes))
    return [args] + [tuple(t.clone() for t in args)
                     for _ in range(copies - 1)]


def time_dissat_three_ways(D, name, wrapper, arg_sets, iters, label, card):
    """Kernel 1 or 3 timed three ways in turns: CUDA events over wrapper
    calls, CUDA events over C entry-point calls (no wrapper), and the
    kernel's own device time by the profiler.  Each loop cycles through
    ``arg_sets`` (operand tuples as :func:`dissat_entry` takes them), one
    set a call, so the inputs are cold in L2.  Each set's entry-point call
    must launch and equal its wrapper's output bitwise first.  Returns the
    three (ms, ms, us or None)."""
    entries, wrapped = [], []
    for args in arg_sets:
        entry, out = dissat_entry(D, *args)
        entry()
        got = wrapper(*args[:6], "c", total_weight=args[6])
        torch.cuda.synchronize()
        if not (torch.equal(out[0], got[0]) and torch.equal(out[1], got[1])):
            fail(f"{name}: a launch-only call differs from its wrapper's "
                 f"({label})")
        entries.append(entry)
        wrapped.append(lambda a=args: wrapper(*a[:6], "c",
                                              total_weight=a[6]))
    nxt = {"wrapper": 0, "entry": 0}

    def cycling(part, fns):
        def call():
            nxt[part] = (nxt[part] + 1) % len(fns)
            fns[nxt[part]]()
        return call
    calls = {"wrapper": cycling("wrapper", wrapped),
             "entry": cycling("entry", entries)}
    t = {"wrapper": [], "entry": []}
    for order in (("wrapper", "entry"), ("entry", "wrapper"),
                  ("wrapper", "entry")):
        for part in order:
            t[part].append(cuda_ms(calls[part], iters))
    prof = kernel_device_us({name: (calls["entry"], 50)},
                            keys={name: "dissat_from_aggregate_kernel"})[name]
    ms_w, ms_e = float(np.mean(t["wrapper"])), float(np.mean(t["entry"]))
    log(f"  {name} at {label}, {len(arg_sets)} operand set(s) cycled (cold "
        f"L2): {ms_w:.5f} ms per wrapper call "
        f"({' '.join(f'{x:.5f}' for x in t['wrapper'])}), {ms_e:.5f} ms per "
        f"C entry-point call ({' '.join(f'{x:.5f}' for x in t['entry'])}), "
        f"{'no profiler record' if prof is None else f'{prof:.2f} us'} on "
        f"the device by the profiler [{card}]")
    return ms_w, ms_e, prof


def phase_times(D, problem, r, card):
    from repro_torch.core.problem import machine_loads
    dev = problem.device
    b = problem.node_weights
    total_b = torch.sum(b)
    loads = machine_loads(b, r, K)
    onehot = (r.long()[:, None] == torch.arange(K, device=dev)).float()
    agg = problem.adjacency @ onehot
    mu, speeds, adj = problem.mu, problem.speeds, problem.adjacency

    def k1():
        D.dissatisfaction_from_aggregate_cuda(agg, r, b, loads, speeds, mu,
                                              "c", total_weight=total_b)

    def p1():
        D.dissatisfaction_from_aggregate_plain(agg, r, b, loads, speeds, mu,
                                               "c", total_weight=total_b)

    def k2():
        D.cost_matrix_cuda(adj, r, b, loads, speeds, mu, "c",
                           total_weight=total_b)

    def p2():
        D.cost_matrix_plain(adj, r, b, loads, speeds, mu, "c",
                            total_weight=total_b)

    def lib2():
        torch.matmul(adj, onehot)

    # in turns (kernel, twin, twin, kernel) so a drifting clock hits both
    t = {name: [] for name in ("k1", "p1", "k2", "p2", "lib2")}
    for order in (("k1", "p1", "k2", "p2", "lib2"),
                  ("lib2", "p2", "k2", "p1", "k1")):
        for name in order:
            fn = {"k1": k1, "p1": p1, "k2": k2, "p2": p2, "lib2": lib2}[name]
            iters = 200 if name in ("k1", "p1") else 20
            t[name].append(cuda_ms(fn, iters))
    ms = {name: float(np.mean(v)) for name, v in t.items()}
    # kernel 1 three ways: the events above time back-to-back wrapper
    # calls, which a launch-bound kernel runs at the host's rate
    three = time_dissat_three_ways(
        D, "dissat_from_aggregate", D.dissatisfaction_from_aggregate_cuda,
        cold_sets((agg, r, b, loads, speeds, D._scalar(mu, dev), total_b),
                  _rows_bytes(1, N, K)), 400, f"(N, K)=({N}, {K})", card)
    device_us = {"dissat_from_aggregate": three[2],
                 **kernel_device_us({"cost_matrix": (k2, 10)})}

    # kernel 1 at the sparse refine's (N, K) = (10^6, 8) (phase 8c's shape)
    big = _random_rows(np.random.default_rng(SEED + 3), SPARSE_N, SPARSE_K)
    big_sets = cold_sets(big[:7], _rows_bytes(1, SPARSE_N, SPARSE_K))
    w_big, e_big, prof_big = time_dissat_three_ways(
        D, "dissat_from_aggregate", D.dissatisfaction_from_aggregate_cuda,
        big_sets, 50, f"(N, K)=({SPARSE_N}, {SPARSE_K})", card)
    bound_big, by_big = _bound_ms(_rows_bytes(1, SPARSE_N, SPARSE_K),
                                  SPARSE_N * SPARSE_K * 12)
    dev_big = e_big if prof_big is None else 1e-3 * prof_big
    log(f"  dissat_from_aggregate at (N, K)=({SPARSE_N}, {SPARSE_K}): bound "
        f"{bound_big:.5f} ms ({by_big}, "
        f"{_rows_bytes(1, SPARSE_N, SPARSE_K) / 1e6:.2f} MB); device time "
        f"/ bound {dev_big / bound_big:.3f}, per C entry-point call / bound "
        f"{e_big / bound_big:.3f}, per wrapper call / bound "
        f"{w_big / bound_big:.3f} [{card}]")
    del big, big_sets

    nnz = int(torch.count_nonzero(adj))
    f4, i4 = 4, 4
    # kernel 2: reads C, r, b, loads, speeds, mu, B once; writes the costs
    bytes2 = f4 * N * N + i4 * N + f4 * N + 2 * f4 * K + 2 * f4 \
        + f4 * N * K
    ops2 = nnz + N * K * 12      # one add per nonzero, then the assembly
    out = []
    for name, byt, flops, kern, plain, lib, line in (
            ("dissat_from_aggregate", _rows_bytes(1, N, K), N * K * 12,
             ms["k1"], ms["p1"], None, 313),
            ("cost_matrix", bytes2, ops2, ms["k2"], ms["p2"], ms["lib2"],
             115)):
        bound, by = _bound_ms(byt, flops)
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/dissatisfaction.cu",
                    "replaces": f"src/repro/kernels/dissatisfaction.py:{line}",
                    "ms": kern, "plain_ms": plain,
                    "bound_ms": bound, "bound_by": by,
                    "library_ms": lib})
        dev_us = device_us[name]
        log(f"  {name}: kernel {kern:.5f} ms per call ("
            f"{'not measured' if dev_us is None else f'{dev_us:.2f} us'} "
            f"on the device), twin "
            f"{plain:.5f} ms, bound {bound:.5f} ms ({by}), library "
            f"{'null' if lib is None else f'{lib:.5f} ms'}")
    return out


def phase_profile(problem, r0, turns: int = 256):
    """Where a turn's time goes: ``torch.profiler`` over the first
    ``turns`` turns of the incremental loop — device time against wall
    time, and device launches per turn."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.refine import refine
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = refine(problem, r0, "c", max_turns=turns)
        done = int(res.num_turns)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    device_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    if device_us <= 0:
        log("  profiler: no device time recorded (not measured)")
        return None
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    log(f"  profiled {done} turns: wall {1e3 * wall / done:.4f} ms/turn, "
        f"device {device_us / 1e3 / done:.4f} ms/turn, busy share "
        f"{device_us / 1e6 / wall:.4f}, {launches / done:.1f} device "
        f"launches per turn")
    for e in top:
        log(f"    {e.key[:60]:60s} {e.count:6d} x "
            f"{e.self_device_time_total / max(e.count, 1):8.2f} us")
    return {"wall_ms_per_turn": 1e3 * wall / done,
            "device_ms_per_turn": device_us / 1e3 / done,
            "busy_share": device_us / 1e6 / wall,
            "launches_per_turn": launches / done}


# ---------------------------------------------------------------------------
# phases 6-9: the sparse path
# ---------------------------------------------------------------------------

def sparse_instance(n: int, k: int, seed: int = 0, device="cuda"):
    """The reference's sparse benchmark instance
    (``benchmarks/sparse_bench.py::_sparse_instance``), built the same
    way from the port's verbatim copy of the generators."""
    from repro_torch.core.sparse import make_sparse_problem
    from repro_torch.graphs.generators import (random_degree_graph_edges,
                                               random_weights_edges)
    s, r = random_degree_graph_edges(n, seed=seed)
    b, w = random_weights_edges(n, s, seed=seed + 1, mean=5.0)
    sp = make_sparse_problem(s, r, w, b, np.ones(k) / k, mu=MU,
                             device=device)
    r0 = torch.as_tensor(np.random.default_rng(seed + 2).integers(0, k, n)
                         .astype(np.int32), device=device)
    return sp, r0


def check_edge_kernels(D, E, sp, r, theta, label):
    """Kernel 4 == twin == kernel 1 on the window-summed aggregate, and
    kernel 5 == twin == the first-max election from kernel 4, all
    bitwise; returns the largest difference seen (0.0 when bitwise)."""
    from repro_torch.core.costs import adjacency_aggregate_sparse
    from repro_torch.core.problem import machine_loads
    k = sp.num_machines
    b = sp.node_weights
    loads = machine_loads(b, r, k)
    agg = adjacency_aggregate_sparse(sp, r)
    err = 0.0
    for fw in ("c", "ct"):
        for th in (None, theta):
            args = (sp, r, b, loads, sp.speeds, sp.mu, fw)
            got = E.dissatisfaction_from_edges_cuda(*args, theta=th)
            wants = {"twin": E.dissatisfaction_from_edges_plain(*args,
                                                                theta=th),
                     "kernel 1": D.dissatisfaction_from_aggregate_cuda(
                         agg, r, b, loads, sp.speeds, sp.mu, fw, theta=th)}
            sweep = E.sweep_candidates_from_edges_cuda(*args, theta=th)
            wants5 = {"twin": E.sweep_candidates_from_edges_plain(*args,
                                                                  theta=th),
                      "election from kernel 4": E.elect(got[0], got[1], r,
                                                        k)}
            torch.cuda.synchronize()
            tag = f"({label}, {fw}, theta={th is not None})"
            for name, want in wants.items():
                diff = float((got[0] - want[0]).abs().max())
                err = max(err, diff)
                if not torch.equal(got[1], want[1]):
                    fail(f"kernel 4 best != {name} {tag}")
                if not torch.equal(got[0], want[0]):
                    fail(f"kernel 4 dissat not bitwise equal to {name} "
                         f"{tag}: max |diff| {diff}")
            for name, want in wants5.items():
                diff = float((sweep[0] - want[0]).abs().max())
                err = max(err, diff)
                for part, a, c in zip(("gains", "picks", "dests"), sweep,
                                      want):
                    if not torch.equal(a, c):
                        fail(f"kernel 5 {part} != {name} {tag}: max |diff| "
                             f"{float((a.double() - c.double()).abs().max())}")
    log(f"  kernels 4, 5 {label}: N={sp.num_nodes} E={sp.num_edges} "
        f"K={k}: kernel 4 bitwise equal to its twin and to kernel 1 on the "
        f"sparse aggregate; kernel 5 bitwise equal to its twin and to the "
        f"election from kernel 4 (c, ct; theta absent and 0.5)")
    return err


def phase_edge_kernels(D, E, sp, r0):
    err = check_edge_kernels(D, E, sp, r0,
                             torch.full((sp.num_nodes,), 0.5, device="cuda"),
                             "full N")
    small, r_small = sparse_instance(1003, SPARSE_K, seed=5)
    err = max(err, check_edge_kernels(
        D, E, small, r_small, torch.full((1003,), 0.5, device="cuda"),
        "ragged N=1003"))
    return err


def _same_run(a, b) -> bool:
    (ra, outs_a), (rb, outs_b) = a, b
    return (all(torch.equal(x, y) for x, y in zip(ra[:5], rb[:5]))
            and all(torch.equal(x, y) for x, y in zip(outs_a, outs_b)))


def busy_share(fn):
    """Run ``fn`` under torch.profiler; return (result, wall s, device s,
    device launches)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    device_s = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return out, wall, device_s, sum(e.count for e in events), top


def phase_sparse_main(D, E, ops, sp, r0):
    from repro_torch.core import costs
    from repro_torch.core.refine import DEFAULT_TOL, refine, refine_sweeps
    n = sp.num_nodes
    c0_0 = float(costs.global_cost_c0(sp, r0))
    imb0 = float(costs.load_imbalance(sp, r0))
    log(f"  initial  C_0 = {c0_0:.6e}  load imbalance {imb0:.6f}")
    edge_fn = ops.make_edge_dissat_fn(sp)

    def run_a():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        return refine_sweeps(sp, r0, "c", max_sweeps=SWEEP_CAP,
                             generator=gen, dissat_fn=edge_fn, **SWEEP_CFG)

    D.reset_launches()
    E.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_a, outs_a = run_a()
    sweeps, moves = int(res_a.num_turns), int(res_a.num_moves)
    converged = bool(res_a.converged)
    wall_a = time.perf_counter() - t0
    k4_a = E.launches["dissat_from_edges"]
    r = res_a.assignment
    c0_1 = float(costs.global_cost_c0(sp, r))
    imb1 = float(costs.load_imbalance(sp, r))
    log(f"  (a) refine_sweeps unbounded, move_prob 0.5, eps 1e-3, kernel 4: "
        f"{sweeps} sweeps, {moves} moves, converged={converged}, "
        f"{wall_a:.3f} s, {1e3 * wall_a / max(sweeps, 1):.3f} ms per sweep, "
        f"kernel 4 launches {k4_a}")
    log(f"      C_0 {c0_0:.6e} -> {c0_1:.6e}, load imbalance {imb0:.6f} -> "
        f"{imb1:.6f} (reference on a CPU: 17 sweeps, 1301 moves, "
        f"BENCH_sparse.json)")
    if not converged or sweeps > SWEEP_CAP:
        fail("run (a) did not reach its ε-equilibrium")
    if not c0_1 < c0_0:
        fail("run (a): C_0 did not descend")
    carried = float(outs_a[0][sweeps - 1])
    if abs(carried - c0_1) > 1e-3 * abs(c0_1):
        fail(f"run (a): carried C_0 {carried} vs fresh {c0_1}")
    # the ε-equilibrium on a fresh reduction: no node above the floor
    # whose destination still has room (the run's own stop rule)
    b = sp.node_weights
    from repro_torch.core.problem import machine_loads
    loads = machine_loads(b, r, SPARSE_K)
    dis, best = edge_fn(None, r, b, loads, sp.speeds, sp.mu, "c",
                        torch.sum(b))
    thresh = DEFAULT_TOL + SWEEP_CFG["epsilon"] * abs(carried) / n
    norm = loads / sp.speeds
    gap = 0.5 * (norm[r.long()] - norm[best.long()]) * sp.speeds[best.long()]
    open_nodes = int(((dis > thresh) & (gap > 0)).sum())
    log(f"      ε-floor {thresh:.4f}: {int((dis > thresh).sum())} nodes "
        f"above it, {open_nodes} of them with room at their destination")
    if open_nodes:
        fail("run (a) stopped above its ε-equilibrium")

    rep, wall_rep, dev_s, dev_launches, top = busy_share(run_a)
    if not _same_run((res_a, outs_a), rep):
        fail("run (a) repeated with the same seed is not bitwise equal")
    log(f"  (a) repeated under torch.profiler: bitwise equal; wall "
        f"{wall_rep:.3f} s, device {dev_s:.4f} s, busy share "
        f"{dev_s / wall_rep:.4f}, {dev_launches / max(sweeps, 1):.1f} device "
        f"launches per sweep")
    for e in top:
        log(f"    {e.key[:60]:60s} {e.count:6d} x "
            f"{e.self_device_time_total / max(e.count, 1):8.2f} us")

    t0 = time.perf_counter()
    by5 = refine_sweeps(sp, r0, "c", max_sweeps=DEGENERATE_SWEEPS,
                        sweep_fn=ops.make_edge_sweep_fn(sp))
    torch.cuda.synchronize()
    wall5 = time.perf_counter() - t0
    t0 = time.perf_counter()
    by4 = refine_sweeps(sp, r0, "c", max_sweeps=DEGENERATE_SWEEPS,
                        dissat_fn=edge_fn)
    torch.cuda.synchronize()
    wall4 = time.perf_counter() - t0
    same = _same_run(by5, by4)
    s5 = int(by5[0].num_turns)
    log(f"  (b) {DEGENERATE_SWEEPS} degenerate sweeps: kernel 5 "
        f"{1e3 * wall5 / max(s5, 1):.3f} ms per sweep, kernel 4 "
        f"{1e3 * wall4 / max(s5, 1):.3f} ms per sweep; {s5} active, "
        f"{int(by5[0].num_moves)} moves; assignment, moves and per-sweep "
        f"potentials equal: {same}")
    if not same:
        fail("run (b): kernel 5 and kernel 4 runs differ")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_c = refine(sp, r0, "c", max_turns=SPARSE_TURNS,
                   verify_every=SPARSE_VERIFY)
    turns_c, moves_c = int(res_c.num_turns), int(res_c.num_moves)
    wall_c = time.perf_counter() - t0
    drift = float(res_c.aggregate_drift)
    c0_c = float(costs.global_cost_c0(sp, res_c.assignment))
    log(f"  (c) sparse refine, kernel 1: {moves_c} moves in {turns_c} turns, "
        f"{1e3 * wall_c / max(turns_c, 1):.4f} ms per turn, drift against a "
        f"rebuild every {SPARSE_VERIFY} turns {drift:.3e}; C_0 "
        f"{c0_0:.6e} -> {c0_c:.6e}")
    if not (moves_c > 0 and c0_c < c0_0 and drift <= 1e-3 * abs(c0_c)):
        fail("run (c): no descent, or drift beyond 1e-3 of C_0")
    launches = {**D.launches, **E.launches}
    log(f"  launches over the sparse path: {launches}")
    for name in ("dissat_from_aggregate", "dissat_from_edges",
                 "sweep_candidates_from_edges"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the sparse path")
    return {"launches": launches, "r": r, "sweeps": sweeps, "moves": moves,
            "ms_per_sweep": 1e3 * wall_a / max(sweeps, 1),
            "busy_share": dev_s / wall_rep}


def phase_sparse_times(E, sp, r):
    from repro_torch.core.problem import machine_loads
    k = sp.num_machines
    n, e = sp.num_nodes, sp.num_edges
    b = sp.node_weights
    total_b = torch.sum(b)
    loads = machine_loads(b, r, k)
    args = (sp, r, b, loads, sp.speeds, sp.mu, "c")
    real = sp.edge_weights != 0
    csr = torch.sparse_coo_tensor(
        torch.stack([sp.senders[real].long(), sp.receivers[real].long()]),
        sp.edge_weights[real], (n, n)).coalesce().to_sparse_csr()
    onehot = (r.long()[:, None] == torch.arange(k, device="cuda")).float()

    fns = {
        "k4": lambda: E.dissatisfaction_from_edges_cuda(
            *args, total_weight=total_b),
        "p4": lambda: E.dissatisfaction_from_edges_plain(
            *args, total_weight=total_b),
        "k5": lambda: E.sweep_candidates_from_edges_cuda(
            *args, total_weight=total_b),
        "p5": lambda: E.sweep_candidates_from_edges_plain(
            *args, total_weight=total_b),
        "lib": lambda: torch.sparse.mm(csr, onehot),
    }
    t = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            iters = 50 if name in ("k4", "k5", "lib") else 5
            t[name].append(cuda_ms(fns[name], iters))
    ms = {name: float(np.mean(v)) for name, v in t.items()}
    device_us = kernel_device_us({"dissat_from_edges": (fns["k4"], 20),
                                  "sweep_candidates_from_edges":
                                  (fns["k5"], 20)})
    f4, i4 = 4, 4
    # each input read once: row offsets, receivers, weights, assignment,
    # node weights, loads, speeds, mu, B; then the outputs written once
    reads = i4 * n + i4 * e + f4 * e + i4 * n + f4 * n + 2 * f4 * k + 2 * f4
    tiles = -(-n // 128)
    bytes4 = reads + f4 * n + i4 * n
    bytes5 = reads + tiles * k * (f4 + 2 * i4)
    ops4 = int(e) + n * k * 12     # one add per edge, then the assembly
    out = []
    for name, byt, flops, kern, plain, line in (
            ("dissat_from_edges", bytes4, ops4, ms["k4"], ms["p4"], 170),
            ("sweep_candidates_from_edges", bytes5, ops4 + n * k, ms["k5"],
             ms["p5"], 245)):
        t_bytes = 1e3 * byt / PEAK_BYTES_S
        t_ops = 1e3 * flops / PEAK_F32_FLOPS
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/edge_block.cu",
                    "replaces": f"src/repro/kernels/edge_block.py:{line}",
                    "ms": kern, "plain_ms": plain,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": ms["lib"]})
        dev_us = device_us[name]
        log(f"  {name}: kernel {kern:.5f} ms per call ("
            f"{'not measured' if dev_us is None else f'{dev_us:.2f} us'} "
            f"on the device), twin {plain:.5f} ms, bound "
            f"{max(t_bytes, t_ops):.5f} ms "
            f"({'bytes' if t_bytes >= t_ops else 'operations'}, "
            f"{byt / 1e6:.1f} MB), library {ms['lib']:.5f} ms "
            f"(torch.sparse.mm CSR @ one-hot, aggregate only)")
    return out


# ---------------------------------------------------------------------------
# phases 10-12: fleets
# ---------------------------------------------------------------------------

def fleet_cases(device="cuda"):
    """The dense fleet: element s is ``random_degree_graph(4096,
    seed=500+s)`` with ``random_weights(seed=1500+s, mean=5)``, mu then
    speeds drawn from ``default_rng(2500+s)`` (batch_study.py's draws),
    framework c, no theta, r0 from ``default_rng(3500+s)``.  Each element
    is built on the host and moved to the card before the next, so no host
    copy of the fleet exists."""
    from repro_torch import sweeps
    from repro_torch.core.problem import make_problem
    from repro_torch.graphs.generators import (random_degree_graph,
                                               random_weights)
    cases = []
    for s in range(FLEET_B):
        adj = random_degree_graph(FLEET_N, seed=500 + s, dmin=3, dmax=6)
        node_w, edge_w = random_weights(adj, seed=1500 + s, mean=5.0)
        del adj
        rng = np.random.default_rng(2500 + s)
        mu = float(rng.choice([4.0, 8.0, 16.0]))
        sp = rng.uniform(0.5, 2.0, size=FLEET_K)
        problem = make_problem(edge_w, node_w, sp / sp.sum(), mu=mu,
                               normalize_speeds=False, device=device)
        del edge_w
        r0 = np.random.default_rng(3500 + s).integers(0, FLEET_K, FLEET_N)
        cases.append(sweeps.SweepCase(problem=problem, assignment=r0,
                                      framework="c", label=f"element {s}"))
    return cases


def check_kernel3(D, agg, r, b, loads, speeds, mu, total_b, label):
    """Kernel 3 vs its twin and vs kernel 1 on every element: best equal,
    dissat bitwise; returns the largest difference seen (0.0 if bitwise)."""
    bsz, rows, k = agg.shape
    err = 0.0
    theta = torch.full((bsz, rows), 0.5, device=agg.device)
    for fw in ("c", "ct"):
        for th in (None, theta):
            got = D.dissatisfaction_from_aggregate_batched_cuda(
                agg, r, b, loads, speeds, mu, fw, theta=th,
                total_weight=total_b)
            twin = D.dissatisfaction_from_aggregate_batched_plain(
                agg, r, b, loads, speeds, mu, fw, theta=th,
                total_weight=total_b)
            ones = [D.dissatisfaction_from_aggregate_cuda(
                agg[e], r[e], b[e], loads[e], speeds[e], mu[e], fw,
                theta=None if th is None else th[e],
                total_weight=total_b[e]) for e in range(bsz)]
            torch.cuda.synchronize()
            tag = f"({label}, {fw}, theta={th is not None})"
            wants = {"twin": twin,
                     "kernel 1": (torch.stack([o[0] for o in ones]),
                                  torch.stack([o[1] for o in ones]))}
            for name, want in wants.items():
                diff = float((got[0] - want[0]).abs().max())
                err = max(err, diff)
                if not torch.equal(got[1], want[1]):
                    fail(f"kernel 3 best != {name} {tag}")
                if not torch.equal(got[0], want[0]):
                    fail(f"kernel 3 dissat not bitwise equal to {name} "
                         f"{tag}: max |diff| {diff}")
    log(f"  kernel 3 {label}: (B, rows, K)={tuple(agg.shape)}: best equal, "
        f"dissat bitwise equal to its twin and to kernel 1 on every element "
        f"(c, ct; theta absent and 0.5)")
    return err


def _random_stack(rng, bsz, rows, k, device="cuda"):
    """A random (B, rows, K) operand set, each element with its own loads,
    speeds, mu and B."""
    from repro_torch.core.problem import machine_loads
    agg = torch.as_tensor(rng.uniform(0, 50, (bsz, rows, k))
                          .astype(np.float32), device=device)
    r = torch.as_tensor(rng.integers(0, k, (bsz, rows)).astype(np.int32),
                        device=device)
    b = torch.as_tensor(rng.uniform(0.1, 10, (bsz, rows)).astype(np.float32),
                        device=device)
    sp = rng.uniform(0.5, 2.0, (bsz, k))
    speeds = torch.as_tensor((sp / sp.sum(axis=1, keepdims=True))
                             .astype(np.float32), device=device)
    loads = torch.stack([machine_loads(b[e], r[e], k) for e in range(bsz)])
    mu = torch.as_tensor(rng.choice([4.0, 8.0, 16.0], bsz)
                         .astype(np.float32), device=device)
    total_b = torch.stack([torch.sum(x) for x in b])
    return agg, r, b, loads, speeds, mu, total_b


def _fleet_operands(problems, r0):
    """Kernel 3's operands at the fleet's start, each element's carry built
    by the unbatched ``init_aggregate_state`` (as refine_batched does)."""
    from repro_torch.core import aggregate as agg_mod
    from repro_torch.core.batch import stack_pytrees, unstack_pytree
    carry = stack_pytrees([agg_mod.init_aggregate_state(
        unstack_pytree(problems, e), r0[e]) for e in range(r0.shape[0])])
    total_b = torch.stack([torch.sum(x) for x in problems.node_weights])
    return (carry.aggregate, carry.assignment, problems.node_weights,
            carry.loads, problems.speeds, problems.mu, total_b)


def phase_fleet_kernels(D, problems, r0, card):
    args = _fleet_operands(problems, r0)
    err = check_kernel3(D, *args, "fleet shape")
    rng = np.random.default_rng(SEED + 10)
    for bsz, rows, k in ((3, 1003, 8), (2, 300, 128), (2, 129, 17)):
        err = max(err, check_kernel3(D, *_random_stack(rng, bsz, rows, k),
                                     "ragged"))
    agg, r, b, loads, speeds, mu, total_b = args
    bsz, n, k = agg.shape

    def k3():
        D.dissatisfaction_from_aggregate_batched_cuda(
            agg, r, b, loads, speeds, mu, "c", total_weight=total_b)

    def p3():
        D.dissatisfaction_from_aggregate_batched_plain(
            agg, r, b, loads, speeds, mu, "c", total_weight=total_b)

    t = {"k3": [], "p3": []}
    for order in (("k3", "p3"), ("p3", "k3")):
        for name in order:
            t[name].append(cuda_ms({"k3": k3, "p3": p3}[name],
                                   200 if name == "k3" else 20))
    ms = {name: float(np.mean(v)) for name, v in t.items()}
    byt = _rows_bytes(bsz, n, k)
    _, _, dev_us = time_dissat_three_ways(
        D, "dissat_from_aggregate_batched",
        D.dissatisfaction_from_aggregate_batched_cuda, cold_sets(args, byt),
        400, f"(B, N, K)=({bsz}, {n}, {k})", card)
    bound, by = _bound_ms(byt, bsz * n * k * 12)
    rec = {"name": "dissat_from_aggregate_batched", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/dissatisfaction.cu",
           "replaces": "src/repro/kernels/dissatisfaction.py:417",
           "ms": ms["k3"], "plain_ms": ms["p3"],
           "bound_ms": bound, "bound_by": by,
           "library_ms": None, "max_abs_err": err}
    log(f"  dissat_from_aggregate_batched at (B, N, K)=({bsz}, {n}, {k}): "
        f"kernel {ms['k3']:.5f} ms per call "
        f"({'not measured' if dev_us is None else f'{dev_us:.2f} us'} on "
        f"the device), twin {ms['p3']:.5f} ms, bound "
        f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}, {byt / 1e6:.2f} MB), "
        f"library null (no single PyTorch call) [{card}]")
    return rec


def phase_dense_fleet(D, cases, problems, r0, card):
    from repro_torch import sweeps
    from repro_torch.core import costs
    from repro_torch.core.batch import refine_batched
    from repro_torch.core.problem import make_state
    from repro_torch.core.refine import _SYNC_EVERY, DEFAULT_TOL, refine

    spec = sweeps.make_spec(cases, mode="refine", max_turns=FLEET_MAX_TURNS,
                            use_kernel=True)
    D.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sweeps.run_sweep(spec)
    turns = res.turns
    wall = time.perf_counter() - t0
    launches = dict(D.launches)
    batched_turns = min(FLEET_MAX_TURNS,
                        _SYNC_EVERY * -(-int(turns.max()) // _SYNC_EVERY))
    log(f"  run_sweep(refine, use_kernel=True), B={FLEET_B}: "
        f"{int(res.moves.sum())} moves, element turns {int(turns.min())}-"
        f"{int(turns.max())} (sum {int(turns.sum())}), converged "
        f"{int(res.converged.sum())}/{FLEET_B}, {wall:.3f} s, "
        f"{1e3 * wall / batched_turns:.4f} ms per batched turn (stacking "
        f"and the carry build included), {turns.sum() / wall:.1f} "
        f"element-turns/s [{card}]")
    log(f"  launches over the fleet run: {launches} (batched turns "
        f"{batched_turns})")
    if not res.converged.all():
        fail("a fleet element did not converge")
    if launches["dissat_from_aggregate_batched"] != batched_turns:
        fail(f"kernel 3 launched {launches['dissat_from_aggregate_batched']}"
             f" times in {batched_turns} batched turns")
    if launches["dissat_from_aggregate"] != 0:
        fail("kernel 1 was launched by the batched run")
    worst = 0.0
    for case, r in zip(cases, res.results):
        cost = costs.cost_matrix(case.problem,
                                 make_state(case.problem, r.assignment), "c")
        dis, _ = costs.dissatisfaction_from_cost(cost, r.assignment)
        slack = DEFAULT_TOL + 4 * float(torch.finfo(torch.float32).eps) \
            * float(cost.abs().max())
        w = float(dis.max())
        if not w <= slack:
            fail(f"fleet {case.label} is not an equilibrium: max "
                 f"dissatisfaction {w} > {slack}")
        worst = max(worst, w)
    log(f"  Nash check on all {FLEET_B} elements from a fresh rebuild: max "
        f"dissatisfaction {worst:.3e}")

    looped = []
    for e in FLEET_LOOPED:
        case = cases[e]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = refine(case.problem, case.assignment, "c",
                     max_turns=FLEET_MAX_TURNS)
        n_turns = int(one.num_turns)
        w = time.perf_counter() - t0
        got = res.results[e]
        same = (torch.equal(one.assignment, got.assignment)
                and torch.equal(one.loads, got.loads)
                and int(one.num_moves) == int(got.num_moves)
                and n_turns == int(got.num_turns))
        log(f"  element {e} alone through refine (kernel 1): "
            f"{int(one.num_moves)} moves in {n_turns} turns, {w:.3f} s, "
            f"{n_turns / w:.1f} element-turns/s; bitwise equal to the "
            f"fleet: {same}")
        if not same:
            fail(f"fleet element {e} differs from its looped run")
        looped.append(n_turns / w)

    _, pwall, dev_s, dev_launches, top = busy_share(
        lambda: refine_batched(problems, r0, "c",
                               max_turns=FLEET_PROFILE_TURNS))
    log(f"  profiled {FLEET_PROFILE_TURNS} batched turns: wall "
        f"{1e3 * pwall / FLEET_PROFILE_TURNS:.4f} ms/turn, device "
        f"{1e3 * dev_s / FLEET_PROFILE_TURNS:.4f} ms/turn, busy share "
        f"{dev_s / pwall:.4f}, {dev_launches / FLEET_PROFILE_TURNS:.1f} "
        f"device launches per batched turn")
    for ev in top:
        log(f"    {ev.key[:60]:60s} {ev.count:6d} x "
            f"{ev.self_device_time_total / max(ev.count, 1):8.2f} us")
    return {"launches": launches, "batched_turns": batched_turns,
            "ms_per_batched_turn": 1e3 * wall / batched_turns,
            "element_turns_per_s": float(turns.sum() / wall),
            "looped_element_turns_per_s": looped}


def phase_sparse_fleet(D, card):
    from repro_torch import sweeps
    from repro_torch.core.batch import stack_problems
    from repro_torch.core.refine import refine, refine_sweeps
    from repro_torch.core.sparse import make_sparse_problem
    from repro_torch.graphs.generators import (random_degree_graph_edges,
                                               random_weights_edges)
    from repro_torch.sweeps.runtime import case_generator
    n, k = SPARSE_FLEET_N, SPARSE_FLEET_K
    snd, rcv = random_degree_graph_edges(n, seed=0)
    cases = []
    for s in range(SPARSE_FLEET_B):
        b, w = random_weights_edges(n, snd, seed=1 + s, mean=5.0)
        sp = make_sparse_problem(snd, rcv, w, b, np.ones(k) / k, mu=MU,
                                 device="cuda")
        r0 = np.random.default_rng(20 + s).integers(0, k, n)
        cases.append(sweeps.SweepCase(problem=sp, assignment=r0,
                                      framework="c", label=f"weights {s}"))
    log(f"  sparse fleet: B={SPARSE_FLEET_B}, N={n}, K={k}, "
        f"E={cases[0].problem.num_edges}, max_degree "
        f"{cases[0].problem.max_degree}")
    stacked = stack_problems([c.problem for c in cases])
    r0 = torch.stack([torch.as_tensor(c.assignment.astype(np.int32),
                                      device="cuda") for c in cases])
    err = check_kernel3(D, *_fleet_operands(stacked, r0), "sparse fleet")
    del stacked, r0
    D.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sweeps.run_sweep(sweeps.make_spec(cases, mode="refine",
                                            max_turns=SPARSE_FLEET_TURNS,
                                            use_kernel=True))
    moves = res.moves
    wall = time.perf_counter() - t0
    launches = dict(D.launches)
    log(f"  run_sweep(refine) for {SPARSE_FLEET_TURNS} turns: moves "
        f"{moves.tolist()}, {1e3 * wall / SPARSE_FLEET_TURNS:.4f} ms per "
        f"batched turn; launches {launches} [{card}]")
    if launches["dissat_from_aggregate_batched"] <= 0:
        fail("kernel 3 was not launched by the sparse fleet")
    t_loop = 0.0
    for e, case in enumerate(cases):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = refine(case.problem, case.assignment, "c",
                     max_turns=SPARSE_FLEET_TURNS)
        same = all(torch.equal(a, c) for a, c in zip(one, res.results[e]))
        t_loop += time.perf_counter() - t0
        if not same:
            fail(f"sparse fleet element {e} differs from its looped run")
    log(f"  every element bitwise equal to its looped refine "
        f"({1e3 * t_loop / (SPARSE_FLEET_B * SPARSE_FLEET_TURNS):.4f} ms "
        f"per looped turn)")

    cfg = dict(moves_per_machine=None, move_prob=0.5, epsilon=1e-3)
    t0 = time.perf_counter()
    res_m = sweeps.run_sweep(sweeps.make_spec(
        cases, mode="multimove", max_turns=SPARSE_FLEET_SWEEPS, seed=0,
        **cfg))
    sweeps_done = res_m.turns
    wall_m = time.perf_counter() - t0
    log(f"  run_sweep(multimove, unbounded, move_prob 0.5, eps 1e-3): "
        f"sweeps {sweeps_done.tolist()}, moves {res_m.moves.tolist()}, "
        f"converged {res_m.converged.tolist()}, {wall_m:.3f} s")
    for e, case in enumerate(cases):
        one, trace = refine_sweeps(
            case.problem, case.assignment, "c",
            max_sweeps=SPARSE_FLEET_SWEEPS,
            generator=case_generator(0, e, "cuda"), **cfg)
        same = (all(torch.equal(a, c) for a, c in zip(one, res_m.results[e]))
                and all(torch.equal(a, c)
                        for a, c in zip(trace, res_m.traces[e])))
        if not same:
            fail(f"multimove case {e} differs from its lone refine_sweeps")
    log("  every multimove case bitwise equal to a lone refine_sweeps with "
        "its derived generator")
    return err


# ---------------------------------------------------------------------------
# phases 13-16: dense LM serving (qwen1.5-4b at full width, kernels 6-7)
# ---------------------------------------------------------------------------

def _sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def _attn_inputs(shapes, seed, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=g, device="cuda").to(dtype)
            for s in shapes]


def _attn_err(got, want, dtype, label):
    """max |got - want| after checking ``ATTN_TOL[dtype]``: |d| <= atol +
    rtol * |want| elementwise."""
    rtol, atol = ATTN_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    bad = diff > atol + rtol * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()) or bool(bad.any()):
        fail(f"{label} vs twin beyond tolerance: max |diff| "
             f"{float(diff.max())}")
    return float(diff.max())


def phase_attention_kernels(A, F):
    """Kernels 6-7 against their twins on the card, f32 and bf16."""
    err6 = err7 = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for b, h, hkv, d, s in DECODE_SHAPES:
            q, k, v = _attn_inputs([(b, h, d), (b, s, hkv, d),
                                    (b, s, hkv, d)], b + s, dtype)
            lens = np.random.default_rng(s).integers(1, s + 1, b)
            lens[0], lens[-1] = 1, s + 904       # shortest; above S
            if b > 2:
                lens[1] = s
            length = torch.as_tensor(lens.astype(np.int32), device="cuda")
            got = A.decode_attention_cuda(q, k, v, length)
            want = A.decode_attention_twin(q, k, v, length)
            torch.cuda.synchronize()
            e = _attn_err(got, want, dtype, f"kernel 6 {(b, h, hkv, d, s)}")
            err6 = max(err6, e)
            log(f"  kernel 6 (B, H, Hkv, D, S)={(b, h, hkv, d, s)} {name}, "
                f"lengths {int(lens.min())}..{int(lens.max())}: max |diff| "
                f"{e:.3e}")
        for b, h, hkv, d, s in DECODE_SPLIT_SHAPES:
            split = A.split_size(s, b * hkv, _sm_count())
            lens = np.asarray([split, 2 * split, 2 * split + 1, 1, s + 77, s,
                               3 * split - 1, split + 1][:b], np.int32)
            q, k, v = _attn_inputs([(b, h, d), (b, s, hkv, d),
                                    (b, s, hkv, d)], b + s + 2, dtype)
            length = torch.as_tensor(lens, device="cuda")
            got = A.decode_attention_cuda(q, k, v, length)
            again = A.decode_attention_cuda(q, k, v, length)
            want = A.decode_attention_twin(q, k, v, length)
            torch.cuda.synchronize()
            e = _attn_err(got, want, dtype, f"kernel 6 {(b, h, hkv, d, s)}")
            if not torch.equal(got, again):
                fail(f"kernel 6 {(b, h, hkv, d, s)} {name}: two calls differ")
            err6 = max(err6, e)
            live = hkv * int(sum(-(-min(n, s) // split) for n in lens))
            log(f"  kernel 6 (B, H, Hkv, D, S)={(b, h, hkv, d, s)} {name}, "
                f"G={h // hkv}, split {split} ({-(-s // split)} splits, "
                f"{live} live blocks), lengths {lens.tolist()}: max |diff| "
                f"{e:.3e}; a second call bitwise equal")
        for b, s, h, hkv, d in FLASH_SHAPES:
            q, k, v = _attn_inputs([(b, s, h, d), (b, s, hkv, d),
                                    (b, s, hkv, d)], b + s + 1, dtype)
            got = F.flash_attention_cuda(q, k, v)
            want = F.flash_attention_twin(q, k, v)
            torch.cuda.synchronize()
            e = _attn_err(got, want, dtype, f"kernel 7 {(b, s, h, hkv, d)}")
            err7 = max(err7, e)
            log(f"  kernel 7 (B, S, H, Hkv, D)={(b, s, h, hkv, d)} {name}: "
                f"max |diff| {e:.3e}")
            del q, k, v, got, want
    log(f"  tolerances: f32 rtol {ATTN_TOL[torch.float32][0]} atol "
        f"{ATTN_TOL[torch.float32][1]}; bf16 rtol "
        f"{ATTN_TOL[torch.bfloat16][0]} atol {ATTN_TOL[torch.bfloat16][1]}")
    q, k = _attn_inputs([(2, 4, 64), (2, 10, 2, 64)], 0, torch.float32)
    length = torch.full((2,), 5, dtype=torch.int32, device="cuda")
    q4, k4 = _attn_inputs([(1, 10, 4, 264), (1, 10, 2, 264)], 0,
                          torch.float32)
    qg, kg = _attn_inputs([(1, 4, 65, 8), (1, 4, 1, 8)], 0, torch.float32)
    qd, kd = _attn_inputs([(1, 130, 128), (1, 8, 1, 128)], 0, torch.float32)
    refusals = {
        "a float16 input": lambda: A.decode_attention_cuda(
            q.half(), k.half(), k.half(), length),
        "a non-contiguous cache": lambda: A.decode_attention_cuda(
            q, k.transpose(0, 1).contiguous().transpose(0, 1), k, length),
        "head_dim 264": lambda: F.flash_attention_cuda(q4, k4, k4),
        "a bf16 query with f32 keys": lambda: F.flash_attention_cuda(
            q4[..., :64].contiguous().bfloat16(), k4[..., :64].contiguous(),
            k4[..., :64].contiguous()),
        "65 query heads per kv head (launcher)": lambda:
            F.flash_attention_cuda(qg, kg, kg),
        "130 query heads per kv head at D=128 (launcher)": lambda:
            A.decode_attention_cuda(qd, kd, kd, length[:1]),
    }
    for what, call in refusals.items():
        try:
            call()
        except (ValueError, RuntimeError) as exc:
            log(f"  refused {what}: {exc}")
        else:
            fail(f"a kernel launched on {what}")
    # a refused launch leaves no error behind for the next one
    _attn_err(A.decode_attention_cuda(q, k, k, length),
              A.decode_attention_twin(q, k, k, length), torch.float32,
              "kernel 6 after a refused launch")
    return err6, err7


def _request_prompts(vocab: int):
    rng = np.random.default_rng(SEED)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_REQUESTS)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


class FiniteGreedy:
    """Greedy sampling that also keeps, on the device, whether every
    logit it saw was finite (read once, after the run)."""

    def __init__(self):
        self.finite = torch.ones((), dtype=torch.bool, device="cuda")

    def __call__(self, logits):
        from repro_torch.serving.sampler import greedy
        self.finite &= torch.isfinite(logits).all()
        return greedy(logits)


def _serve_full_width(cfg, mods, card):
    """Phases 14 and 18: ``cfg`` at full width, random weights from a
    seeded generator on the card, serving the 48 requests of
    ``_request_prompts`` through the port's ServingEngine with the launch
    counts of ``mods`` set to 0 just before the run.  Checks that every
    request has its tokens and every logit was finite; returns (params,
    engine, stats, launches, twin calls)."""
    from repro_torch.models import init_params
    from repro_torch.models.convert import param_count
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED))
    torch.cuda.synchronize()
    n_params = param_count(params)
    log(f"  init_params on the card (seed {SEED}): {n_params} parameters "
        f"({4 * n_params / 1e9:.2f} GB f32) in "
        f"{time.perf_counter() - t0:.2f} s")
    if n_params != cfg.param_count():
        fail(f"{n_params} parameters, the config counts {cfg.param_count()}")
    serve = ServeConfig(max_batch=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                        cache_dtype="bfloat16")
    sampler = FiniteGreedy()
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, serve, sampler=sampler)
    torch.cuda.synchronize()
    log(f"  engine: {serve}, weights cast to {cfg.compute_dtype} once and "
        f"cache allocated in {time.perf_counter() - t0:.2f} s; device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    prompts = _request_prompts(cfg.vocab_size)
    for uid, prompt in enumerate(prompts):
        engine.submit(Request(uid, prompt, max_new_tokens=SERVE_NEW))
    log(f"  {len(prompts)} requests, prompt lengths "
        f"{min(p.size for p in prompts)}..{max(p.size for p in prompts)} "
        f"(sum {sum(p.size for p in prompts)}) from default_rng({SEED}), "
        f"{SERVE_NEW} new tokens each, greedy")

    for mod in mods:
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    stats = engine.run()
    launches = {k: v for mod in mods for k, v in mod.launches.items()}
    twins = {k: v for mod in mods for k, v in mod.twin_calls.items()}
    steps = stats["decode_steps"]
    log(f"  served: {stats['requests']} requests, {stats['prefills']} "
        f"prefills, {steps} decode steps, {stats['generated_tokens']} "
        f"generated tokens in {stats['wall_s']:.3f} s: "
        f"{stats['tok_per_s']:.2f} generated tok/s [{card}]")
    log(f"  prefill: {stats['prefill_tokens']} prompt tokens in "
        f"{stats['prefill_s']:.3f} s, "
        f"{stats['prefill_tokens'] / stats['prefill_s']:.1f} prefill tok/s; "
        f"decode: {1e3 * stats['decode_s'] / steps:.3f} ms per decode step "
        f"(16 slots); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"  launches over the serving run: {launches}; twin calls {twins}")
    if stats["requests"] != SERVE_REQUESTS or len(engine.finished) \
            != SERVE_REQUESTS:
        fail(f"{stats['requests']} of {SERVE_REQUESTS} requests finished")
    if any(len(r.output) != SERVE_NEW for r in engine.finished):
        fail("a request did not produce its 64 tokens")
    if not bool(sampler.finite):
        fail("non-finite logits while serving")
    return params, engine, stats, launches, twins


def _profile_decode(engine):
    """A profiled window of decode steps at full occupancy: every slot
    gets a request that continues from the slot's cache as the run left
    it."""
    from repro_torch.serving import Request
    for slot in range(SERVE_SLOTS):
        req = Request(10_000 + slot, np.zeros(1, np.int32),
                      max_new_tokens=PROFILE_STEPS + 1)
        req.output.append(int(engine.finished[slot].output[-1]))
        engine.slots[slot] = req
        engine.budget[slot] = PROFILE_STEPS
    pos = engine.cache.position.tolist()
    steps0 = engine.steps
    _, wall, dev_s, dev_launches, top = busy_share(
        lambda: [engine.step() for _ in range(PROFILE_STEPS)])
    log(f"  profiled {engine.steps - steps0} engine decode steps (16 slots "
        f"at cache positions {min(pos)}..{max(pos)}): wall "
        f"{1e3 * wall / PROFILE_STEPS:.3f} ms/step, device "
        f"{1e3 * dev_s / PROFILE_STEPS:.3f} ms/step, busy share "
        f"{dev_s / wall:.4f}, {dev_launches / PROFILE_STEPS:.1f} device "
        f"launches per step")
    for ev in top:
        log(f"    {ev.key[:60]:60s} {ev.count:6d} x "
            f"{ev.self_device_time_total / max(ev.count, 1):8.2f} us")


def phase_serving(A, F, card):
    """Phase 14: qwen1.5-4b at full width through the port's
    ServingEngine, kernels 6-7 on every layer, no twin."""
    from repro_torch import configs
    cfg = configs.get_config(LM_ARCH)
    log(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads (kv {cfg.num_kv_heads}) x {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, qkv_bias "
        f"{cfg.qkv_bias}, params {cfg.param_dtype}, compute "
        f"{cfg.compute_dtype}")
    params, engine, stats, launches, twins = _serve_full_width(
        cfg, (A, F), card)
    steps = stats["decode_steps"]
    want = {"flash_attention": cfg.num_layers * SERVE_REQUESTS,
            "decode_attention": cfg.num_layers * steps}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"kernel {name} launched {launches[name]} times, want {n}")
    if any(twins.values()):
        fail(f"a twin ran on the serving path: {twins}")
    log(f"  checks: every request has {SERVE_NEW} tokens, every logit "
        f"finite, kernel 7 launched {cfg.num_layers} x {SERVE_REQUESTS} and "
        f"kernel 6 {cfg.num_layers} x {steps} times, no twin ran")
    _profile_decode(engine)
    return params, engine, {"stats": stats, "launches": launches}


def _max_rel(a, b) -> float:
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def phase_paths(params, engine):
    """Phase 15: the kernel path against the plain path at full width."""
    from repro_torch.models.transformer import decode_step
    from repro_torch.serving.sampler import greedy

    cfg = engine.cfg
    # (a) one bf16 decode step of phase 14's engine on both paths, from
    # the same state: each path writes its own new row before reading it
    last = torch.as_tensor([[r.output[-1]] for r in
                            engine.finished[-SERVE_SLOTS:]], device="cuda")
    pos = engine.cache.position.clone()
    out = {}
    for path in ("kernel", "plain"):
        logits, cache = decode_step(engine.params, cfg, last,
                                    engine.cache._replace(position=pos),
                                    attention=path)
        out[path] = logits[:, 0].float()
    rel = _max_rel(out["kernel"], out["plain"])
    agree = int((greedy(out["kernel"]) == greedy(out["plain"])).sum())
    log(f"  bf16 decode step at 16 slots: max |diff| / max(1, max|logit|) "
        f"= {rel:.3e} (tolerance {BF16_STEP_TOL}); argmax equal on {agree}"
        f"/{SERVE_SLOTS} slots")
    if not rel <= BF16_STEP_TOL:
        fail("the bf16 decode step differs between the kernel and plain "
             "paths beyond tolerance")

    rel32 = _f32_parity(params, cfg, "attention")
    return {"bf16_rel": rel, "bf16_argmax_equal": agree, "f32_rel": rel32}


def _f32_parity(params, cfg, switch: str) -> float:
    """Phases 15 and 19: f32 compute, the same weights, two requests
    through a 2-slot engine on the kernel path and on the plain path
    (``switch`` names the engine's argument that selects it): tokens
    equal, every sampled logit within ``F32_LOGIT_TOL``."""
    import dataclasses

    from repro_torch.serving import Request, ServeConfig, ServingEngine
    from repro_torch.serving.sampler import greedy

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PARITY_PROMPTS]
    runs = {}
    for path in ("kernel", "plain"):
        seen = []

        def sampler(logits, seen=seen):
            seen.append(logits[:, -1].float().cpu())
            return greedy(logits)

        eng = ServingEngine(cfg32, params, ServeConfig(
            max_batch=2, max_len=PARITY_MAX_LEN, cache_dtype="float32"),
            sampler=sampler, **{switch: path})
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid, p, max_new_tokens=PARITY_NEW))
        t0 = time.perf_counter()
        eng.run()
        runs[path] = ({r.uid: r.output for r in eng.finished}, seen,
                      time.perf_counter() - t0)
        del eng
    tok_k, logit_k, wall_k = runs["kernel"]
    tok_p, logit_p, wall_p = runs["plain"]
    rel32 = max(_max_rel(a, b) for a, b in zip(logit_k, logit_p))
    log(f"  f32 compute, prompts {PARITY_PROMPTS}, {PARITY_NEW} new tokens: "
        f"kernel path {wall_k:.3f} s, plain path {wall_p:.3f} s; tokens "
        f"equal: {tok_k == tok_p}; logits max |diff| / max(1, max|logit|) "
        f"= {rel32:.3e} over {len(logit_k)} sampler calls (tolerance "
        f"{F32_LOGIT_TOL})")
    if tok_k != tok_p:
        fail("the kernel and plain paths generated different tokens")
    if len(logit_k) != len(logit_p) or not rel32 <= F32_LOGIT_TOL:
        fail("f32 logits differ between the kernel and plain paths beyond "
             "tolerance")
    return rel32


def _sdpa():
    return torch.nn.functional.scaled_dot_product_attention


def phase_attention_times(A, F, engine, card):
    """Phase 16: kernels 6-7 at the serving shapes."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.dissatisfaction import _ptr
    cfg_h, hkv, d = 20, 20, 128
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    # kernel 6: layer 0 of the engine's cache, each slot's current length
    k6, v6 = engine.cache.kv_k[0], engine.cache.kv_v[0]
    b, s = k6.shape[0], k6.shape[1]
    length = torch.clamp(engine.cache.position + 1, max=s).to(torch.int32)
    (q6,) = _attn_inputs([(b, cfg_h, d)], 6, torch.bfloat16)
    valid = int(length.sum())
    mask = (torch.arange(s, device="cuda")[None, :] < length[:, None])[
        :, None, None, :]
    out6 = torch.empty_like(q6)
    lib6 = _build.library("decode_attention").decode_attention
    args6, scratch6 = A.decode_attention_args(q6, k6, v6, length, out6)
    split6 = A.split_size(s, b * hkv, _sm_count())
    lens6 = length.tolist()
    log(f"  kernel 6 at the serving shape: split {split6} positions, "
        f"{-(-s // split6)} splits, {-(-s // split6) * hkv * b} blocks "
        f"launched, {hkv * sum(-(-n // split6) for n in lens6)} live (lengths "
        f"{min(lens6)}..{max(lens6)}, {valid} valid positions), "
        f"{_sm_count()} SMs")

    def k6_call():
        A.decode_attention_cuda(q6, k6, v6, length)

    def p6_call():
        A.decode_attention_twin(q6, k6, v6, length)

    def lib6_call():
        _sdpa()(q6[:, :, None, :], k6.transpose(1, 2), v6.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

    def raw6():
        lib6(*args6)

    # kernel 7: the longest prompt of the serving run, S = 3072
    s7 = SERVE_PROMPT[1]
    q7, k7, v7 = _attn_inputs([(1, s7, cfg_h, d), (1, s7, hkv, d),
                               (1, s7, hkv, d)], 7, torch.bfloat16)
    out7 = torch.empty_like(q7)
    lib7 = _build.library("flash_attention").flash_attention_bf16
    args7 = (_ptr(q7), _ptr(k7), _ptr(v7), _ptr(out7), 1, s7, cfg_h, hkv, d,
             d, stream)

    def k7_call():
        F.flash_attention_cuda(q7, k7, v7)

    def p7_call():
        F.flash_attention_twin(q7, k7, v7)

    def lib7_call():
        _sdpa()(q7.transpose(1, 2), k7.transpose(1, 2), v7.transpose(1, 2),
                is_causal=True, enable_gqa=True)

    def raw7():
        lib7(*args7)

    # the launch-only loops skip the wrappers' checks: check once here
    # that one call of each launches and matches its wrapper bitwise
    for raw, lib, args, out, wrapped in (
            (raw6, lib6, args6, out6, lambda: A.decode_attention_cuda(
                q6, k6, v6, length)),
            (raw7, lib7, args7, out7, lambda: F.flash_attention_cuda(
                q7, k7, v7))):
        if lib(*args) != 0 or not torch.equal(out, wrapped()):
            fail("a launch-only call differs from its wrapper's")

    calls = {"k6": (k6_call, 50), "d6": (raw6, 50), "p6": (p6_call, 5),
             "l6": (lib6_call, 20), "k7": (k7_call, 50), "d7": (raw7, 50),
             "p7": (p7_call, 3), "l7": (lib7_call, 50)}
    t = {name: [] for name in calls}
    for order in (list(calls), list(reversed(calls))):
        for name in order:
            fn, iters = calls[name]
            t[name].append(cuda_ms(fn, iters, warmup=2))
    ms = {name: float(np.mean(v)) for name, v in t.items()}
    prof_us = kernel_device_us({"decode_attention": (raw6, 20),
                                "flash_attention": (raw7, 20)}, attempts=1)
    gb, gh, ghkv, gd, gs = DECODE_GQA_SHAPE
    qg, kg, vg = _attn_inputs([(gb, gh, gd), (gb, gs, ghkv, gd),
                               (gb, gs, ghkv, gd)], 56, torch.bfloat16)
    lg = length[:gb] if gb <= b else length.repeat(-(-gb // b))[:gb]
    gqa_ms = cuda_ms(lambda: A.decode_attention_cuda(qg, kg, vg, lg), 50,
                     warmup=2)
    gvalid = int(torch.clamp(lg, max=gs).sum())
    gbound = 1e3 * 2 * (2 * gvalid * ghkv * gd + 2 * gb * gh * gd) \
        / PEAK_BYTES_S
    gsplit = A.split_size(gs, gb * ghkv, _sm_count())
    log(f"  decode_attention at yi-34b's heads (B, H, Hkv, D, S)="
        f"{DECODE_GQA_SHAPE}, bf16, the serving lengths ({gvalid} valid "
        f"positions, split {gsplit}): {gqa_ms:.5f} ms per call, bound "
        f"{gbound:.5f} ms (bytes), bound share {gbound / gqa_ms:.4f} [{card}]")
    del qg, kg, vg
    q32, k32, v32 = (x.float() for x in (q7, k7, v7))
    f32_ms = cuda_ms(lambda: F.flash_attention_cuda(q32, k32, v32), 5,
                     warmup=1)
    log(f"  flash_attention f32 instance (attention.cu, CUDA cores) at "
        f"(1, {s7}, {cfg_h}, {hkv}, {d}): {f32_ms:.5f} ms per call [{card}]")
    del q32, k32, v32
    bf = 2
    bytes6 = bf * (2 * valid * hkv * d + 2 * b * cfg_h * d) + 4 * b
    ops6 = 4 * valid * cfg_h * d           # q.k and p.v, 2 flops per MAC
    bytes7 = bf * (2 * s7 * cfg_h * d + 2 * s7 * hkv * d)
    ops7 = 4 * cfg_h * d * s7 * (s7 + 1) // 2
    out = []
    for name, byt, flops, key, source, line, shape in (
            ("decode_attention", bytes6, ops6, "6", "decode_attention.cu",
             "decode_attention.py:70",
             f"(B, H, Hkv, D, S)=({b}, {cfg_h}, {hkv}, {d}, {s}), bf16, "
             f"{valid} valid positions"),
            ("flash_attention", bytes7, ops7, "7", "flash_attention.cu",
             "flash_attention.py:90",
             f"(B, S, H, Hkv, D)=(1, {s7}, {cfg_h}, {hkv}, {d}), bf16")):
        kern, plain, lib = ms["k" + key], ms["p" + key], ms["l" + key]
        dev = 1e3 * ms["d" + key]   # us, a loop of C entry-point calls
        t_bytes = 1e3 * byt / PEAK_BYTES_S
        t_ops = 1e3 * flops / PEAK_BF16_FLOPS
        rec = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{source}",
               "replaces": f"src/repro/kernels/{line}",
               "ms": kern, "plain_ms": plain,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": lib}
        prof = prof_us[name]
        log(f"  {name} at {shape}: kernel {kern:.5f} ms per call "
            f"({dev:.2f} us on the device by CUDA events around a loop that "
            f"only launches it; "
            f"{'no profiler record' if prof is None else f'{prof:.2f} us'} "
            f"by the profiler), twin {plain:.5f} ms, bound "
            f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}; "
            f"{byt / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP), library "
            f"(scaled_dot_product_attention) {lib:.5f} ms; kernel / bound "
            f"{kern / rec['bound_ms']:.2f}, bound share "
            f"{rec['bound_ms'] / kern:.4f}, kernel / library "
            f"{kern / lib:.3f} [{card}]")
        out.append(rec)
    return out


def _ssd_inputs(b, seq, h, p, n, dtype, seed):
    """Kernel 8's inputs with the Mamba2 initialisation's decays: a in
    [-16, -1], dt in [1e-3, 0.1], so dt * a reaches -1.6 a step and e^cum
    underflows inside a chunk."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, seq, h, p), generator=g, device="cuda").to(dtype)
    bm = torch.randn((b, seq, n), generator=g, device="cuda").to(dtype)
    cm = torch.randn((b, seq, n), generator=g, device="cuda").to(dtype)
    dt = 1e-3 + (0.1 - 1e-3) * torch.rand((b, seq, h), generator=g,
                                          device="cuda")
    a = -(1.0 + 15.0 * torch.rand((h,), generator=g, device="cuda"))
    return x, dt, a, bm, cm


def _ssd_err(got, want, label) -> float:
    """max |got - want| after checking it against SSD_TOL * max(1, max
    |want|)."""
    bound = SSD_TOL * max(1.0, float(want.abs().max()))
    diff = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or not diff <= bound:
        fail(f"{label} vs twin beyond tolerance: max |diff| {diff}, bound "
             f"{bound}")
    return diff


def phase_ssd_kernel(S8):
    """Phase 17: kernel 8 against its twin on the card."""
    err = 0.0
    for i, (b, seq, h, p, n, dtype, with_state) in enumerate(SSD_SHAPES):
        x, dt, a, bm, cm = _ssd_inputs(b, seq, h, p, n, dtype, 17 + i)
        init = torch.randn((b, h, p, n), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(i)) if with_state else None
        got = S8.ssd_scan_cuda(x, dt, a, bm, cm, init)
        want = S8.ssd_scan_twin(x, dt, a, bm, cm, SSD_CHUNK, init)
        torch.cuda.synchronize()
        shape = (b, seq, h, p, n)
        ey = _ssd_err(got[0], want[0], f"kernel 8 y {shape}")
        es = _ssd_err(got[1], want[1], f"kernel 8 state {shape}")
        err = max(err, ey, es)
        log(f"  kernel 8 (B, L, H, P, N)={shape} {str(dtype)[6:]} inputs"
            f"{', from an initial state' if with_state else ''}: y max "
            f"|diff| {ey:.3e} (max |y| {float(want[0].abs().max()):.3f}), "
            f"state max |diff| {es:.3e} (max |state| "
            f"{float(want[1].abs().max()):.3f})")
        del x, dt, a, bm, cm, got, want
    log(f"  tolerance: max |diff| <= {SSD_TOL} * max(1, max |want|), y and "
        f"state each")
    x, dt, a, bm, cm = _ssd_inputs(1, 70, 2, 16, 8, torch.float32, 0)
    big = torch.zeros((1, 70, 512), device="cuda")
    wide = torch.zeros((1, 70, 2, 72), device="cuda")
    refusals = {
        "a float16 input": lambda: S8.ssd_scan_cuda(
            x.half(), dt, a, bm.half(), cm.half()),
        "a bf16 dt": lambda: S8.ssd_scan_cuda(x, dt.bfloat16(), a, bm, cm),
        "a non-contiguous x": lambda: S8.ssd_scan_cuda(
            x.transpose(1, 2).contiguous().transpose(1, 2), dt, a, bm, cm),
        "N = 512, past a block's shared memory (launcher)": lambda:
            S8.ssd_scan_cuda(x, dt, a, big, big),
        "bf16 with P = 72, past the bf16 kernel's widths (wrapper)": lambda:
            S8.ssd_scan_cuda(wide.bfloat16(), dt, a, bm.bfloat16(),
                             cm.bfloat16()),
    }
    for what, call in refusals.items():
        try:
            call()
        except (ValueError, RuntimeError) as exc:
            log(f"  refused {what}: {exc}")
        else:
            fail(f"kernel 8 launched on {what}")
    # a refused launch leaves no error behind for the next one, f32 or bf16
    for xs, bs, cs in ((x, bm, cm),
                       (x.bfloat16(), bm.bfloat16(), cm.bfloat16())):
        got = S8.ssd_scan_cuda(xs, dt, a, bs, cs)
        want = S8.ssd_scan_twin(xs, dt, a, bs, cs, SSD_CHUNK)
        torch.cuda.synchronize()
        _ssd_err(got[0], want[0], f"kernel 8 ({xs.dtype}) after a refused "
                 f"launch")
    return err


def phase_ssm_serving(S8, card):
    """Phase 18: mamba2-1.3b at full width through the port's
    ServingEngine, kernel 8 on every prefill layer, no twin."""
    from repro_torch import configs
    cfg = configs.get_config(SSM_ARCH)
    log(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"d_inner {cfg.d_inner}, {cfg.ssm_heads} heads x "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, conv {cfg.ssm_conv}, "
        f"chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}, tied embeddings "
        f"{cfg.tie_embeddings}, params {cfg.param_dtype}, compute "
        f"{cfg.compute_dtype}")
    params, engine, stats, launches, twins = _serve_full_width(
        cfg, (S8,), card)
    prefills = stats["prefills"]
    want = cfg.num_layers * prefills
    if prefills != SERVE_REQUESTS or launches["ssd_scan"] != want:
        fail(f"kernel 8 launched {launches['ssd_scan']} times over "
             f"{prefills} prefills, want {cfg.num_layers} x "
             f"{SERVE_REQUESTS}")
    if any(twins.values()):
        fail(f"a twin ran on the serving path: {twins}")
    per_call = S8.DEVICE_LAUNCHES[getattr(torch, cfg.compute_dtype)]
    log(f"  checks: every request has {SERVE_NEW} tokens, every logit "
        f"finite, kernel 8 launched {cfg.num_layers} x {prefills} = {want} "
        f"times ({per_call} device launches each, its passes: "
        f"{per_call * want}), twin calls {twins['ssd_scan_twin']}")
    _profile_decode(engine)
    return params, engine, {"stats": stats, "launches": launches}


def phase_ssm_paths(S8, params, engine, card):
    """Phase 19: the SSM kernel path against the plain path at full
    width, then kernel 8's times at the serving shape."""
    import dataclasses

    from repro_torch.models.transformer import decode_step, prefill
    from repro_torch.serving.sampler import greedy

    cfg = engine.cfg
    _f32_parity(params, cfg, "ssm")
    # one bf16 prefill of a longest-prompt request and one decode step on
    # both paths, on phase 18's cast weights, and on the plain path at f32
    # compute on the uncast weights; all decode the token the kernel path
    # chose.  The tolerance is the bf16 floor of this input: the kernel
    # path's logits may lie no further from the plain path's than bf16
    # compute moves the plain path's from f32 compute, for the prefill
    # and for the step each (the kernel and its twin differ by f32
    # rounding, which at bf16 flips a few roundings of the scan's output)
    rng = np.random.default_rng(SEED + 2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          SERVE_PROMPT[1]).astype(np.int64),
                             device="cuda")[None]
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    out, nxt = {}, None
    for run, weights, c, path in (("kernel", engine.params, cfg, "kernel"),
                                  ("plain", engine.params, cfg, "plain"),
                                  ("plain f32", params, cfg32, "plain")):
        first, cache = prefill(weights, c, tokens, SERVE_MAX_LEN, ssm=path)
        if nxt is None:
            nxt = greedy(first).long().reshape(1, 1)
        step, _ = decode_step(weights, c, nxt, cache)
        out[run] = (first[:, 0].float(), step[:, 0].float())
        del cache
    rel = [_max_rel(k, p) for k, p in zip(out["kernel"], out["plain"])]
    floor = [_max_rel(p, f) for p, f in zip(out["plain"], out["plain f32"])]
    agree = [bool(greedy(k) == greedy(p))
             for k, p in zip(out["kernel"], out["plain"])]
    # each run's top two prefill logits: an argmax that differs between
    # the paths is a near-tie when their gap is inside the bf16 floor
    top2 = {run: [round(v, 4) for v in torch.topk(o[0][0], 2).values.tolist()]
            + [int(torch.argmax(o[0][0]))] for run, o in out.items()}
    log(f"  bf16 prefill of {SERVE_PROMPT[1]} tokens, then one decode step: "
        f"kernel vs plain path max |diff| / max(1, max|logit|) = "
        f"{rel[0]:.3e}, {rel[1]:.3e}; bf16 floor (plain path, bf16 vs f32 "
        f"compute) {floor[0]:.3e}, {floor[1]:.3e}; argmax equal (prefill, "
        f"step): {agree}; prefill top two logits and argmax by run: {top2}")
    if not all(r <= f for r, f in zip(rel, floor)):
        fail("the bf16 prefill or step differs between the kernel and "
             "plain paths by more than bf16 compute moves the plain path")

    return ssd_times(S8, card)


# the bf16 kernel's passes, by the names of their CUDA kernels
SSD_PASSES = ("ssd_chunk_states_kernel", "ssd_state_passing_kernel",
              "ssd_chunk_outputs_kernel")


def ssd_times(S8, card):
    """Kernel 8 at the serving shape: the wrapper, its twin and a loop of C
    entry-point calls (the device time of all three passes) by CUDA events,
    in turns; each pass's share by the profiler; the f32 instance."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.dissatisfaction import _ptr
    from torch.profiler import ProfilerActivity, profile
    b, seq, h, p, n, dtype, _ = SSD_SHAPES[0]
    x, dt, a, bm, cm = _ssd_inputs(b, seq, h, p, n, dtype, 19)
    lib = _build.library("ssd_scan_bf16")
    y = torch.empty((b, seq, h, p), device="cuda")
    final = torch.empty((b, h, p, n), device="cuda")
    work = torch.empty(lib.ssd_scan_bf16_work_bytes(b, seq, h, p, n),
                       dtype=torch.uint8, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (_ptr(x), _ptr(dt), _ptr(a), _ptr(bm), _ptr(cm), _ptr(None),
            _ptr(y), _ptr(final), _ptr(work), b, seq, h, p, n, stream)

    def k8_call():
        S8.ssd_scan_cuda(x, dt, a, bm, cm)

    def p8_call():
        S8.ssd_scan_twin(x, dt, a, bm, cm, SSD_CHUNK)

    def raw8():
        lib.ssd_scan_bf16(*args)

    # the launch-only loop skips the wrapper's checks: check once here that
    # one call launches and matches the wrapper bitwise
    status = lib.ssd_scan_bf16(*args)
    want = S8.ssd_scan_cuda(x, dt, a, bm, cm)
    torch.cuda.synchronize()
    if status != 0 or not (torch.equal(y, want[0])
                           and torch.equal(final, want[1])):
        fail("kernel 8's launch-only call differs from its wrapper's")
    del want
    calls = {"k8": (k8_call, 20), "d8": (raw8, 20), "p8": (p8_call, 5)}
    t = {name: [] for name in calls}
    for order in (list(calls), list(reversed(calls))):
        for name in order:
            fn, iters = calls[name]
            t[name].append(cuda_ms(fn, iters, warmup=2))
    ms = {name: float(np.mean(v)) for name, v in t.items()}
    reps = 10
    raw8()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            raw8()
        torch.cuda.synchronize()
    passes = {name: [0, 0.0] for name in SSD_PASSES}
    for e in prof.key_averages():
        for name in SSD_PASSES:
            if name in e.key:
                passes[name][0] += e.count
                passes[name][1] += e.self_device_time_total
    # the profiler may miss some launches of a window: each pass's time is
    # its mean over the launches it recorded
    mean = {name: us / count for name, (count, us) in passes.items()
            if count}
    if len(mean) == len(SSD_PASSES):
        total_us = sum(mean.values())
        shares = ", ".join(
            f"{name} {us:.2f} us ({us / total_us:.3f}; {passes[name][0]} of "
            f"{reps} launches recorded)" for name, us in mean.items())
    else:
        shares = f"the profiler recorded no launch of some pass: {passes}"
    xf, bf, cf = x.float(), bm.float(), cm.float()
    f32_ms = cuda_ms(lambda: S8.ssd_scan_cuda(xf, dt, a, bf, cf), 5,
                     warmup=1)
    del xf, bf, cf
    log(f"  ssd_scan f32 instance (ssd_scan.cu, CUDA cores) at (B, L, H, P, "
        f"N)=({b}, {seq}, {h}, {p}, {n}): {f32_ms:.5f} ms per call [{card}]")
    elt = torch.finfo(dtype).bits // 8
    byt = (elt * (b * seq * h * p + 2 * b * seq * n)     # x, bm, cm
           + 4 * (b * seq * h + h)                       # dt, a
           + 4 * (b * seq * h * p + b * h * p * n))      # y, final state
    flops = 4 * b * seq * h * p * n   # increment and read-out, per state
    t_bytes = 1e3 * byt / PEAK_BYTES_S
    t_ops = 1e3 * flops / (PEAK_BF16_FLOPS if dtype == torch.bfloat16
                           else PEAK_F32_FLOPS)
    rec = {"name": "ssd_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan_bf16.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:81",
           "ms": ms["k8"], "plain_ms": ms["p8"],
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None}
    log(f"  ssd_scan at (B, L, H, P, N)=({b}, {seq}, {h}, {p}, {n}), "
        f"{str(dtype)[6:]} x/bm/cm: kernel {ms['k8']:.5f} ms per call "
        f"({1e3 * ms['d8']:.2f} us on the device by CUDA events around a "
        f"loop that only calls the C entry point, "
        f"{S8.DEVICE_LAUNCHES[dtype]} device launches per call; passes by "
        f"the profiler: {shares}), "
        f"twin {ms['p8']:.5f} ms, bound {rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']}; {byt / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP "
        f"at {'bf16' if dtype == torch.bfloat16 else 'f32'} peak); kernel / "
        f"bound {ms['k8'] / rec['bound_ms']:.2f}; library: none (no single "
        f"PyTorch call) [{card}]")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.graphs.generators import random_degree_graph, \
        random_weights
    from repro_torch.kernels import _build
    from repro_torch.kernels import dissatisfaction as D
    from repro_torch.kernels import edge_block as E
    from repro_torch.kernels import ops
    from repro_torch.core.problem import make_problem
    from repro_torch.provenance import provenance
    t_start = time.perf_counter()

    log("== phase 1: device")
    card = smi()
    log(f"  nvidia-smi: {card}")
    log(f"  provenance: {json.dumps(provenance())}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"  kernel build: {time.perf_counter() - t0:.1f} s")
    for stem, report in _build.build_reports.items():
        for line in report.splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                log(f"  [{stem}] {line.strip()}")

    log(f"== set-up: problem N={N}, K={K}, mu={MU} from seed {SEED}")
    t0 = time.perf_counter()
    adj_np = random_degree_graph(N, seed=SEED, dmin=3, dmax=6)
    node_w, edge_w = random_weights(adj_np, seed=SEED + 1, mean=5.0)
    del adj_np
    rng = np.random.default_rng(SEED + 2)
    speeds = rng.uniform(0.5, 2.0, size=K)
    problem = make_problem(edge_w, node_w, speeds, mu=MU, device="cuda")
    del edge_w
    torch.cuda.synchronize()
    log(f"  built in {time.perf_counter() - t0:.1f} s; speeds "
        f"{np.round(speeds / speeds.sum(), 4).tolist()}")

    log("== phase 2: kernels vs plain twins on the card")
    err1, err2 = phase_kernels(D, ops, problem, rng)

    log("== phase 3: main path (initial_partition -> refine)")
    main_run = phase_main(D, ops, problem)

    log("== phase 4: times (CUDA events, main-path shapes)")
    kernels = phase_times(D, problem, main_run["r"], card)
    log("== phase 5: where a turn's time goes (torch.profiler)")
    phase_profile(problem, main_run["r0"])
    for rec, err in zip(kernels, (err1, err2)):
        rec["launches"] = main_run["launches"][rec["name"]]
        rec["max_abs_err"] = err
    del problem
    torch.cuda.empty_cache()

    log(f"== phase 6: sparse set-up, N={SPARSE_N}, K={SPARSE_K}, mu={MU} "
        f"(the reference's million-node instance)")
    t0 = time.perf_counter()
    sp, r0 = sparse_instance(SPARSE_N, SPARSE_K)
    torch.cuda.synchronize()
    log(f"  built on the host in {time.perf_counter() - t0:.1f} s: "
        f"E={sp.num_edges} padded directed edges, max_degree "
        f"{sp.max_degree}")
    if (sp.num_edges, sp.max_degree) != (SPARSE_EDGES, SPARSE_MAX_DEGREE):
        fail(f"sparse instance is not the reference's: E={sp.num_edges}, "
             f"max_degree={sp.max_degree}")

    log("== phase 7: edge kernels vs plain twins on the card")
    err45 = phase_edge_kernels(D, E, sp, r0)

    log("== phase 8: sparse main path (refine_sweeps, refine)")
    sparse_run = phase_sparse_main(D, E, ops, sp, r0)

    log("== phase 9: sparse times (CUDA events, N=10^6, K=8)")
    edge_kernels = phase_sparse_times(E, sp, sparse_run["r"])
    for rec in edge_kernels:
        rec["launches"] = sparse_run["launches"][rec["name"]]
        rec["max_abs_err"] = err45
    kernels += edge_kernels
    del sp
    torch.cuda.empty_cache()

    log(f"== phase 10: fleet set-up (B={FLEET_B}, N={FLEET_N}, K={FLEET_K})"
        f" and kernel 3 vs its twin and kernel 1")
    from repro_torch.core.batch import stack_problems
    t0 = time.perf_counter()
    cases = fleet_cases()
    problems = stack_problems([c.problem for c in cases])
    r0 = torch.stack([torch.as_tensor(c.assignment.astype(np.int32),
                                      device="cuda") for c in cases])
    torch.cuda.synchronize()
    log(f"  built in {time.perf_counter() - t0:.1f} s; mu "
        f"{problems.mu.tolist()}")
    k3 = phase_fleet_kernels(D, problems, r0, card)

    log("== phase 11: dense fleet (run_sweep refine, kernel 3 per turn)")
    fleet = phase_dense_fleet(D, cases, problems, r0, card)
    k3["launches"] = fleet["launches"]["dissat_from_aggregate_batched"]
    kernels.insert(2, k3)
    del cases, problems, r0
    torch.cuda.empty_cache()

    log("== phase 12: sparse fleet and multimove")
    k3["max_abs_err"] = max(k3["max_abs_err"], phase_sparse_fleet(D, card))
    torch.cuda.empty_cache()

    from repro_torch.kernels import decode_attention as A
    from repro_torch.kernels import flash_attention as F
    log("== phase 13: attention kernels 6-7 vs plain twins on the card")
    err6, err7 = phase_attention_kernels(A, F)
    log(f"== phase 14: {LM_ARCH} at full width through ServingEngine "
        f"(kernels 6-7)")
    params, engine, serving = phase_serving(A, F, card)
    log("== phase 15: kernel path vs plain path at full width")
    phase_paths(params, engine)
    log("== phase 16: attention times (CUDA events, serving shapes)")
    attn = phase_attention_times(A, F, engine, card)
    for rec, err in zip(attn, (err6, err7)):
        rec["launches"] = serving["launches"][rec["name"]]
        rec["max_abs_err"] = err
    kernels += attn
    del params, engine
    torch.cuda.empty_cache()

    from repro_torch.kernels import ssd_scan as S8
    log("== phase 17: kernel 8 (SSD scan) vs its plain twin on the card")
    err8 = phase_ssd_kernel(S8)
    log(f"== phase 18: {SSM_ARCH} at full width through ServingEngine "
        f"(kernel 8)")
    params, engine, ssm_serving = phase_ssm_serving(S8, card)
    log("== phase 19: SSM kernel path vs plain path at full width; kernel "
        "8's times (CUDA events, serving shape)")
    rec8 = phase_ssm_paths(S8, params, engine, card)
    rec8["launches"] = ssm_serving["launches"]["ssd_scan"]
    rec8["max_abs_err"] = err8
    kernels.append(rec8)
    del params, engine
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
