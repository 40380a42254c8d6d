"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch twin, drives the dense partition game
end to end at N=16384, K=16, the sparse sweep runtime at the reference's
million-node instance (N=10^6, E=9,002,624, K=8), the batched fleets
(32 dense problems of N=4096, K=16; 4 sparse ones of N=65536, K=8), the
dense LM serving path (qwen1.5-4b at full width, 32 requests through the
continuous-batching engine), the SSM serving path (mamba2-1.3b at full
width, the same traffic) and the paper's Time-Warp DES with periodic
refinement (N=2048, K=16; a fleet of 4 at N=1024), the distributed
refinement runtime with its faults (16 shards of the dense instance),
run telemetry on those paths, the MoE and hybrid serving paths
(granite-moe-1b-a400m and zamba2-7b at full width, the same traffic), and
training with the expert planner (granite-moe-1b-a400m and mamba2-1.3b at
full width through ``launch.train``), the three LM examples
(``moe_expert_rebalance``, ``train_lm`` with its restart, and temperature
sampling on qwen1.5-4b at full width), and the contract linter over every
entry point of the game at its full size grid, times every kernel, and
checks the results.

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
     of 256 batched turns; then the same 32 elements under
     ``mode="simultaneous"`` and ``mode="multimove"`` (2 moves a machine,
     move_prob 0.5), at most 64 sweeps, each one loop over the stack:
     elements 0, 13 and 31 alone and one loop over those three equal the
     fleet bitwise; executed fleet sweeps against the elements' sum, host
     syncs a fleet sweep, one loop's wall against the looped runs';
 12. the sparse fleet — 4 weightings of ``random_degree_graph_edges(65536,
     seed=0)``: kernel 3 bitwise against its twin and kernel 1 on the
     fleet's initial sparse carry; 1024 batched ``refine`` turns, each
     element bitwise its looped run; then the same cases under
     ``mode="multimove"`` (unbounded, move_prob 0.5, ε=1e-3, 24 sweeps),
     one loop over the stack, each case bitwise a lone ``refine_sweeps``
     with the generator derived for its index, with the same
     measurements;
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
     32 greedy requests with prompts of 512-3072 tokens from
     ``default_rng(0)`` and 64 new tokens each: every request complete,
     every logit finite, kernel 7 launched 40 x 32 times, kernel 6 40 x
     decode steps, no twin; prefill tokens/s, ms per decode step,
     generated tok/s, and a profiled window of 8 decode steps;
 15. kernel path vs plain path at full width — one bf16 decode step of
     phase 14's engine on both paths; then f32 compute, the same weights,
     2 slots, max_len 1024, prompts of 500 and 900 tokens, 16 new tokens:
     equal tokens, logits within a stated tolerance;
 16. attention times — kernels 6 and 7 at the serving shapes beside their
     bound, their twins and ``scaled_dot_product_attention``, measured in
     turns; the device time of each from CUDA events around a loop that
     only calls the kernel's C entry point; kernel 6 on phase 14's cache
     at a fixed state (16 full slots, lengths ``DECODE_TIMED_LENGTHS``, a
     request's prompt plus its 64 new tokens each), its split, blocks
     launched and live blocks there, and its time at
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

 20. the DES — ``benchmarks/fig7_8_simtime.py``'s Fig. 8 setup at N=2048
     (``specialized_geometric``, degrees 3-12, so E=48 and H=96 by the
     benchmark's formula), K=16 with speeds from ``random_churn(16, 32,
     1024)``, the benchmark's flood workload (24 threads, 4 windows of 60,
     scope 2, at most 3 a source), inter/intra delays 8/1, framework c,
     ``refine_freq=2048``, ``refine_max_turns=1024``: the refined run
     (kernel 1 every refinement turn) and a static run, both to drain with
     nothing dropped or evicted and every thread seen by exactly its hop
     closure; the first 2 refinement rounds again on kernel 1's plain twin,
     every ``DESState`` field bitwise equal; 256 ticks replayed from CUDA
     graphs against eager ticks, bitwise; a profiled window of 64 ticks
     and one tick's device launches;
 21. the DES fleet and the remaining core — ``run_simulation_batch`` over 4
     scenarios at N=1024 (graphs, workloads and churn from seeds 0-3),
     refining through kernel 3, the whole run bitwise kernel 3's twin path,
     elements 0 and 3 bitwise their lone runs on kernel 1 (all of them
     take ~45 s each); then on a dense N=4096, K=16 problem: ``refine``,
     ``simulated_annealing`` (2048 steps), ``equalize_cardinality`` and
     ``count_discrepancies`` over 512 traced ct turns, each checked and
     timed;
 22. distributed refinement and faults on phase 3's instance, 16 shards
     of 1024 rows (one per machine): (a) ``refine_distributed`` to
     equilibrium, bitwise phase 3's ``refine`` (assignment, loads, moves,
     turns), kernel 3 once per loop turn and kernel 1 never, the measured
     wire reconciled with the ledger, a profiled window beside the
     controller's; (b) 512 traced turns, every trace field but the
     potentials bitwise ``refine_traced`` (the potentials within 1e-5:
     the initial ones are sums of 16 shard partials), the wire reconciled;
     the same turns on kernel 3 bitwise ``refine``'s; (c) 64 sweeps,
     assignment and counts bitwise ``refine_simultaneous`` (loads and
     potentials within 1e-5), on kernel 3 bitwise ``refine_sweeps`` on
     kernel 1; (d) 200 recompute turns on kernel 2 over the (16384,
     16384) row blocks against the controller's recompute turns on kernel
     2; (e) ``tests/test_faults.py``'s mixed fault plan (seed 0) recovers
     within the repair budget, the zero-fault plan is (a) bitwise (its
     loads after the reference's final audit, which replaces carried
     loads more than 1e-3 from the shards' fresh partials), a shard
     down to the end raises ``DeadShardError``; (f)
     ``refine_distributed_shard_map`` on a one-rank NCCL group, kernel 1
     each turn, bitwise (a); (g) phase 20's DES with
     ``refine_backend="distributed"`` over its first 2 refinement rounds,
     every ``DESState`` field bitwise phase 20's single-backend rounds.
 23. run telemetry (``repro_torch.obs``) on the instances above: (a) phase
     3's game under a ``Recorder`` with a ``JsonlSink``, bitwise phase 3,
     one ``turn`` event a turn, ``python -m repro_torch.obs.report
     --check`` exit 0; then its first 256 turns without, with, with and
     without a recorder: ms per turn, and the host syncs (counted under
     ``torch.cuda.set_sync_debug_mode("warn")``) — the only ones the
     recorder adds being its two reads of the card, before and after the
     loop;
     (b) ``make_timed_dissat_fn`` around kernel 1 for 256 turns: 256
     ``phase`` spans, bitwise the unwrapped run; (c) phase 20's first 2
     refinement rounds under a recorder: every ``DESState`` field bitwise
     phase 20's, tick rows on the stride, 4 ``des_refine`` events,
     ``--check``, ms per tick with and without; (d) phase 22 (a) under a
     recorder, bitwise, its ``wire`` event ok with measured bytes equal to
     the ledger's; a fault-injected traced run (the mixed plan) bitwise
     its recorder-free run, closing ``recovered=True``, ``--check``.
 24. full-width MoE serving — granite-moe-1b-a400m's published config (24
     layers, d_model 1024, 16 heads and 8 KV heads of 64, 32 experts of
     d_ff 512 with top-8 routing in groups of 512 at capacity 1.25, vocab
     49155, tied embeddings, f32 parameters, bf16 compute), phase 14's
     ``ServeConfig`` and traffic: (a) every request complete, every logit
     finite, kernel 7 launched 24 x 32 times, kernel 6 24 x decode steps,
     no twin; prefill tokens/s, ms per decode step, generated tok/s, a
     profiled window of 8 decode steps; (b) layer 0's MoE block on the MoE
     input of a 3072-token prompt at f32: scatter at capacity 8.0 against
     the dense oracle, scatter against einsum at 1.25 with the dropped
     pairs counted, ``expert_load`` summing to top_k, ``coactivation``
     symmetric with a zero diagonal; the bf16 block's time and device
     kernels at the prefill and decode shapes; (c) phase 15's f32 parity
     (2 slots, prompts of 500 and 900 tokens, 16 new tokens: equal tokens,
     logits within tolerance) with the smallest top-8 routing margin seen;
 25. full-width hybrid serving — zamba2-7b's published config (81 Mamba2
     layers, d_model 3584, 112 SSM heads of 64, state 64, chunk 256; one
     shared attention+MLP block, 32 heads of 112, d_ff 14336, applied
     after every 6th layer, 13 times; vocab 32000, bf16 parameters and
     compute), the same traffic: (a) kernel 8 launched 81 x 32 times,
     kernel 7 13 x 32 and kernel 6 13 x decode steps, no twin; the serving
     metrics and a profiled window; (b) kernel 8 against its twin at (1,
     3072, 112, 64, 64) in bf16 within ``SSD_TOL``, and its time; (c) the
     f32 parity of the kernel path (kernels 6-8) and the plain path.
 26. full-width MoE training — granite-moe-1b-a400m's published config
     (f32 parameters, bf16 compute, remat) trained through
     ``repro_torch.launch.train.train`` for 6 steps of 8 x 1024 tokens
     from seed 0, replanning the experts over 4 groups every 2 steps:
     (a) kernel 7 at the training shape (8, 1024, 16, 8, 64) bf16 against
     its twin, kernel 1 at the planner's (32, 4) and (24, 4) bitwise; (b)
     at f32 compute and 2 layers of full width, ``forward_train``'s loss
     and every gradient on the kernel path (kernels forward, the plain
     formula backward) against the twins under autograd, within 1e-4; (c)
     every loss finite and the last below the first; each replan's
     imbalance, moves and kernel-1 launches, its permutation bitwise
     ``expert_placement`` on the CPU from the same statistics, layer 0's
     MoE block at f32 unchanged across it within 2e-4; ms a step, trained
     tokens/s, peak memory; (d) kernel 7 launched 2 x 24 times every step
     (remat), no twin; (e) one checkpoint, at step 4, from which a fresh
     ``train`` on the directory resumes and ends on the uninterrupted
     state bitwise (params, Adam moments, statistics), its two steps
     profiled for the device's busy share;
 27. full-width SSM training — mamba2-1.3b the same way without the
     planner: kernel 8 at (8, 1024, 64, 64, 128) bf16 against its twin,
     (b), kernel 8 launched 2 x 48 times every step, (e).
 28. the LM examples — (a) ``repro_torch.moe_expert_rebalance`` (qwen3-moe
     smoke, 60 steps, the data shift at step 30, replans over 4 groups at
     mu 0.5 at steps 15, 30, 45 and 60): each replan's permutation and
     stats bitwise ``expert_placement`` on the CPU from the same router
     statistics, kernel 7 launched 60 x its layers, kernel 1 in the
     replans, no twin; (b) ``repro_torch.train_lm --steps 40
     --demo-restart`` in a temp dir (the ~115M granite-moe-100m config,
     8 x 256 tokens a step, replans over 4 groups at 10, 20 and 25, each
     checked as phase 26 checks its replans): the second run resumes at
     step 20, every loss finite; ms a step, trained tokens/s, checkpoint
     sizes and I/O; (c) ``launch.serve.serve("qwen1.5-4b", smoke=False,
     temperature=0.8, requests=8, max_new=32)`` twice (the same tokens)
     and greedy (different tokens), kernel 7 launched 40 x prefills and
     kernel 6 40 x decode steps, no twin; then 2^17 card draws of
     ``sample_logits`` from one logits row (V = 1024) at T = 0.8 without
     and with top_k 50, the total-variation distance from softmax(logits /
     T) within its bound at 10^-6 and no draw outside the top-k.
 29. the contract linter on the card — (a) ``repro_torch.analysis``'s
     every rule family at the full grid with ``device="cuda"``: the 17
     rules, the dispatch matrix, the findings (none outside the port's
     ``baseline.json``) and the seconds; (b) for each of the 21 entry
     points the allocator's peak bytes at each N of the grid and the
     fitted ``mem_device`` exponents, each within its declared budget +
     ``EXPONENT_TOL`` and within ``EXPECTATION_TOL`` of
     ``complexity.json``'s ``full/cuda`` section; (c) kernels 1-8's
     launches during (a) (``analysis_launches`` in the kernels' line):
     kernels 1, 3 and 4, on the entry points' card routes, more than 0.

Each path's launch counts are set to 0 just before it and read just after.
The sharding hints' redistribution counts
(``repro_torch.sharding.hints.redistributions``) are set to 0 before phase
14 and must read 0 after every serving, training and example phase: no
mesh is active on the card, so every hint and relayout in the model code
returns its input.  Before the kernels' record, one line gives the ms a
decode step of phases 14, 18, 24 and 25 beside an earlier run's, with the
card's name and power limit.
The line before the last two is the kernels' JSON record; then the card's
name and power limit; the last line is ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
HUB_N = 20_000            # phase 7's hub instances (BA, m=2; and a star)
HUB_DEGREE = 5000         # the star's hub: five of the kernels' chunks
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
# phase 11's sweep modes over the same 32 elements: run_sweep's
# "simultaneous" (§4.5) and "multimove" with these knobs, each a cap of
# FLEET_SWEEPS sweeps (a cut for the script's time limit)
FLEET_SWEEPS = 64
FLEET_MULTIMOVE = dict(moves_per_machine=2, move_prob=0.5)
SPARSE_FLEET_B = 4
SPARSE_FLEET_N = 65536
SPARSE_FLEET_K = 8
SPARSE_FLEET_TURNS = 1024
SPARSE_FLEET_SWEEPS = 24

# the dense LM serving path: qwen1.5-4b's published config unchanged
LM_ARCH = "qwen1.5-4b"
SERVE_SLOTS = 16
SERVE_MAX_LEN = 4096
SERVE_REQUESTS = 32         # cut for the script's time limit
SERVE_PROMPT = (512, 3072)  # prompt lengths, uniform, from default_rng(SEED)
SERVE_NEW = 64
PROFILE_STEPS = 8           # profiled engine decode steps at full occupancy
PARITY_PROMPTS = (500, 900)  # phase 15, f32 compute, kernel vs plain path
PARITY_NEW = 16
PARITY_MAX_LEN = 1024
# (B, H, Hkv, D, S) and (B, S, H, Hkv, D) of phase 13; head_dim 112 is
# zamba2-7b's, 96 is not a power of two and 100 not a multiple of 8 (the
# bf16 kernel 7 then pads it); G = 2 at D = 64 is granite-moe-1b-a400m's
# serving shape
DECODE_SHAPES = ((16, 20, 20, 128, 4096), (4, 32, 8, 128, 1000),
                 (3, 8, 1, 64, 777), (16, 32, 32, 112, 4096),
                 (16, 16, 8, 64, 4096))
# kernel 6's split-S cases of phase 13, (B, H, Hkv, D, S): G = 7 (yi-34b's
# head layout), G = 8 at zamba2-7b's D = 112, G = 48 (granite-34b's: each
# warp keeps several (row, part) states in shared memory), and D = 100 (no
# multiple of 8: the instance that stages without TMA); each row's length
# is one split, a split border, one past it, 1, above S, S, ...
DECODE_SPLIT_SHAPES = ((8, 56, 8, 128, 4096), (4, 64, 8, 112, 1500),
                       (4, 48, 1, 128, 4096), (8, 16, 16, 100, 777))
# kernel 6's timed state in phase 16: every slot full, each holding a
# request at its last decode step (a prompt from SERVE_PROMPT plus SERVE_NEW
# tokens), lengths from default_rng(SEED), whatever the request count
DECODE_TIMED_LENGTHS = tuple(int(n) + SERVE_NEW for n in np.random.default_rng(
    SEED).integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_SLOTS))
# kernel 6 at a GQA shape in phase 16, for information: yi-34b's heads
DECODE_GQA_SHAPE = (16, 56, 8, 128, 4096)
FLASH_SHAPES = ((1, 3072, 20, 20, 128), (2, 1000, 32, 8, 128),
                (1, 333, 8, 1, 64), (1, 3072, 32, 32, 112),
                (2, 1000, 32, 8, 96), (1, 130, 14, 2, 100),
                (1, 3072, 16, 8, 64))
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

# phases 20-21: the DES (benchmarks/fig7_8_simtime.py's Fig. 8 model at
# size), its fleet, and the remaining core.  At N=4096 a tick takes
# 2.1-2.7 ms on the card and the two runs to drain take 32.6k and 52.5k
# ticks (80 + 115 s, tools/des_probe.py); N=2048 halves the busy time an
# event takes (resident LPs x proc_ticks) and with it the ticks to drain.
# 64 threads are the most that drain at N=2048 with nothing dropped or
# evicted, refined and static (tools/des_probe.py --largest: 96, 128, 192
# and 256 overflow the 48-slot event lists); the benchmark has 24 at N=96.
DES_N = 2048
DES_K = 16
DES_THREADS = 64
DES_WINDOWS = 4
DES_WINDOW_TIME = 60.0
DES_SCOPE = 2
DES_REFINE_FREQ = 2048
DES_REFINE_TURNS = 1024
DES_MAX_TICKS = 400_000
DES_CHURN = (32, 1024)      # random_churn: segments, ticks a segment
DES_PARITY_ROUNDS = 2       # refinement rounds held kernel vs twin path
DES_EAGER_TICKS = 256       # ticks held graph-replayed vs eager
DES_PROFILE_TICKS = 64
DES_FLEET_B = 4              # cut for the script's time limit
DES_FLEET_N = 1024
DES_FLEET_THREADS = 24
DES_FLEET_REFINE_FREQ = 512
DES_FLEET_TURNS = 512
DES_FLEET_CHURN = (32, 256)
# fleet elements also run alone (all 8 took ~90 s; the first and the last
# keep the batched == looped check inside the script's time limit)
DES_FLEET_LONE = (0, DES_FLEET_B - 1)
# phase 22: the distributed slice on phase 3's instance, one shard per
# machine (the reference's default); the fault plan is
# tests/test_faults.py::_mixed_plan's, scaled to S and K
DIST_S = 16
DIST_TRACED_TURNS = 512
DIST_SWEEPS = 64
DIST_PLAN_ROUNDS = 96
DIST_PLAN = dict(p_down=0.03, down_length=(2, 4), p_omit=0.05, p_lost=0.2,
                 p_dup=0.08, p_corrupt=0.04)
DIST_PROFILE_TURNS = 256
TELEMETRY_WINDOW = 256      # phase 23 (a): turns a timed window
TIMED_TURNS = 256           # phase 23 (b): turns under the timed dissat_fn
ANNEAL_N = 4096
ANNEAL_K = 16
ANNEAL_STEPS = 2048
ANNEAL_TRACE_TURNS = 512

# phases 24-25: the MoE and hybrid families at their published widths,
# phase 14's ServeConfig and traffic
MOE_ARCH = "granite-moe-1b-a400m"
HYBRID_ARCH = "zamba2-7b"
# one MoE block's impls against each other at f32 compute: max |diff| <=
# MOE_TOL * max(1, max |want|) (the reference's own tolerance between
# them, tests/test_models.py); the same routing code, so the statistics
# are equal
MOE_TOL = 1e-4
MOE_TIMED_ITERS = 10

# ms a decode step of phases 14, 18, 24 and 25 (32 requests) in an earlier
# run of this script on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section
# 5), printed beside this run's
EARLIER_DECODE_MS = {"qwen1.5-4b": 60.846, "mamba2-1.3b": 48.807,
                     "granite-moe-1b-a400m": 85.699, "zamba2-7b": 113.776}

# phases 26-27: training at full width (launch.train.train), the
# expert planner on granite's router statistics
# (6 steps: the script's time limit)
TRAIN_STEPS = 6
TRAIN_BATCH = 8
TRAIN_SEQ = 1024
TRAIN_REPLAN = 2            # replans at steps 2, 4 and 6
TRAIN_GROUPS = 4            # expert groups the planner balances over
TRAIN_CKPT_EVERY = 4        # (e): one checkpoint, at 4, resumed from it
TRAIN_PARITY_LAYERS = 2     # (b): f32, full width, kernel vs plain autograd
TRAIN_GRAD_TOL = 1e-4       # (b): max |g_k - g_p| / max |g_p| over leaves
PLANNER_MOE_TOL = 2e-4      # (c): the reference's budget, test_planner.py
PLANNER_MOE_TOKENS = 1024   # (c): tokens through layer 0's MoE block
TRAIN_PROFILE_STEPS = (4, 5)  # (e): steps of the resumed run profiled

# phase 28: the LM examples on the card
EXAMPLE_REPLANS = [15, 30, 45, 60]  # (a): moe_expert_rebalance's replans
TRAIN_LM_STEPS = 40         # (b): train_lm --steps 40 --demo-restart
SAMPLE_ARCH = LM_ARCH       # (c): temperature sampling at full width
SAMPLE_TEMPERATURE = 0.8
SAMPLE_REQUESTS = 8
SAMPLE_NEW = 32
SAMPLE_DRAWS = 2 ** 17      # (c): card draws from one logits row
SAMPLE_VOCAB = 1024         # its width (a seeded N(0, 3^2) row)
SAMPLE_TOP_K = 50

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s on the tensor cores

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12


_START = time.perf_counter()


def log(*args) -> None:
    if args and str(args[0]).startswith("== "):    # a phase's header
        args = (*args, f"[{time.perf_counter() - _START:.1f} s in]")
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _timed(fn) -> float:
    """Seconds ``fn()`` takes."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def check_redistributions(phase: str) -> None:
    """Fail unless no sharding hint or relayout has redistributed a
    tensor since the counts were set to 0 before phase 14."""
    from repro_torch.sharding import hints
    if any(hints.redistributions.values()):
        fail(f"{phase}: sharding redistributions on the card: "
             f"{hints.redistributions}")
    log(f"  {phase}: sharding redistributions {hints.redistributions}")


def decode_ms(stats: dict) -> float:
    return 1e3 * stats["decode_s"] / stats["decode_steps"]


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
    return {"r": r, "r0": r0, "loads": res.loads, "launches": launches,
            "moves": moves, "turns": turns,
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

def sparse_instance(n: int, k: int, seed: int = 0, device="cuda",
                    graph: str = "random_degree"):
    """The reference's sparse benchmark instance
    (``benchmarks/sparse_bench.py::_sparse_instance``), built the same
    way from the port's verbatim copy of the generators.  ``graph``
    "barabasi" takes ``preferential_attachment_edges(n, m=2)`` instead,
    whose first nodes are hubs, and "star" adds edges from node 0 to
    nodes 1..HUB_DEGREE, a row spanning several of the kernels' chunks."""
    from repro_torch.core.sparse import make_sparse_problem
    from repro_torch.graphs.generators import (preferential_attachment_edges,
                                               random_degree_graph_edges,
                                               random_weights_edges)
    if graph == "barabasi":
        s, r = preferential_attachment_edges(n, seed=seed, m=2)
    else:
        s, r = random_degree_graph_edges(n, seed=seed)
    if graph == "star":
        s = np.concatenate([s, np.zeros(HUB_DEGREE, s.dtype)])
        r = np.concatenate([r, np.arange(1, HUB_DEGREE + 1, dtype=r.dtype)])
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
            wants5["a second call"] = E.sweep_candidates_from_edges_cuda(
                *args, theta=th)
            torch.cuda.synchronize()
            for name, want in wants5.items():
                diff = float((sweep[0] - want[0]).abs().max())
                err = max(err, diff)
                for part, a, c in zip(("gains", "picks", "dests"), sweep,
                                      want):
                    if not torch.equal(a, c):
                        fail(f"kernel 5 {part} != {name} {tag}: max |diff| "
                             f"{float((a.double() - c.double()).abs().max())}")
            if int(E._ticket(r.device)[0]) != 0:
                fail(f"kernel 5 left its ticket at "
                     f"{int(E._ticket(r.device)[0])} {tag}")
    deg = torch.diff(sp.row_start, append=torch.tensor(
        [sp.num_edges], dtype=torch.int32, device=sp.row_start.device))
    log(f"  kernels 4, 5 {label}: N={sp.num_nodes} E={sp.num_edges} "
        f"K={k}, largest row {int(deg.max())} edges: kernel 4 bitwise equal "
        f"to its twin and to kernel 1 on the sparse aggregate; kernel 5 "
        f"bitwise equal to its twin, to the election from kernel 4 and to "
        f"a second call, its ticket back at 0 (c, ct; theta absent and 0.5)")
    return err


def phase_edge_kernels(D, E, sp, r0):
    err = check_edge_kernels(D, E, sp, r0,
                             torch.full((sp.num_nodes,), 0.5, device="cuda"),
                             "full N")
    small, r_small = sparse_instance(1003, SPARSE_K, seed=5)
    err = max(err, check_edge_kernels(
        D, E, small, r_small, torch.full((1003,), 0.5, device="cuda"),
        "ragged N=1003"))
    for graph, k in (("barabasi", SPARSE_K), ("barabasi", 16),
                     ("star", SPARSE_K)):
        hub, r_hub = sparse_instance(HUB_N, k, seed=7, graph=graph)
        err = max(err, check_edge_kernels(
            D, E, hub, r_hub, torch.full((HUB_N,), 0.5, device="cuda"),
            f"{graph} hub graph"))
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


def edge_entries(E, sp, r, b, loads, speeds, mu, total_b):
    """Calls of kernels 4 and 5's C entry points with the arguments their
    wrappers pass (no checks, no allocation), and the buffers they write:
    kernel 4's (dissat, best), kernel 5's (gains, picks, dests) views.
    ``mu`` and ``total_b`` are device scalars the caller holds."""
    from repro_torch.kernels.dissatisfaction import _entry_point
    dev = r.device
    n, e, k = sp.num_nodes, sp.num_edges, loads.shape[0]
    ins, _ = E._inputs(sp, r, b, loads, speeds, mu, None, total_b, dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    dissat, best = torch.empty_like(b), torch.empty_like(r)
    a4 = ins + (dissat.data_ptr(), best.data_ptr(), n, e, k, 0, stream)
    a5, views = E.sweep_candidates_args(ins, n, e, k, 0, stream, dev)
    f4 = _entry_point("dissat_from_edges", "edge_block")
    f5 = _entry_point("sweep_candidates_from_edges", "edge_block")
    return (lambda: f4(*a4)), (lambda: f5(*a5)), (dissat, best), views


def device_launches(fn, calls: int = 4, reps: int = 20):
    """The device launches of ``calls`` calls of ``fn``, exactly: (kernel
    nodes a call, other nodes a call) of one CUDA graph that captures the
    calls, where every launch is a node and none is dropped; then the
    names of the device kernels the profiler records over ``reps`` calls
    (it drops some of a window's records: all of four calls' once)."""
    import ctypes

    from torch.profiler import ProfilerActivity, profile
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int)]
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    raw = graph.raw_cuda_graph()
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
        fail("cuGraphGetNodes failed on a captured graph")
    nodes = (ctypes.c_void_p * count.value)()
    if cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) != 0:
        fail("cuGraphGetNodes failed on a captured graph")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0:
            fail("cuGraphNodeGetType failed on a captured graph")
        kinds.append(kind.value)
    graph.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if getattr(e, "device_type", None) is not None
                    and str(e.device_type).endswith("CUDA")})
    kernels = kinds.count(0)                   # 0: a kernel node
    return kernels / calls, (len(kinds) - kernels) / calls, names


def phase_sparse_times(E, sp, r, card):
    """Kernels 4 and 5 at the million-node shape, three ways in turns: CUDA
    events over wrapper calls, CUDA events over C entry-point calls, and
    the kernels' device time by the profiler; beside them the twins and
    ``torch.sparse.mm``.  The 92 MB of inputs exceed the 50 MB L2, so each
    call reads most of them from device memory without cycling copies."""
    from repro_torch.core.problem import machine_loads
    from repro_torch.kernels.dissatisfaction import _scalar
    k = sp.num_machines
    n, e = sp.num_nodes, sp.num_edges
    b = sp.node_weights
    total_b = torch.sum(b)
    loads = machine_loads(b, r, k)
    mu = _scalar(sp.mu, r.device)
    args = (sp, r, b, loads, sp.speeds, mu, "c")
    real = sp.edge_weights != 0
    csr = torch.sparse_coo_tensor(
        torch.stack([sp.senders[real].long(), sp.receivers[real].long()]),
        sp.edge_weights[real], (n, n)).coalesce().to_sparse_csr()
    onehot = (r.long()[:, None] == torch.arange(k, device="cuda")).float()
    e4, e5, out4, out5 = edge_entries(E, sp, r, b, loads, sp.speeds, mu,
                                      total_b)
    fns = {
        "k4": lambda: E.dissatisfaction_from_edges_cuda(
            *args, total_weight=total_b),
        "e4": e4,
        "p4": lambda: E.dissatisfaction_from_edges_plain(
            *args, total_weight=total_b),
        "k5": lambda: E.sweep_candidates_from_edges_cuda(
            *args, total_weight=total_b),
        "e5": e5,
        "p5": lambda: E.sweep_candidates_from_edges_plain(
            *args, total_weight=total_b),
        "lib": lambda: torch.sparse.mm(csr, onehot),
    }
    # an entry-point call launches and writes what its wrapper returns
    for entry, wrapper, got in (("e4", "k4", out4), ("e5", "k5", out5)):
        if fns[entry]() != 0:
            fail(f"edge kernel entry point {entry} did not launch")
        want = fns[wrapper]()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            fail(f"{entry}: a launch-only call differs from its wrapper's")
    t = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1], list(fns)):
        for name in order:
            iters = 5 if name in ("p4", "p5") else 50
            t[name].append(cuda_ms(fns[name], iters))
    ms = {name: float(np.mean(v)) for name, v in t.items()}
    device_us = kernel_device_us({"dissat_from_edges": (e4, 20),
                                  "sweep_candidates_from_edges": (e5, 20)})
    per_call = {"k4": device_launches(fns["k4"]),
                "k5": device_launches(fns["k5"])}
    f4, i4 = 4, 4
    # each input read once: row offsets, receivers, weights, assignment,
    # node weights, loads, speeds, mu, B; then the outputs written once
    # (kernel 5's are the three (K,) vectors)
    reads = i4 * n + i4 * e + f4 * e + i4 * n + f4 * n + 2 * f4 * k + 2 * f4
    bytes4 = reads + f4 * n + i4 * n
    bytes5 = reads + k * (f4 + 2 * i4)
    ops4 = int(e) + n * k * 12     # one add per edge, then the assembly
    out = []
    for name, tag, byt, flops, line in (
            ("dissat_from_edges", "4", bytes4, ops4, 170),
            ("sweep_candidates_from_edges", "5", bytes5, ops4 + n * k,
             245)):
        bound, by = _bound_ms(byt, flops)
        dev_us = device_us[name]
        wrap, entry = ms[f"k{tag}"], ms[f"e{tag}"]
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/edge_block.cu",
                    "replaces": f"src/repro/kernels/edge_block.py:{line}",
                    "ms": wrap, "plain_ms": ms[f"p{tag}"],
                    "bound_ms": bound, "bound_by": by,
                    "library_ms": ms["lib"]})
        log(f"  {name} (kernel {tag}) at (N, E, K)=({n}, {e}, {k}): "
            f"{wrap:.5f} ms per wrapper call "
            f"({' '.join(f'{x:.5f}' for x in t['k' + tag])}), {entry:.5f} "
            f"ms per C entry-point call "
            f"({' '.join(f'{x:.5f}' for x in t['e' + tag])}), "
            f"{'not measured' if dev_us is None else f'{dev_us:.2f} us'} on "
            f"the device by the profiler; {per_call['k' + tag][0]:g} device "
            f"launches per wrapper call (CUDA graph nodes), of "
            f"{per_call['k' + tag][2]} [{card}]")
        dev_ms = entry if dev_us is None else 1e-3 * dev_us
        log(f"    bound {bound:.5f} ms ({by}, {byt / 1e6:.2f} MB), device "
            f"time / bound {dev_ms / bound:.3f}, per wrapper call / bound "
            f"{wrap / bound:.3f}; twin {ms['p' + tag]:.5f} ms; library "
            f"{ms['lib']:.5f} ms (torch.sparse.mm CSR @ one-hot, aggregate "
            f"only)")
    # one launch a call, and that of kernel 5 (no argmax, max or gather
    # after it)
    launches, others, names = per_call["k5"]
    if not (launches == 1 and others == 0 and len(names) == 1
            and "sweep_candidates_from_edges_kernel" in names[0]):
        fail(f"kernel 5's wrapper made other device launches than one of "
             f"its kernel: {launches} kernel and {others} other graph "
             f"nodes a call, {names}")
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
    for mode, kw in (("simultaneous", {}), ("multimove", FLEET_MULTIMOVE)):
        phase_fleet_sweeps(D, cases, mode, kw, FLEET_SWEEPS, FLEET_LOOPED,
                           card)
    return {"launches": launches, "batched_turns": batched_turns,
            "ms_per_batched_turn": 1e3 * wall / batched_turns,
            "element_turns_per_s": float(turns.sum() / wall),
            "looped_element_turns_per_s": looped}


def _sweep_lone(case, index, mode, kw, max_sweeps):
    """Case ``index``'s lone run of a sweep mode, with the coin generator
    ``run_sweep`` derives for it (seed 0)."""
    from repro_torch.core.refine import refine_simultaneous, refine_sweeps
    from repro_torch.sweeps.runtime import case_generator
    if mode == "simultaneous":
        return refine_simultaneous(case.problem, case.assignment,
                                   case.framework, max_sweeps=max_sweeps)
    gen = (case_generator(0, index, "cuda")
           if kw.get("move_prob", 1.0) < 1.0 else None)
    return refine_sweeps(case.problem, case.assignment, case.framework,
                         max_sweeps=max_sweeps, generator=gen, **kw)


def _same_sweep_run(lone, result, trace) -> bool:
    """A lone sweep run equals a fleet element (its result and its
    (c0s, ct0s, active)) bitwise, dtypes included."""
    got = list(result) + list(trace)
    want = list(lone[0]) + list(lone[1])
    return len(got) == len(want) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))


def phase_fleet_sweeps(D, cases, mode, kw, max_sweeps, lone_idx, card):
    """A fleet through ``run_sweep(mode)``, one loop over the stack: its
    executed fleet sweeps against Σ_b sweeps_b, its host syncs (the flag
    reads in ``core/batch.py`` a fleet sweep), its wall against the lone
    runs of the elements ``lone_idx`` and against one loop over those
    elements alone; every lone run and that small loop's elements bitwise
    the fleet's, and no kernel launched (the sweep modes reduce with the
    assembled cost matrix, as the reference's vmapped sweeps do)."""
    from repro_torch import sweeps
    from repro_torch.core.batch import (refine_simultaneous_batched,
                                        refine_sweeps_batched,
                                        stack_problems, unstack_pytree)
    from repro_torch.sweeps.runtime import case_generator
    spec = sweeps.make_spec(cases, mode=mode, max_turns=max_sweeps, **kw)
    D.reset_launches()
    res, wall, syncs, where = count_syncs(lambda: sweeps.run_sweep(spec))
    if any(D.launches.values()):
        fail(f"the {mode} fleet launched kernels: {dict(D.launches)}")
    turns = res.turns
    fleet_sweeps, total = int(turns.max()), int(turns.sum())
    loop_reads = max((c for site, c in where.items()
                      if site.startswith("batch.py:")), default=0)
    log(f"  run_sweep({mode}{', ' if kw else ''}"
        f"{', '.join(f'{k}={v}' for k, v in kw.items())}), B={len(cases)}, "
        f"cap {max_sweeps} sweeps: sweeps per element {int(turns.min())}-"
        f"{fleet_sweeps}, converged {int(res.converged.sum())}/{len(cases)}"
        f", {int(res.moves.sum())} moves; {fleet_sweeps} executed fleet "
        f"sweeps against sum_b sweeps_b = {total}; {syncs} host syncs "
        f"({loop_reads} flag reads of the loop, "
        f"{loop_reads / max(fleet_sweeps, 1):.3f} a fleet sweep; by site "
        f"{dict(where)}); {wall:.3f} s, "
        f"{1e3 * wall / max(fleet_sweeps, 1):.3f} ms a fleet sweep [{card}]")
    lone_idx = list(lone_idx)
    if lone_idx == list(range(len(cases))):     # the fleet is that loop
        small, small_wall = None, wall
    else:
        sub = [cases[e] for e in lone_idx]
        sub_p = stack_problems([c.problem for c in sub])
        sub_r0 = torch.stack([torch.as_tensor(
            np.asarray(c.assignment, np.int32), device="cuda") for c in sub])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "simultaneous":
            small = refine_simultaneous_batched(sub_p, sub_r0, "c",
                                                max_sweeps=max_sweeps)
        else:
            gens = ([case_generator(0, e, "cuda") for e in lone_idx]
                    if kw.get("move_prob", 1.0) < 1.0 else None)
            small = refine_sweeps_batched(sub_p, sub_r0, "c",
                                          max_sweeps=max_sweeps,
                                          generators=gens, **kw)
        torch.cuda.synchronize()
        small_wall = time.perf_counter() - t0
    lone_wall, lone_sweeps = 0.0, []
    for j, e in enumerate(lone_idx):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lone = _sweep_lone(cases[e], e, mode, kw, max_sweeps)
        torch.cuda.synchronize()
        lone_wall += time.perf_counter() - t0
        lone_sweeps.append(int(lone[0].num_turns))
        if not _same_sweep_run(lone, res.results[e], res.traces[e]):
            fail(f"{mode} fleet element {e} differs from its lone run")
        if small is not None and not _same_sweep_run(
                lone, *unstack_pytree(small, j)):
            fail(f"{mode} loop over elements {lone_idx}: element {e} "
                 f"differs from its lone run")
    log(f"  elements {lone_idx} alone: sweeps {lone_sweeps}, bitwise "
        f"equal to the fleet and to one loop over these {len(lone_idx)}; "
        f"looped {lone_wall:.3f} s ({sum(lone_sweeps)} sweeps) against one "
        f"loop {small_wall:.3f} s ({max(lone_sweeps)} fleet sweeps), "
        f"{lone_wall / small_wall:.2f}x [{card}]")


def phase_sparse_fleet(D, card):
    from repro_torch import sweeps
    from repro_torch.core.batch import stack_problems
    from repro_torch.core.refine import refine
    from repro_torch.core.sparse import make_sparse_problem
    from repro_torch.graphs.generators import (random_degree_graph_edges,
                                               random_weights_edges)
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

    # the unbounded multimove fleet, one loop over the stack, each case
    # bitwise a lone refine_sweeps with the generator derived for its index
    phase_fleet_sweeps(D, cases, "multimove", dict(
        moves_per_machine=None, move_prob=0.5, epsilon=1e-3),
        SPARSE_FLEET_SWEEPS, range(SPARSE_FLEET_B), card)
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
    """Phases 14, 18, 24 and 25: ``cfg`` at full width, random weights
    from a seeded generator on the card, serving the 32 requests of
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
    want = cfg.param_count() + cfg.shared_block_params()
    elt = torch.finfo(cfg.pdtype()).bits // 8
    log(f"  init_params on the card (seed {SEED}): {n_params} parameters "
        f"({elt * n_params / 1e9:.2f} GB {cfg.param_dtype}) in "
        f"{time.perf_counter() - t0:.2f} s")
    if n_params != want:
        fail(f"{n_params} parameters, the config counts {want}")
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


def _check_serving_launches(launches, twins, want):
    for name, n in want.items():
        if launches[name] != n:
            fail(f"kernel {name} launched {launches[name]} times, want {n}")
    if any(twins.values()):
        fail(f"a twin ran on the serving path: {twins}")


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
    _check_serving_launches(launches, twins, {
        "flash_attention": cfg.num_layers * SERVE_REQUESTS,
        "decode_attention": cfg.num_layers * steps})
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


def _parity_prompts(vocab: int):
    rng = np.random.default_rng(SEED + 1)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n in PARITY_PROMPTS]


def _f32_parity(params, cfg, *switches: str) -> float:
    """Phases 15, 19, 24 and 25: f32 compute, the same weights, two
    requests through a 2-slot engine on the kernel path and on the plain
    path (``switches`` name the engine's arguments that select it): tokens
    equal, every sampled logit within ``F32_LOGIT_TOL``."""
    import dataclasses

    from repro_torch.serving import Request, ServeConfig, ServingEngine
    from repro_torch.serving.sampler import greedy

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    prompts = _parity_prompts(cfg.vocab_size)
    runs = {}
    for path in ("kernel", "plain"):
        seen = []

        def sampler(logits, seen=seen):
            seen.append(logits[:, -1].float().cpu())
            return greedy(logits)

        eng = ServingEngine(cfg32, params, ServeConfig(
            max_batch=2, max_len=PARITY_MAX_LEN, cache_dtype="float32"),
            sampler=sampler, **{switch: path for switch in switches})
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
    # kernel 6: layer 0 of the engine's cache at the fixed lengths
    k6, v6 = engine.cache.kv_k[0], engine.cache.kv_v[0]
    b, s = k6.shape[0], k6.shape[1]
    length = torch.tensor(DECODE_TIMED_LENGTHS, dtype=torch.int32,
                          device="cuda")
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


def _ssd_bound(b, seq, h, p, n, dtype):
    """Kernel 8's work at (B, L, H, P, N): (bytes, flops, ms at the byte
    rate, ms at the operation rate of ``dtype``'s peak)."""
    elt = torch.finfo(dtype).bits // 8
    byt = (elt * (b * seq * h * p + 2 * b * seq * n)     # x, bm, cm
           + 4 * (b * seq * h + h)                       # dt, a
           + 4 * (b * seq * h * p + b * h * p * n))      # y, final state
    flops = 4 * b * seq * h * p * n   # increment and read-out, per state
    t_bytes = 1e3 * byt / PEAK_BYTES_S
    t_ops = 1e3 * flops / (PEAK_BF16_FLOPS if dtype == torch.bfloat16
                           else PEAK_F32_FLOPS)
    return byt, flops, t_bytes, t_ops


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
    byt, flops, t_bytes, t_ops = _ssd_bound(b, seq, h, p, n, dtype)
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



# ---------------------------------------------------------------------------
# phases 20-21: the DES, its fleet, and the remaining core
# ---------------------------------------------------------------------------

def des_instance(n: int, k: int, threads: int, seed: int, refine_freq: int,
                 refine_turns: int, churn: tuple[int, int]):
    """``benchmarks/fig7_8_simtime.py``'s Fig. 8 setup at size: the
    specialized geometric graph, the moving hot-spot flood workload, an
    Appendix-A initial partition and a ``random_churn`` schedule.  Returns
    (config, adjacency on the device, the initial state, the schedule,
    the workload)."""
    from repro_torch.core.initial import initial_partition
    from repro_torch.des import engine, scenarios
    from repro_torch.des.workload import flooded_packet_workload
    from repro_torch.graphs.generators import specialized_geometric
    adj = specialized_geometric(n, seed)
    deg = int((adj > 0).sum(1).max())
    spec = flooded_packet_workload(
        adj, seed, num_threads=threads, num_windows=DES_WINDOWS,
        window_sim_time=DES_WINDOW_TIME, scope=DES_SCOPE, max_per_lp=3)
    cfg = engine.DESConfig(
        num_lps=n, num_machines=k, num_threads=threads,
        event_capacity=max(48, 2 * deg + 8),
        history_capacity=max(96, 4 * deg + 16), inter_delay=8,
        intra_delay=1, refine_freq=refine_freq, refine_framework="c",
        refine_max_turns=refine_turns, max_ticks=DES_MAX_TICKS)
    adj_t = torch.as_tensor(adj, device="cuda")
    m0 = initial_partition(adj_t, k, generator=seed)
    state = engine.make_initial_state(cfg, m0, spec.src, spec.time,
                                      spec.count, device="cuda")
    return cfg, adj_t, state, scenarios.random_churn(k, *churn, seed=seed), \
        spec


def des_fields(state, prefix=""):
    """(name, tensor) for every field of a ``DESState``, nested ones too."""
    for name in state._fields:
        value = getattr(state, name)
        if isinstance(value, tuple):
            yield from des_fields(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", value


def des_differ(a, b) -> list[str]:
    return [name for (name, x), (_, y) in zip(des_fields(a), des_fields(b))
            if not torch.equal(x, y)]


def flood_closure_ok(adj, spec, seen) -> bool:
    """The DES's own oracle (``tests/test_des.py``): every thread is seen
    by exactly the LPs within its hop budget of its source."""
    nbr = (adj > 0).to(torch.float32)
    src = torch.as_tensor(spec.src.astype(np.int64), device=adj.device)
    hops = torch.as_tensor(spec.count.astype(np.int64), device=adj.device)
    mask = torch.zeros((len(spec.src), adj.shape[0]), dtype=torch.bool,
                       device=adj.device)
    mask[torch.arange(len(spec.src), device=adj.device), src] = True
    for hop in range(1, int(spec.count.max()) + 1):
        grown = mask | ((mask.to(torch.float32) @ nbr) > 0)
        mask = torch.where((hops >= hop)[:, None], grown, mask)
    return torch.equal(mask.T, seen)


def _des_summary(label, out, wall, card) -> str:
    ticks = int(out.tick)
    return (f"  {label}: {ticks} ticks, processed {int(out.processed)}, "
            f"rollbacks {int(out.rollbacks)}, refines {int(out.refines)}, "
            f"moves {int(out.moves)}, dropped {int(out.dropped)}, "
            f"hist_evict {int(out.hist_evict)}, drained {bool(out.done)}, "
            f"{wall:.3f} s, {1e3 * wall / max(ticks, 1):.4f} ms per tick "
            f"[{card}]")


def _des_checks(label, out, adj, spec):
    if not bool(out.done):
        fail(f"{label}: the DES did not drain in {int(out.tick)} ticks")
    if int(out.dropped) or int(out.hist_evict):
        fail(f"{label}: dropped {int(out.dropped)}, hist_evict "
             f"{int(out.hist_evict)} (both must be 0)")
    if not flood_closure_ok(adj, spec, out.seen):
        fail(f"{label}: a thread's seen set is not its hop closure")


def phase_des(D, card):
    """The DES at size: a refined run and a static run to drain, kernel 1
    against its twin over the first refinement rounds, a profiled window
    of ticks."""
    import dataclasses

    from repro_torch.core.batch import stack_pytrees
    from repro_torch.des import engine
    from repro_torch.kernels.ops import make_aggregate_dissat_fn_plain
    sync = torch.cuda.synchronize

    t0 = time.perf_counter()
    cfg, adj, s0, churn, spec = des_instance(
        DES_N, DES_K, DES_THREADS, SEED, DES_REFINE_FREQ, DES_REFINE_TURNS,
        DES_CHURN)
    sync()
    log(f"  set-up {time.perf_counter() - t0:.1f} s: specialized_geometric("
        f"{DES_N}, seed={SEED}), E={cfg.event_capacity}, "
        f"H={cfg.history_capacity}, T={DES_THREADS}, K={DES_K}, "
        f"refine_freq={cfg.refine_freq}, framework c, max turns "
        f"{cfg.refine_max_turns}, random_churn{DES_CHURN}")
    prefix_cfg = dataclasses.replace(
        cfg, max_ticks=DES_PARITY_ROUNDS * cfg.refine_freq)

    # the main path, counted: to the end of the first rounds, then on to
    # the drain from there (the run resumes bitwise where it stopped)
    D.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    prefix = engine.run_simulation(prefix_cfg, adj, s0, churn)
    sync()
    t_prefix = time.perf_counter() - t0
    refined = engine.run_simulation(cfg, adj, prefix, churn)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(D.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(_des_summary("refined (kernel 1)", refined, wall, card))
    log(f"  peak device memory {peak:.2f} GB; launches over the refined "
        f"run: {launches}")
    _des_checks("refined run", refined, adj, spec)
    if int(refined.refines) < 1 or launches["dissat_from_aggregate"] <= 0:
        fail("the refined DES made no refinement round on kernel 1")

    sync()
    t0 = time.perf_counter()
    twin = engine.run_simulation(prefix_cfg, adj, s0, churn,
                                 dissat_fn=make_aggregate_dissat_fn_plain())
    sync()
    t_twin = time.perf_counter() - t0
    differ = des_differ(prefix, twin)
    log(f"  kernel path vs twin path over the first {int(prefix.refines)} "
        f"refinement rounds ({int(prefix.tick)} ticks): every DESState field"
        f" bitwise equal: {not differ} ({t_prefix:.3f} s / {t_twin:.3f} s)")
    if differ or int(prefix.refines) < min(DES_PARITY_ROUNDS,
                                           int(refined.refines)):
        fail(f"DES kernel path differs from its twin path in {differ}")

    # the run loop replays CUDA graphs of ticks; eager ticks must agree
    window = dataclasses.replace(cfg, max_ticks=DES_EAGER_TICKS)
    graphed = engine.run_simulation(window, adj, s0, churn)
    eager = engine._run_lone(window, adj, s0, churn, None, graph_ticks=0)
    differ = des_differ(graphed, eager)
    log(f"  {DES_EAGER_TICKS} ticks replayed from CUDA graphs of "
        f"{engine._GRAPH_TICKS} ticks vs run eagerly: every field bitwise "
        f"equal: {not differ}")
    if differ:
        fail(f"graph-replayed DES ticks differ from eager ones in {differ}")

    static_cfg = dataclasses.replace(cfg, refine_freq=0)
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    static = engine.run_simulation(static_cfg, adj, s0, churn)
    sync()
    swall = time.perf_counter() - t0
    speak = torch.cuda.max_memory_allocated() / 1e9
    log(_des_summary("static (refine_freq=0)", static, swall, card))
    log(f"  peak device memory {speak:.2f} GB")
    _des_checks("static run", static, adj, spec)
    log(f"  refinement changed the simulation's ticks by "
        f"{100 * (int(refined.tick) - int(static.tick)) / int(static.tick):+.2f}"
        f" %, its rollbacks by {int(refined.rollbacks) - int(static.rollbacks)}")

    out = {"launches": launches, "ticks": int(refined.tick),
           "static_ticks": int(static.tick),
           "ms_per_tick": 1e3 * wall / int(refined.tick),
           "static_ms_per_tick": 1e3 * swall / int(static.tick),
           "peak_gb": peak}
    # a profiled window of the run loop's graph replays, from the state
    # after the first rounds (mid-run), with its graph already captured
    stack = stack_pytrees([prefix])
    nbr, sched = engine._device_inputs(adj, prefix, churn, lone=True)
    ticks = engine._Ticks(cfg, nbr, stack, engine._speeds_fn(cfg, stack,
                                                              sched))
    ticks.advance(engine._GRAPH_TICKS)
    _, pwall, dev_s, dev_launches, top = busy_share(
        lambda: ticks.advance(DES_PROFILE_TICKS))
    log(f"  profiled {DES_PROFILE_TICKS} graph-replayed ticks from tick "
        f"{int(prefix.tick)}: wall {1e3 * pwall / DES_PROFILE_TICKS:.4f} "
        f"ms/tick, device {1e3 * dev_s / DES_PROFILE_TICKS:.4f} ms/tick, "
        f"busy share {dev_s / pwall:.4f}, {dev_launches / DES_PROFILE_TICKS:.1f}"
        f" kernels per tick recorded by the profiler")
    for ev in top:
        log(f"    {ev.key[:60]:60s} {ev.count:6d} x "
            f"{ev.self_device_time_total / max(ev.count, 1):8.2f} us")
    per_tick, other, _ = device_launches(
        lambda: engine._tick(cfg, nbr, stack, sched.speeds[:, 0]), calls=2,
        reps=2)
    log(f"  one tick captured in a CUDA graph: {per_tick:.1f} kernel nodes, "
        f"{other:.1f} other nodes (the host launches one graph per "
        f"{engine._GRAPH_TICKS} ticks)")
    out.update(busy=dev_s / pwall, launches_per_tick=per_tick,
               instance=(cfg, adj, s0, churn), prefix=prefix,
               prefix_s=t_prefix)
    return out


def phase_des_fleet(D, card):
    """``run_simulation_batch`` over a fleet, refinement through kernel 3;
    the whole run again on kernel 3's twin, bitwise; the elements in
    ``DES_FLEET_LONE`` bitwise their lone runs (kernel 1)."""
    from repro_torch.core.batch import stack_pytrees, unstack_pytree
    from repro_torch.des import engine, scenarios
    from repro_torch.kernels.ops import make_aggregate_dissat_fn_plain
    sync = torch.cuda.synchronize

    t0 = time.perf_counter()
    elements = [des_instance(DES_FLEET_N, DES_K, DES_FLEET_THREADS, SEED + b,
                             DES_FLEET_REFINE_FREQ, DES_FLEET_TURNS,
                             DES_FLEET_CHURN)
                for b in range(DES_FLEET_B)]
    cfgs = {(e[0].event_capacity, e[0].history_capacity) for e in elements}
    if len(cfgs) != 1:
        fail(f"fleet elements need one capacity; got {cfgs}")
    cfg = elements[0][0]
    adjs = torch.stack([e[1] for e in elements])
    states = stack_pytrees([e[2] for e in elements])
    scheds = scenarios.stack_schedules([e[3] for e in elements])
    sync()
    log(f"  set-up {time.perf_counter() - t0:.1f} s: B={DES_FLEET_B}, "
        f"specialized_geometric({DES_FLEET_N}, seed {SEED}.."
        f"{SEED + DES_FLEET_B - 1}), T={DES_FLEET_THREADS}, K={DES_K}, "
        f"E={cfg.event_capacity}, "
        f"refine_freq={cfg.refine_freq}, framework c")
    D.reset_launches()
    sync()
    t0 = time.perf_counter()
    fleet = engine.run_simulation_batch(cfg, adjs, states, scheds)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(D.launches)
    ticks = fleet.tick.tolist()
    log(f"  fleet: ticks {min(ticks)}-{max(ticks)}, refines "
        f"{fleet.refines.tolist()}, moves {fleet.moves.tolist()}, "
        f"{wall:.3f} s, {1e3 * wall / max(ticks):.4f} ms per fleet tick, "
        f"{sum(ticks) / wall:.1f} element-ticks/s [{card}]")
    log(f"  launches over the fleet run: {launches}")
    if launches["dissat_from_aggregate_batched"] <= 0 \
            or launches["dissat_from_aggregate"] != 0:
        fail("the fleet DES must refine on kernel 3 and never on kernel 1")

    # kernel 3 against its twin at the shapes this run gives it: each
    # round refines the sub-batch of elements whose cadence hits
    twin3 = make_aggregate_dissat_fn_plain(batched=True)
    widths = set()

    def twin_fn(aggregate, *args, **kwargs):
        widths.add(aggregate.shape[0])
        return twin3(aggregate, *args, **kwargs)

    sync()
    t0 = time.perf_counter()
    twin = engine.run_simulation_batch(cfg, adjs, states, scheds,
                                       dissat_fn=twin_fn)
    sync()
    differ = des_differ(fleet, twin)
    log(f"  kernel 3 path vs its twin path over the whole fleet run (rounds "
        f"on sub-batches of {sorted(widths)} elements, N={DES_FLEET_N}, "
        f"K={DES_K}): every DESState field bitwise equal: {not differ} "
        f"({time.perf_counter() - t0:.3f} s)")
    if differ or not widths:
        fail(f"the fleet DES on kernel 3 differs from its twin path in "
             f"{differ} (rounds on {sorted(widths)} elements)")
    lone_ticks = 0
    lone_wall = 0.0
    for b, (_, adj, s0, churn, spec) in enumerate(elements):
        got = unstack_pytree(fleet, b)
        _des_checks(f"fleet element {b}", got, adj, spec)
        if b not in DES_FLEET_LONE:
            continue
        sync()
        t0 = time.perf_counter()
        lone = engine.run_simulation(cfg, adj, s0, churn)
        sync()
        lone_wall += time.perf_counter() - t0
        lone_ticks += int(lone.tick)
        differ = des_differ(lone, got)
        if differ:
            fail(f"fleet element {b} differs from its lone run in {differ}")
    log(f"  elements {DES_FLEET_LONE} bitwise their lone runs (kernel 1); "
        f"lone runs "
        f"{lone_ticks / lone_wall:.1f} element-ticks/s against the fleet's "
        f"{sum(ticks) / wall:.1f}")
    return {"launches": launches, "ticks": ticks,
            "element_ticks_per_s": sum(ticks) / wall,
            "lone_element_ticks_per_s": lone_ticks / lone_wall}


def phase_core_rest(card):
    """``simulated_annealing``, ``equalize_cardinality`` and
    ``count_discrepancies`` on a dense problem at size."""
    from repro_torch.core import (count_discrepancies, costs,
                                  equalize_cardinality, simulated_annealing)
    from repro_torch.core.problem import make_problem
    from repro_torch.core.refine import refine, refine_traced
    from repro_torch.graphs.generators import random_degree_graph, \
        random_weights
    n = ANNEAL_N

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    adj = random_degree_graph(n, seed=SEED + 5, dmin=3, dmax=6)
    node_w, edge_w = random_weights(adj, seed=SEED + 6, mean=5.0)
    speeds = np.random.default_rng(SEED + 7).uniform(0.5, 2.0, ANNEAL_K)
    problem = make_problem(edge_w, node_w, speeds, mu=MU, device="cuda")
    r0 = torch.as_tensor(np.random.default_rng(SEED + 8).integers(
        0, ANNEAL_K, n).astype(np.int32), device="cuda")
    res, t_ref = timed(lambda: refine(problem, r0, "c", max_turns=400_000))
    r = res.assignment
    start = float(costs.global_cost(problem, r, "c"))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ann, t_ann = timed(lambda: simulated_annealing(
        problem, r, gen, "c", steps=ANNEAL_STEPS))
    best = float(ann.cost)
    again = float(costs.global_cost(problem, ann.assignment, "c"))
    log(f"  refine to equilibrium first ({int(res.num_moves)} moves, "
        f"{t_ref:.3f} s); simulated_annealing {ANNEAL_STEPS} steps: "
        f"{int(ann.accepted)} accepted, C_0 {start:.6e} -> {best:.6e}, "
        f"{t_ann:.3f} s, {1e3 * t_ann / ANNEAL_STEPS:.4f} ms per step "
        f"[{card}]")
    if not (best <= start and math.isfinite(best)
            and abs(again - best) <= 1e-3 * abs(best)
            and tuple(ann.trace.shape) == (ANNEAL_STEPS,)
            and bool(torch.isfinite(ann.trace).all())):
        fail("simulated_annealing: the best cost rose, is not its "
             "assignment's cost, or the trace is not finite")
    eq, t_eq = timed(lambda: equalize_cardinality(problem, r, "c"))
    counts = torch.bincount(eq.long(), minlength=ANNEAL_K)
    before = torch.bincount(r.long(), minlength=ANNEAL_K)
    over = (before > n // ANNEAL_K)[r.long()]
    moved = eq != r
    log(f"  equalize_cardinality: {int(moved.sum())} moves (excess "
        f"{int(torch.clamp(before - n // ANNEAL_K, min=0).sum())}), "
        f"{t_eq:.3f} s [{card}]")
    if not bool((counts == n // ANNEAL_K).all()) \
            or bool((moved & ~over).any()):
        fail("equalize_cardinality: sizes not equal, or a node left a "
             "machine that was not over-full")
    (tres, trace), t_tr = timed(lambda: refine_traced(
        problem, r0, "ct", max_turns=ANNEAL_TRACE_TURNS))
    initial = costs.global_cost_c0(problem, r0)
    count, t_cd = timed(lambda: count_discrepancies(trace, "ct", initial))
    c0 = np.concatenate([[np.float32(initial.item())],
                         trace.c0.cpu().numpy()]).astype(np.float32)
    host = int(np.sum((c0[1:] - c0[:-1] > np.float32(1e-4) * np.abs(c0[:-1]))
                      & trace.moved.cpu().numpy()))
    log(f"  count_discrepancies over {ANNEAL_TRACE_TURNS} traced ct turns "
        f"({int(tres.num_moves)} moves, {t_tr:.3f} s): {int(count)} C_0 "
        f"ascents, {1e3 * t_cd:.3f} ms; host recount {host} [{card}]")
    if int(count) != host:
        fail("count_discrepancies disagrees with its host recount")
    return {"anneal_ms_per_step": 1e3 * t_ann / ANNEAL_STEPS,
            "equalize_s": t_eq, "discrepancies": int(count)}

# ---------------------------------------------------------------------------
# phase 22: distributed refinement and faults
# ---------------------------------------------------------------------------

def _differ(want, got, fields=("assignment", "loads", "num_moves",
                               "num_turns", "converged")) -> list[str]:
    """The result fields that are not bitwise equal (counts by value)."""
    bad = []
    for f in fields:
        a, b = getattr(want, f), getattr(got, f)
        if f in ("num_moves", "num_turns", "converged"):
            same = int(a) == int(b)
        else:
            same = a.dtype == b.dtype and torch.equal(a, b)
        if not same:
            bad.append(f)
    return bad


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _loop_turns(turns: int) -> int:
    """Turns a sequential loop runs for ``turns`` active ones: it reads the
    convergence flag once every ``_SYNC_EVERY`` turns and masks the turns
    in between, each of which still reduces."""
    from repro_torch.core.refine import _SYNC_EVERY
    return -(-turns // _SYNC_EVERY) * _SYNC_EVERY


def views_load_partials(views, assignment, k):
    """(S, K) every shard's fresh load partial, as the drivers' audit
    reduces them."""
    from repro_torch.distributed import protocol
    r_local = assignment.index_select(0, views.ids.reshape(-1).long()
                                      ).view(views.ids.shape)
    return protocol.shard_load_partials(views.weights, views.valid, r_local,
                                        k)


def phase_distributed(D, ops, problem, main_run, des, card):
    """The distributed slice on phase 3's instance with one shard per
    machine: (a) the emulated driver to equilibrium, (b) traced turns,
    (c) sweeps, (d) recompute turns on kernel 2, (e) faults, (f) the
    collective driver on a one-rank NCCL group, (g) the DES's distributed
    backend.  Each against its single-controller run."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import distributed as PD
    from repro_torch.core import costs
    from repro_torch.core.refine import (refine, refine_simultaneous,
                                         refine_sweeps, refine_traced)
    from repro_torch.des import engine
    from repro_torch.distributed import faults as PF
    sync = torch.cuda.synchronize
    r0, s = main_run["r0"], DIST_S
    counts = {}

    def counted(label, fn):
        D.reset_launches()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        counts[label] = dict(D.launches)
        return out, time.perf_counter() - t0

    def launched(label, want: dict):
        got = {name: counts[label][name] for name in want}
        log(f"  ({label}) launches: {counts[label]}")
        if got != want:
            fail(f"phase 22 ({label}): launches {got}, expected {want}")

    stats = PD.boundary_stats(problem, s)

    # (a) the emulated driver to equilibrium: bitwise phase 3's refine
    (res, wire), wall = counted("a", lambda: PD.refine_distributed(
        problem, r0, "c", num_shards=s, max_turns=400_000,
        measure_wire=True))
    turns = int(res.num_turns)
    bad = [f for f, want in (("assignment", main_run["r"]),
                             ("loads", main_run["loads"]))
           if not torch.equal(getattr(res, f), want)]
    if (int(res.num_moves), turns) != (main_run["moves"],
                                       main_run["turns"]):
        bad.append("counts")
    ms_turn = 1e3 * wall / turns
    check = PD.reconcile(PD.ledger_for_run(stats, K, wire.rounds), wire)
    log(f"  (a) refine_distributed, S={s}: {int(res.num_moves)} moves in "
        f"{turns} turns, converged={bool(res.converged)}, {wall:.3f} s, "
        f"{ms_turn:.4f} ms per turn (phase 3's refine: "
        f"{main_run['ms_per_turn']:.4f}) [{card}]; bitwise phase 3: "
        f"{not bad}; {wire.payload_bytes // max(wire.rounds, 1)} B a turn "
        f"on the wire ({wire.payload_bytes} B in all, setup "
        f"{wire.setup_bytes} B); {check.summary()}")
    if bad or not bool(res.converged):
        fail(f"phase 22 (a): refine_distributed differs from phase 3's "
             f"refine in {bad}")
    if not check.ok:
        fail("phase 22 (a): measured wire bytes differ from the ledger")
    launched("a", {"dissat_from_aggregate_batched": _loop_turns(turns),
                   "dissat_from_aggregate": 0, "cost_matrix": 0})
    _, pwall, dev_s, dev_launches, _ = busy_share(
        lambda: PD.refine_distributed(problem, r0, "c", num_shards=s,
                                      max_turns=DIST_PROFILE_TURNS))
    _, cwall, cdev_s, cdev_launches, _ = busy_share(
        lambda: refine(problem, r0, "c", max_turns=DIST_PROFILE_TURNS))
    n = DIST_PROFILE_TURNS
    log(f"  profiled {n} turns: distributed wall {1e3 * pwall / n:.4f} "
        f"ms/turn, device {1e3 * dev_s / n:.4f} ms/turn, busy "
        f"{dev_s / pwall:.4f}, {dev_launches / n:.1f} kernels a turn "
        f"recorded; controller wall {1e3 * cwall / n:.4f} ms/turn, device "
        f"{1e3 * cdev_s / n:.4f}, busy {cdev_s / cwall:.4f}, "
        f"{cdev_launches / n:.1f} kernels a turn [{card}]")
    out = {"ms_per_turn": ms_turn, "busy": dev_s / pwall,
           "controller_busy": cdev_s / cwall,
           "bytes_per_turn": wire.payload_bytes // max(wire.rounds, 1),
           "a": res, "a_s": wall}

    # (b) traced turns: the assembled reduction bitwise refine_traced, and
    # kernel 3 (cost_fn="pallas") bitwise refine over the same turns
    (res_t, tr, wire_t), wall_t = counted(
        "b", lambda: PD.refine_distributed_traced(
            problem, r0, "c", num_shards=s, max_turns=DIST_TRACED_TURNS,
            measure_wire=True))
    want_t, wtr = refine_traced(problem, r0, "c", max_turns=DIST_TRACED_TURNS)
    bad = _differ(want_t, res_t) + [
        f for f in wtr._fields if f not in ("c0", "ct0")
        and not torch.equal(getattr(wtr, f), getattr(tr, f))]
    check = PD.reconcile(PD.ledger_for_run(stats, K, wire_t.rounds,
                                           traced=True), wire_t)
    rel_c0, rel_ct0 = _rel(tr.c0, wtr.c0), _rel(tr.ct0, wtr.ct0)
    log(f"  (b) {DIST_TRACED_TURNS} traced turns, {int(res_t.num_moves)} "
        f"moves, {1e3 * wall_t / DIST_TRACED_TURNS:.4f} ms per turn: every "
        f"trace field but the potentials and the result bitwise "
        f"refine_traced: {not bad}; C_0 / Ct_0 traces within {rel_c0:.3e} "
        f"/ {rel_ct0:.3e} of it (initial potentials summed from {s} shard "
        f"partials); {check.summary()}")
    if bad or not check.ok or max(rel_c0, rel_ct0) > 1e-5:
        fail(f"phase 22 (b): traced run differs from refine_traced in "
             f"{bad}, wire ok {check.ok}")
    launched("b", {"dissat_from_aggregate_batched": 0,
                   "dissat_from_aggregate": 0, "cost_matrix": 0})
    (res_p, _), _ = counted("b3", lambda: PD.refine_distributed_traced(
        problem, r0, "c", num_shards=s, max_turns=DIST_TRACED_TURNS,
        cost_fn="pallas"))
    bad = _differ(refine(problem, r0, "c", max_turns=DIST_TRACED_TURNS),
                  res_p)
    log(f"  (b) the same turns reduced by kernel 3: bitwise refine's first "
        f"{DIST_TRACED_TURNS} turns: {not bad}")
    if bad:
        fail(f"phase 22 (b): kernel-3 traced run differs from refine in "
             f"{bad}")
    launched("b3", {"dissat_from_aggregate_batched": DIST_TRACED_TURNS,
                    "dissat_from_aggregate": 0})

    # (c) sweeps: the assembled reduction against refine_simultaneous,
    # kernel 3 against refine_sweeps on kernel 1
    (res_s, outs_s, wire_s), wall_s = counted(
        "c", lambda: PD.refine_distributed_simultaneous(
            problem, r0, "c", num_shards=s, max_sweeps=DIST_SWEEPS,
            measure_wire=True))
    want_s, wouts = refine_simultaneous(problem, r0, "c",
                                        max_sweeps=DIST_SWEEPS)
    bad = _differ(want_s, res_s, ("assignment", "num_moves", "num_turns",
                                  "converged"))
    if not torch.equal(outs_s[2], wouts[2]):
        bad.append("active")
    loads_bitwise = torch.equal(res_s.loads, want_s.loads)
    rel = max(_rel(res_s.loads, want_s.loads), _rel(outs_s[0], wouts[0]),
              _rel(outs_s[1], wouts[1]))
    check = PD.reconcile(PD.ledger_for_run(stats, K, wire_s.rounds,
                                           simultaneous=True), wire_s)
    sweeps = int(res_s.num_turns)
    log(f"  (c) {sweeps} sweeps, {int(res_s.num_moves)} moves, "
        f"{1e3 * wall_s / max(sweeps, 1):.4f} ms per sweep: assignment, "
        f"counts and active bitwise refine_simultaneous: {not bad}; loads "
        f"bitwise: {loads_bitwise}, loads and potentials within {rel:.3e} "
        f"(each sweep sums {s} shard partials); "
        f"{wire_s.payload_bytes // max(wire_s.rounds, 1)} B a sweep; "
        f"{check.summary()}")
    if bad or not check.ok or rel > 1e-5:
        fail(f"phase 22 (c): sweeps differ from refine_simultaneous in "
             f"{bad}, wire ok {check.ok}")
    launched("c", {"dissat_from_aggregate_batched": 0,
                   "dissat_from_aggregate": 0})
    (res_c3, _), _ = counted("c3", lambda: PD.refine_distributed_simultaneous(
        problem, r0, "c", num_shards=s, max_sweeps=DIST_SWEEPS,
        cost_fn="pallas"))
    want_c3, _ = refine_sweeps(problem, r0, "c", max_sweeps=DIST_SWEEPS,
                               dissat_fn=ops.make_aggregate_dissat_fn())
    bad = _differ(want_c3, res_c3, ("assignment", "num_moves", "num_turns",
                                    "converged"))
    ran = int(res_c3.num_turns) + int(bool(res_c3.converged))
    log(f"  (c) the same sweeps reduced by kernel 3: assignment and counts "
        f"bitwise refine_sweeps on kernel 1: {not bad}")
    if bad:
        fail(f"phase 22 (c): kernel-3 sweeps differ in {bad}")
    launched("c3", {"dissat_from_aggregate_batched": ran,
                    "dissat_from_aggregate": 0})

    # (d) recompute turns on kernel 2 over the (S*Ns, N) row blocks
    res_d, wall_d = counted("d", lambda: PD.refine_distributed(
        problem, r0, "c", num_shards=s, max_turns=RECOMPUTE_TURNS,
        incremental=False, cost_fn="pallas"))
    want_d = refine(problem, r0, "c", max_turns=RECOMPUTE_TURNS,
                    cost_matrix_fn=ops.make_core_cost_matrix_fn())
    bad = _differ(want_d, res_d)
    c0_rel = abs(float(costs.global_cost_c0(problem, res_d.assignment))
                 / float(costs.global_cost_c0(problem, want_d.assignment))
                 - 1.0)
    log(f"  (d) {RECOMPUTE_TURNS} recompute turns on kernel 2, "
        f"{int(res_d.num_moves)} moves, {1e3 * wall_d / RECOMPUTE_TURNS:.4f}"
        f" ms per turn: bitwise the controller's recompute turns on kernel "
        f"2: {not bad}; C_0 within {c0_rel:.3e}")
    if bad and c0_rel > 1e-3:
        fail(f"phase 22 (d): recompute run differs in {bad}, C_0 by "
             f"{c0_rel:.3e}")
    launched("d", {"cost_matrix": RECOMPUTE_TURNS,
                   "dissat_from_aggregate_batched": 0})

    # (e) faults: a mixed plan recovers, the zero plan is the fault-free
    # run, a shard that never comes back raises
    plan = PF.make_fault_plan(DIST_PLAN_ROUNDS, s, 0, num_machines=K,
                              num_nodes=N, **DIST_PLAN)
    (res_e, rep), wall_e = counted("e", lambda: PD.refine_distributed(
        problem, r0, "c", num_shards=s, max_turns=400_000, fault_plan=plan))
    turns_e = int(res_e.num_turns)
    log(f"  (e) mixed fault plan (seed 0): {int(res_e.num_moves)} moves in "
        f"{turns_e} turns, converged={bool(res_e.converged)}, {wall_e:.3f} "
        f"s; recovered={rep.recovered} with drift {rep.recovery_drift:.3e} "
        f"(budget {PF.DEFAULT_DEGRADED.repair_tol}), {rep.repairs} repairs,"
        f" {rep.repaired_cols} columns, {rep.retries} retries, {rep.dups} "
        f"duplicates, {rep.down_rounds} rounds with a shard down, "
        f"recovery at round {rep.recovery_round}")
    if not (rep.recovered and bool(res_e.converged)
            and rep.recovery_drift <= PF.DEFAULT_DEGRADED.repair_tol):
        fail("phase 22 (e): the mixed fault plan did not recover")
    launched("e", {"dissat_from_aggregate_batched": _loop_turns(turns_e),
                   "dissat_from_aggregate": 0})
    (res_z, rep_z), _ = counted("e0", lambda: PD.refine_distributed(
        problem, r0, "c", num_shards=s, max_turns=400_000,
        fault_plan=PF.zero_fault_plan(DIST_PLAN_ROUNDS, s)))
    # the faulty drivers end with the reference's audit: a load entry
    # whose carried value is further than repair_tol (absolute) from the
    # sum of the shards' fresh partials is replaced by that sum, and f32
    # loads of ~5e3 carried over 10^4 moves drift further than that, so
    # the zero-fault run is (a) passed through the same audit
    views = PD.build_views(problem, s)
    fresh = torch.sum(views_load_partials(views, res.assignment, K), dim=0)
    audited = torch.where(
        ~((res.loads - fresh).abs() <= PF.DEFAULT_DEGRADED.repair_tol),
        fresh, res.loads)
    bad = _differ(res, res_z, ("assignment", "num_moves", "num_turns",
                               "converged"))
    if not torch.equal(res_z.loads, audited):
        bad.append("loads")
    patched = int((res_z.loads != res.loads).sum())
    log(f"  (e) zero-fault plan: assignment, moves, turns bitwise (a), "
        f"loads bitwise (a)'s after the final audit: {not bad}; the audit "
        f"replaced {patched} of {K} carried loads (carried drift "
        f"{rep_z.pre_repair_drift:.3e} against the {s} shards' fresh "
        f"partials); repairs {rep_z.repairs}")
    if bad:
        fail(f"phase 22 (e): the zero-fault plan differs from (a) in {bad}")
    z = np.zeros((DIST_PLAN_ROUNDS, s), bool)
    down = z.copy()
    down[:, 3] = True
    dead = PF._assemble(down, z, np.zeros(z.shape, np.int32), z, z,
                        np.zeros(z.shape, np.int32),
                        np.zeros(z.shape, np.float32), PF.DEFAULT_DEGRADED,
                        N)
    try:
        PD.refine_distributed(problem, r0, "c", num_shards=s, max_turns=48,
                              fault_plan=dead)
        fail("phase 22 (e): a shard down to the end did not raise")
    except PF.DeadShardError as err:
        log(f"  (e) shard 3 down every round: DeadShardError "
            f"({str(err)[:60]}...)")

    # (f) the collective driver on a one-rank NCCL group
    res_f, wall_f = counted("f", lambda: PD.refine_distributed_shard_map(
        problem, r0, "c", num_shards=1, max_turns=400_000))
    bad = _differ(res, res_f)
    log(f"  (f) refine_distributed_shard_map on a one-rank NCCL group: "
        f"{int(res_f.num_turns)} turns, {1e3 * wall_f / turns:.4f} ms per "
        f"turn; bitwise (a): {not bad}; group destroyed: "
        f"{not dist.is_initialized()}")
    if bad or dist.is_initialized():
        fail(f"phase 22 (f): the collective run differs from (a) in {bad}")
    launched("f", {"dissat_from_aggregate": _loop_turns(turns),
                   "dissat_from_aggregate_batched": 0})

    # (g) the DES with refine_backend="distributed" over phase 20's first
    # refinement rounds, against phase 20's single-backend rounds
    cfg, adj, s0, churn = des["instance"]
    dcfg = dataclasses.replace(cfg, refine_backend="distributed",
                               max_ticks=DES_PARITY_ROUNDS * cfg.refine_freq)
    got, wall_g = counted("g", lambda: engine.run_simulation(dcfg, adj, s0,
                                                             churn))
    bad = des_differ(des["prefix"], got)
    log(f"  (g) the DES over its first {int(got.refines)} refinement rounds "
        f"({int(got.tick)} ticks, {wall_g:.3f} s) with "
        f"refine_backend='distributed': every DESState field bitwise the "
        f"single backend's: {not bad}")
    if bad or int(got.refines) < 1:
        fail(f"phase 22 (g): the distributed DES differs in {bad}")
    if counts["g"]["dissat_from_aggregate_batched"] <= 0 \
            or counts["g"]["dissat_from_aggregate"] != 0:
        fail(f"phase 22 (g): launches {counts['g']}")
    log(f"  (g) launches: {counts['g']}")
    out["launches"] = {
        name: {label: c[name] for label, c in counts.items() if c[name]}
        for name in ("dissat_from_aggregate", "cost_matrix",
                     "dissat_from_aggregate_batched")}
    return out


# ---------------------------------------------------------------------------
# phase 23: run telemetry
# ---------------------------------------------------------------------------

def count_syncs(fn):
    """``(fn(), wall s, host syncs, where)``: the syncs counted as the
    warnings ``torch.cuda.set_sync_debug_mode("warn")`` raises, ``where``
    a Counter of the ``file:line`` each was raised from; the wall from a
    synced start to a synced end."""
    import collections
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    syncs = [w for w in caught if "synchroniz" in str(w.message).lower()]
    where = collections.Counter(f"{Path(w.filename).name}:{w.lineno}"
                                for w in syncs)
    return out, wall, len(syncs), where


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, NaN payloads included (a repaired fault's carried
    potentials may be NaN until the repair)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return a.dtype == b.dtype and torch.equal(a, b)


def report_check(path) -> tuple[int, str]:
    """``python -m repro_torch.obs.report PATH --check``: (exit code, the
    last lines of its output)."""
    import os
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parent / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                          str(path), "--check"], env=env,
                         capture_output=True, text=True, timeout=300)
    text = (out.stdout + out.stderr).strip().splitlines()
    return out.returncode, " | ".join(text[-3:])


def phase_telemetry(D, ops, problem, main_run, des, dist_run, card):
    """Run telemetry at full width on earlier phases' instances: (a) phase
    3's game with a JSONL recorder, (b) the timed ``dissat_fn``, (c) phase
    20's first refinement rounds with a recorder, (d) phase 22's emulated
    driver and a fault-injected traced run with recorders, (e) the device
    launches the row writes add.  Each result bitwise its recorder-free
    run; each log passes ``--check``."""
    import dataclasses
    import tempfile

    from repro_torch import distributed as PD
    from repro_torch.core import refine as R
    from repro_torch.core.batch import stack_pytrees
    from repro_torch.core.refine import refine
    from repro_torch.des import engine
    from repro_torch.distributed import faults as PF
    from repro_torch.obs import JsonlSink, Recorder
    from repro_torch.obs.report import check_run, replay_run
    from repro_torch.obs.rows import TurnRows
    sync = torch.cuda.synchronize
    r0 = main_run["r0"]
    tmp = Path(tempfile.mkdtemp(prefix="telemetry_"))
    D.reset_launches()
    out = {}

    # (a) phase 3's game under a JSONL recorder; then windows of its first
    # TELEMETRY_WINDOW turns without and with a recorder, in turns
    log_a = tmp / "refine.jsonl"
    rec = Recorder([JsonlSink(log_a)])
    on, wall_full, syncs_full, _ = count_syncs(
        lambda: refine(problem, r0, "c", max_turns=400_000, recorder=rec))
    rec.close()
    turns = int(on.num_turns)
    bad = [f for f, want in (("assignment", main_run["r"]),
                             ("loads", main_run["loads"]))
           if not torch.equal(getattr(on, f), want)]
    if (int(on.num_moves), turns) != (main_run["moves"], main_run["turns"]):
        bad.append("counts")
    n_turn = sum(e["kind"] == "turn" for e in rec.events)
    code, tail = report_check(log_a)
    log(f"  (a) refine with a JsonlSink recorder: {int(on.num_moves)} moves "
        f"in {turns} turns, {1e3 * wall_full / turns:.4f} ms per turn, "
        f"{syncs_full} host syncs; bitwise phase 3: {not bad}; {n_turn} "
        f"turn events; log {log_a.stat().st_size} B; report --check exit "
        f"{code} ({tail})")
    if bad:
        fail(f"phase 23 (a): the recorded run differs from phase 3 in {bad}")
    if n_turn != turns or code != 0:
        fail(f"phase 23 (a): {n_turn} turn events for {turns} turns, "
             f"report --check exit {code}")
    w = TELEMETRY_WINDOW
    runs = {False: [], True: []}
    for recorded in (False, True, True, False):
        got, wall, syncs, where = count_syncs(
            lambda: refine(problem, r0, "c", max_turns=w,
                           recorder=Recorder() if recorded else None))
        runs[recorded].append((got, wall, syncs, where))
    ms_off = [1e3 * r[1] / w for r in runs[False]]
    ms_on = [1e3 * r[1] / w for r in runs[True]]
    syncs_off, syncs_on = runs[False][1][2], runs[True][0][2]
    extra = runs[True][0][3] - runs[False][1][3]
    missing = runs[False][1][3] - runs[True][0][3]
    bad = [f for r in runs[True] + runs[False][1:]
           for f in _differ(runs[False][0][0], r[0])]
    log(f"  (a) {w} turns in turns off/on/on/off: {ms_off[0]:.4f} / "
        f"{ms_on[0]:.4f} / {ms_on[1]:.4f} / {ms_off[1]:.4f} ms per turn "
        f"[{card}]; host syncs {syncs_on} with the recorder (the first "
        f"with), {syncs_off} without (the last without; with only: "
        f"{dict(extra)}, without only: "
        f"{dict(missing)}); all four bitwise: {not bad}")
    # the recorder reads the card twice a run (obs/rows.py's read_back):
    # the replay seed before the first turn, the rows and the result
    # after the last; no other sync
    if bad or sum(extra.values()) > 2 or any(
            not where.startswith("rows.py:") for where in extra):
        fail(f"phase 23 (a): windows differ in {bad}; syncs only with the "
             f"recorder {dict(extra)}, only without {dict(missing)}")
    out.update(ms_on=float(np.mean(ms_on)), ms_off=float(np.mean(ms_off)),
               syncs=(syncs_on, syncs_off))

    # (b) kernel 1 under make_timed_dissat_fn for TIMED_TURNS turns
    rec_b = Recorder()
    timed = ops.make_timed_dissat_fn(ops.make_aggregate_dissat_fn(), rec_b,
                                     name="kernels.dissat")
    plain = refine(problem, r0, "c", max_turns=TIMED_TURNS)
    sync()
    t0 = time.perf_counter()
    got = refine(problem, r0, "c", max_turns=TIMED_TURNS, dissat_fn=timed)
    sync()
    wall_b = time.perf_counter() - t0
    spans = [e["dur"] for e in rec_b.events if e["kind"] == "phase"]
    bad = _differ(plain, got)
    log(f"  (b) make_timed_dissat_fn around kernel 1: {len(spans)} phase "
        f"spans over {TIMED_TURNS} turns, {1e3 * np.mean(spans):.4f} ms a "
        f"span (median {1e3 * np.median(spans):.4f}), {1e3 * wall_b / TIMED_TURNS:.4f}"
        f" ms a turn; bitwise the unwrapped run: {not bad}")
    if bad or len(spans) != TIMED_TURNS:
        fail(f"phase 23 (b): {len(spans)} spans, differs in {bad}")

    # (c) phase 20's first refinement rounds under a recorder
    cfg, adj, s0, churn = des["instance"]
    prefix_cfg = dataclasses.replace(
        cfg, max_ticks=DES_PARITY_ROUNDS * cfg.refine_freq)
    log_c = tmp / "des.jsonl"
    rec_c = Recorder([JsonlSink(log_c)])
    got_c, wall_c, syncs_c, _ = count_syncs(
        lambda: engine.run_simulation(prefix_cfg, adj, s0, churn,
                                      recorder=rec_c))
    rec_c.close()
    differ = des_differ(des["prefix"], got_c)
    ticks = [e for e in rec_c.events if e["kind"] == "tick"]
    rounds = [e for e in rec_c.events if e["kind"] == "des_refine"]
    n_ticks = int(got_c.tick)
    code_c, tail_c = report_check(log_c)
    log(f"  (c) the DES's first {len(rounds)} refinement rounds "
        f"({n_ticks} ticks) with a recorder: every DESState field bitwise "
        f"phase 20's: {not differ}; {len(ticks)} tick events, every one on "
        f"the stride {cfg.trace_stride}: "
        f"{all(e['t'] % cfg.trace_stride == 0 for e in ticks)}; "
        f"{1e3 * wall_c / n_ticks:.4f} ms per tick with the recorder, "
        f"{1e3 * des['prefix_s'] / n_ticks:.4f} without (phase 20) "
        f"[{card}]; host syncs {syncs_c}; report --check exit {code_c} "
        f"({tail_c})")
    if differ or len(rounds) != DES_PARITY_ROUNDS or code_c != 0:
        fail(f"phase 23 (c): differs in {differ}, {len(rounds)} rounds, "
             f"report --check exit {code_c}")
    if len(ticks) != n_ticks // cfg.trace_stride or not all(
            e["t"] % cfg.trace_stride == 0 for e in ticks):
        fail(f"phase 23 (c): {len(ticks)} tick events over {n_ticks} ticks")
    out.update(des_ms_on=1e3 * wall_c / n_ticks,
               des_ms_off=1e3 * des["prefix_s"] / n_ticks)

    # (d) phase 22 (a) and a fault-injected traced run under recorders
    rec_d = Recorder()
    sync()
    t0 = time.perf_counter()
    got_d = PD.refine_distributed(problem, r0, "c", num_shards=DIST_S,
                                  max_turns=400_000, recorder=rec_d)
    sync()
    wall_d = time.perf_counter() - t0
    bad = _differ(dist_run["a"], got_d)
    wire = [e for e in rec_d.events if e["kind"] == "wire"]
    ok = len(wire) == 1 and wire[0]["ok"] and (
        wire[0]["measured_payload"], wire[0]["measured_setup"]) == (
        wire[0]["predicted_payload"], wire[0]["predicted_setup"])
    problems = check_run(replay_run(rec_d.events))
    log(f"  (d) refine_distributed, S={DIST_S}, with a recorder: bitwise "
        f"phase 22 (a): {not bad}; {wall_d:.3f} s against (a)'s "
        f"{dist_run['a_s']:.3f}; wire {wire[0] if wire else None}; "
        f"check_run {problems or 'clean'}")
    if bad or not ok or problems:
        fail(f"phase 23 (d): differs in {bad}, wire ok {ok}, {problems}")
    plan = PF.make_fault_plan(DIST_PLAN_ROUNDS, DIST_S, 0, num_machines=K,
                              num_nodes=N, **DIST_PLAN)
    base = PD.refine_distributed_traced(problem, r0, "c", num_shards=DIST_S,
                                        max_turns=DIST_TRACED_TURNS,
                                        fault_plan=plan)
    log_f = tmp / "faults.jsonl"
    rec_f = Recorder([JsonlSink(log_f)])
    got_f = PD.refine_distributed_traced(problem, r0, "c", num_shards=DIST_S,
                                         max_turns=DIST_TRACED_TURNS,
                                         fault_plan=plan, recorder=rec_f)
    rec_f.close()
    bad = _differ(base[0], got_f[0]) + [
        f for f in base[1]._fields
        if not _bits_equal(getattr(base[1], f), getattr(got_f[1], f))]
    if base[2] != got_f[2]:
        bad.append("report")
    end = rec_f.events[-1]
    wire = [e for e in rec_f.events if e["kind"] == "wire"]
    kinds = sorted({e["kind"] for e in rec_f.events})
    code_f, tail_f = report_check(log_f)
    log(f"  (d) fault-injected traced run ({DIST_TRACED_TURNS} turns, the "
        f"mixed plan, seed 0) with a recorder: bitwise the recorder-free "
        f"run: {not bad}; recovered={end.get('recovered')}; wire ok "
        f"{bool(wire) and wire[0]['ok']}; {len(rec_f.events)} events of "
        f"kinds {kinds}; report --check exit {code_f} ({tail_f})")
    if bad or end.get("recovered") is not True or not wire \
            or not wire[0]["ok"] or code_f != 0:
        fail(f"phase 23 (d): the faulty run differs in {bad}, recovered "
             f"{end.get('recovered')}, report --check exit {code_f}")
    out["launches"] = dict(D.launches)
    log(f"  launches over phase 23: {out['launches']}")
    for name in ("dissat_from_aggregate", "dissat_from_aggregate_batched"):
        if out["launches"][name] <= 0:
            fail(f"phase 23: kernel {name} was not launched")

    # (e) the device launches a recorder adds: kernel nodes of a CUDA
    # graph capturing 32 turns of refine's loop, and one tick's step,
    # without and with their row writes
    def loop(rows):
        return R._refine(problem, r0, "c", 32, R.DEFAULT_TOL, None, True, 0,
                         0, None, None, rows=rows)

    stack = stack_pytrees([s0])
    nbr, sched = engine._device_inputs(adj, s0, churn, lone=True)
    speeds_of = engine._speeds_fn(cfg, stack, sched)
    tel = engine._Telemetry(cfg, cfg.refine_freq, sched, stack.tick,
                            engine._TICK_ROWS)
    plain = engine._Ticks(cfg, nbr, stack, speeds_of, 0)
    rowed = engine._Ticks(cfg, nbr, stack, speeds_of, 0, tel)
    nodes = {name: device_launches(fn, calls=1, reps=1)[0] for name, fn in (
        ("turns", lambda: loop(None)), ("turns_rows", lambda: loop(
            TurnRows())), ("tick", lambda: plain.step(stack)),
        ("tick_rows", lambda: rowed.step(stack)))}
    log(f"  (e) device launches (CUDA graph kernel nodes): 32 turns "
        f"{nodes['turns']:.0f} without the row buffer, "
        f"{nodes['turns_rows']:.0f} with it; a DES tick "
        f"{nodes['tick']:.0f} without the row write, "
        f"{nodes['tick_rows']:.0f} with it")
    out["nodes"] = nodes
    return out


# ---------------------------------------------------------------------------
# phases 24-25: the MoE and hybrid families at full width
# ---------------------------------------------------------------------------

def _moe_err(got, want, label) -> float:
    diff = float((got - want).abs().max())
    bound = MOE_TOL * max(1.0, float(want.abs().max()))
    if not bool(torch.isfinite(got).all()) or not diff <= bound:
        fail(f"{label}: max |diff| {diff}, bound {bound}")
    return diff


def _moe_inputs(params, cfg, tokens):
    """Each layer's block and MoE input (the normed residual stream after
    its attention half) on ``tokens``, as prefill computes them: the
    layers in order, each MoE at the config's capacity."""
    from repro_torch.models.attention import causal_attention
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.moe import moe_block
    from repro_torch.models.transformer import _residual, embed_inputs
    x = embed_inputs(params, cfg, tokens)
    for block in params["blocks"]:
        x = _residual(x, causal_attention(
            block["attn"], cfg, rms_norm(x, block["attn_norm"],
                                         cfg.rms_eps)), cfg)
        xn = rms_norm(x, block["ffn_norm"], cfg.rms_eps)
        yield block, xn
        x = _residual(x, moe_block(block["moe"], cfg, xn)[0], cfg)


def _routing_margin(params, cfg) -> float:
    """Phase 24 (c): the smallest gap between the k-th and (k+1)-th
    router probability over every token and layer of the parity prompts'
    prefill, f32 compute: a route that flips between the kernel and plain
    paths needs a gap inside their rounding."""
    import dataclasses
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    margin = float("inf")
    for prompt in _parity_prompts(cfg.vocab_size):
        tokens = torch.as_tensor(prompt.astype(np.int64), device="cuda")[None]
        for block, xn in _moe_inputs(params, cfg32, tokens):
            top = torch.topk(torch.softmax(
                xn[0] @ block["moe"]["router"].float(), dim=-1),
                cfg.top_k + 1, dim=-1).values
            margin = min(margin, float((top[:, -2] - top[:, -1]).min()))
    return margin


def _moe_block_checks(params, engine, cfg, card):
    """Phase 24 (b): layer 0's MoE block on the MoE input of a
    3072-token prompt (its embedding through layer 0's attention half, f32
    compute): scatter at capacity 8.0 against the dense oracle, scatter
    against einsum at the config's capacity with the dropped pairs
    counted, the statistics; then the bf16 serving block's time and
    device launches at the prefill and decode shapes."""
    import dataclasses

    from repro_torch.models import moe as M

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    rng = np.random.default_rng(SEED + 3)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          SERVE_PROMPT[1]).astype(np.int64),
                             device="cuda")[None]
    block, xn = next(_moe_inputs(params, cfg32, tokens))
    t, k = xn.shape[1], cfg.top_k

    def run(impl, capacity):
        c = dataclasses.replace(cfg32, moe_impl=impl,
                                capacity_factor=capacity)
        return M.moe_block(block["moe"], c, xn)

    y_dense, st_dense = run("dense", cfg.capacity_factor)
    y_ample, st_ample = run("scatter", 8.0)
    y_scatter, st_scatter = run("scatter", cfg.capacity_factor)
    y_einsum, st_einsum = run("einsum", cfg.capacity_factor)
    err_dense = _moe_err(y_ample, y_dense, "MoE scatter at capacity 8.0 vs "
                         "the dense oracle")
    err_einsum = _moe_err(y_scatter, y_einsum, f"MoE scatter vs einsum at "
                          f"capacity {cfg.capacity_factor}")
    for st in (st_ample, st_scatter, st_einsum):
        if not all(torch.equal(a, b) for a, b in zip(st, st_dense)):
            fail("the MoE impls' router statistics differ")
    _, ids, _ = M._route(block["moe"], cfg32, xn.reshape(t, -1))
    plans = {cap: M._dispatch(ids, dataclasses.replace(
        cfg32, capacity_factor=cap), dropless=False)
        for cap in (8.0, cfg.capacity_factor)}
    kept = {cap: int(plan.keep.sum()) for cap, plan in plans.items()}
    load_sum = float(st_dense.expert_load.sum())
    coact = st_dense.coactivation
    if kept[8.0] != t * k:
        fail(f"capacity 8.0 dropped {t * k - kept[8.0]} pairs")
    if abs(load_sum - k) > 1e-4 or not torch.equal(coact, coact.T) \
            or bool(torch.diagonal(coact).any()):
        fail(f"MoE statistics: expert_load sums to {load_sum}, coactivation "
             f"symmetric {torch.equal(coact, coact.T)}, diagonal "
             f"{torch.diagonal(coact).tolist()}")
    plan = plans[cfg.capacity_factor]
    load = st_dense.expert_load
    log(f"  (b) layer 0's MoE block, {t} tokens, f32: scatter at capacity "
        f"8.0 vs dense max |diff| {err_dense:.3e}; scatter vs einsum at "
        f"{cfg.capacity_factor} (groups of {plan.sg}, {plan.groups} groups, "
        f"capacity {plan.cap}) {err_einsum:.3e} (tolerance {MOE_TOL} x "
        f"max(1, max |y|)); pairs kept {kept[cfg.capacity_factor]} of "
        f"{t * k}, dropped {t * k - kept[cfg.capacity_factor]}; expert_load "
        f"sums to {load_sum:.6f} (min {float(load.min()):.4f}, max "
        f"{float(load.max()):.4f}), aux_loss "
        f"{float(st_dense.aux_loss):.5f}, coactivation symmetric, zero "
        f"diagonal")
    del y_dense, y_ample, y_scatter, y_einsum
    # the serving block: bf16 experts, f32 router, on the engine's weights
    moe16 = engine.params["blocks"][0]["moe"]
    x16 = xn.to(cfg.cdtype())
    step16 = x16[0, :SERVE_SLOTS, None, :].contiguous()   # 16 slots, 1 token
    out = {}
    for label, fn in (
            ("prefill", lambda: M.moe_block(moe16, cfg, x16)),
            ("decode", lambda: M.moe_block(moe16, cfg, step16,
                                           dropless=True))):
        ms = cuda_ms(fn, MOE_TIMED_ITERS, warmup=2)
        kernels, other, _ = device_launches(fn, calls=2, reps=2)
        out[label] = (ms, kernels)
        log(f"  (b) the bf16 MoE block at the {label} shape: {ms:.4f} ms a "
            f"call (CUDA events), {kernels:.0f} device kernels a call "
            f"({other:.0f} other graph nodes) [{card}]")
    return {"err_dense": err_dense, "err_einsum": err_einsum,
            "dropped": t * k - kept[cfg.capacity_factor], "times": out}


def phase_moe(A, F, S8, card):
    """Phase 24: granite-moe-1b-a400m at full width through the port's
    ServingEngine (kernel 7 on every prefill layer, kernel 6 on every
    decode layer, no kernel 8 and no twin); its layer-0 MoE block's
    impls; the f32 kernel path against the plain path with the smallest
    top-k routing margin."""
    from repro_torch import configs
    cfg = configs.get_config(MOE_ARCH)
    log(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads (kv {cfg.num_kv_heads}) x {cfg.head_dim}, "
        f"{cfg.num_experts} experts top-{cfg.top_k} of d_ff {cfg.d_ff}, "
        f"groups of {cfg.moe_group_size}, capacity {cfg.capacity_factor}, "
        f"vocab {cfg.vocab_size}, params {cfg.param_dtype}, compute "
        f"{cfg.compute_dtype}")
    params, engine, stats, launches, twins = _serve_full_width(
        cfg, (A, F, S8), card)
    steps = stats["decode_steps"]
    _check_serving_launches(launches, twins, {
        "flash_attention": cfg.num_layers * SERVE_REQUESTS,
        "decode_attention": cfg.num_layers * steps,
        "ssd_scan": 0})
    log(f"  (a) checks: every request has {SERVE_NEW} tokens, every logit "
        f"finite, kernel 7 launched {cfg.num_layers} x {SERVE_REQUESTS} and "
        f"kernel 6 {cfg.num_layers} x {steps} times, kernel 8 0 times, no "
        f"twin ran")
    _profile_decode(engine)
    block = _moe_block_checks(params, engine, cfg, card)
    del engine
    torch.cuda.empty_cache()
    rel32 = _f32_parity(params, cfg, "attention")
    margin = _routing_margin(params, cfg)
    log(f"  (c) smallest top-{cfg.top_k} routing margin (router "
        f"probability {cfg.top_k} less {cfg.top_k + 1}, in descending "
        f"order) over every token and layer of the parity prompts' f32 "
        f"prefill: {margin:.3e}")
    return {"launches": launches, "stats": stats, "block": block,
            "f32_rel": rel32}


def phase_hybrid(A, F, S8, card):
    """Phase 25: zamba2-7b at full width through the port's ServingEngine
    (kernel 8 on every Mamba2 prefill layer, kernel 7 on every prefill
    application of the shared block, kernel 6 on every decode
    application, no twin); kernel 8 against its twin at the serving
    shape; the f32 kernel path against the plain path."""
    from repro_torch import configs
    cfg = configs.get_config(HYBRID_ARCH)
    log(f"  {cfg.name}: {cfg.num_layers} Mamba2 layers of {cfg.ssm_heads} "
        f"heads x {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
        f"{cfg.ssm_chunk}, d_model {cfg.d_model}; one shared block of "
        f"{cfg.num_heads} heads (kv {cfg.num_kv_heads}) x {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, every {cfg.attn_period} layers; vocab "
        f"{cfg.vocab_size}, params {cfg.param_dtype}, compute "
        f"{cfg.compute_dtype}")
    params, engine, stats, launches, twins = _serve_full_width(
        cfg, (A, F, S8), card)
    steps, n_attn = stats["decode_steps"], cfg.attention_layers
    _check_serving_launches(launches, twins, {
        "flash_attention": n_attn * SERVE_REQUESTS,
        "decode_attention": n_attn * steps,
        "ssd_scan": cfg.num_layers * SERVE_REQUESTS})
    log(f"  (a) checks: every request has {SERVE_NEW} tokens, every logit "
        f"finite, kernel 8 launched {cfg.num_layers} x {SERVE_REQUESTS}, "
        f"kernel 7 {n_attn} x {SERVE_REQUESTS} and kernel 6 {n_attn} x "
        f"{steps} times, no twin ran")
    _profile_decode(engine)
    del engine
    torch.cuda.empty_cache()

    # (b) kernel 8 at the serving shape: the longest prompt at zamba2's
    # SSM widths, bf16 x/bm/cm as the bf16 compute gives them
    shape = (1, SERVE_PROMPT[1], cfg.ssm_heads, cfg.ssm_head_dim,
             cfg.ssm_state)
    x, dt, a, bm, cm = _ssd_inputs(*shape, torch.bfloat16, 25)
    got = S8.ssd_scan_cuda(x, dt, a, bm, cm)
    want = S8.ssd_scan_twin(x, dt, a, bm, cm, cfg.ssm_chunk)
    torch.cuda.synchronize()
    ey = _ssd_err(got[0], want[0], f"kernel 8 y {shape}")
    es = _ssd_err(got[1], want[1], f"kernel 8 state {shape}")
    del got, want
    k8 = cuda_ms(lambda: S8.ssd_scan_cuda(x, dt, a, bm, cm), 20, warmup=2)
    p8 = cuda_ms(lambda: S8.ssd_scan_twin(x, dt, a, bm, cm, cfg.ssm_chunk),
                 5, warmup=1)
    byt, flops, t_bytes, t_ops = _ssd_bound(*shape, torch.bfloat16)
    bound = max(t_bytes, t_ops)
    log(f"  (b) kernel 8 (B, L, H, P, N)={shape} bf16 vs twin: y max |diff| "
        f"{ey:.3e}, state {es:.3e} (tolerance {SSD_TOL} x max(1, max "
        f"|want|)); kernel {k8:.5f} ms a call, twin {p8:.5f} ms, bound "
        f"{bound:.5f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}; "
        f"{byt / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP), kernel / bound "
        f"{k8 / bound:.2f} [{card}]")
    del x, dt, a, bm, cm

    rel32 = _f32_parity(params, cfg, "attention", "ssm")
    return {"launches": launches, "stats": stats, "ssd_err": max(ey, es),
            "k8_ms": k8, "f32_rel": rel32}


# ---------------------------------------------------------------------------
# phases 26-27: training at full width
# ---------------------------------------------------------------------------

def _train_counts(mods) -> dict:
    """Every launch and twin counter of ``mods``, by name."""
    out = {}
    for mod in mods:
        out.update(mod.launches)
        out.update(getattr(mod, "twin_calls", {}))
    return out


def _train_kernel_checks(F, S8, D, cfg, card):
    """(a): the kernels of the training path against their twins at the
    shapes the path gives them: kernel 7 at (B, S, H, Hkv, D) bf16, kernel
    8 at (B, S, H, P, N) bf16; with an MoE, kernel 1 at the planner's
    (experts, groups) and (layers, groups), bitwise."""
    errs = {}
    b, s = TRAIN_BATCH, TRAIN_SEQ
    if cfg.attention_layers:
        h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q, k, v = _attn_inputs(((b, s, h, hd), (b, s, hkv, hd),
                                (b, s, hkv, hd)), 26, torch.bfloat16)
        got = F.flash_attention_cuda(q, k, v)
        errs["flash_attention"] = _attn_err(
            got, F.flash_attention_twin(q, k, v), torch.bfloat16,
            f"kernel 7 at {(b, s, h, hkv, hd)} bf16")
        log(f"  (a) kernel 7 (B, S, H, Hkv, D)={(b, s, h, hkv, hd)} bf16 vs "
            f"twin: max |diff| {errs['flash_attention']:.3e} (tolerance "
            f"{ATTN_TOL[torch.bfloat16]})")
        del q, k, v, got
    if cfg.family in ("ssm", "hybrid"):
        shape = (b, s, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        x, dt, a, bm, cm = _ssd_inputs(*shape, torch.bfloat16, 27)
        got = S8.ssd_scan_cuda(x, dt, a, bm, cm)
        want = S8.ssd_scan_twin(x, dt, a, bm, cm, cfg.ssm_chunk)
        errs["ssd_scan"] = max(_ssd_err(got[0], want[0], f"kernel 8 y {shape}"),
                               _ssd_err(got[1], want[1],
                                        f"kernel 8 state {shape}"))
        log(f"  (a) kernel 8 (B, L, H, P, N)={shape} bf16 vs twin: max |diff| "
            f"{errs['ssd_scan']:.3e} (tolerance {SSD_TOL} x max(1, max "
            f"|want|))")
        del x, dt, a, bm, cm, got, want
    if cfg.num_experts:
        rng = np.random.default_rng(SEED + 26)
        errs["dissat_from_aggregate"] = max(
            check_kernel1(D, *_random_rows(rng, n, TRAIN_GROUPS), label=lab)
            for n, lab in ((cfg.num_experts, "planner (experts, groups)"),
                           (cfg.num_layers, "planner (layers, stages)")))
    torch.cuda.empty_cache()
    return errs


def _train_grad_parity(cfg, mods) -> dict:
    """(b): f32 compute, ``TRAIN_PARITY_LAYERS`` layers of full width:
    ``forward_train``'s loss and every gradient on the kernel path (the
    kernels forward, the plain formula backward) against the plain path
    (the twins under autograd), same weights, same batch."""
    import dataclasses

    from repro_torch.models import init_params
    from repro_torch.training.data import SyntheticDataConfig, synthetic_batch
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import flatten
    cfg2 = dataclasses.replace(cfg, num_layers=TRAIN_PARITY_LAYERS,
                               compute_dtype="float32")
    params = init_params(cfg2, torch.Generator(device="cuda").manual_seed(
        SEED))
    batch = synthetic_batch(SyntheticDataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=SEED, input_kind=cfg.input_kind,
        d_model=cfg.d_model), 0, device="cuda")
    for mod in mods:
        mod.reset_launches()
    lk, _, gk = value_and_grad(params, cfg2, batch)
    kernel_counts = _train_counts(mods)
    lp, _, gp = value_and_grad(params, cfg2, batch, attention="plain",
                               ssm="plain")
    torch.cuda.synchronize()
    worst, worst_path = 0.0, ""
    for path, a, b in zip(*flatten(gk), flatten(gp)[1]):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if not bool(torch.isfinite(a).all()):
            fail(f"(b) non-finite gradient at {path}")
        if rel >= worst:
            worst, worst_path = rel, path
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    log(f"  (b) f32, {TRAIN_PARITY_LAYERS} layers of full width, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}: loss kernel path {float(lk):.6f}, "
        f"plain {float(lp):.6f} (rel {loss_rel:.3e}); gradients max |diff| "
        f"/ max |g| {worst:.3e} at {worst_path} over "
        f"{len(flatten(gk)[1])} leaves (gate {TRAIN_GRAD_TOL}); kernel "
        f"path launches {kernel_counts}")
    if not (worst <= TRAIN_GRAD_TOL and loss_rel <= TRAIN_GRAD_TOL):
        fail("(b) the kernel path's loss or gradients differ from the plain "
             "path's beyond the gate")
    del params, gk, gp
    torch.cuda.empty_cache()
    return {"grad_rel": worst, "loss_rel": loss_rel}


class _TrainProbe:
    """Instruments ``repro_torch.launch.train`` for one phase: each step is
    timed between syncs with its launch counts, a window of consecutive
    steps runs under the profiler (device activity only: a step's CPU-side
    events made the trace's processing take ~30 s), checkpoint I/O is
    timed, and each replan is recorded and checked on the CPU."""

    def __init__(self, T, mods, D, cfg):
        self.T, self.mods, self.D, self.cfg = T, mods, D, cfg
        self.steps, self.replans, self.io = [], [], []
        self.profile_at: tuple = ()
        self.profile = None       # (steps, wall s, device s, top kernels)
        self._prof = None

    def __enter__(self):
        T, probe = self.T, self
        ck = T.checkpoint
        self.real = (T.make_train_step, T.PartitionPlanner, ck.save,
                     ck.restore)
        real_step, real_planner, real_save, real_restore = self.real

        def timed(label, fn):
            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                probe.io.append((label, time.perf_counter() - t0))
                return out
            return call
        ck.save = timed("save", real_save)
        ck.restore = timed("restore", real_restore)

        def make_train_step(cfg, hyper, **kw):
            fn = real_step(cfg, hyper, **kw)

            def step(state, batch):
                at = int(state.step)
                torch.cuda.synchronize()
                before = _train_counts(probe.mods)
                if probe.profile_at and at == probe.profile_at[0]:
                    probe.start_profile()
                t0 = time.perf_counter()
                out = fn(state, batch)
                torch.cuda.synchronize()
                if probe.profile_at and at == probe.profile_at[-1]:
                    probe.stop_profile()
                after = _train_counts(probe.mods)
                probe.steps.append((at, time.perf_counter() - t0, {
                    k: after[k] - before[k] for k in after}))
                return out
            return step

        class Planner(real_planner):
            def maybe_replan(self, step, state):
                return probe.replan(super().maybe_replan, self, step, state)

        T.make_train_step, T.PartitionPlanner = make_train_step, Planner
        return self

    def start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._prof_t0 = time.perf_counter()

    def stop_profile(self):
        wall = time.perf_counter() - self._prof_t0
        self._prof.__exit__(None, None, None)
        events = [e for e in self._prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")]
        device_s = sum(e.self_device_time_total for e in events) / 1e6
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
        self.profile = (self.profile_at, wall, device_s, top)
        self._prof = None

    def __exit__(self, *exc):
        ck = self.T.checkpoint
        (self.T.make_train_step, self.T.PartitionPlanner, ck.save,
         ck.restore) = self.real
        return False

    def replan(self, real, planner, step, state):
        """A replan on the card, then the same statistics through
        ``expert_placement`` on the CPU: the permutation bitwise, the
        stats equal; the MoE block's f32 map kept across the
        permutation."""
        import dataclasses

        from repro_torch.models.moe import moe_block
        from repro_torch.sharding.planner import expert_placement
        load, coact = state.expert_load.cpu(), state.coactivation.cpu()
        k1 = self.D.launches["dissat_from_aggregate"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, stats = real(step, state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if stats is None:
            return new, stats
        moved = new is not state
        e = load.shape[0]
        perm = planner._last_perm.cpu() if moved \
            else torch.arange(e, dtype=torch.int32)
        cpu_perm, _, cpu_stats = expert_placement(load, coact,
                                                  planner.num_groups,
                                                  mu=planner.mu)
        same_stats = cpu_stats["moves"] == stats["moves"] and all(
            math.isclose(cpu_stats[k], stats[k], rel_tol=1e-6)
            for k in ("imbalance_before", "imbalance_after"))
        if not torch.equal(perm, cpu_perm) or not same_stats:
            fail(f"(c) replan at step {step}: the card's permutation "
                 f"{perm.tolist()} / stats {stats} differ from the CPU's "
                 f"{cpu_perm.tolist()} / {cpu_stats}")
        moe_err = None
        if moved:
            cfg32 = dataclasses.replace(self.cfg, compute_dtype="float32")
            g = torch.Generator(device="cuda").manual_seed(SEED + step)
            x = torch.randn((1, PLANNER_MOE_TOKENS, self.cfg.d_model),
                            generator=g, device="cuda")
            y0, _ = moe_block(state.params["blocks"][0]["moe"], cfg32, x)
            y1, _ = moe_block(new.params["blocks"][0]["moe"], cfg32, x)
            diff = (y1 - y0).abs()
            moe_err = float(diff.max())
            if bool((diff > PLANNER_MOE_TOL * (1 + y0.abs())).any()):
                fail(f"(c) replan at step {step}: the MoE block's output "
                     f"moved by {moe_err} across the permutation")
        self.replans.append({
            "step": step, "stats": stats, "moved": moved,
            "perm": perm.tolist(), "k1": self.D.launches[
                "dissat_from_aggregate"] - k1, "ms": 1e3 * wall,
            "moe_err": moe_err})
        return new, stats


def _steady(probe_steps, start: int):
    """(ms a step, launches a step) over the timed steps past ``start``."""
    rows = [(t, c) for at, t, c in probe_steps if at > start]
    ms = 1e3 * sum(t for t, _ in rows) / len(rows)
    return ms, rows[-1][1]


def phase_train(arch: str, F, S8, D, card, planner: bool):
    """Phases 26-27: ``arch`` trained at its published widths through
    ``repro_torch.launch.train.train`` (a)-(e); see the docstring."""
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.launch import train as T
    from repro_torch.models.convert import param_count
    from repro_torch.training.tree import flatten
    cfg = configs.get_config(arch)
    mods = (F, S8, D)
    n_attn = cfg.attention_layers
    n_ssm = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    log(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, params {cfg.param_dtype}, compute "
        f"{cfg.compute_dtype}, remat {cfg.remat}; batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} = {TRAIN_BATCH * TRAIN_SEQ} tokens a step")
    errs = _train_kernel_checks(F, S8, D, cfg, card)
    parity = _train_grad_parity(cfg, mods)

    kw = dict(smoke=False, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
              seq_len=TRAIN_SEQ, replan=TRAIN_REPLAN if planner else 0,
              groups=TRAIN_GROUPS if planner else 1, log_every=1, seed=SEED,
              device="cuda")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # (c)-(d): the uninterrupted run, checkpoints at 3 and 6
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for mod in mods:
            mod.reset_launches()
        t0 = time.perf_counter()
        with _TrainProbe(T, mods, D, cfg) as probe:
            straight, losses = T.train(arch, ckpt_dir=ckpt,
                                       ckpt_every=TRAIN_CKPT_EVERY, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = _train_counts(mods)
        n_params = param_count(straight.params)
        ms, per_step = _steady(probe.steps, 0)
        tok_s = TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3)
        log(f"  (c) {TRAIN_STEPS} steps in {wall:.1f} s (checkpoints and "
            f"replans included): {n_params} parameters, losses "
            f"{[round(x, 4) for x in losses]}; {ms:.1f} ms a step over steps "
            f"1-{TRAIN_STEPS - 1} (step 0 {1e3 * probe.steps[0][1]:.1f} ms), "
            f"{tok_s:.1f} trained tokens/s; peak memory {peak / 2**30:.2f} "
            f"GiB [{card}]")
        if n_params != cfg.param_count() + cfg.shared_block_params():
            fail(f"(c) {n_params} parameters, the config counts "
                 f"{cfg.param_count()}")
        if not all(math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            fail(f"(c) losses not finite and falling: {losses}")
        for r in probe.replans:
            st = r["stats"]
            log(f"  (c) replan at step {r['step']}: imbalance "
                f"{st['imbalance_before']:.4f} -> {st['imbalance_after']:.4f}"
                f", {st['moves']} moves, permuted {r['moved']}, kernel 1 "
                f"launched {r['k1']} times, {r['ms']:.1f} ms; permutation "
                f"{r['perm']} == expert_placement on the CPU, bitwise"
                + (f"; MoE block f32 max |diff| across it {r['moe_err']:.3e} "
                   f"(tolerance {PLANNER_MOE_TOL})"
                   if r["moe_err"] is not None else ""))
        if planner:
            if [r["step"] for r in probe.replans] != list(range(
                    TRAIN_REPLAN, TRAIN_STEPS + 1, TRAIN_REPLAN)):
                fail(f"(c) replans at {[r['step'] for r in probe.replans]}")
            if sum(r["k1"] for r in probe.replans) == 0 \
                    or launches["dissat_from_aggregate"] != sum(
                        r["k1"] for r in probe.replans):
                fail(f"(c) kernel 1 launches {launches}")
        # (d): launches a step, every step
        want = {"flash_attention": 2 * n_attn if cfg.remat else n_attn,
                "ssd_scan": 2 * n_ssm if cfg.remat else n_ssm,
                "flash_attention_twin": 0, "ssd_scan_twin": 0}
        for at, _, counts in probe.steps:
            if any(counts[k] != n for k, n in want.items()):
                fail(f"(d) step {at} launched {counts}, want {want}")
        log(f"  (d) every step: kernel 7 {want['flash_attention']}, kernel 8 "
            f"{want['ssd_scan']} launches (remat: each layer's forward runs "
            f"again in the backward), no twin; the run: {launches}")

        # (e): a fresh train() resumes from the step-4 checkpoint and must
        # end on the uninterrupted state bitwise (the replan at step 6
        # included)
        for mod in mods:
            mod.reset_launches()
        t0 = time.perf_counter()
        with _TrainProbe(T, mods, D, cfg) as probe2:
            probe2.profile_at = TRAIN_PROFILE_STEPS
            resumed, tail = T.train(arch, ckpt_dir=ckpt,
                                    ckpt_every=TRAIN_STEPS + 1, **kw)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        paths, a = flatten(straight)
        _, b = flatten(resumed)
        differ = [p for p, x, y in zip(paths, a, b) if not _bits_equal(x, y)]
        if differ or tail != losses[TRAIN_CKPT_EVERY:]:
            fail(f"(e) the resumed run differs from the uninterrupted one: "
                 f"{len(differ)} leaves ({differ[:4]}), losses {tail} vs "
                 f"{losses[TRAIN_CKPT_EVERY:]}")
        steps_p, pwall, pdev, top = probe2.profile
        busy = pdev / pwall
        log(f"  (e) resumed from step {TRAIN_CKPT_EVERY} to {TRAIN_STEPS} in "
            f"{wall2:.1f} s (restore included): all {len(paths)} leaves "
            f"(params, Adam moments, count, step, router statistics) "
            f"bitwise the uninterrupted run's, losses equal; steps "
            f"{steps_p} under the profiler: {1e3 * pwall:.1f} ms of wall, "
            f"{1e3 * pdev:.1f} ms on the device, busy share {busy:.4f} "
            f"[{card}]")
        io = probe.io + probe2.io
        log(f"  (e) checkpoint I/O (16 GB-class f32 state, npz on the "
            f"machine's disk): "
            + ", ".join(f"{label} {t:.1f} s" for label, t in io))
        log(f"  (e) steps {steps_p}' heaviest device kernels (profiler, "
            f"self device time):")
        for ev in top:
            log(f"    {ev.key[:70]:70s} {ev.count:6d} x "
                f"{ev.self_device_time_total / max(ev.count, 1):10.2f} us")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del straight, resumed
    torch.cuda.empty_cache()
    return {"errs": errs, "parity": parity, "launches": launches,
            "per_step": per_step, "ms": ms, "tok_s": tok_s, "peak": peak,
            "busy": busy, "replans": probe.replans + probe2.replans,
            "io": io}


# ---------------------------------------------------------------------------
# phase 28: the LM examples on the card
# ---------------------------------------------------------------------------

def sampling_tv(gen, logits_row, temperature: float, top_k: int,
                draws: int):
    """``draws`` draws of ``sample_logits`` from one logits row (on its
    device) against ``softmax(logits / T)`` (top-k kept as the sampler
    keeps it, from the f32 row divided by T) in f64 on the host: (total
    variation distance, its bound, draws outside the kept set).  The
    bound: E[TV] <= 0.5 sum_i sqrt(p_i (1 - p_i) / n), and one draw moves
    TV by at most 1/n, so TV passes E[TV] + sqrt(ln(10^6) / (2 n)) with
    probability below 10^-6 (McDiarmid)."""
    from repro_torch.serving.sampler import sample_logits
    v = logits_row.shape[-1]
    tok = sample_logits(gen, logits_row[None].expand(draws, v),
                        temperature=temperature, top_k=top_k)
    counts = torch.bincount(tok.long(), minlength=v).cpu().double()
    z = logits_row.float().cpu() / temperature
    kept = torch.ones(v, dtype=torch.bool)
    if top_k > 0:
        kept = z >= torch.topk(z, top_k).values[-1]
    p = torch.softmax(torch.where(kept, z.double(), -math.inf), dim=0)
    tv = 0.5 * float((counts / draws - p).abs().sum())
    bound = 0.5 * float(torch.sqrt(p * (1 - p) / draws).sum()) \
        + math.sqrt(math.log(1e6) / (2 * draws))
    return tv, bound, int(counts[~kept].sum())


def _dir_bytes(path: str) -> int:
    import os
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def phase_examples(A, F, D, card):
    """Phase 28: the three LM examples' paths (a)-(c); see the
    docstring."""
    import os
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch import moe_expert_rebalance as MX
    from repro_torch import train_lm as TL
    from repro_torch.launch import serve as SV
    from repro_torch.launch import train as T
    from repro_torch.sharding.planner import expert_placement
    mods = (A, F, D)
    counts = {}

    # (a) moe_expert_rebalance: the shifting data, replans on kernel 1
    cfg = configs.get_smoke_config(MX.ARCH)
    for mod in mods:
        mod.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, records = MX.run(device="cuda", verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["rebalance"] = _train_counts(mods)
    if [r["step"] for r in records] != EXAMPLE_REPLANS:
        fail(f"(a) replans at {[r['step'] for r in records]}")
    per_step = cfg.attention_layers * (2 if cfg.remat else 1)
    launched = counts["rebalance"]
    if launched["flash_attention"] != MX.STEPS * per_step \
            or launched["flash_attention_twin"] \
            or launched["dissat_from_aggregate"] == 0:
        fail(f"(a) launches {launched}, want kernel 7 {MX.STEPS} x "
             f"{per_step}, kernel 1 > 0, no twin")
    for r in records:
        e = r["expert_load"].shape[0]
        perm = r["perm"] if r["perm"] is not None \
            else torch.arange(e, dtype=torch.int32)
        cpu_perm, _, cpu_stats = expert_placement(
            r["expert_load"], r["coactivation"], 4, mu=0.5)
        same = cpu_stats["moves"] == r["stats"]["moves"] and all(
            math.isclose(cpu_stats[k], r["stats"][k], rel_tol=1e-6)
            for k in ("imbalance_before", "imbalance_after"))
        if not torch.equal(perm, cpu_perm) or not same \
                or not math.isfinite(r["loss"]):
            fail(f"(a) replan at step {r['step']}: the card's permutation "
                 f"{perm.tolist()} / {r['stats']} (loss {r['loss']}) vs the "
                 f"CPU's {cpu_perm.tolist()} / {cpu_stats}")
        log(f"  (a) step {r['step']}: loss {r['loss']:.4f}, imbalance "
            f"{r['stats']['imbalance_before']:.4f} -> "
            f"{r['stats']['imbalance_after']:.4f}, {r['stats']['moves']} "
            f"moves, permutation {perm.tolist()} == the CPU's, bitwise")
    log(f"  (a) {MX.ARCH} smoke, {MX.STEPS} steps and "
        f"{len(records)} replans in {wall:.2f} s ({1e3 * wall / MX.STEPS:.1f}"
        f" ms a step with the replans); launches {launched} [{card}]")

    # (b) train_lm --steps 40 --demo-restart in a temporary directory
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_lm_")
    midi = TL.midi_config()
    try:
        for mod in mods:
            mod.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _TrainProbe(T, mods, D, midi) as probe:
            (_, first), (_, second) = TL.run(
                steps=TRAIN_LM_STEPS, ckpt_dir=ckpt, demo_restart=True,
                device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts["train_lm"] = _train_counts(mods)
        half = TRAIN_LM_STEPS // 2
        sizes = {name: _dir_bytes(os.path.join(ckpt, name))
                 for name in sorted(os.listdir(ckpt))}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses = first + second
    if len(first) != half or len(second) != TRAIN_LM_STEPS - half \
            or not all(math.isfinite(x) for x in losses):
        fail(f"(b) phase 1 ran {len(first)} steps, phase 2 {len(second)} "
             f"(want {half} and {TRAIN_LM_STEPS - half}, resumed at "
             f"{half}); losses {losses}")
    ms, _ = _steady(probe.steps, 0)
    batch, seq = 8, 256
    tok_s = batch * seq / (ms / 1e3)
    launched = counts["train_lm"]
    per_step = midi.attention_layers * (2 if midi.remat else 1)
    if launched["flash_attention"] != TRAIN_LM_STEPS * per_step \
            or launched["flash_attention_twin"] \
            or launched["dissat_from_aggregate"] == 0:
        fail(f"(b) launches {launched}, want kernel 7 {TRAIN_LM_STEPS} x "
             f"{per_step}, kernel 1 > 0, no twin")
    log(f"  (b) {midi.name} ({midi.param_count()} parameters), "
        f"{TRAIN_LM_STEPS} steps of {batch} x {seq} tokens with a restart "
        f"at {half} in {wall:.1f} s: losses {losses[0]:.4f} -> "
        f"{first[-1]:.4f} | resumed {second[0]:.4f} -> {second[-1]:.4f}; "
        f"{ms:.2f} ms a step, {tok_s:.1f} trained tokens/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    for r in probe.replans:
        st = r["stats"]
        log(f"  (b) replan at step {r['step']}: imbalance "
            f"{st['imbalance_before']:.4f} -> {st['imbalance_after']:.4f}, "
            f"{st['moves']} moves, kernel 1 {r['k1']} launches, "
            f"{r['ms']:.1f} ms; permutation == the CPU's, bitwise")
    log(f"  (b) checkpoints: " + ", ".join(
        f"{name} {n / 1e9:.3f} GB" for name, n in sizes.items())
        + "; I/O " + ", ".join(f"{label} {t:.2f} s" for label, t in probe.io))
    log(f"  (b) launches {launched}")

    # (c) sampling with temperature at full width
    for mod in mods:
        mod.reset_launches()
    runs = []
    for temperature in (SAMPLE_TEMPERATURE, SAMPLE_TEMPERATURE, 0.0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = SV.serve(SAMPLE_ARCH, smoke=False, temperature=temperature,
                         requests=SAMPLE_REQUESTS, max_new=SAMPLE_NEW,
                         seed=SEED, device="cuda")
        torch.cuda.synchronize()
        runs.append((stats, time.perf_counter() - t0))
        torch.cuda.empty_cache()
    counts["sample"] = _train_counts(mods)
    (hot, w1), (again, w2), (greedy, w3) = runs
    cfg = configs.get_config(SAMPLE_ARCH)
    for stats, _ in runs:
        if len(stats["outputs"]) != SAMPLE_REQUESTS or any(
                len(t) != SAMPLE_NEW for t in stats["outputs"].values()):
            fail(f"(c) incomplete requests: {stats['outputs']}")
    if hot["outputs"] != again["outputs"]:
        fail("(c) the same seed sampled different tokens")
    if hot["outputs"] == greedy["outputs"]:
        fail("(c) sampling at T = 0.8 gave the greedy tokens")
    launched = counts["sample"]
    prefills = sum(st["prefills"] for st, _ in runs)
    steps = sum(st["decode_steps"] for st, _ in runs)
    n = cfg.attention_layers
    if launched["flash_attention"] != n * prefills \
            or launched["decode_attention"] != n * steps \
            or launched["flash_attention_twin"] \
            or launched["decode_attention_twin"]:
        fail(f"(c) launches {launched}, want kernel 7 {n} x {prefills}, "
             f"kernel 6 {n} x {steps}, no twin")
    differ = sum(a != b for u in hot["outputs"]
                 for a, b in zip(hot["outputs"][u], greedy["outputs"][u]))
    log(f"  (c) {SAMPLE_ARCH} at full width, {SAMPLE_REQUESTS} requests x "
        f"{SAMPLE_NEW} new tokens at T = {SAMPLE_TEMPERATURE}: "
        f"{hot['tok_per_s']:.1f} and {again['tok_per_s']:.1f} generated "
        f"tok/s ({w1:.1f} and {w2:.1f} s with the weights' draw), the same "
        f"tokens both runs; greedy {greedy['tok_per_s']:.1f} tok/s "
        f"({w3:.1f} s), {differ} of {SAMPLE_REQUESTS * SAMPLE_NEW} tokens "
        f"differ; launches {launched} [{card}]")
    g = torch.Generator(device="cpu").manual_seed(SEED + 28)
    row = (3.0 * torch.randn(SAMPLE_VOCAB, generator=g)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 28)
    sampling = []
    for top_k in (0, SAMPLE_TOP_K):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tv, bound, outside = sampling_tv(gen, row, SAMPLE_TEMPERATURE, top_k,
                                         SAMPLE_DRAWS)
        dt = time.perf_counter() - t0
        log(f"  (c) {SAMPLE_DRAWS} card draws, V = {SAMPLE_VOCAB}, T = "
            f"{SAMPLE_TEMPERATURE}, top_k {top_k}: TV from softmax(logits "
            f"/ T) {tv:.5f} (bound {bound:.5f}), {outside} draws outside "
            f"the kept set, {dt:.2f} s")
        if not tv <= bound or outside:
            fail(f"(c) top_k {top_k}: TV {tv} > {bound} or {outside} draws "
                 f"outside the top-k")
        sampling.append({"top_k": top_k, "tv": tv, "bound": bound})
    return {"launches": counts, "sampling": sampling, "train_ms": ms,
            "train_tok_s": tok_s, "ckpt_bytes": sizes}


# phase 29: the kernels the linter's entry points launch on the card
# (``refine.kernel`` and ``distributed.shard_map``: kernel 1;
# ``batch.refine`` and ``distributed.refine``: kernel 3;
# ``refine.sparse.edge_kernel``: kernel 4)
ANALYSIS_ROUTES = ("dissat_from_aggregate", "dissat_from_aggregate_batched",
                   "dissat_from_edges")


def _kernel_modules():
    from repro_torch.kernels import decode_attention, dissatisfaction, \
        edge_block, flash_attention, ssd_scan
    return (dissatisfaction, edge_block, decode_attention, flash_attention,
            ssd_scan)


def phase_analysis(card):
    """Phase 29: the contract linter's every family at the full grid on
    the card; the allocator fits against the budgets and the table; the
    kernels' launches during the run."""
    from repro_torch.analysis import (FAMILIES, AnalysisContext,
                                      complexity_rules, entrypoints,
                                      load_baseline, registered_rules,
                                      run_rules, split_findings)
    cx = complexity_rules
    mods = _kernel_modules()
    for mod in mods:
        mod.reset_launches()
    t0 = time.perf_counter()
    ctx = AnalysisContext(complexity_grid="full", device="cuda")
    findings, fam_secs = [], {}
    with ctx.sessions():                # one NCCL group for every family
        for fam in FAMILIES:
            t1 = time.perf_counter()
            findings += run_rules(ctx, [fam])
            fam_secs[fam] = round(time.perf_counter() - t1, 1)
    findings.sort(key=lambda f: f.id)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: n for mod in mods for name, n in mod.launches.items()}
    rules = registered_rules()
    log(f"  (a) {len(rules)} rules in {secs:.1f} s on {card} (by family "
        f"{fam_secs}): {', '.join(sorted(r.name for r in rules))}")
    for cell, info in ctx.reports["dispatch-coverage"]["cells"].items():
        log(f"    {cell:<20s}{'covered' if info['covered'] else 'MISSING'}")
    new, known, stale = split_findings(findings, load_baseline())
    for f in known:
        log(f"    [baselined] {f.id}")
    for f in new:
        log(f"    [NEW] {f.id}: {f.message}")
    for sid in sorted(stale):
        log(f"    [stale baseline entry] {sid}")
    if new:
        fail(f"the linter found {len(new)} finding(s) outside the port's "
             f"baseline: {[f.id for f in new]}")
    if len(rules) != 17:
        fail(f"{len(rules)} rules registered, want the reference's 17")
    section = cx.section_name("full", "cuda")
    table = cx.load_table().get("grids", {}).get(section)
    if table is None:
        fail(f"complexity.json has no {section!r} section")
    profiles = cx.all_profiles("full", "cuda")
    if len(profiles) != len(entrypoints.registered_entry_points()):
        fail(f"{len(profiles)} profiles for "
             f"{len(entrypoints.registered_entry_points())} entry points")
    log(f"  (b) the allocator's peak bytes at each grid size, the fitted "
        f"mem_device exponents (budget + {cx.EXPONENT_TOL}; table "
        f"{section!r} within {cx.EXPECTATION_TOL})")
    for name, prof in sorted(profiles.items()):
        budget = cx.declared_budget(entrypoints.entry_point(name))["mem"]
        fits = prof["fits"]["mem_device"]
        want = table[name]["fits"]["mem_device"]
        peaks = prof["mem_device_bytes"]
        log(f"    {name:<32s} N {prof['sizes']['n']}: {peaks['n']} B; "
            + "; ".join(f"{d} {fits[d]:.3f} (budget {budget[d]}, table "
                        f"{want[d]})" for d in sorted(fits)))
        for dim, got in fits.items():
            if got > budget[dim] + cx.EXPONENT_TOL:
                fail(f"{name}: mem_device exponent {got:.3f} in {dim} over "
                     f"its budget {budget[dim]}")
            if abs(got - want[dim]) > cx.EXPECTATION_TOL:
                fail(f"{name}: mem_device exponent {got:.3f} in {dim}, the "
                     f"table says {want[dim]}")
    log(f"  (c) kernel launches during (a): {launches}")
    for name in ANALYSIS_ROUTES:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the linter's card "
                 f"routes")
    return {"launches": launches, "seconds": secs}


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
    # the nvcc processes build while this thread draws the main problem
    with ThreadPoolExecutor(1) as nvcc_pool:
        build = nvcc_pool.submit(_timed, _build.build_all)
        log(f"== set-up: problem N={N}, K={K}, mu={MU} from seed {SEED}, "
            f"beside the kernels' build")
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
        build_s = build.result()
    log(f"  kernel build: {build_s:.1f} s")
    for stem, report in _build.build_reports.items():
        for line in report.splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                log(f"  [{stem}] {line.strip()}")

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
    edge_kernels = phase_sparse_times(E, sp, sparse_run["r"], card)
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
    from repro_torch.sharding import hints
    hints.reset_redistributions()
    log("== phase 13: attention kernels 6-7 vs plain twins on the card")
    err6, err7 = phase_attention_kernels(A, F)
    log(f"== phase 14: {LM_ARCH} at full width through ServingEngine "
        f"(kernels 6-7)")
    params, engine, serving = phase_serving(A, F, card)
    check_redistributions("phase 14")
    log("== phase 15: kernel path vs plain path at full width")
    phase_paths(params, engine)
    check_redistributions("phase 15")
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
    check_redistributions("phase 18")
    log("== phase 19: SSM kernel path vs plain path at full width; kernel "
        "8's times (CUDA events, serving shape)")
    rec8 = phase_ssm_paths(S8, params, engine, card)
    check_redistributions("phase 19")
    rec8["launches"] = ssm_serving["launches"]["ssd_scan"]
    rec8["max_abs_err"] = err8
    kernels.append(rec8)
    del params, engine
    torch.cuda.empty_cache()

    log(f"== phase 20: the DES at N={DES_N}, K={DES_K} (refine_freq "
        f"{DES_REFINE_FREQ}: kernel 1 per turn), and a static run")
    des = phase_des(D, card)
    log(f"== phase 21: the DES fleet (B={DES_FLEET_B}, N={DES_FLEET_N}: "
        f"kernel 3 per batched turn) and the remaining core at N={ANNEAL_N}")
    des_fleet = phase_des_fleet(D, card)
    phase_core_rest(card)
    log(f"  DES launches: kernel 1 {des['launches']['dissat_from_aggregate']}"
        f" (phase 20), kernel 3 "
        f"{des_fleet['launches']['dissat_from_aggregate_batched']} "
        f"(phase 21)")
    log(f"== phase 22: distributed refinement and faults on phase 3's "
        f"instance (S={DIST_S} shards of {N // DIST_S}; kernel 3 per "
        f"emulated turn, kernel 2 per recompute turn, kernel 1 per rank "
        f"turn)")
    t0 = time.perf_counter()
    dist_run = phase_distributed(D, ops, problem, main_run, des, card)
    log(f"  phase 22: {time.perf_counter() - t0:.1f} s")
    for rec in kernels:
        if rec["name"] in dist_run["launches"]:
            rec["distributed_launches"] = dist_run["launches"][rec["name"]]
    log("== phase 23: run telemetry (repro_torch.obs) on phases 3, 20 and "
        "22's instances: recorders, the timed dissat_fn, report --check")
    t0 = time.perf_counter()
    tel = phase_telemetry(D, ops, problem, main_run, des, dist_run, card)
    log(f"  phase 23: {time.perf_counter() - t0:.1f} s")
    for rec in kernels:
        if tel["launches"].get(rec["name"]):
            rec["telemetry_launches"] = tel["launches"][rec["name"]]
    del problem, main_run, des, dist_run, tel
    torch.cuda.empty_cache()
    log(f"== phase 24: {MOE_ARCH} at full width through ServingEngine "
        f"(kernels 6-7), its MoE block, kernel vs plain path")
    t0 = time.perf_counter()
    moe_run = phase_moe(A, F, S8, card)
    check_redistributions("phase 24")
    log(f"  phase 24: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    log(f"== phase 25: {HYBRID_ARCH} at full width through ServingEngine "
        f"(kernels 6-8), kernel 8 at its shape, kernel vs plain path")
    t0 = time.perf_counter()
    hybrid_run = phase_hybrid(A, F, S8, card)
    check_redistributions("phase 25")
    log(f"  phase 25: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    for rec in kernels:
        if rec["name"] in ("decode_attention", "flash_attention",
                           "ssd_scan"):
            rec["moe_launches"] = moe_run["launches"][rec["name"]]
            rec["hybrid_launches"] = hybrid_run["launches"][rec["name"]]
    log(f"== phase 26: {MOE_ARCH} training at full width (launch.train: "
        f"kernel 7 forward, the expert planner on kernel 1)")
    t0 = time.perf_counter()
    train_moe = phase_train(MOE_ARCH, F, S8, D, card, planner=True)
    check_redistributions("phase 26")
    log(f"  phase 26: {time.perf_counter() - t0:.1f} s")
    log(f"== phase 27: {SSM_ARCH} training at full width (launch.train: "
        f"kernel 8 forward)")
    t0 = time.perf_counter()
    train_ssm = phase_train(SSM_ARCH, F, S8, D, card, planner=False)
    check_redistributions("phase 27")
    log(f"  phase 27: {time.perf_counter() - t0:.1f} s")
    for rec in kernels:
        name = rec["name"]
        if name in ("flash_attention", "ssd_scan", "dissat_from_aggregate"):
            rec["train_launches"] = {MOE_ARCH: train_moe["launches"][name],
                                     SSM_ARCH: train_ssm["launches"][name]}
        for run in (train_moe, train_ssm):
            if name in run["errs"]:
                rec["max_abs_err"] = max(rec["max_abs_err"],
                                         run["errs"][name])
    log("== phase 28: the LM examples on the card (moe_expert_rebalance, "
        "train_lm --demo-restart, temperature sampling at full width)")
    t0 = time.perf_counter()
    examples = phase_examples(A, F, D, card)
    check_redistributions("phase 28")
    log(f"  phase 28: {time.perf_counter() - t0:.1f} s")
    for rec in kernels:
        name = rec["name"]
        if name in ("flash_attention", "decode_attention",
                    "dissat_from_aggregate"):
            rec["examples_launches"] = {
                run: counts[name]
                for run, counts in examples["launches"].items()}
    log("== phase 29: the contract linter on the card (repro_torch.analysis, "
        "full grid)")
    t0 = time.perf_counter()
    lint = phase_analysis(card)
    check_redistributions("phase 29")
    log(f"  phase 29: {time.perf_counter() - t0:.1f} s")
    for rec in kernels:
        rec["analysis_launches"] = lint["launches"][rec["name"]]
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    decode = {LM_ARCH: decode_ms(serving["stats"]),
              SSM_ARCH: decode_ms(ssm_serving["stats"]),
              MOE_ARCH: decode_ms(moe_run["stats"]),
              HYBRID_ARCH: decode_ms(hybrid_run["stats"])}
    print("decode ms a step (this run / earlier run): " + ", ".join(
        f"{arch} {ms:.3f} / {EARLIER_DECODE_MS[arch]:.3f}"
        for arch, ms in decode.items()) + f" [{card}]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
