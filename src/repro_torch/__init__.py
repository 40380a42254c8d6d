"""repro_torch — the PyTorch and CUDA port of ``repro``, for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package keeps its
module names and public signatures so each counterpart is easy to find,
and imports nothing of it.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.  Ported so far: the partition game on
dense and sparse (edge-list) problems with its refinement entry points,
``refine_sweeps``, cluster moves, batched fleets, simulated annealing,
the capacity-constrained repairs and the §5.1 discrepancy count
(``core``), the paper's Time-Warp DES with periodic refinement and its
fleets (``des``, ``des_partitioning``), distributed refinement and its
fault injection (``distributed``), run telemetry — event streams from
every runtime, JSONL logs and the replay/report CLI (``obs``) — the
``SweepSpec → run_sweep`` runtime (``sweeps``), LM serving of all four
families — dense, SSM (Mamba2), MoE and hybrid (``models``, ``configs``,
``serving``, ``launch.serve``) — LM training with checkpoints and the
game's expert planner (``training``, ``sharding.planner``,
``launch.train``), the sharding rules and hints over a ``DeviceMesh``
(``sharding``), the dry run that shards every (arch x shape) cell on the
``meta`` device over a fake process group and counts its FLOPs, bytes and
collectives (``configs.shapes``, ``launch.dryrun``, ``launch.traffic``,
``launch.flops``, ``launch.collectives``), the LM examples
(``moe_expert_rebalance``, ``train_lm``, ``serve_lm``), eight kernels —
five for refinement, two for attention, one for the SSD scan
(``kernels``) — and, copied, the graph generators (``graphs``) and the §2
baselines (``partitioners``).  The reference's static analysis
(``repro.analysis``) is not ported yet.
"""
