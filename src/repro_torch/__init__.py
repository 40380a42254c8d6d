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
``SweepSpec → run_sweep`` runtime (``sweeps``), dense and SSM (Mamba2)
LM serving (``models``, ``configs``, ``serving``, ``launch.serve``),
eight kernels — five for refinement, two for attention, one for the SSD
scan (``kernels``) — and, copied, the graph generators (``graphs``) and
the §2 baselines (``partitioners``).
"""
