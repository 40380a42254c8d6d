"""repro_torch — the PyTorch and CUDA port of ``repro``, for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package keeps its
module names and public signatures so each counterpart is easy to find,
and imports nothing of it.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.  Ported so far: the partition game on
dense and sparse (edge-list) problems with its refinement entry points,
``refine_sweeps``, cluster moves and batched fleets (``core``), the
``SweepSpec → run_sweep`` runtime (``sweeps``), dense and SSM (Mamba2)
LM serving (``models``, ``configs``, ``serving``, ``launch.serve``), eight
kernels — five for refinement, two for attention, one for the SSD scan
(``kernels``) — and the graph generators (``graphs``, copied).
"""
