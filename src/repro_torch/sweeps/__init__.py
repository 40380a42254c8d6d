"""Batched sweep runtime: scenario fleets as stacked batches (DESIGN.md
§12), PyTorch port of ``repro.sweeps``.

``SweepSpec → run_sweep → SweepResult`` for the partition game, plus the
stacking/reduction helpers the batched DES entry point
(:func:`repro_torch.des.engine.run_simulation_batch`) shares.
"""
from ..core.batch import (  # noqa: F401
    batch_size,
    refine_batched,
    refine_simultaneous_batched,
    refine_traced_batched,
    shard_across_devices,
    stack_problems,
    stack_pytrees,
    unstack_pytree,
)
from ..des.engine import run_simulation_batch  # noqa: F401
from ..des.scenarios import pad_segments, stack_schedules  # noqa: F401
from .metrics import load_cv, load_cv_trace, time_averaged_cv  # noqa: F401
from .runtime import (  # noqa: F401
    SweepCase,
    SweepResult,
    SweepSpec,
    make_spec,
    run_sweep,
)
