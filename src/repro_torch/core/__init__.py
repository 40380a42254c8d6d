"""The partition game: dense and sparse problems, costs, aggregate carry,
refinement (turns, sweeps, cluster moves), batched fleets, initial
partitioning, simulated annealing and the capacity-constrained repairs."""
from .annealing import AnnealResult, simulated_annealing  # noqa: F401
from .constrained import (  # noqa: F401
    contiguous_stage_dp,
    equalize_cardinality,
    make_contiguous,
)


def __getattr__(name):
    # ``refine`` imports the kernel adapters, and the kernel modules import
    # ``core.costs``; importing ``refine`` here eagerly would close that
    # cycle whenever a kernel module is imported first.
    if name == "count_discrepancies":
        from .refine import count_discrepancies
        return count_discrepancies
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
