"""Sharding (port of ``repro.sharding``): the partition-spec rules over a
(pod, data, model) mesh (``rules``: specs as plain tuples, DTensor
placements over a ``DeviceMesh``), the activation hints (``hints``), and
the planner, the paper's game placing experts and pipeline stages."""
from .rules import (  # noqa: F401
    batch_spec,
    cache_shardings,
    param_shardings,
    state_shardings,
)
from .planner import (  # noqa: F401
    PartitionPlanner,
    apply_expert_permutation,
    expert_placement,
    stage_assignment,
)
