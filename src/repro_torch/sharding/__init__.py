"""Sharding (port of ``repro.sharding``): so far the planner, the
paper's game placing experts and pipeline stages.  The reference's
PartitionSpec rules and hints come with a later slice."""
from .planner import (  # noqa: F401
    PartitionPlanner,
    apply_expert_permutation,
    expert_placement,
    stage_assignment,
)
