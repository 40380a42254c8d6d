"""The partition game: problem, costs, aggregate carry, refinement and
initial partitioning (dense problems)."""
