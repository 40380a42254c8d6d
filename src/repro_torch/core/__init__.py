"""The partition game: dense and sparse problems, costs, aggregate carry,
refinement (turns, sweeps, cluster moves), batched fleets and initial
partitioning."""
