from .baselines import (  # noqa: F401
    greedy_load_partition,
    kernighan_lin_refine,
    nandy_loucks_refine,
    random_partition,
    spectral_bisection,
)
