"""Continuous-batching serving (port of ``repro.serving``)."""
from .engine import Request, ServeConfig, ServingEngine  # noqa: F401
from .sampler import greedy, sample_logits  # noqa: F401
