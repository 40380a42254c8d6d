"""Assigned-architecture registry: ``--arch <id>`` resolves here (port of
``repro.configs``).

Each module defines ``CONFIG`` (exact published numbers, source noted in its
docstring) and ``smoke()`` (reduced same-family variant for CPU tests).  The
modules are the reference's, copied; so are the dry run's four input shapes
(``shapes``), whose inputs are ``meta`` tensors.
"""
from __future__ import annotations

import importlib

from .shapes import SHAPES, Shape, input_specs, shape_is_applicable  # noqa: F401

ARCH_IDS = (
    "mamba2_1p3b",
    "qwen3_moe_235b_a22b",
    "granite_moe_1b_a400m",
    "minicpm_2b",
    "yi_34b",
    "granite_34b",
    "qwen1p5_4b",
    "musicgen_medium",
    "chameleon_34b",
    "zamba2_7b",
)

# public --arch aliases (hyphenated, as assigned)
ALIASES = {
    "mamba2-1.3b": "mamba2_1p3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "minicpm-2b": "minicpm_2b",
    "yi-34b": "yi_34b",
    "granite-34b": "granite_34b",
    "qwen1.5-4b": "qwen1p5_4b",
    "musicgen-medium": "musicgen_medium",
    "chameleon-34b": "chameleon_34b",
    "zamba2-7b": "zamba2_7b",
}


# user-registered configs (register_config) take precedence over modules
_REGISTRY: dict = {}


def register_config(cfg, smoke=None) -> None:
    """Register a custom ModelConfig under ``cfg.name`` (examples, tests)."""
    _REGISTRY[cfg.name] = (cfg, smoke if smoke is not None else cfg)


def _module(arch: str):
    key = ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(ALIASES) + sorted(_REGISTRY)}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(arch: str):
    if arch in _REGISTRY:
        return _REGISTRY[arch][0]
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    if arch in _REGISTRY:
        return _REGISTRY[arch][1]
    return _module(arch).smoke()


def all_archs():
    return list(ALIASES.keys())
