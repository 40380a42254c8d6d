"""Run provenance for the port: code version, toolchain and device.

Stamped beside every number the port reports, so a measurement is never
compared with one from another commit, PyTorch or CUDA version, or card
without it showing.
"""
from __future__ import annotations

import datetime
import platform
import subprocess
from pathlib import Path

import torch

# src/repro_torch/provenance.py -> the repo root is two levels above src
REPO_ROOT = Path(__file__).resolve().parents[2]


def git_sha(root=None) -> str | None:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"],
                             cwd=root or REPO_ROOT, capture_output=True,
                             text=True, timeout=10)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def provenance(root=None) -> dict:
    """What produced a result: code version, toolchain and device."""
    on_card = torch.cuda.is_available()
    return {
        "git_sha": git_sha(root),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 0,
        "platform": platform.platform(),
        "python": platform.python_version(),
        "timestamp_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
    }
