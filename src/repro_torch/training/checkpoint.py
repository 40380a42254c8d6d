"""Checkpoint / restore with atomic commit — the fault-tolerance substrate
(port of ``repro.training.checkpoint``).

Layout:  <dir>/step_<n:08d>/arrays.npz + manifest.json, committed by an
atomic rename, so a crash mid-save can never corrupt the latest
checkpoint.  ``restore`` finds the newest complete step; the train driver
calls it on startup, which is the whole restart story: kill the process
anywhere, relaunch, continue bit-exact.

Leaves are stored under the port's own tree paths
(:func:`repro_torch.training.tree.flatten`).  numpy has no bfloat16, so a
bfloat16 leaf is stored as its bits (int16) with ``bfloat16`` as its dtype
in the manifest: every restore is bitwise.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from .tree import flatten, unflatten

# dtypes stored as the bits of an integer of their width
_BITS = {torch.bfloat16: torch.int16}


def _host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    leaf = leaf.detach().cpu()
    name = str(leaf.dtype).removeprefix("torch.")
    if leaf.dtype in _BITS:
        leaf = leaf.view(_BITS[leaf.dtype])
    return leaf.contiguous().numpy(), name


def save(directory: str, step: int, state) -> str:
    """Atomically persist ``state`` (any tree of tensors) for ``step``."""
    os.makedirs(directory, exist_ok=True)
    paths, leaves = flatten(state)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_save_")
    try:
        host = [_host(leaf) for leaf in leaves]
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": arr for i, (arr, _) in enumerate(host)})
        manifest = {
            "step": step,
            "paths": paths,
            "dtypes": [name for _, name in host],
            "shapes": [list(arr.shape) for arr, _ in host],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(directory, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                 # atomic commit
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    dtype = getattr(torch, dtype_name)
    t = torch.from_numpy(arr)
    return t.view(dtype) if dtype in _BITS else t


def restore(directory: str, like, step: int | None = None, *,
            prefix: str = ""):
    """Restore into the structure of ``like`` (paths and shapes checked;
    each leaf takes ``like``'s dtype and device).  With ``prefix`` (such
    as ``"params"``), only the checkpoint's entries under it are read,
    into a ``like`` that is that subtree.

    Returns (state, step) or (None, None) when nothing to restore; raises
    ``ValueError`` when the checkpoint's structure is not ``like``'s."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        return None, None
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    paths, leaves = flatten(like, prefix)
    stored = {p: i for i, p in enumerate(manifest["paths"])
              if not prefix or p.startswith(prefix + "/")}
    if paths != list(stored):
        raise ValueError(f"checkpoint/state structure mismatch in {path}")
    restored = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for p, leaf in zip(paths, leaves):
            i = stored[p]
            t = _tensor(data[f"a{i}"], manifest["dtypes"][i])
            if list(t.shape) != list(leaf.shape):
                raise ValueError(f"shape mismatch at {p}: "
                                 f"{tuple(t.shape)} vs {tuple(leaf.shape)}")
            restored.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return unflatten(like, restored), step
