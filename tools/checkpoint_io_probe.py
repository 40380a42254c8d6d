"""What a training checkpoint costs on the card's machine: mamba2-1.3b's
full-width ``TrainState`` (1162 f32 leaves, 16.1 GB: params and both Adam
moments) through ``repro_torch.training.checkpoint.save`` and ``restore``
(npz on the disk under ``TMPDIR``), beside the device-to-host copy alone
and two variants of the same npz layout: zip members written straight from
each leaf's memory with the next leaf's copy overlapped, and members read by
a pool of threads.  Every restore is checked bitwise.

  python3 tools/checkpoint_io_probe.py      # one CUDA card
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402
from repro_torch.training.train_step import init_train_state  # noqa: E402
from repro_torch.training.tree import flatten  # noqa: E402


def timed(label, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    print(f"{label}: {time.perf_counter() - t0:.2f} s", flush=True)
    return out


def write_members(path, leaves):
    """The npz layout, each member written from the leaf's host copy with
    no intermediate bytes; the next two copies run meanwhile."""
    pool = ThreadPoolExecutor(2)

    def host(i):
        return pool.submit(lambda: leaves[i].detach().cpu().numpy())
    pending = [host(i) for i in range(min(2, len(leaves)))]
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i in range(len(leaves)):
            arr = pending[i].result()
            if i + 2 < len(leaves):
                pending.append(host(i + 2))
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(arr))
                f.write(memoryview(arr.reshape(-1)).cast("B"))
            pending[i] = None
    pool.shutdown()


def read_members(path, count, threads):
    def one(i):
        with zipfile.ZipFile(path) as zf, zf.open(f"a{i}.npy") as f:
            arr = np.lib.format.read_array(f)
        return torch.from_numpy(arr).to("cuda")
    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(one, range(count)))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("checkpoint_io_probe: needs a CUDA card")
    state = init_train_state(configs.get_config("mamba2-1.3b"), 0,
                             device="cuda")
    _, leaves = flatten(state)
    size = sum(t.numel() * t.element_size() for t in leaves)
    print(f"{len(leaves)} leaves, {size / 1e9:.2f} GB", flush=True)
    d = tempfile.mkdtemp(prefix="checkpoint_io_probe_")
    try:
        host = timed("device-to-host copy (.cpu())",
                     lambda: [t.cpu() for t in leaves])
        del host
        timed("checkpoint.save (np.savez)",
              lambda: checkpoint.save(d, 1, state))
        got, _ = timed("checkpoint.restore (np.load, one leaf at a time)",
                       lambda: checkpoint.restore(d, state))
        assert all(torch.equal(a, b) for a, b in zip(leaves, flatten(got)[1]))
        del got
        torch.cuda.empty_cache()
        path = os.path.join(d, "members.npz")
        timed("zip members from the leaves' memory, copies overlapped",
              lambda: write_members(path, leaves))
        for threads in (4, 8):
            got = timed(f"members read by {threads} threads, then to the "
                        f"card", lambda: read_members(path, len(leaves),
                                                      threads))
            assert all(torch.equal(a, b) for a, b in zip(leaves, got))
            del got
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
