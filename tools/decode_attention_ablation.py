"""Where kernel 6's time goes on the card: the split size, and text variants
of ``src/repro_torch/kernels/csrc/decode_attention.cu`` with one setting
changed or one part of the work taken out, built side by side with the
repo's nvcc flags and timed in turns (CUDA events around a loop that only
calls the C entry point) at the serving shape (B, H, Hkv, D, S) = (16, 20,
20, 128, 4096), bf16, with lengths drawn from ``default_rng(0)`` in
519..3062 (the range of the serving run's slots at its end).  Every
variant's output is held against the twin and its max |diff| printed:
``loads_only``, ``no_combine``, ``math_only`` and ``fixed_only`` are for
timing only; the others compute the attention.  Last, the card's plain
read rate: one ``torch.sum`` over as many bf16 bytes as the bound counts.

  python3 tools/decode_attention_ablation.py [variant ...]  # one CUDA card, nvcc
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as A  # noqa: E402

SHAPE = (16, 20, 20, 128, 4096)
LENGTHS = (519, 3062)
ROUNDS, ITERS = 3, 50
PEAK_BYTES_S = 3.35e12


def _stages(n):
    return [(f"constexpr int kStages = {A.STAGES};",
             f"constexpr int kStages = {n};")]


# the workers skip their pairs: the ring, the fold and the combine only
_LOADS_ONLY = [("    if (one_pair) {\n      if (warp < pairs)\n",
                "    if (true) {\n      if (false)\n")]
# every split writes its partials and stops: no ticket, no combine
_NO_COMBINE = [("  if (n_live == 1) return;\n", "  return;\n")]
# no TMA load is issued or waited for: the math on whatever the ring holds
_MATH_ONLY = [
    ("    for (int t = 0; t < min(NS, n_tiles); ++t) {",
     "    for (int t = 0; t < 0; ++t) {"),
    ("      mbar_wait(&full[slot], parity);\n", ""),
    ("      if (tid == 0 && t + NS < n_tiles) {  // refill the slot",
     "      if (false) {  // refill the slot")]
# no tile at all: each live block's set-up, fold, partials and combine
_FIXED_ONLY = [("  const int n_tiles = (end - start + kTile - 1) / kTile;",
                "  const int n_tiles = 0;")]
# name -> (what it changes, [(old text, new text), ...], split or None)
VARIANTS = {
    "kernel": ("the source as it is, the wrapper's split", [], None),
    "no_split": ("one split: one block per (row, kv head)", [], SHAPE[4]),
    "split_256": ("splits of 256 positions", [], 256),
    "split_1024": ("splits of 1024 positions", [], 1024),
    "stages_1": ("a ring of one tile: no load in flight during the math",
                 _stages(1), None),
    "stages_3": ("a ring of three tiles", _stages(3), None),
    "stages_4": ("a ring of four tiles", _stages(4), None),
    "tile_32": ("32-position tiles",
                [("constexpr int kTile = 64;", "constexpr int kTile = 32;")],
                None),
    "round_4": ("rounds of 4 keys (one a worker): the softmax state moves "
                "twice as often",
                [("constexpr int kRound = 8;", "constexpr int kRound = 4;")],
                None),
    "loads_only": ("the ring's loads, the fold and the combine: no logits, "
                   "softmax or P V", _LOADS_ONLY, None),
    "no_combine": ("the splits write their partials; no ticket, no combine",
                   _NO_COMBINE, None),
    "math_only": ("no loads: logits, softmax and P V on whatever the ring "
                  "holds", _MATH_ONLY, None),
    "fixed_only": ("no tiles: set-up, fold, partials and combine",
                   _FIXED_ONLY, None),
}
# variants whose output is the attention
COMPUTES = ("kernel", "no_split", "split_256", "split_1024", "stages_1",
            "stages_3", "stages_4", "tile_32", "round_4")


def _variant_source(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"decode_attention_ablation: the source no "
                             f"longer holds {old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def _build_all(names, out: Path) -> dict:
    """One library per distinct source text, all built in parallel."""
    src = (_build.CSRC / "decode_attention.cu").read_text()
    texts = {name: _variant_source(src, VARIANTS[name][1]) for name in names}
    procs, by_text = {}, {}
    for name, text in texts.items():
        if text in by_text:
            continue
        by_text[text] = name
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out / f"{name}.so"), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"decode_attention_ablation: {name} did not "
                             f"build\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        fn = lib.decode_attention
        fn.argtypes = _build.SIGNATURES["decode_attention"]["decode_attention"]
        fn.restype = ctypes.c_int
        built[name] = fn
    return {name: built[by_text[texts[name]]] for name in names}


def main(names) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("decode_attention_ablation: needs a CUDA card")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: "
                         f"{list(VARIANTS)}")
    names = ["kernel"] + [n for n in names if n != "kernel"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    b, h, hkv, d, s = SHAPE
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .cuda().to(torch.bfloat16)
               for shape in ((b, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    lens = rng.integers(LENGTHS[0], LENGTHS[1] + 1, b).astype(np.int32)
    length = torch.from_numpy(lens).cuda()
    want = A.decode_attention_twin(q, k, v, length).float()
    valid = int(lens.sum())
    bound = 1e3 * 2 * (2 * valid * hkv * d + 2 * b * h * d) / PEAK_BYTES_S
    with tempfile.TemporaryDirectory() as tmp:
        fns = _build_all(names, Path(tmp))
        calls, errs, splits = {}, {}, {}
        for name, fn in fns.items():
            out = torch.zeros_like(q)
            args, keep = A.decode_attention_args(q, k, v, length, out,
                                                 split=VARIANTS[name][2])
            if fn(*args) != 0:
                raise SystemExit(f"decode_attention_ablation: {name} did "
                                 f"not launch")
            torch.cuda.synchronize()
            errs[name] = float((out.float() - want).abs().max())
            splits[name] = args[12]
            calls[name] = (fn, args, keep)
        if errs["kernel"] > 1e-2:
            raise SystemExit(f"decode_attention_ablation: the kernel is "
                             f"{errs['kernel']:.3e} from its twin")
        print(f"kernel 6 at (B, H, Hkv, D, S)={SHAPE}, bf16, lengths "
              f"{lens.min()}..{lens.max()} ({valid} valid positions): bound "
              f"{bound:.5f} ms (bytes) [{card}]")
        # the card's plain read rate over the bound's bytes: one PyTorch
        # reduction of a bf16 buffer that size, timed in the same turns
        flat = torch.ones(int(bound * 1e-3 * PEAK_BYTES_S) // 2,
                          dtype=torch.bfloat16, device="cuda")
        timed = {name: calls[name][:2] for name in names}
        timed["read"] = (lambda: flat.sum(dtype=torch.float32), ())
        times = {name: [] for name in timed}
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        for _ in range(ROUNDS):
            for name, (fn, args) in timed.items():
                for _ in range(3):
                    fn(*args)
                torch.cuda.synchronize()
                start.record()
                for _ in range(ITERS):
                    fn(*args)
                stop.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(stop) / ITERS)
    read = float(np.mean(times.pop("read")))
    print(f"  read floor  {read:.5f} ms  torch.sum over "
          f"{flat.numel() * 2 / 1e6:.2f} MB of bf16: "
          f"{flat.numel() * 2 / read / 1e9:.3f} TB/s")
    for name in names:
        t = times[name]
        tag = "" if name in COMPUTES else " (timing only)"
        print(f"  {name:11s} {np.mean(t):.5f} ms "
              f"({' '.join(f'{x:.5f}' for x in t)})  bound share "
              f"{bound / np.mean(t):.3f}  split {splits[name]:5d}  error "
              f"{errs[name]:.2e}{tag}  {VARIANTS[name][0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
