"""Where kernel 7's time goes on the card: text variants of
``src/repro_torch/kernels/csrc/flash_attention.cu``, each with one part of
the work taken out or one setting changed, built side by side with the
repo's nvcc flags and timed in turns (CUDA events around a loop that only
calls the C entry point) at the serving shape (B, S, H, Hkv, D) = (1,
3072, 20, 20, 128), bf16.  Only ``kernel`` (the source as it is) computes
attention, and it is checked against the twin; the others are for timing.

  python3 tools/flash_attention_ablation.py [variant ...]   # one CUDA card, nvcc
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
from repro_torch.kernels import flash_attention as F  # noqa: E402

SHAPE = (1, 3072, 20, 20, 128)
ROUNDS, ITERS = 3, 30

_SOFTMAX = ("        sm.tile(s, j, c0, c1);\n", "")
_PV = ("        issue_pv(hi, lo, j - 1);\n        wgmma_wait<1>();",
       "        wgmma_wait<0>();")
_STAGES = "__host__ __device__ constexpr int stages() { return DC == 4 ? 2 : 3; }"
_SPLIT_LATE = """        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(hi);
        fence_regs(lo);
        release(j - 1);
        split(s, hi, lo);
"""
_SPLIT_EARLY = """        uint32_t hn[16], ln[16];
        split(s, hn, ln);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(hi);
        fence_regs(lo);
        release(j - 1);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          hi[i] = hn[i];
          lo[i] = ln[i];
        }
"""
# name -> (what it changes, [(old text, new text), ...])
VARIANTS = {
    "kernel": ("the source as it is", []),
    "no_softmax": ("no softmax in the tile loop", [_SOFTMAX]),
    "no_split": ("no hi/lo split in the tile loop",
                 [("        release(j - 1);\n        split(s, hi, lo);\n",
                   "        release(j - 1);\n")]),
    "no_qk": ("no Q K^T in the tile loop",
              [("        issue_qk(s, j);\n        rescale",
                "        rescale")]),
    "no_pv": ("no P V in the tile loop", [_PV]),
    "no_pv_no_softmax": ("neither", [_PV, _SOFTMAX]),
    "loads_only": ("the K/V stream alone: consumers wait and release",
                   [("if (my_tiles > 0) {", "if (false) {"),
                    ("for (int j = my_tiles; j < n_tiles; ++j) {",
                     "for (int j = 0; j < n_tiles; ++j) {")]),
    "stages_2": ("a ring of 2 K/V stages",
                 [(_STAGES, _STAGES.replace("DC == 4 ? 2 : 3", "2"))]),
    "stages_4": ("a ring of 4 K/V stages",
                 [(_STAGES, _STAGES.replace("DC == 4 ? 2 : 3",
                                            "DC >= 3 ? 2 : 4"))]),
    "early_split": ("the split before P V's wait, into fresh fragments",
                    [(_SPLIT_LATE, _SPLIT_EARLY)]),
    "three_groups": ("3 consumer warpgroups, 192 rows a block (D <= 128 "
                     "instances only)",
                     [("constexpr int kConsumers = 2;",
                       "constexpr int kConsumers = 3;"),
                      ("setmaxnreg.dec.sync.aligned.u32 40;",
                       "setmaxnreg.dec.sync.aligned.u32 24;"),
                      ("setmaxnreg.inc.sync.aligned.u32 232;",
                       "setmaxnreg.inc.sync.aligned.u32 160;"),
                      ("case 3: return launch<3>", "case 3: return launch<2>"),
                      ("default: return launch<4>",
                       "default: return launch<2>")]),
}


def _variant_source(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"flash_attention_ablation: the source no longer "
                             f"holds {old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def _build_all(names, out: Path) -> dict:
    src = (_build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name in names:
        cu = out / f"{name}.cu"
        cu.write_text(_variant_source(src, VARIANTS[name][1]))
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_attention_ablation: {name} did not "
                             f"build\n{log}")
        fn = ctypes.CDLL(str(out / f"{name}.so")).flash_attention_bf16
        fn.argtypes = _build.SIGNATURES["flash_attention"][
            "flash_attention_bf16"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(names) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_attention_ablation: needs a CUDA card")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: "
                         f"{list(VARIANTS)}")
    names = ["kernel"] + [n for n in names if n != "kernel"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    b, s, h, hkv, d = SHAPE
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).cuda().bfloat16() for shape in
        ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    out = torch.empty_like(q)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out)] + [
        b, s, h, hkv, d, d, stream]
    with tempfile.TemporaryDirectory() as tmp:
        fns = _build_all(names, Path(tmp))
        if fns["kernel"](*args) != 0:
            raise SystemExit("flash_attention_ablation: the kernel did not "
                             "launch")
        err = float((out.float() - F.flash_attention_twin(q, k, v).float())
                    .abs().max())
        print(f"kernel vs twin at {SHAPE}: max |diff| {err:.3e} [{card}]")
        times = {name: [] for name in names}
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        for _ in range(ROUNDS):
            for name in names:
                for _ in range(3):
                    fns[name](*args)
                torch.cuda.synchronize()
                start.record()
                for _ in range(ITERS):
                    fns[name](*args)
                stop.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(stop) / ITERS)
    for name in names:
        t = times[name]
        print(f"  {name:18s} {np.mean(t):.5f} ms ({' '.join(f'{x:.5f}' for x in t)})"
              f"  {VARIANTS[name][0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
