"""Where kernel 8's time goes on the card: text variants of
``src/repro_torch/kernels/csrc/ssd_scan_bf16.cu``, each with one pass run
alone, one part of the work taken out or one setting changed, built side by
side with the repo's nvcc flags and timed in turns (CUDA events around a
loop that only calls the C entry point) at the serving shape (B, L, H, P,
N) = (1, 3072, 64, 64, 128), bf16 x/bm/cm, with the Mamba2
initialisation's decays.  Every variant's output is held against the twin
and its max |diff| over max(1, max |want|) printed: only ``kernel`` (the
source as it is) and the settings (``chunk_128``, ``slots_4``) compute
the scan; the others are for timing, and
``no_split`` shows what one bf16 rounding of each f32 operand costs in
accuracy.

  python3 tools/ssd_scan_ablation.py [variant ...]   # one CUDA card, nvcc
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
from repro_torch.kernels import ssd_scan as S  # noqa: E402

SHAPE = (1, 3072, 64, 64, 128)
ROUNDS, ITERS = 3, 30

_PASS1 = ("  pass1<<<", "  if (false) pass1<<<")
_PASS2 = ("  ssd_state_passing_kernel<<<", "  if (false) ssd_state_passing_kernel<<<")
_PASS3 = ("  pass3<<<", "  if (false) pass3<<<")
_LO_PASS1 = ("""#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<NC>(acc, lo + 4 * kk, sw128_desc(b_addr + 2048 * kk, kBox));
""", "")
_LO_STATE = ("""#pragma unroll
  for (int k = 0; k < NC; ++k)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(acc, sw128_desc(c_addr + k * kBox + 32 * kk),
               sw128_desc(s_addr + (NC + k) * kBox + 32 * kk), 1);
""", "")
_LO_SCORES = ("""#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<1>(acc, lo + 4 * kk, sw128_desc(x_addr + 2048 * kk, kBox));
""", "")
_CB_PRODUCT = """    wgmma_fence();
#pragma unroll
    for (int k = 0; k < NC; ++k)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, sw128_desc(c_addr + k * kBox + 32 * kk),
                 sw128_desc(b_addr + k * kBox + 32 * kk), k + kk > 0);
    wgmma_commit();
    fence_regs(s);
    wgmma_wait<0>();
    fence_regs(s);
"""
# (without C B^T's product the block syncs before B's stage is refilled,
# as the product's completion guaranteed that every warp had seen it)
_CB = (_CB_PRODUCT, """#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 1.f;
    __syncthreads();
""")
# C B^T computed once a chunk and read back as f32, 16 KB a tile from L2
# (for the timing, from the cum array: L2-resident and large enough at the
# serving shape)
_CB_READ = (_CB_PRODUCT, """    {
      const float4* gt = reinterpret_cast<const float4*>(
          cum + ((blockIdx.x % 16) * 4 + j) * 4096 + threadIdx.x * 32);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = gt[i];
        s[4 * i] = v.x;
        s[4 * i + 1] = v.y;
        s[4 * i + 2] = v.z;
        s[4 * i + 3] = v.w;
      }
    }
    __syncthreads();
""")
_SCORES = ("""    if (j == rt) {""", """    if (false) {""")
_SCORES_OFF = ("""        s[i] = s[i] * ((i & 2) ? v1 : v0) * s_u[col];""",
               """        s[i] = s[i];""")
_NO_STATE = [("  mbar_wait(head_full, 0);\n  wgmma_fence();\n",
              "  mbar_wait(head_full, 0);\n  if (false) {\n  wgmma_fence();\n"),
             ("  for (int i = 0; i < 32; ++i) acc[i] *= (i & 2) ? e1 : e0;\n",
              "  for (int i = 0; i < 32; ++i) acc[i] *= (i & 2) ? e1 : e0;\n  }\n")]
# (the block syncs before thread 0 re-arms the barriers: without the
# products nothing else keeps a warp from missing a phase)
_NO_TILES = ("    mbar_wait(b_full, j & 1);\n",
             "    mbar_wait(b_full, j & 1);\n    mbar_wait(x_full, j & 1);\n"
             "    __syncthreads();\n"
             "    if (tid == 0 && j + 1 < n_tiles) {\n      load_b(j + 1);\n"
             "      load_x(j + 1);\n    }\n    continue;\n")
# name -> (what it changes, [(old text, new text), ...])
VARIANTS = {
    "kernel": ("the source as it is", []),
    "pass1_only": ("pass 1 (chunk states) alone", [_PASS2, _PASS3]),
    "pass2_only": ("pass 2 (state passing) alone", [_PASS1, _PASS3]),
    "pass3_only": ("pass 3 (chunk outputs) alone", [_PASS1, _PASS2]),
    "no_split": ("bf16 operands rounded once: no lo products in passes 1, 3",
                 [_LO_PASS1, _LO_STATE, _LO_SCORES]),
    "no_cb": ("no C B^T in pass 3 (its logits taken as 1)", [_CB]),
    "cb_read": ("pass 3 reads C B^T (f32, computed once a chunk) instead of "
                "recomputing it for every head; B still streamed", [_CB_READ]),
    "no_scores": ("no decay, dt or mask on pass 3's logits",
                  [_SCORES, _SCORES_OFF]),
    "loads_only": ("pass 3's loads and stores alone: no products, no "
                   "scores", _NO_STATE + [_NO_TILES]),
    "chunk_128": ("a chunk of 128 steps",
                  [("constexpr int kChunk = 256;", "constexpr int kChunk = 128;")]),
    "slots_4": ("a ring of 4 sub-tiles in pass 1 (the whole chunk in flight)",
                [("constexpr int kSlots1 = 2;", "constexpr int kSlots1 = 4;")]),
}
# variants whose output is the scan
COMPUTES = ("kernel", "chunk_128", "slots_4")


def _variant_source(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"ssd_scan_ablation: the source no longer holds "
                             f"{old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def _build_all(names, out: Path) -> dict:
    src = (_build.CSRC / "ssd_scan_bf16.cu").read_text()
    procs = {}
    for name in names:
        cu = out / f"{name}.cu"
        cu.write_text(_variant_source(src, VARIANTS[name][1]))
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out / f"{name}.so"), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"ssd_scan_ablation: {name} did not build\n{log}")
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and not line.strip().startswith("0 bytes")]
        if spills:
            print(f"  [{name}] ptxas: {'; '.join(spills)}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn, argtypes in _build.SIGNATURES["ssd_scan_bf16"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _build.RESTYPES.get(fn, ctypes.c_int)
        libs[name] = lib
    return libs


def main(names) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_scan_ablation: needs a CUDA card")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: "
                         f"{list(VARIANTS)}")
    names = ["kernel"] + [n for n in names if n != "kernel"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    b, seq, h, p, n = SHAPE
    rng = np.random.default_rng(0)

    def cuda(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda().to(dtype)

    x = cuda(rng.standard_normal((b, seq, h, p)), torch.bfloat16)
    bm = cuda(rng.standard_normal((b, seq, n)), torch.bfloat16)
    cm = cuda(rng.standard_normal((b, seq, n)), torch.bfloat16)
    dt = cuda(rng.uniform(1e-3, 0.1, (b, seq, h)))
    a = cuda(-rng.uniform(1.0, 16.0, h))
    want_y, want_s = S.ssd_scan_twin(x, dt, a, bm, cm, 256)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_all(names, Path(tmp))
        calls, errs = {}, {}
        for name, lib in libs.items():
            y = torch.zeros((b, seq, h, p), device="cuda")
            final = torch.zeros((b, h, p, n), device="cuda")
            work = torch.empty(lib.ssd_scan_bf16_work_bytes(b, seq, h, p, n),
                               dtype=torch.uint8, device="cuda")
            args = [ctypes.c_void_p(t.data_ptr()) for t in
                    (x, dt, a, bm, cm)] + [ctypes.c_void_p(None)] + [
                ctypes.c_void_p(t.data_ptr()) for t in (y, final, work)] + [
                b, seq, h, p, n, stream]
            if name.startswith("pass"):   # the other passes' outputs first
                libs["kernel"].ssd_scan_bf16(*args)
            if lib.ssd_scan_bf16(*args) != 0:
                raise SystemExit(f"ssd_scan_ablation: {name} did not launch")
            torch.cuda.synchronize()
            errs[name] = max(
                float((y - want_y).abs().max()) / max(1.0, float(want_y.abs().max())),
                float((final - want_s).abs().max()) / max(1.0, float(want_s.abs().max())))
            calls[name] = (lib.ssd_scan_bf16, args)
        if errs["kernel"] > 3e-4:
            raise SystemExit(f"ssd_scan_ablation: the kernel is {errs['kernel']:.3e} "
                             f"from its twin")
        print(f"kernel vs twin at {SHAPE}: max |diff| / max(1, max |want|) "
              f"{errs['kernel']:.3e} [{card}]")
        times = {name: [] for name in names}
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        for _ in range(ROUNDS):
            for name in names:
                fn, args = calls[name]
                for _ in range(3):
                    fn(*args)
                torch.cuda.synchronize()
                start.record()
                for _ in range(ITERS):
                    fn(*args)
                stop.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(stop) / ITERS)
    for name in names:
        t = times[name]
        tag = "" if name in COMPUTES else " (timing only)"
        print(f"  {name:14s} {np.mean(t):.5f} ms ({' '.join(f'{v:.5f}' for v in t)})"
              f"  error {errs[name]:.2e}{tag}  {VARIANTS[name][0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
