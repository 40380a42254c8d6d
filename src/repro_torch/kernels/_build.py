"""Build and bind the CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ``ctypes``; nothing includes PyTorch's
headers, so a build takes seconds.  Libraries land in ``build/`` beside
this file (ignored by git), named by a hash of the source and the flags,
so an edited source is rebuilt and an unchanged one is reused (the hash
covers the shared headers ``csrc/*.cuh`` too).  All sources are compiled
at once, one ``nvcc`` each, started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"

# -fmad=false keeps every multiply and add separately rounded, as the
# reference and the PyTorch twins round them; -Xptxas -v reports each
# kernel's registers, shared memory and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_F = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of every kernel entry point, by source stem
SIGNATURES = {
    "dissatisfaction": {
        # agg, r_rows, b_rows, theta, loads, speeds, mu, total_b,
        # dissat, best, rows, k, framework, stream
        "dissat_from_aggregate": [_F] * 10 + [_I, _I, _I, _F],
        # the same ten pointers over a (B, rows, K) stack, then batch,
        # rows, k, framework, stream
        "dissat_from_aggregate_batched": [_F] * 10 + [_I, _I, _I, _I, _F],
        # adj, r_cols, r_rows, b_rows, loads, speeds, mu, total_b, out,
        # rows, cols, k, framework, stream
        "cost_matrix": [_F] * 9 + [_I, _I, _I, _I, _F],
    },
    "edge_block": {
        # row_start, receivers, weights, assignment, b_rows, theta, loads,
        # speeds, mu, total_b, dissat, best, n, e, k, framework, stream
        "dissat_from_edges": [_F] * 12 + [_I, _I, _I, _I, _F],
        # the same ten inputs, gains, picks, dests, partial (2 x blocks x
        # K int32), ticket (2 + 2 x 128 int32 zeros), n, e, k, framework,
        # stream
        "sweep_candidates_from_edges": [_F] * 15 + [_I, _I, _I, _I, _F],
    },
    "attention": {
        # q, k, v, out, B, S, H, Hkv, D, stream (float32 only)
        "flash_attention": [_F] * 4 + [_I] * 5 + [_F],
    },
    "decode_attention": {
        # q, k, v, length, out, partial, ticket, B, H, Hkv, S, D, split,
        # dtype, stream
        "decode_attention": [_F] * 7 + [_I] * 7 + [_F],
    },
    "flash_attention": {
        # q, k, v, out, B, S, H, Hkv, D (stored width), head_dim, stream
        # (bfloat16)
        "flash_attention_bf16": [_F] * 4 + [_I] * 6 + [_F],
    },
    "ssd_scan": {
        # x, dt, a, bm, cm, init_state, y, final_state, B, L, H, P, N,
        # stream (float32)
        "ssd_scan": [_F] * 8 + [_I] * 5 + [_F],
    },
    "ssd_scan_bf16": {
        # x, dt, a, bm, cm, init_state, y, final_state, work, B, L, H, P, N,
        # stream (bfloat16 x, bm, cm)
        "ssd_scan_bf16": [_F] * 9 + [_I] * 5 + [_F],
        # B, L, H, P, N -> bytes of `work`
        "ssd_scan_bf16_work_bytes": [_I] * 5,
    },
}
# entry points that return something else than a status
RESTYPES = {"ssd_scan_bf16_work_bytes": ctypes.c_longlong}

_libraries: dict[str, ctypes.CDLL] = {}
# source stem -> the compiler's report (ptxas registers / shared memory)
build_reports: dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                       "the CUDA toolkit")


def _target(source: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}-{digest[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` whose library is missing, all in
    parallel; return stem -> library path.  Raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src))
               for src in sorted(CSRC.glob("*.cu"))}
    running = {}
    for stem, (src, out) in targets.items():
        if out.is_file():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        running[stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    failed = []
    for stem, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        build_reports[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}: nvcc exit {proc.returncode}\n{log}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {stem: out for stem, (_, out) in targets.items()}


def library(stem: str = "dissatisfaction") -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use."""
    if stem not in _libraries:
        path = build_all()[stem]
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES[stem].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        _libraries[stem] = lib
    return _libraries[stem]
