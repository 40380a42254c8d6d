"""Decode-step time of the four serving configurations of ``chip_smoke.py``
(phases 14, 18, 24 and 25: qwen1.5-4b, mamba2-1.3b, granite-moe-1b-a400m
and zamba2-7b at their published widths, 32 greedy requests of 64 new
tokens on 16 slots) for two or more source trees of the port, in turns,
in one call on one card: a host's speed moves these host-bound numbers
more than most changes do, so trees are compared only inside one call.

Each turn is a subprocess that puts its tree's ``src`` first on the path,
builds that tree's kernels and serves the four configurations through
``chip_smoke._serve_full_width`` (this checkout's harness, the same for
every tree).  The last line is a JSON object: the card, the order, and
for each turn its tree and, per configuration, ms per decode step and
prefill tokens/s.

  python3 tools/serving_ab_probe.py --tree parent=DIR/src --tree change=src \\
      --order parent,change,change,parent [--archs granite-moe-1b-a400m]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen1.5-4b", "mamba2-1.3b", "granite-moe-1b-a400m", "zamba2-7b")


def child(src: str, archs) -> dict:
    """Serve ``archs`` (of the four configurations) on the tree at
    ``src``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    sys.path.insert(0, str(Path(src).resolve()))
    import torch

    import repro_torch
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as A
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import ssd_scan as S8
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    loaded = str(Path(repro_torch.__file__).resolve().parents[1])
    if loaded != str(Path(src).resolve()):
        chip_smoke.fail(f"imported {loaded}, not {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.smi()
    t0 = time.perf_counter()
    _build.build_all()
    out = {"src": src, "build_s": time.perf_counter() - t0, "serve": {}}
    for arch in archs:
        params, engine, stats, _, _ = chip_smoke._serve_full_width(
            configs.get_config(arch), (A, F, S8), card)
        out["serve"][arch] = {
            "decode_ms": chip_smoke.decode_ms(stats),
            "prefill_tok_s": stats["prefill_tokens"] / stats["prefill_s"]}
        del params, engine
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=PATH of a tree's src directory")
    ap.add_argument("--order", default=None,
                    help="comma-separated tree names, one turn each")
    ap.add_argument("--archs", default=",".join(ARCHS),
                    help="comma-separated configurations to serve")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, args.archs.split(","))),
              flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",") if args.order else list(trees)
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    card = chip_smoke.smi()
    turns = []
    for name in order:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", trees[name], "--archs",
             args.archs],
            capture_output=True, text=True, timeout=1800)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        turn["tree"] = name
        turns.append(turn)
        print(f"{name}: " + ", ".join(
            f"{arch} {r['decode_ms']:.3f} ms" for arch, r in
            turn["serve"].items()) + f" [{card}]", flush=True)
    print(json.dumps({"card": card, "order": order, "turns": turns}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
