"""How big a DES fits the card: ``chip_smoke.py``'s phase-20 setup
(``benchmarks/fig7_8_simtime.py``'s Fig. 8 model; ``chip_smoke.des_instance``)
at a chosen N and thread counts, run in chunks of ticks, printing after each
chunk the counters a size must keep at zero (proposals dropped for event-list
capacity, history evictions), the fullest event list and history, and the
wall ms per tick; with ``--eager`` every tick runs without the run loop's
CUDA graphs.  One profiled window of 64 ticks first gives the device's time
and kernels per tick.  A run stops at its first drop or eviction; each
(thread count, refine period) ends with a summary line (events processed
per tick among them), and ``--largest`` stops after the first thread count,
in the order given, whose runs all drain with nothing dropped or evicted.

  python3 tools/des_probe.py --n 2048 --threads 256 128 64 48 32 \\
      --refine-freq 2048 0 --largest
  python3 tools/des_probe.py --n 4096 --threads 24 --ticks 512 --eager
  python3 tools/des_probe.py --n 4096 --ticks 400000 --refine-freq 0
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from repro_torch.des import engine  # noqa: E402


def probe(args, threads: int, refine_freq: int, card: str) -> bool:
    """Run one setup in chunks; True when it drains clean."""
    graph_ticks = 0 if args.eager else engine._GRAPH_TICKS
    cfg, adj, s, churn, _ = C.des_instance(
        args.n, C.DES_K, threads, C.SEED, refine_freq,
        C.DES_REFINE_TURNS, C.DES_CHURN)

    def run(cfg, s):
        return engine._run_lone(cfg, adj, s, churn, None, graph_ticks)

    C.log(f"N={args.n} T={threads} K={C.DES_K} E={cfg.event_capacity} "
          f"H={cfg.history_capacity} refine_freq={cfg.refine_freq} "
          f"{'eager' if args.eager else 'graphs'} [{card}]")
    window = dataclasses.replace(cfg, max_ticks=64, refine_freq=0)
    _, wall, dev_s, kernels, _ = C.busy_share(lambda: run(window, s))
    C.log(f"  first 64 ticks (the graph's capture included): wall "
          f"{1e3 * wall / 64:.3f} ms/tick, device {1e3 * dev_s / 64:.3f} "
          f"ms/tick, {kernels / 64:.1f} kernels per tick (profiler)")
    start = time.perf_counter()
    while int(s.tick) < args.ticks and not bool(s.done):
        t0, before = time.perf_counter(), int(s.tick)
        stop = min(before + args.chunk, args.ticks)
        s = run(dataclasses.replace(cfg, max_ticks=stop), s)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / max(int(s.tick) - before, 1)
        C.log(f"  tick {int(s.tick)}: processed {int(s.processed)}, "
              f"rollbacks {int(s.rollbacks)}, dropped {int(s.dropped)}, "
              f"hist_evict {int(s.hist_evict)}, refines {int(s.refines)}, "
              f"fullest event list {int(s.ev.valid.sum(1).max())}, history "
              f"{int(s.hist.valid.sum(1).max())}, {ms:.3f} ms/tick, drained "
              f"{bool(s.done)} ({time.perf_counter() - start:.0f} s)")
        if int(s.dropped) or int(s.hist_evict):
            break
    wall = time.perf_counter() - start
    ticks = int(s.tick)
    clean = bool(s.done) and not int(s.dropped) and not int(s.hist_evict)
    C.log(f"  SUMMARY N={args.n} T={threads} refine_freq={refine_freq}: "
          f"{'clean' if clean else 'NOT clean'}, drained {bool(s.done)}, "
          f"{ticks} ticks, processed {int(s.processed)} "
          f"({int(s.processed) / max(ticks, 1):.4f} events per tick), "
          f"rollbacks {int(s.rollbacks)}, refines {int(s.refines)}, "
          f"dropped {int(s.dropped)}, hist_evict {int(s.hist_evict)}, "
          f"{wall:.1f} s, {1e3 * wall / max(ticks, 1):.4f} ms per tick "
          f"[{card}]")
    return clean


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=C.DES_N)
    parser.add_argument("--threads", type=int, nargs="+",
                        default=[C.DES_THREADS])
    parser.add_argument("--ticks", type=int, default=C.DES_MAX_TICKS,
                        help="stop after this many ticks (or at the drain)")
    parser.add_argument("--chunk", type=int, default=2048)
    parser.add_argument("--refine-freq", type=int, nargs="+",
                        default=[C.DES_REFINE_FREQ],
                        help="ticks between refinement rounds (0: static)")
    parser.add_argument("--eager", action="store_true",
                        help="run every tick eagerly, without CUDA graphs")
    parser.add_argument("--largest", action="store_true",
                        help="stop after the first thread count whose runs "
                             "all drain clean")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        C.fail("no CUDA device: this probe needs one GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = C.smi()
    for threads in args.threads:
        clean = [probe(args, threads, freq, card)
                 for freq in args.refine_freq]
        if args.largest and all(clean):
            C.log(f"largest clean thread count at N={args.n}: {threads}")
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
