"""Multi-pod dry run: shard and count every (arch x shape x mesh) cell on
the ``meta`` device (port of ``repro.launch.dryrun``).

The one entry point of the port that never runs on the card and never
launches a kernel: as the reference lowers on fake CPU devices, this
builds abstract trees on ``meta`` (shapes and dtypes, no storage) over a
``fake`` process group of 256 or 512 ranks (``launch.mesh``).  For each
cell it proves, without hardware:

  (a) the abstract state, params or cache build on ``meta``;
  (b) the sharding rules are coherent: every leaf distributes over the
      mesh as ``sharding.rules`` asks (``distribute_tensor`` must not
      raise);
  (c) memory per rank: argument and output bytes summed from the local
      shards; temp bytes are ``null`` — there is no compiler to ask, and
      the port does not estimate them;
  (d) FLOPs: ``launch.flops`` over the cell's function at global shape,
      divided by the ranks.  On ``meta`` every kernel wrapper takes its
      plain twin, so the count is the plain formula's (by design);
  (e) the roofline terms: compute at the H100's bf16 peak, memory at the
      analytic floor of ``launch.traffic`` over HBM3, and collectives from
      ``launch.collectives`` over a run of the cell's function on DTensors
      (plain tensors the model creates join as replicated, under
      ``implicit_replication``) over NVLink.  The run is inside
      ``sharding.hints.use_mesh``: the model's hints place its activations
      as the reference's do (``--mode baseline`` sets REPRO_NO_HINTS=1 and
      turns them off), and its cache writes, decode attention, SSD scans
      and microbatch splits take their mesh branches.  Where that run
      raises, or passes ``COLLECTIVE_BUDGET_S``, the cell records
      ``collective_bytes_per_chip: null`` and the op it reached.

The collectives are counted a layer kind at a time (``--collectives
layers``, the default), as the reference counts a scanned layer body once
and multiplies it by its trip count: the cell's DTensor run at three
depths r + k p (p the hybrid's ``attn_period``, else 1; r the depth mod
p), everything else the cell's own, and each kind's bytes and op count
fitted exactly in integers as a + b k and taken at k = depth // p.  A
third depth off the line of the first two makes the count null with its
reason, never an estimate.  Each reduced run has the budget to itself, so
a cell's count does not depend on its host's speed.  ``--collectives
full`` runs the whole function once; ``both`` runs both and fails a cell
whose counts differ by kind.  A model no deeper than the fit's deepest
run is run whole in either mode.

The bandwidths and peak are NVIDIA H100 datasheet figures
(``launch.mesh``); the 256- and 512-rank meshes are the reference's pod
shapes, a model and not a machine the port has run on.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out dryrun_results
  # one process per arch, then the summary of the merged cells:
  for a in ...; do python -m repro_torch.launch.dryrun --arch $a \\
      --mesh both --out DIR & done; wait
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out DIR --resume
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Callable

import torch

from repro_torch import configs
from repro_torch.configs import SHAPES, input_specs, shape_is_applicable
from repro_torch.launch import collectives, traffic
from repro_torch.launch.flops import FlopCounter
from repro_torch.launch.mesh import (HBM_BANDWIDTH, NVLINK_BANDWIDTH,
                                     PEAK_FLOPS_BF16, make_production_mesh)
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.models.config import HYBRID
from repro_torch.sharding import hints, rules
from repro_torch.training.train_step import (TrainHyper, init_train_state,
                                             make_train_step)

TEMP_BYTES_REASON = ("no compiler to ask: the port runs eagerly and does "
                     "not estimate its temporaries")
# seconds a cell's DTensor run may take; past it the cell's collective count
# is null with the op it reached (sharding propagation on the 2x16x16 mesh
# spends minutes on one attention einsum of a 32k-token prefill)
COLLECTIVE_BUDGET_S = 120.0
COLLECTIVE_METHODS = ("layers", "full", "both")


@dataclasses.dataclass
class Cell:
    """A cell's function, its ``meta`` arguments at global shape (a list),
    their specs, and the specs of its outputs (a function of the
    outputs)."""
    fn: Callable
    args: list
    arg_specs: list
    out_specs: Callable


def _config(arch: str, smoke: bool, cfg_overrides: dict | None):
    cfg = configs.get_smoke_config(arch) if smoke else configs.get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    return cfg


def _logits_spec(cfg, mesh, logits) -> tuple:
    sizes = rules.axis_sizes(mesh)
    dp_axis = rules.batch_spec(mesh)[0]
    dsize = rules._axis_size(sizes, dp_axis)
    bshard = dp_axis if logits.shape[0] % dsize == 0 else None
    model = "model" if "model" in sizes else None
    vshard = model if cfg.vocab_size % sizes.get(model, 1) == 0 else None
    return (bshard,) + (None,) * (logits.ndim - 2) + (vshard,)


def serving_strategy(cfg, mesh, strategy: str) -> str:
    """The params' strategy of an inference cell: inference has no
    optimizer state, so ``fsdp`` becomes ``zero1`` (params over 'model'
    only: local reads, no per-step weight re-gathers) whenever the
    model-shard fits comfortably; big MoE stacks keep the (data x model)
    sharding and pay the per-layer gather."""
    if strategy != "fsdp":
        return strategy
    tp = rules.axis_sizes(mesh).get("model", 1)
    bytes_p = 2 if cfg.param_dtype == "bfloat16" else 4
    p_shard_gb = (cfg.param_count() + cfg.shared_block_params()) \
        * bytes_p / tp / 1e9
    return "zero1" if p_shard_gb < 8.0 else "fsdp"


def build_cell(arch: str, shape_name: str, mesh, *, strategy: str = "fsdp",
               microbatches: int = 1, cfg_overrides: dict | None = None,
               smoke: bool = False, pick_strategy: bool = True) -> Cell:
    """The cell's function and its abstract arguments on ``meta``.  An
    inference cell's params take :func:`serving_strategy` of its config,
    or ``strategy`` itself without ``pick_strategy`` (a reduced-depth
    build keeps its full-depth cell's)."""
    cfg = _config(arch, smoke, cfg_overrides)
    shape = SHAPES[shape_name]
    specs = input_specs(cfg, shape)

    if shape.kind == "train":
        step_fn = make_train_step(cfg, TrainHyper(microbatches=microbatches))
        state = init_train_state(cfg, 0, device="meta")
        state_specs = rules.state_specs(cfg, mesh, state, strategy=strategy)
        batch_specs = rules.batch_specs(cfg, mesh, specs)

        def out_specs(out):
            return [state_specs,
                    {k: (None,) * v.ndim for k, v in out[1].items()}]
        return Cell(step_fn, [state, specs], [state_specs, batch_specs],
                    out_specs)

    params = init_params(cfg, 0, device="meta")
    if pick_strategy:
        strategy = serving_strategy(cfg, mesh, strategy)
    params_specs = rules.param_specs(cfg, mesh, params, strategy=strategy)
    tok_spec = rules.batch_specs(cfg, mesh, specs)["inputs"]

    def cache_out(out):
        return [_logits_spec(cfg, mesh, out[0]),
                rules.cache_specs(cfg, mesh, out[1])]

    if shape.kind == "prefill":
        def prefill_fn(p, inputs):
            return prefill(p, cfg, inputs, max_len=shape.seq_len)
        return Cell(prefill_fn, [params, specs["inputs"]],
                    [params_specs, tok_spec], cache_out)

    # decode: one token against a cache of seq_len
    def serve_fn(p, cache, inputs):
        return decode_step(p, cfg, inputs, cache)

    cache = init_cache(cfg, shape.global_batch, shape.seq_len, cfg.cdtype(),
                       device="meta")
    return Cell(serve_fn, [params, cache, specs["inputs"]],
                [params_specs, rules.cache_specs(cfg, mesh, cache), tok_spec],
                cache_out)


def distribute(tree, specs, mesh):
    """``tree`` with every tensor leaf a DTensor placed per ``specs``."""
    from torch.distributed.tensor import distribute_tensor
    flat_specs = dict(rules.leaves(specs))

    def place(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, mesh, rules.to_placements(
            flat_specs[path], mesh))

    return rules.map_leaves(place, tree)


def local_bytes(tree) -> int:
    """Bytes of this rank's local shards of a tree of DTensors."""
    return sum(math.prod(leaf.to_local().shape) * leaf.element_size()
               for _, leaf in rules.leaves(tree)
               if isinstance(leaf, torch.Tensor))


def _collectives(cell: Cell, dist_args,
                 mesh) -> tuple[dict | None, str | None]:
    """The collectives of a DTensor run of the cell, or (None, reason).
    The run is inside ``hints.use_mesh``, so the model's hints act (unless
    REPRO_NO_HINTS=1) and its cache writes and batch splits take their
    mesh branches.  On a mesh of three axes DTensor's strategy costs price
    strided shards as plain ones (``collectives.strided_costs_as_shards``):
    its exact pricing takes minutes an op there."""
    from torch.distributed.tensor.experimental import implicit_replication
    counter = collectives.CollectiveCounter(COLLECTIVE_BUDGET_S)
    costs = collectives.strided_costs_as_shards() if mesh.ndim >= 3 \
        else contextlib.nullcontext()
    try:
        with implicit_replication(), hints.use_mesh(mesh), costs, counter:
            cell.fn(*dist_args)
    except Exception as e:      # the op the DTensor run stopped at
        op = getattr(counter.last_op, "__name__", str(counter.last_op))
        msg = str(e).strip()
        if not msg:
            frame = traceback.extract_tb(e.__traceback__)[-1]
            msg = (f"raised at {os.path.basename(frame.filename)}:"
                   f"{frame.lineno}")
        return None, f"{op}: {type(e).__name__}: {msg[:300]}"
    return collectives.stats(counter), None


def fit_depths(cfg) -> tuple[int, int, list[int]]:
    """(p, k0, depths): the period p of the model's layer kinds (a
    hybrid's ``attn_period``, else 1) and the three depths r + k p,
    k = k0, k0 + 1, k0 + 2, that the layer count runs (r the depth mod p),
    k0 the least that gives each depth at least 2 layers and a hybrid at
    least one period."""
    p = cfg.attn_period if cfg.family == HYBRID and cfg.attn_period > 0 \
        else 1
    r = cfg.num_layers % p
    k0 = 1 if p > 1 else 0
    while r + k0 * p < 2:
        k0 += 1
    return p, k0, [r + k * p for k in (k0, k0 + 1, k0 + 2)]


def fit_line(runs: list[dict], depths: list[int], k0: int,
             k: int) -> tuple[dict | None, str | None]:
    """The stats (``collectives.stats``'s keys) at trip count ``k`` of
    three runs at trip counts k0, k0 + 1, k0 + 2 (``depths`` layers):
    each kind's bytes and op count a + b k, exactly, or (None, reason)
    where a third run is off the line of the first two or the line goes
    below 0 at ``k``."""
    out = {}
    for key, what in (("by_kind", "bytes"), ("count", "ops")):
        out[key] = {}
        for kind in sorted(set().union(*(r[key] for r in runs))):
            v = [int(r[key].get(kind, 0)) for r in runs]
            step = v[1] - v[0]
            if v[2] - v[1] != step:
                return None, (f"{what} of {kind} off a line: {v[0]}, "
                              f"{v[1]}, {v[2]} at {depths[0]}, {depths[1]}, "
                              f"{depths[2]} layers")
            value = v[0] + (k - k0) * step
            if value < 0:
                return None, (f"{what} of {kind} below 0 at {k} periods: "
                              f"{v[0]}, {v[1]}, {v[2]} at {depths[0]}, "
                              f"{depths[1]}, {depths[2]} layers")
            out[key][kind] = value
    out["total_bytes"] = sum(out["by_kind"].values())
    return out, None


def _collectives_by_layers(arch: str, shape_name: str, mesh, cfg, *,
                           strategy: str, microbatches: int,
                           cfg_overrides: dict | None, smoke: bool):
    """(stats, reason, depths, seconds a depth): the cell's collectives
    fitted over the layer counts of :func:`fit_depths` (each a run of the
    cell at that depth, everything else the cell's own, the params'
    strategy included), or (None, reason, ...) where a run stops or the
    fit refuses."""
    p, k0, depths = fit_depths(cfg)
    if SHAPES[shape_name].kind != "train":      # the full depth's pick
        strategy = serving_strategy(cfg, mesh, strategy)
    runs, seconds = [], []
    for depth in depths:
        t0 = time.time()
        cell = build_cell(arch, shape_name, mesh, strategy=strategy,
                          microbatches=microbatches, smoke=smoke,
                          cfg_overrides=dict(cfg_overrides or {},
                                             num_layers=depth),
                          pick_strategy=False)
        coll, reason = _collectives(
            cell, distribute(cell.args, cell.arg_specs, mesh), mesh)
        seconds.append(round(time.time() - t0, 2))
        if coll is None:
            return None, f"at {depth} layers: {reason}", depths, seconds
        runs.append(coll)
    coll, reason = fit_line(runs, depths, k0, cfg.num_layers // p)
    return coll, reason, depths, seconds


def run_cell(arch: str, shape_name: str, multi_pod: bool, mesh=None, *,
             strategy: str = "fsdp", microbatches: int = 1,
             cfg_overrides: dict | None = None, smoke: bool = False,
             collectives_method: str = "layers") -> dict:
    if collectives_method not in COLLECTIVE_METHODS:
        raise ValueError(f"collectives_method must be one of "
                         f"{COLLECTIVE_METHODS}; got {collectives_method!r}")
    shape = SHAPES[shape_name]
    cfg = _config(arch, smoke, cfg_overrides)
    runnable, reason = shape_is_applicable(cfg, shape)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    sizes = rules.axis_sizes(mesh)
    mesh_name = "x".join(str(n) for n in sizes.values())
    cell_rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "kind": shape.kind, "strategy": strategy,
                "microbatches": microbatches,
                "cfg_overrides": cfg_overrides or {}}
    if not runnable:
        cell_rec.update(status="SKIP", reason=reason)
        return cell_rec
    chips = math.prod(sizes.values())

    t0 = time.time()
    cell = build_cell(arch, shape_name, mesh, strategy=strategy,
                      microbatches=microbatches, cfg_overrides=cfg_overrides,
                      smoke=smoke)                                   # (a)
    dist_args = distribute(cell.args, cell.arg_specs, mesh)          # (b)
    t_build = time.time() - t0

    t0 = time.time()                                                 # (d)
    with FlopCounter() as counter:
        out = cell.fn(*cell.args)
    flops, naive_bytes = counter.flops, counter.bytes
    t_count = time.time() - t0
    out_bytes = local_bytes(distribute(list(out), cell.out_specs(out), mesh))
    mem_info = {"argument_size_in_bytes": local_bytes(dist_args),    # (c)
                "output_size_in_bytes": out_bytes,
                "temp_size_in_bytes": None,
                "temp_size_reason": TEMP_BYTES_REASON}
    flops_chip = flops / chips

    # (e): a model no deeper than the fit's deepest run is run whole
    whole = cfg.num_layers <= fit_depths(cfg)[2][-1]
    full = full_reason = t_full = None
    if whole or collectives_method != "layers":
        t0 = time.time()
        full, full_reason = _collectives(cell, dist_args, mesh)
        t_full = time.time() - t0
    if whole or collectives_method == "full":
        method, depths, depth_s = "full", [cfg.num_layers], [round(t_full, 2)]
        coll, coll_reason, t_coll = full, full_reason, t_full
    else:
        t0 = time.time()
        method = "layers"
        coll, coll_reason, depths, depth_s = _collectives_by_layers(
            arch, shape_name, mesh, cfg, strategy=strategy,
            microbatches=microbatches, cfg_overrides=cfg_overrides,
            smoke=smoke)
        t_coll = time.time() - t0

    compute_s = flops_chip / PEAK_FLOPS_BF16
    tp = sizes.get("model", 1)
    floor = traffic.analytic_traffic(cfg, shape, chips, tp=tp,
                                     microbatches=microbatches)
    floor_memory_s = floor["total"] / HBM_BANDWIDTH
    collective_s = coll["total_bytes"] / NVLINK_BANDWIDTH if coll else None

    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (6 if shape.kind == "train" else 2) \
        * cfg.active_param_count() * tokens
    model_flops_per_chip = model_flops / chips
    terms = [("compute", compute_s), ("memory", floor_memory_s)]
    if collective_s is not None:
        terms.append(("collective", collective_s))
    dominant_floor = max(terms, key=lambda kv: kv[1])[0]
    bound_floor = max(t for _, t in terms)
    cell_rec.update(
        status="OK",
        chips=chips,
        analytic_memory_bytes=floor["total"],
        analytic_memory_term_s=floor_memory_s,
        analytic_breakdown={k: v for k, v in floor.items() if k != "total"},
        dominant_floor=dominant_floor,
        roofline_fraction_floor=compute_s / max(bound_floor, 1e-30),
        build_s=round(t_build, 2), count_s=round(t_count, 2),
        collectives_s=round(t_coll, 2),
        flops_per_chip=flops_chip,
        naive_bytes_per_chip=naive_bytes / chips,
        collective_bytes_per_chip=coll["total_bytes"] if coll else None,
        collective_by_kind=coll["by_kind"] if coll else None,
        collective_count=coll["count"] if coll else None,
        collective_reason=coll_reason,
        collectives=collectives_method,
        collective_method=method,
        collective_depths=depths,
        collective_depth_s=depth_s,
        compute_term_s=compute_s,
        memory_term_s=floor_memory_s,
        collective_term_s=collective_s,
        model_flops_per_chip=model_flops_per_chip,
        useful_flop_ratio=(model_flops_per_chip / flops_chip)
        if flops_chip else None,
        memory_analysis=mem_info,
    )
    if collectives_method == "both":
        cell_rec.update(
            collective_by_kind_full=full["by_kind"] if full else None,
            collective_count_full=full["count"] if full else None,
            collective_reason_full=full_reason,
            collectives_full_s=round(t_full, 2))
        if coll and full and (coll["by_kind"], coll["count"]) != (
                full["by_kind"], full["count"]):
            cell_rec.update(status="FAIL", error=(
                f"the layer fit and the full run disagree: "
                f"{json.dumps(coll)} against {json.dumps(full)}"))
    return cell_rec


def cell_knobs(arch: str, shape_name: str, mode: str) -> dict:
    """run_cell kwargs per the reference's tuning table."""
    if mode == "baseline":
        return {"cfg_overrides": {"moe_impl": "scatter", "attn_q_chunks": 1}}
    over = {}
    kw = {}
    cfg = configs.get_config(arch)
    if cfg.family == "moe":
        over["moe_impl"] = "einsum"
    if shape_name == "train_4k":
        # grad accumulation until temp < 16 GB HBM (the reference's table)
        kw["microbatches"] = 8 if cfg.param_count() > 1e11 else 4
    if shape_name == "prefill_32k" and cfg.attention_layers:
        over["attn_q_chunks"] = 8       # blocked attention
    if over:
        kw["cfg_overrides"] = over
    return kw


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="directory for JSON results")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose JSON already exists in --out")
    ap.add_argument("--mode", default="tuned",
                    choices=["baseline", "tuned"],
                    help="baseline = no sharding hints / scatter MoE / "
                         "mb=1 / unblocked attention (the paper-faithful "
                         "naive distribution); tuned = the reference's "
                         "tuning table")
    ap.add_argument("--collectives", default="layers",
                    choices=COLLECTIVE_METHODS,
                    help="layers = each layer kind counted once and "
                         "multiplied (three reduced depths, fitted "
                         "exactly); full = the whole function's DTensor "
                         "run; both = the two, a cell FAIL where they "
                         "differ by kind")
    args = ap.parse_args(argv)

    if args.mode == "baseline":
        os.environ["REPRO_NO_HINTS"] = "1"

    archs = configs.all_archs() if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    t_all = time.time()
    for multi in meshes:
        mesh = make_production_mesh(multi_pod=multi)
        mesh_name = "2x16x16" if multi else "16x16"
        for arch in archs:
            for shape_name in shapes:
                tag = f"{arch} x {shape_name} x {mesh_name} [{args.mode}]"
                path = None
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    suffix = "" if args.mode == "tuned" else "_baseline"
                    name = (f"dryrun_{arch}_{shape_name}_{mesh_name}"
                            f"{suffix}.json")
                    path = os.path.join(args.out, name.replace("/", "_"))
                if args.resume and path and os.path.exists(path):
                    with open(path) as f:
                        cell = json.load(f)
                    if cell.get("status") == "SKIP" or (
                            cell.get("status") == "OK" and
                            cell.get("collectives") == args.collectives):
                        results.append(cell)
                        print(f"[CACHED {cell['status']}] {tag}")
                        continue
                try:
                    cell = run_cell(arch, shape_name, multi, mesh=mesh,
                                    collectives_method=args.collectives,
                                    **cell_knobs(arch, shape_name,
                                                 args.mode))
                except Exception as e:  # record and continue — unattended run
                    cell = {"arch": arch, "shape": shape_name,
                            "mesh": mesh_name, "status": "FAIL",
                            "error": f"{type(e).__name__}: {e}"}
                results.append(cell)
                if cell["status"] == "SKIP":
                    print(f"[SKIP] {tag}: {cell['reason']}")
                elif cell["status"] == "FAIL":
                    print(f"[FAIL] {tag}: {cell['error'][:400]}")
                else:
                    coll = cell["collective_bytes_per_chip"]
                    print(f"[OK]   {tag}: flops/chip="
                          f"{cell['flops_per_chip']:.3e} coll_bytes/chip="
                          + (f"{coll:.3e}" if coll is not None else
                             f"null ({cell['collective_reason'][:120]})")
                          + f" by {cell['collective_method']} "
                          f"{cell['collective_depths']}"
                          + f" dominant_floor={cell['dominant_floor']} "
                          f"({cell['build_s'] + cell['count_s'] + cell['collectives_s']:.1f}"
                          f" s)", flush=True)
                if path:
                    with open(path, "w") as f:
                        json.dump(cell, f, indent=2)
    ok = [c for c in results if c["status"] == "OK"]
    skip = [c for c in results if c["status"] == "SKIP"]
    fail = [c for c in results if c["status"] == "FAIL"]
    null = [c for c in ok if c["collective_bytes_per_chip"] is None]
    print(f"\n{len(ok)}/{len(results)} cells OK ({len(skip)} documented "
          f"skips, {len(fail)} FAILURES; {len(null)} OK cells without a "
          f"collective count) in {time.time() - t_all:.1f} s")
    return results


if __name__ == "__main__":
    main()
