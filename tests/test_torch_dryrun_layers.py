"""The dry run's collectives counted a layer kind at a time, and the two
model-code sites that run per shard under a mesh, on the CPU.

* The MoE's expert products per shard (``models/moe.py::_experts``): a
  narrow qwen3-moe train cell with 128 experts is ``OK`` with a count on a
  fake (2, 16) mesh, where DTensor's own products stopped at a view in
  the forward, and on a fake (16, 16) mesh, where they stopped in the
  backward; on gloo meshes of real tensors the per-shard products and
  their gradients equal the plain products.
* The embedding lookup per shard (``models/transformer.py::embed_inputs``):
  on a fake (4, 2) mesh it moves the ids and the lookup's reduction, never
  the table, byte for byte as worked out from the specs; on gloo meshes of
  real tensors it equals the plain lookup bitwise, gradient included.
* The layer fit (``launch/dryrun.py``): the depths it runs, its exact
  integer fit and its refusals, and the fit against the full run by kind
  on smoke cells at depths the fit does not run.

Every mesh lives in a subprocess of its own (no process group is left in
the test worker); they all start together, before the module's first
test.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch import configs
from repro_torch.launch import dryrun

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _env():
    return dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")


# the narrow qwen3-moe train cell: 128 experts of the full config, every
# width cut, one layer, 2 microbatches of a (32, 64) batch
_NARROW_MOE = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import SHAPES, Shape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, release_mesh
    SHAPES["train_tiny"] = Shape("train_tiny", "train", 64, 32)
    shape = tuple(json.loads(sys.argv[1]))
    mesh = make_mesh(shape, ("data", "model"))
    over = dict(num_layers=1, d_model=256, vocab_size=512, num_heads=4,
                num_kv_heads=4, head_dim=64, d_ff=64, moe_group_size=64,
                moe_impl="einsum")
    cell = dryrun.run_cell("qwen3-moe-235b-a22b", "train_tiny", False,
                           mesh=mesh, microbatches=2, cfg_overrides=over)
    release_mesh()
    print(json.dumps(cell))
""")
NARROW_MESHES = {"forward": (2, 16), "backward": (16, 16)}

# smoke cells under ``--collectives both`` at a depth the fit does not
# run: (arch, depth, shapes)
FIT_CASES = {"qwen1.5-4b": (5, ("train_tiny",)),
             "zamba2-7b": (9, ("train_tiny", "decode_32k")),
             "granite-moe-1b-a400m": (5, ("train_tiny",))}
_FIT = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import SHAPES, Shape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, release_mesh
    SHAPES["train_tiny"] = Shape("train_tiny", "train", 32, 8)
    arch, depth, names = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
    mesh = make_mesh((4, 2), ("data", "model"))
    cells = []
    for name in names:
        knobs = dryrun.cell_knobs(arch, name, "tuned")
        if name == "train_tiny":
            knobs["microbatches"] = 4
        knobs["cfg_overrides"] = dict(knobs.get("cfg_overrides", {}),
                                      num_layers=depth)
        cells.append(dryrun.run_cell(arch, name, False, mesh=mesh,
                                     smoke=True, collectives_method="both",
                                     **knobs))
    release_mesh()
    print(json.dumps(cells))
""")

# one rank of a gloo ('data', 'model') mesh of real CPU tensors: the MoE's
# expert products and the embedding lookup, each with its gradient, under
# ``use_mesh`` against the plain functions
_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, shape, store, out = (int(sys.argv[1]), tuple(json.loads(
        sys.argv[2])), sys.argv[3], sys.argv[4])
    world = int(np.prod(shape))
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs
    from repro_torch.models import moe, transformer
    from repro_torch.sharding import hints, rules
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    rng = np.random.default_rng(0)

    def draw(*dims):
        return torch.as_tensor(rng.standard_normal(dims),
                               dtype=torch.float32)

    def place(x, spec):
        return distribute_tensor(x, mesh, rules.to_placements(spec, mesh))

    def run(fn, leaves, specs, cot):
        plain = [x.clone().requires_grad_(x.is_floating_point())
                 for x in leaves]
        want = fn(*plain)
        want_grads = torch.autograd.grad(
            want, [x for x in plain if x.requires_grad], cot)
        with implicit_replication(), hints.use_mesh(mesh):
            placed = [place(x, s).requires_grad_(x.is_floating_point())
                      for x, s in zip(leaves, specs)]
            got = fn(*placed)
            live = [x for x in placed if x.requires_grad]
            grads = torch.autograd.grad(
                got, live, distribute_tensor(cot, mesh, got.placements))
            got = got.full_tensor()
            grads = [g.full_tensor() for g in grads]
        return {"diff": float((got - want).abs().max()),
                "equal": bool(torch.equal(got, want.detach())),
                "grad_diff": max(float((g - w).abs().max())
                                 for g, w in zip(grads, want_grads)),
                "grads_equal": all(bool(torch.equal(g, w))
                                   for g, w in zip(grads, want_grads)),
                "grads": len(grads)}

    # (G, E, C, d) buffers, 8 experts of (d, f) = (16, 24); the buffer as
    # the hints place it, the weights as the rules do
    g, e, c, d, f = 4, 8, 3, 16, 24
    experts = run(
        lambda b, wg, wu, wd: moe._experts(
            {"gate": wg, "up": wu, "down": wd}, b, torch.float32),
        [draw(g, e, c, d), draw(e, d, f), draw(e, d, f), draw(e, f, d)],
        [("data", "model", None, None), ("model", "data", None),
         ("model", "data", None), ("model", None, "data")],
        draw(g, e, c, d))

    # a (64, 16) table, rows over 'model' and columns over 'data' (the
    # fsdp rule); ids in every rank's rows, the first and last row too
    cfg = configs.get_smoke_config("qwen1.5-4b")
    ids = torch.as_tensor(rng.integers(0, 64, (4, 8)))
    ids[0, 0], ids[-1, -1] = 0, 63
    lookup = run(
        lambda table, i: transformer.embed_inputs({"embed": table}, cfg, i),
        [draw(64, 16), ids], [("model", "data"), ("data", None)],
        draw(4, 8, 16))
    json.dump({"experts": experts, "lookup": lookup,
               "ranges": [int(ids.min()), int(ids.max())]}, open(out, "w"))
    dist.destroy_process_group()
""")
GLOO_MESHES = {"1x1": (1, 1), "1x2": (1, 2)}


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """Every subprocess of the module, started together; ``get(key)``
    waits for one group and returns its payload."""
    procs = {}
    for name, shape in NARROW_MESHES.items():
        procs[("narrow", name)] = [subprocess.Popen(
            [sys.executable, "-c", _NARROW_MOE, json.dumps(shape)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)]
    for arch, (depth, names) in FIT_CASES.items():
        procs[("fit", arch)] = [subprocess.Popen(
            [sys.executable, "-c", _FIT, arch, str(depth), *names],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)]
    outs = {}
    for name, shape in GLOO_MESHES.items():
        tmp = tmp_path_factory.mktemp(f"gloo{name}")
        world = math.prod(shape)
        outs[name] = [tmp / f"rank{r}.json" for r in range(world)]
        procs[("gloo", name)] = [subprocess.Popen(
            [sys.executable, "-c", _RANK, str(r), json.dumps(shape),
             str(tmp / "store"), str(outs[name][r])], env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
    done = {}

    def get(key):
        if key not in done:
            results = [p.communicate(timeout=600) for p in procs[key]]
            for p, (_, err) in zip(procs[key], results):
                assert p.returncode == 0, err[-3000:]
            if key[0] == "gloo":
                done[key] = [json.loads(path.read_text())
                             for path in outs[key[1]]]
            else:
                done[key] = json.loads(results[0][0].strip().splitlines()[-1])
        return done[key]

    yield get
    for group in procs.values():
        for proc in group:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


# ---------------------------------------------------------------------------
# the layer fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,depths", [
    ("zamba2-7b", (6, 1, [9, 15, 21])),          # 81 = 3 + 13 * 6
    ("qwen1.5-4b", (1, 2, [2, 3, 4])),
    ("mamba2-1.3b", (1, 2, [2, 3, 4])),
    ("qwen3-moe-235b-a22b", (1, 2, [2, 3, 4])),
])
def test_fit_depths_follow_the_rule(arch, depths):
    """p the hybrid's period (1 otherwise), depths r + k p for three
    consecutive k from the least that gives 2 layers and, for the hybrid,
    a period."""
    assert dryrun.fit_depths(configs.get_config(arch)) == depths


@pytest.mark.parametrize("layers,period,want", [
    (7, 2, (2, 1, [3, 5, 7])), (4, 2, (2, 1, [2, 4, 6])),
    (13, 4, (4, 1, [5, 9, 13])), (9, 8, (8, 1, [9, 17, 25])),
    (2, 0, (1, 2, [2, 3, 4]))])
def test_fit_depths_of_smoke_hybrids(layers, period, want):
    cfg = dataclasses.replace(configs.get_smoke_config("zamba2-7b"),
                              num_layers=layers, attn_period=period)
    assert dryrun.fit_depths(cfg) == want


def _stats(by_kind, count):
    return {"total_bytes": sum(by_kind.values()), "by_kind": by_kind,
            "count": count}


def test_fit_line_is_exact_in_integers():
    """Bytes and op counts a + b k taken at k, a kind missing at a depth
    counted 0; the total is the sum of the kinds."""
    big = 10 ** 15
    runs = [_stats({"all-gather": big + 3 * k, "all-reduce": 7},
                   {"all-gather": 2 * k, "all-reduce": 1})
            for k in (1, 2, 3)]
    runs[0]["by_kind"]["reduce-scatter"] = 0
    runs[0]["count"]["reduce-scatter"] = 0
    for r, k in zip(runs[1:], (2, 3)):
        r["by_kind"]["reduce-scatter"] = 5 * (k - 1)
        r["count"]["reduce-scatter"] = k - 1
    fit, reason = dryrun.fit_line(runs, [9, 15, 21], 1, 13)
    assert reason is None
    assert fit == _stats(
        {"all-gather": big + 39, "all-reduce": 7, "reduce-scatter": 60},
        {"all-gather": 26, "all-reduce": 1, "reduce-scatter": 12})
    assert all(isinstance(v, int) for v in fit["by_kind"].values())


@pytest.mark.parametrize("key,kind,values", [
    ("by_kind", "all-gather", (100, 200, 301)),
    ("count", "all-reduce", (1, 2, 4)),
    ("by_kind", "reduce-scatter", (0, 0, 8)),
])
def test_fit_line_refuses_counts_off_a_line(key, kind, values):
    """A third depth off the line of the first two gives no count: a
    reason that names the kind and the three counts."""
    runs = [_stats({"all-gather": 100 * k, "all-reduce": 8,
                    "reduce-scatter": 0},
                   {"all-gather": k, "all-reduce": k, "reduce-scatter": 0})
            for k in (1, 2, 3)]
    for r, v in zip(runs, values):
        r[key][kind] = v
    fit, reason = dryrun.fit_line(runs, [2, 3, 4], 2, 40)
    assert fit is None
    assert kind in reason and ", ".join(map(str, values)) in reason
    assert ("bytes" if key == "by_kind" else "ops") in reason


def test_fit_line_refuses_a_count_below_zero():
    runs = [_stats({"all-gather": v}, {"all-gather": 1})
            for v in (30, 20, 10)]
    fit, reason = dryrun.fit_line(runs, [2, 3, 4], 2, 40)
    assert fit is None and "below 0" in reason


@pytest.mark.parametrize("shape,want", [("decode_32k", "fsdp"),
                                        ("prefill_32k", "fsdp"),
                                        ("train_4k", "fsdp")])
def test_reduced_depths_keep_the_full_depth_strategy(monkeypatch, shape,
                                                     want):
    """qwen3-moe-235b-a22b's params take fsdp at 94 layers and would take
    zero1 at 2-4 (its model shard under 8 GB): every reduced build keeps
    the full depth's strategy, so the fit counts the cell's own layout."""
    cfg = configs.get_config("qwen3-moe-235b-a22b")
    mesh = {"data": 16, "model": 16}
    assert dryrun.serving_strategy(cfg, mesh, "fsdp") == "fsdp"
    assert dryrun.serving_strategy(dataclasses.replace(cfg, num_layers=4),
                                   mesh, "fsdp") == "zero1"
    built = []

    def build(arch, shape_name, mesh, **kw):
        built.append(kw)
        return dryrun.Cell(None, [], [], None)

    def count(cell, args, mesh):
        k = built[-1]["cfg_overrides"]["num_layers"]
        return {"total_bytes": 3 * k, "by_kind": {"all-gather": 3 * k},
                "count": {"all-gather": k}}, None

    monkeypatch.setattr(dryrun, "build_cell", build)
    monkeypatch.setattr(dryrun, "distribute", lambda tree, specs, mesh: tree)
    monkeypatch.setattr(dryrun, "_collectives", count)
    coll, reason, depths, _ = dryrun._collectives_by_layers(
        "qwen3-moe-235b-a22b", shape, mesh, cfg, strategy="fsdp",
        microbatches=8, cfg_overrides={"moe_impl": "einsum"}, smoke=False)
    assert reason is None and depths == [2, 3, 4]
    assert coll == {"total_bytes": 282, "by_kind": {"all-gather": 282},
                    "count": {"all-gather": 94}}
    assert [(b["strategy"], b["pick_strategy"], b["microbatches"],
             b["cfg_overrides"]) for b in built] == [
        (want, False, 8, {"moe_impl": "einsum", "num_layers": d})
        for d in depths]


@pytest.mark.parametrize("arch", list(FIT_CASES))
def test_layer_fit_equals_the_full_run(runs, arch):
    """Under ``--collectives both`` on a fake (4, 2) mesh, at a depth
    the fit does not run (qwen1.5-4b 5 and granite-moe 5 from 2, 3, 4;
    zamba2 9 from 3, 5, 7, attn_period 2), the fit and the whole
    function's run count the same bytes and ops of every kind."""
    depth, names = FIT_CASES[arch]
    cells = runs(("fit", arch))
    assert [c["shape"] for c in cells] == list(names)
    for cell in cells:
        assert cell["status"] == "OK", cell.get("error", cell)
        assert cell["collective_method"] == "layers"
        assert depth not in cell["collective_depths"]
        assert len(cell["collective_depths"]) == 3
        assert cell["collective_reason"] is None
        assert cell["collective_reason_full"] is None
        assert cell["collective_by_kind"] == cell["collective_by_kind_full"]
        assert cell["collective_count"] == cell["collective_count_full"]
        assert cell["collective_bytes_per_chip"] == sum(
            cell["collective_by_kind"].values()) > 0
    if arch != "zamba2-7b":
        assert cells[0]["collective_depths"] == [2, 3, 4]
    else:
        assert cells[0]["collective_depths"] == [3, 5, 7]


# ---------------------------------------------------------------------------
# F6: the expert products per shard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", list(NARROW_MESHES))
def test_narrow_moe_train_cell_counts_its_collectives(runs, where):
    """The narrow qwen3-moe train cell (128 experts, 2 microbatches) is
    ``OK`` with a count on a fake (2, 16) mesh and a fake (16, 16) mesh,
    where DTensor's own expert products stopped at ``aten.view`` in the
    forward and in the backward."""
    cell = runs(("narrow", where))
    assert cell["status"] == "OK", cell
    assert cell["collective_reason"] is None, cell["collective_reason"]
    assert cell["collective_method"] == "full"
    assert cell["collective_bytes_per_chip"] == sum(
        cell["collective_by_kind"].values()) > 0
    assert {"all-gather", "reduce-scatter"} <= set(cell["collective_by_kind"])


@pytest.mark.parametrize("mesh", list(GLOO_MESHES))
def test_expert_products_per_shard_equal_the_plain_ones(runs, mesh):
    """On a gloo ('data', 'model') mesh of real tensors — one rank, and
    two ranks holding 4 experts each — the per-shard expert products and
    their gradients (buffer and the three weights) equal the plain
    ``_experts`` within 1e-6."""
    for rank in runs(("gloo", mesh)):
        out = rank["experts"]
        assert out["grads"] == 4
        assert out["diff"] <= 1e-6 and out["grad_diff"] <= 1e-6, out


# ---------------------------------------------------------------------------
# F7: the embedding lookup per shard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(GLOO_MESHES))
def test_masked_lookup_equals_the_plain_lookup(runs, mesh):
    """On a gloo mesh of real tensors — one rank, and two ranks holding 32
    rows each, with ids in both ranks' rows — the lookup per shard and the
    table's gradient equal the plain lookup's bitwise."""
    for rank in runs(("gloo", mesh)):
        out = rank["lookup"]
        assert rank["ranges"] == [0, 63]
        assert out["grads"] == 1
        assert out["equal"] and out["grads_equal"], out


_LOOKUP = textwrap.dedent("""
    import json
    import torch
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import make_mesh, release_mesh
    from repro_torch.models import transformer
    from repro_torch.sharding import hints, rules
    cfg = get_smoke_config("qwen1.5-4b")
    mesh = make_mesh((4, 2), ("data", "model"))
    out = {}
    for name, spec in (("fsdp", ("model", "data")), ("zero1", ("model", None))):
        for b, s in ((8, 16), (8, 1)):
            table = distribute_tensor(
                torch.empty((cfg.vocab_size, cfg.d_model), device="meta"),
                mesh, rules.to_placements(spec, mesh))
            ids = distribute_tensor(
                torch.empty((b, s), dtype=torch.int64, device="meta"), mesh,
                rules.to_placements(("data", None), mesh))
            hints.reset_redistributions()
            with implicit_replication(), hints.use_mesh(mesh):
                with collectives.CollectiveCounter() as counter:
                    x = transformer.embed_inputs({"embed": table}, cfg, ids)
            out[f"{name} {s}"] = {
                "stats": collectives.stats(counter),
                "placements": [repr(p) for p in x.placements],
                "shape": list(x.shape),
                "redistributions": dict(hints.redistributions)}
    release_mesh()
    print(json.dumps(out))
""")


def test_lookup_moves_its_reduction_and_never_the_table():
    """``embed_inputs`` alone on a fake (4, 2) ('data', 'model') mesh, the
    smoke qwen1.5-4b's (128, 64) f32 table (its local shard 4096 or 16384
    bytes), ids (8, S) with rows over 'data':

    * zero1 (rows over 'model'): each rank looks up its 2 batch rows in
      its 64 table rows, a partial sum over 'model'.  Prompt (S = 16): a
      reduce-scatter onto the sequence, (2, 8, 64) f32 = 4096 bytes.
      Decode (S = 1): an all-reduce of (2, 1, 64) f32 = 512 bytes.
    * fsdp (rows over 'model', columns over 'data'): the ids are gathered
      over 'data' first, (8, S) int64 = 64 S bytes, and the result's
      columns stay over 'data'.  S = 16: the reduce-scatter over 'model'
      of (8, 8, 16) f32, 4096 bytes, then the columns-to-rows exchange
      over 'data', which the CPU group issues as an all-gather of the
      (8, 8, 64) result, 16384 bytes.  S = 1: the all-reduce of (8, 1, 16)
      f32, 512 bytes, and the exchange's (8, 1, 64), 2048 bytes.

    The result lands on the residual stream's layout by one relayout."""
    out = subprocess.run([sys.executable, "-c", _LOOKUP], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    want = {
        "zero1 16": {"reduce-scatter": (4096, 1)},
        "zero1 1": {"all-reduce": (512, 1)},
        "fsdp 16": {"all-gather": (1024 + 16384, 2),
                    "reduce-scatter": (4096, 1)},
        "fsdp 1": {"all-gather": (64 + 2048, 2), "all-reduce": (512, 1)},
    }
    for key, kinds in want.items():
        stats = got[key]["stats"]
        assert stats["by_kind"] == {k: v[0] for k, v in kinds.items()}, key
        assert stats["count"] == {k: v[1] for k, v in kinds.items()}, key
        assert got[key]["redistributions"] == {"hint": 0, "layout": 1}
        s = int(key.split()[1])
        assert got[key]["shape"] == [8, s, 64]
        assert got[key]["placements"] == (
            ["Shard(dim=0)", "Shard(dim=1)"] if s > 1
            else ["Shard(dim=0)", "Replicate()"])


# ---------------------------------------------------------------------------
# the tree helpers' own module
# ---------------------------------------------------------------------------

def test_tree_helpers_live_where_nothing_imports_back():
    """``repro_torch.tree`` imports nothing of the package, so the planner
    imports ``map_with_path`` at its top; ``training.tree`` keeps the
    names its callers import."""
    probe = textwrap.dedent("""
        import json, sys
        import repro_torch.tree
        loaded = sorted(m for m in sys.modules if m.startswith("repro_torch"))
        from repro_torch import tree
        from repro_torch.sharding import planner
        from repro_torch.training import tree as training_tree
        same = all(getattr(training_tree, n) is getattr(tree, n) for n in
                   ("flatten", "unflatten", "map_tree", "map_with_path"))
        print(json.dumps({"loaded": loaded, "same": same,
                          "planner": planner.map_with_path
                          is tree.map_with_path}))
    """)
    out = subprocess.run([sys.executable, "-c", probe], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"loaded": ["repro_torch", "repro_torch.tree"],
                   "same": True, "planner": True}
