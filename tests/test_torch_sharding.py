"""The port's sharding rules (``repro_torch.sharding.rules``) against the
reference's (``repro.sharding.rules``), on the CPU.

Specs are compared entry by entry: the port's spec is a plain tuple with
one entry per dim, the reference's a ``PartitionSpec`` that may be
shorter (padded here with ``None``).  The port keeps one dict per layer
under ``blocks``, so its spec for ``blocks/<i>/...`` is held against the
reference's spec of the stacked leaf with the stacked dim dropped.  The
reference's trees are ``jax.eval_shape`` stand-ins on an ``AbstractMesh``;
the port's are ``meta`` tensors with a ``{axis: size}`` mesh.  Local shard
shapes on a real (fake-process-group) ``DeviceMesh`` run in a subprocess,
so no process group is left in the test worker.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro import configs as jconfigs
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.sharding import rules as jrules
from repro.training import init_train_state as jinit_state
from repro_torch import configs as tconfigs
from repro_torch.models import init_cache as tinit_cache
from repro_torch.models import init_params as tinit_params
from repro_torch.sharding import rules as trules
from repro_torch.training.train_step import init_train_state as tinit_state

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
FAMILY_ARCHS = ("qwen1.5-4b", "granite-moe-1b-a400m", "mamba2-1.3b",
                "zamba2-7b")


def _abstract_mesh(sizes, names):
    """AbstractMesh across jax versions (as ``tests/test_sharding.py``)."""
    try:
        return AbstractMesh(sizes, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


def _ref_specs(tree, is_leaf=lambda x: isinstance(x, P)):
    """{path: spec tuple} of a reference spec or sharding tree."""
    flat = jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)
    out = {}
    for path, leaf in flat:
        spec = leaf if isinstance(leaf, P) else leaf.spec
        out["/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path)] = tuple(spec)
    return out


def _ref_key(path: str) -> tuple[str, bool]:
    """The reference's path for a port path, and whether the reference
    stacks the leaf (a ``blocks/<i>/`` segment dropped)."""
    parts = path.split("/")
    if "blocks" in parts:
        i = parts.index("blocks")
        return "/".join(parts[:i + 1] + parts[i + 2:]), True
    return path, False


def _assert_same(port_specs: dict, ref: dict, what: str) -> int:
    """Every port spec equals the reference's (stacked dim dropped, None
    padded); returns the number of leaves compared."""
    for path, spec in port_specs.items():
        key, stacked = _ref_key(path)
        want = ref[key][1:] if stacked else ref[key]
        want = tuple(want) + (None,) * (len(spec) - len(want))
        assert spec == want, (what, path, spec, ref[key])
    return len(port_specs)


@pytest.mark.parametrize("arch", jconfigs.all_archs())
@pytest.mark.parametrize("multi_pod", [False, True])
def test_param_specs_match_reference(arch, multi_pod):
    """Every leaf's spec is the reference's ``param_specs`` entry on the
    production mesh, and every sharded dim divides its axis size."""
    sizes, names = MESHES[multi_pod]
    ref = _ref_specs(jrules.param_specs(
        jconfigs.get_config(arch), _abstract_mesh(sizes, names),
        jax.eval_shape(lambda: jinit_params(jconfigs.get_config(arch),
                                            jax.random.PRNGKey(0)))))
    cfg = tconfigs.get_config(arch)
    params = tinit_params(cfg, 0, device="meta")
    mesh = dict(zip(names, sizes))
    specs = dict(trules.leaves(trules.param_specs(cfg, mesh, params)))
    leaves = dict(trules.leaves(params))
    assert set(specs) == set(leaves)
    n = _assert_same(specs, ref, arch)
    assert n == len(leaves) and n >= 4
    sharded = 0
    for path, spec in specs.items():
        assert len(spec) == leaves[path].ndim
        for dim, axis in zip(leaves[path].shape, spec):
            size = trules._axis_size(mesh, axis)
            assert dim % size == 0, (path, spec)
            sharded += size > 1
    assert sharded >= 4


@pytest.mark.parametrize("strategy", ["fsdp", "zero1"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_state_shardings_match_reference(arch, strategy):
    sizes, names = MESHES[False]
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jstate = jax.eval_shape(lambda: jinit_state(jcfg, jax.random.PRNGKey(0)))
    ref = _ref_specs(jrules.state_shardings(
        jcfg, _abstract_mesh(sizes, names), jstate, strategy=strategy),
        is_leaf=lambda x: hasattr(x, "spec"))
    state = tinit_state(tcfg, 0, device="meta")
    mesh = dict(zip(names, sizes))
    port = {path: sh.spec for path, sh in trules.leaves(
        trules.state_shardings(tcfg, mesh, state, strategy=strategy))}
    assert _assert_same(port, ref, strategy) == len(
        trules.leaves(state))
    # zero1 keeps 'data' off the params, never off the moments
    if strategy == "zero1":
        assert not any("data" in str(spec) for path, spec in port.items()
                       if path.startswith("params/"))
        assert any("data" in str(spec) for path, spec in port.items()
                   if path.startswith("opt/mu/"))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cache_shardings_match_reference(arch, multi_pod):
    """The decode cache at decode_32k's (128, 32768): heads or sequence
    over 'model' (qwen1.5-4b's 20 KV heads do not divide 16), SSM heads
    over 'model', batch over the data axes."""
    sizes, names = MESHES[multi_pod]
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jcache = jax.eval_shape(lambda: jinit_cache(jcfg, 128, 32768,
                                                jcfg.cdtype()))
    ref = _ref_specs(jrules.cache_shardings(
        jcfg, _abstract_mesh(sizes, names), jcache),
        is_leaf=lambda x: hasattr(x, "spec"))
    cache = tinit_cache(tcfg, 128, 32768, tcfg.cdtype(), device="meta")
    port = {path: sh.spec for path, sh in trules.leaves(
        trules.cache_shardings(tcfg, dict(zip(names, sizes)), cache))
        if sh is not None}
    assert set(port) == set(ref)
    _assert_same(port, ref, arch)
    if cache.kv_k is not None:
        assert "model" in port["kv_k"]


def test_batch_spec_uses_pod_axis():
    for sizes, names in MESHES.values():
        want = tuple(jrules.batch_spec(_abstract_mesh(sizes, names)))
        assert trules.batch_spec(dict(zip(names, sizes))) == want
    multi = dict(zip(MESHES[True][1], MESHES[True][0]))
    axes = trules.batch_spec(multi)[0]
    assert "pod" in axes and "data" in axes
    batch = {"inputs": torch.empty((256, 4096), device="meta"),
             "odd": torch.empty((3, 4096), device="meta")}
    specs = trules.batch_specs(None, multi, batch)
    assert specs == {"inputs": (("pod", "data"), None), "odd": (None, None)}


def test_rules_fall_back_to_replication_when_indivisible():
    """A dim not divisible by its axis replicates, never fails: the smoke
    config's tiny dims against 16-wide axes, as the reference falls back."""
    sizes, names = MESHES[False]
    arch = "qwen1.5-4b"
    ref = _ref_specs(jrules.param_specs(
        jconfigs.get_smoke_config(arch), _abstract_mesh(sizes, names),
        jax.eval_shape(lambda: jinit_params(jconfigs.get_smoke_config(arch),
                                            jax.random.PRNGKey(0)))))
    cfg = tconfigs.get_smoke_config(arch)
    params = tinit_params(cfg, 0, device="meta")
    specs = dict(trules.leaves(trules.param_specs(
        cfg, dict(zip(names, sizes)), params)))
    _assert_same(specs, ref, arch)
    dropped = sum(axis is None for spec in specs.values() for axis in spec)
    assert dropped > 0
    for path, leaf in trules.leaves(params):
        for dim, axis in zip(leaf.shape, specs[path]):
            assert axis is None or dim % 16 == 0, (path, specs[path])


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "yi-34b",
                                  "chameleon-34b"])
def test_param_bytes_per_chip_equal_reference(arch):
    """``test_sharding.py::test_param_bytes_fit_hbm``'s per-chip bytes
    (params + 2 f32 moments over the shard count) equal the reference's
    exactly, in integers (every sharded dim divides its axis)."""
    sizes, names = MESHES[False]
    jcfg = jconfigs.get_config(arch)
    jtree = jax.eval_shape(lambda: jinit_params(jcfg, jax.random.PRNGKey(0)))
    jspecs = jrules.param_specs(jcfg, _abstract_mesh(sizes, names), jtree)
    mesh = dict(zip(names, sizes))

    def per_chip(pairs):
        total = 0
        for shape, itemsize, spec in pairs:
            shard = math.prod(trules._axis_size(mesh, a) for a in spec)
            numel = math.prod(shape)
            assert (numel * (itemsize + 8)) % shard == 0
            total += numel * (itemsize + 8) // shard
        return total

    want = per_chip(
        (leaf.shape, leaf.dtype.itemsize, tuple(spec)) for leaf, spec in zip(
            jax.tree.leaves(jtree),
            jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, P))))
    cfg = tconfigs.get_config(arch)
    params = tinit_params(cfg, 0, device="meta")
    specs = dict(trules.leaves(trules.param_specs(cfg, mesh, params)))
    got = per_chip((leaf.shape, leaf.element_size(), specs[path])
                   for path, leaf in trules.leaves(params))
    assert got == want
    assert got < 16e9, f"{arch}: {got / 1e9:.1f} GB/chip"


_SHARDS = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch import configs
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import make_mesh, release_mesh
    from repro_torch.models import init_cache, init_params
    from repro_torch.sharding import rules
    mesh = make_mesh((4, 2), ("data", "model"))
    out = {}
    for arch in sys.argv[1:]:
        cfg = configs.get_smoke_config(arch)
        params = init_params(cfg, 0, device="meta")
        cache = init_cache(cfg, 8, 64, cfg.cdtype(), device="meta")
        shards = {}
        for name, tree, shardings in (
                ("params", params, rules.param_shardings(cfg, mesh, params)),
                ("cache", cache, rules.cache_shardings(cfg, mesh, cache))):
            placement = dict(rules.leaves(shardings))
            for path, leaf in rules.leaves(tree):
                if leaf is None:
                    continue
                local = distribute_tensor(
                    leaf, mesh, placement[path].placements).to_local()
                shards[name + "/" + path] = [
                    list(local.shape),
                    [repr(p) for p in placement[path].placements]]
        out[arch] = shards
    group = torch.distributed.is_initialized()
    release_mesh()
    print(json.dumps({"shards": out, "group": group,
                      "left": torch.distributed.is_initialized()}))
""")


def test_local_shards_on_a_fake_mesh_match_reference_specs():
    """On a fake (4, 2) ``DeviceMesh`` (a subprocess), each smoke leaf's
    local shard — params and decode cache, all four families — has the
    shape the reference's spec implies, and the group is released."""
    sizes, names = (4, 2), ("data", "model")
    mesh = dict(zip(names, sizes))
    amesh = _abstract_mesh(sizes, names)
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _SHARDS, *FAMILY_ARCHS],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["group"] and not payload["left"]
    for arch in FAMILY_ARCHS:
        jcfg = jconfigs.get_smoke_config(arch)
        ref = {"params/" + k: v for k, v in _ref_specs(jrules.param_specs(
            jcfg, amesh, jax.eval_shape(lambda: jinit_params(
                jcfg, jax.random.PRNGKey(0))))).items()}
        jcache = jax.eval_shape(lambda: jinit_cache(jcfg, 8, 64,
                                                    jcfg.cdtype()))
        ref.update({"cache/" + k: v for k, v in _ref_specs(
            jrules.cache_shardings(jcfg, amesh, jcache),
            is_leaf=lambda x: hasattr(x, "spec")).items()})
        tcfg = tconfigs.get_smoke_config(arch)
        shapes = {"params/" + p: leaf.shape for p, leaf in trules.leaves(
            tinit_params(tcfg, 0, device="meta"))}
        shapes.update({"cache/" + p: leaf.shape for p, leaf in trules.leaves(
            tinit_cache(tcfg, 8, 64, tcfg.cdtype(), device="meta"))
            if leaf is not None})
        got = payload["shards"][arch]
        assert set(got) == set(shapes)
        for path, (local, placements) in got.items():
            key, stacked = _ref_key(path)
            spec = ref[key][1:] if stacked else ref[key]
            spec = tuple(spec) + (None,) * (len(shapes[path]) - len(spec))
            want = [d // trules._axis_size(mesh, a)
                    for d, a in zip(shapes[path], spec)]
            assert local == want, (arch, path, local, spec, placements)
        assert any(np.prod(v[0]) < np.prod(shapes[k])
                   for k, v in got.items()), arch
