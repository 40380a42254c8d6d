"""The tuned dry run with the sharding hints at their sites in the port's
model code (``repro_torch.sharding.hints``, ``models/attention.py``,
``models/moe.py``, ``models/transformer.py``), against the reference's
hint sites, on the CPU.

* The tuned smoke cells of four families and yi-34b (whose heads do not
  divide a 16-wide axis at full width) on a fake (4, 2) and a fake
  (2, 2, 2) mesh: every cell ``OK`` with a collective count.  Each
  (mesh, arch) runs in a subprocess of its own (no process group is left
  in the test worker); the ten start together.
* One attention layer on a fake (1, 2) mesh whose collectives are worked
  out by hand from the specs and the hint sites.
* Hint-site parity: the ``(dims, rank)`` of every ``hint`` call of a
  smoke forward, prefill and decode of each family, against the
  reference's, recorded by patching ``hint`` in the reference's model
  modules (nothing in ``src/repro`` changes).
* With no mesh, or with ``REPRO_NO_HINTS=1``, every hint and relayout
  returns its input and the entry points return bitwise what they return
  with the hints taken out; on a one-rank mesh of real tensors the mesh
  branches (out-of-place cache writes, the microbatch split) compute what
  the plain branches do.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_reference
from repro_torch.sharding import hints
from repro_torch.sharding.hints import DP

ARCHS = ("qwen1.5-4b", "granite-moe-1b-a400m", "mamba2-1.3b", "zamba2-7b",
         "yi-34b")
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def _env():
    return dict(os.environ, PYTHONPATH=os.path.abspath("src"),
                OMP_NUM_THREADS="1")


_CELLS = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.configs import SHAPES, Shape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, release_mesh
    from repro_torch.sharding import hints
    SHAPES["train_tiny"] = Shape("train_tiny", "train", 32, 8)
    SHAPES["prefill_tiny"] = Shape("prefill_tiny", "prefill", 32, 8)
    shape, axes = json.loads(sys.argv[1])
    arch = sys.argv[2]
    mesh = make_mesh(tuple(shape), tuple(axes))
    cells = []
    for name in ("train_tiny", "prefill_tiny", "decode_32k"):
        knobs = dryrun.cell_knobs(arch, name, "tuned")
        if name == "train_tiny":
            knobs["microbatches"] = 4
        cells.append(dryrun.run_cell(arch, name, False, mesh=mesh,
                                     smoke=True, **knobs))
    release_mesh()
    print(json.dumps({"cells": cells, "redistributions":
                      hints.redistributions,
                      "left": torch.distributed.is_initialized()}))
""")


@pytest.fixture(scope="module", autouse=True)
def tuned_runs():
    """The ten (mesh, arch) subprocesses, started together before the
    module's first test, so they run beside the tests above the cells'
    (the last in the file); ``get(mesh, arch)`` waits for one and returns
    its payload."""
    procs = {(mesh, arch): subprocess.Popen(
        [sys.executable, "-c", _CELLS, json.dumps(MESHES[mesh]), arch],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for mesh in MESHES for arch in ARCHS}
    done = {}

    def get(mesh, arch):
        if (mesh, arch) not in done:
            out, err = procs[(mesh, arch)].communicate(timeout=900)
            assert procs[(mesh, arch)].returncode == 0, err[-3000:]
            done[(mesh, arch)] = json.loads(out.strip().splitlines()[-1])
        return done[(mesh, arch)]

    yield get
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


_LAYER = textwrap.dedent("""
    import dataclasses, json
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import make_mesh, release_mesh
    from repro_torch.models import attention
    from repro_torch.sharding import hints, rules
    from repro_torch.sharding.hints import DP, fitted_spec, mesh_axis_sizes
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-4b"), d_model=16,
                              num_heads=4, num_kv_heads=2, head_dim=4,
                              qkv_bias=False)
    mesh = make_mesh((1, 2), ("data", "model"))
    specs = {"wq": ("data", "model"), "wk": ("data", "model"),
             "wv": ("data", "model"), "wo": ("model", "data")}
    params = attention.init_attention(torch.Generator().manual_seed(0), cfg,
                                      device="meta")
    params = {k: distribute_tensor(v, mesh, rules.to_placements(specs[k],
                                                                mesh))
              for k, v in params.items()}
    rep = [Replicate(), Replicate()]
    x = distribute_tensor(torch.empty((2, 8, 16), device="meta"), mesh, rep)
    with implicit_replication(), hints.use_mesh(mesh):
        with collectives.CollectiveCounter() as counter:
            attention.causal_attention(params, cfg, x, attention="plain")
        stats = collectives.stats(counter)
        moved = dict(hints.redistributions)
        # the logits as the core's twin builds them, on q, k, v as hinted
        q, k, v = attention._project_qkv(
            params, cfg, x, torch.arange(8, device="meta")[None, :])
        qg = q.to(torch.float32).reshape(2, 8, 2, 2, 4)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
        want = rules.to_placements(fitted_spec(
            mesh_axis_sizes(), logits.shape, (DP, None, None, "model", None)),
            mesh)
    out = {"stats": stats, "redistributions": moved,
           "q": [repr(p) for p in q.placements],
           "logits": [repr(p) for p in logits.placements],
           "logits_want": [repr(p) for p in want]}
    release_mesh()
    print(json.dumps(out))
""")


def test_one_attention_layer_counts_what_the_hints_move():
    """One attention layer (B=2, S=8, d=16, 4 heads of 4 over 2 kv heads,
    f32) on a fake (1, 2) ('data', 'model') mesh, x replicated, the
    weights per the rules (wq, wk, wv: columns over 'model'; wo: rows):

    * q = x @ wq comes out with its features over 'model'; the moved q
      hint puts its sequence there (Shard(2) -> Shard(1), an all-to-all,
      which the CPU process group issues as an all-gather of the whole
      q and a chunk): 2*8*16*4 = 1024 bytes;
    * the moved k and v hints replicate their features: 2*8*8*4 = 512
      bytes each;
    * the core's hints then find q, k, v placed (no redistribution), the
      logits come out with their query dim over 'model', as the
      reference's logits hint asks, and the output keeps its sequence
      over 'model' as the reference's output hint asks;
    * the relayout before wo gathers the sequence: 1024 bytes; wo's rows
      over 'model' leave the output a partial sum (no collective).

    4 all-gathers, 3072 bytes; 3 redistributions by hints, 1 by a
    relayout."""
    out = subprocess.run([sys.executable, "-c", _LAYER], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["stats"] == {"total_bytes": 3072,
                                "by_kind": {"all-gather": 3072},
                                "count": {"all-gather": 4}}
    assert payload["redistributions"] == {"hint": 3, "layout": 1}
    assert payload["q"] == ["Replicate()", "Shard(dim=1)"]
    assert payload["logits"] == payload["logits_want"] \
        == ["Replicate()", "Shard(dim=3)"]


# ---------------------------------------------------------------------------
# hint-site parity with the reference
# ---------------------------------------------------------------------------

FAMILIES = ("qwen1.5-4b", "granite-moe-1b-a400m", "mamba2-1.3b",
            "zamba2-7b")
_Q = ((DP, "model", None, None), 4)
_KV = ((DP, None, None, None), 4)
_GROUPS = ((DP, None, None), 3)
_EXPERTS = ((DP, "model", None, None), 4)
_RESIDUAL = ((DP, "model", None), 3)
_OUT5 = ((DP, "model", None, None, None), 5)
# the reference's 13 sites (file, line of the call) -> its (dims, rank)
# there, and the port's (function, dims, rank), or None where the port has
# no such tensor
SITES = {
    ("attention.py", 84): (_Q, ("_causal_core",) + _Q),
    ("attention.py", 85): (_KV, ("_causal_core",) + _KV),
    ("attention.py", 86): (_KV, ("_causal_core",) + _KV),
    # logits: only inside kernel 7 and its twin, which q's layout already
    # places as the reference asks (test above)
    ("attention.py", 94): (((DP, None, None, "model", None), 5), None),
    # the output, hinted on the (B, S, Hkv, G, D) form the port's core
    # does not build: the port hints its (B, S, H, D) output
    ("attention.py", 99): (_OUT5, ("_causal_core",) + _Q),
    # the query blocks of attn_q_chunks > 1: kernel 7 builds no S x S
    # logits, so the port has no blocking
    ("attention.py", 111): (((None, DP, "model", None, None, None), 6),
                            None),
    ("attention.py", 115): (_OUT5, ("_causal_core",) + _Q),
    ("moe.py", 153): (_GROUPS, ("moe_block",) + _GROUPS),
    ("moe.py", 154): (((DP, None, "model", None), 4),
                      ("moe_block", (DP, None, "model", None), 4)),
    ("moe.py", 156): (_EXPERTS, ("moe_block",) + _EXPERTS),
    ("moe.py", 158): (_EXPERTS, ("moe_block",) + _EXPERTS),
    ("moe.py", 160): (_GROUPS, ("moe_block",) + _GROUPS),
    ("transformer.py", 138): (_RESIDUAL, "residual"),  # _residual_site
}
# moved before the (heads, head_dim) split: q's sequence over 'model', k
# and v replicated over it, on the flat projections (every entry point
# that projects q, k, v: in decode the length-1 sequence replicates)
MOVED = {("_project_qkv", (DP, "model", None), 3),
         ("_project_qkv", (DP, None, None), 3)}


def _residual_site(cfg, entry: str):
    """The port's counterpart of the reference's residual hint: at the top
    of each layer of ``backbone`` (dense and MoE: ``_dense_layer``; SSM and
    hybrid: ``_mamba_layer``) and, added, of ``prefill``'s loops."""
    if entry == "prefill":
        return ("prefill",) + _RESIDUAL
    if cfg.family in ("ssm", "hybrid"):
        return ("_mamba_layer",) + _RESIDUAL
    return ("_dense_layer",) + _RESIDUAL


def _recorder(calls: list, *, with_line: bool):
    def record(x, *dims):
        frame = sys._getframe(1)
        where = (os.path.basename(frame.f_code.co_filename), frame.f_lineno) \
            if with_line else frame.f_code.co_name
        calls.append((where, tuple(dims), x.ndim))
        return x
    return record


def _parity_configs(arch):
    jcfg, tcfg = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(
        arch)
    if jcfg.family == "moe":           # the tuned MoE: the hinted path
        jcfg = dataclasses.replace(jcfg, moe_impl="einsum")
        tcfg = dataclasses.replace(tcfg, moe_impl="einsum")
    return jcfg, tcfg


def _record_entries(monkeypatch, modules, mod_tf, cfg, params, inputs,
                    to_array, *, with_line):
    """{entry: the hint calls of forward_logits, prefill and decode_step
    of ``mod_tf`` on ``inputs`` (B, S) ids}, ``hint`` patched in
    ``modules`` by a recorder that returns its input."""
    calls = []
    rec = _recorder(calls, with_line=with_line)
    for mod in modules:
        monkeypatch.setattr(mod, "hint", rec)
    s = inputs.shape[1]
    mod_tf.forward_logits(params, cfg, to_array(inputs))
    forward = len(calls)
    _, cache = mod_tf.prefill(params, cfg, to_array(inputs), max_len=s + 4)
    prefill = len(calls)
    mod_tf.decode_step(params, cfg, to_array(inputs[:, -1:]), cache)
    return {"forward": calls[:forward], "prefill": calls[forward:prefill],
            "decode": calls[prefill:]}


@pytest.mark.parametrize("arch", FAMILIES)
def test_hint_sites_match_the_reference(monkeypatch, arch):
    """Every reference site a smoke forward, prefill or decode of the
    family reaches has its counterpart in the port, and the port calls no
    other hint but the moved flat-projection sites and prefill's residual
    (the reference's prefill scans its own body without the backbone's
    hint); as sets, since the reference traces a scan body once.  Within
    the port the counts tie the sites that share (dims, rank): the core's
    q and output hints, k and v, the MoE's groups and experts."""
    jcfg, tcfg = _parity_configs(arch)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    inputs = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 8))

    jby = _record_entries(monkeypatch, (jattn, jmoe, jtf), jtf, jcfg,
                          jparams, inputs,
                          lambda a: jnp.asarray(a, jnp.int32), with_line=True)
    tby = _record_entries(monkeypatch, (tattn, tmoe, ttf), ttf, tcfg,
                          tparams, inputs,
                          lambda a: torch.as_tensor(a, dtype=torch.int64),
                          with_line=False)
    attention = jcfg.family != "ssm"
    for entry in ("forward", "prefill", "decode"):
        ref_sites = {where for where, _, _ in jby[entry]}
        assert ref_sites <= set(SITES), ref_sites
        want = {SITES[s][1] for s in ref_sites
                if SITES[s][1] not in (None, "residual")}
        if ("transformer.py", 138) in ref_sites or entry == "prefill":
            want.add(_residual_site(tcfg, entry))
        if attention:
            want |= MOVED
        got = set(tby[entry])
        assert got == want, (entry, got ^ want)
        # the reference's own dims at every site it reached
        for where, dims, rank in jby[entry]:
            assert SITES[where][0] == (dims, rank), where
        counts = Counter(tby[entry])
        if ("_causal_core",) + _KV in counts:
            assert counts[("_causal_core",) + _Q] \
                == counts[("_causal_core",) + _KV] \
                == 2 * counts[("_project_qkv", (DP, "model", None), 3)]
        if ("moe_block", (DP, None, "model", None), 4) in counts:
            n = counts[("moe_block", (DP, None, "model", None), 4)]
            assert counts[("moe_block",) + _GROUPS] == 2 * n
            assert counts[("moe_block",) + _EXPERTS] == 2 * n
    # the reference's own sites by entry: the core in forward and prefill,
    # the residual in forward alone, the MoE's everywhere
    fwd = {where for where, _, _ in jby["forward"]}
    assert ("transformer.py", 138) in fwd
    assert ("transformer.py", 138) not in {w for w, _, _ in jby["prefill"]}
    if attention:
        assert {("attention.py", n) for n in (84, 85, 86, 94, 99)} <= fwd
        assert not {w for w, _, _ in jby["decode"]} & {
            ("attention.py", n) for n in (84, 85, 86, 94, 99)}
    if jcfg.family == "moe":
        for entry in ("forward", "prefill", "decode"):
            assert {("moe.py", n) for n in (153, 154, 156, 158, 160)} <= {
                w for w, _, _ in jby[entry]}


def test_every_reference_site_is_accounted_for(monkeypatch):
    """All 13 of the reference's sites are reached (the query blocks with
    ``attn_q_chunks=2``) and each has its entry in ``SITES``; those without
    a port counterpart are the logits and the query blocks alone."""
    seen = set()
    for arch, over in (("qwen1.5-4b", {"attn_q_chunks": 2}),
                       ("qwen1.5-4b", {}),
                       ("granite-moe-1b-a400m", {"moe_impl": "einsum"})):
        cfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **over)
        params = jtf.init_params(cfg, jax.random.PRNGKey(0))
        calls = []
        rec = _recorder(calls, with_line=True)
        for mod in (jattn, jmoe, jtf):
            monkeypatch.setattr(mod, "hint", rec)
        jtf.forward_logits(params, cfg, jnp.zeros((2, 8), jnp.int32))
        seen |= {where for where, _, _ in calls}
    assert seen == set(SITES) and len(SITES) == 13
    assert {s for s, (_, port) in SITES.items() if port is None} == {
        ("attention.py", 94), ("attention.py", 111)}


# ---------------------------------------------------------------------------
# no mesh: the hints change nothing
# ---------------------------------------------------------------------------

def _entry_outputs(cfg, params, inputs):
    """forward_train's loss, forward_logits, prefill's logits and cache and
    two decode steps' logits and cache, on the CPU."""
    s = inputs.shape[1]
    out = {}
    targets = torch.roll(inputs, -1, dims=1)
    loss, metrics = ttf.forward_train(params, cfg, {"inputs": inputs,
                                                    "targets": targets})
    out["loss"], out["ce"] = loss, metrics["ce"]
    out["logits"], _ = ttf.forward_logits(params, cfg, inputs)
    last, cache = ttf.prefill(params, cfg, inputs, max_len=s + 4)
    out["prefill"] = last
    for step in range(2):
        tok = torch.argmax(last[:, -1], dim=-1)[:, None]
        before = cache
        last, cache = ttf.decode_step(params, cfg, tok, cache)
        # the plain branch writes the cache in place
        for name in ("kv_k", "ssm_state"):
            if getattr(before, name) is not None:
                assert getattr(cache, name) is getattr(before, name)
        out[f"decode{step}"] = last
    for name in ("kv_k", "kv_v", "ssm_state", "ssm_conv"):
        if getattr(cache, name) is not None:
            out[name] = getattr(cache, name)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_no_mesh_entry_points_are_bitwise_unhinted(monkeypatch, arch):
    """With no mesh active, and with ``REPRO_NO_HINTS=1``, every ``hint``
    and ``relayout`` the model code calls returns its input object, the
    redistribution counts stay 0, and forward_train, forward_logits,
    prefill and decode_step return bitwise what they return with hint and
    relayout replaced by the identity (the model code without them)."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                              compute_dtype="float32")
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_impl="einsum")
    params = ttf.init_params(cfg, 0, device="cpu")
    inputs = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)), dtype=torch.int64)
    real_hint, real_relayout = hints.hint, hints.relayout
    seen = Counter()

    def checked(real, name):
        def fn(x, *dims):
            out = real(x, *dims)
            assert out is x
            seen[name] += 1
            return out
        return fn

    identity = {"hint": lambda x, *dims: x, "relayout": lambda x, *dims: x}
    runs = {}
    for mode in ("identity", "no mesh", "REPRO_NO_HINTS"):
        for mod in (tattn, tmoe, ttf):
            for name, real in (("hint", real_hint),
                               ("relayout", real_relayout)):
                if hasattr(mod, name):
                    monkeypatch.setattr(
                        mod, name, identity[name] if mode == "identity"
                        else checked(real, name))
        if mode == "REPRO_NO_HINTS":
            monkeypatch.setenv("REPRO_NO_HINTS", "1")
        hints.reset_redistributions()
        runs[mode] = _entry_outputs(cfg, params, inputs)
        assert hints.redistributions == {"hint": 0, "layout": 0}
        monkeypatch.delenv("REPRO_NO_HINTS", raising=False)
    assert seen["hint"] > 0 and seen["relayout"] > 0
    for mode in ("no mesh", "REPRO_NO_HINTS"):
        assert runs[mode].keys() == runs["identity"].keys()
        for key, want in runs["identity"].items():
            assert torch.equal(runs[mode][key], want), (mode, key)


_ONE_RANK = textwrap.dedent("""
    import dataclasses, json, os, sys, tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.sharding import hints, rules
    from repro_torch.training.train_step import (TrainHyper,
                                                 init_train_state,
                                                 make_train_step)
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    arch = sys.argv[1]
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              compute_dtype="float32")
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_impl="einsum")
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (4, 8), generator=gen)
    params = init_params(cfg, 0, device="cpu")

    def serve(p, toks):
        last, cache = prefill(p, cfg, toks, max_len=12)
        outs = [last]
        for _ in range(2):
            tok = torch.argmax(last[:, -1], dim=-1)[:, None]
            last, cache = decode_step(p, cfg, tok, cache)
            outs.append(last)
        return outs + [t for t in cache[:4] if t is not None]

    def train(state, batch):
        step = make_train_step(cfg, TrainHyper(microbatches=2))
        new, metrics = step(state, batch)
        return [metrics["loss"], metrics["grad_norm"]] + [
            leaf for _, leaf in rules.leaves(new.params)]

    batch = {"inputs": tokens, "targets": torch.roll(tokens, -1, 1)}
    plain = serve(params, tokens) + train(init_train_state(cfg, 0, "cpu"),
                                          batch)
    p_specs = rules.param_specs(cfg, mesh, params)
    state = init_train_state(cfg, 0, "cpu")
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), hints.use_mesh(mesh):
        d_params = dryrun.distribute(params, p_specs, mesh)
        d_tokens = dryrun.distribute({"t": tokens}, {"t": ("data", None)},
                                     mesh)["t"]
        d_state = dryrun.distribute(state, rules.state_specs(cfg, mesh,
                                                             state), mesh)
        d_batch = dryrun.distribute(batch, rules.batch_specs(cfg, mesh,
                                                              batch), mesh)
        meshed = serve(d_params, d_tokens) + train(d_state, d_batch)
    meshed = [t.full_tensor() if isinstance(t, DTensor) else t
              for t in meshed]
    diff = [float((a - b).abs().max()) for a, b in zip(plain, meshed)]
    print(json.dumps({"n": len(plain), "m": len(meshed), "diff": diff,
                      "layout": hints.redistributions["layout"]}))
    dist.destroy_process_group()
""")


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_branches_compute_the_plain_function(arch):
    """On a one-rank ('data', 'model') mesh of real CPU tensors (gloo),
    prefill, two decode steps and a train step of 2 microbatches, under
    ``use_mesh``, take the mesh branches (the cache stacked and written
    out of place, decode attention per head shard, the microbatch split
    through a relayout) and return what the plain run returns."""
    out = subprocess.run([sys.executable, "-c", _ONE_RANK, arch],
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["n"] == payload["m"]
    assert payload["layout"] > 0
    np.testing.assert_array_less(payload["diff"], 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tuned_smoke_cells_count_their_collectives(tuned_runs, mesh, arch):
    """``run_cell`` in tuned mode (4 microbatches for the train step) on
    the smoke config: train, prefill and decode are ``OK`` and count
    their collectives, each count the sum of its kinds; the hints acted
    (redistributions) and so did the microbatch split and the MoE's token
    flatten or the norms' sequence gather (relayouts)."""
    payload = tuned_runs(mesh, arch)
    assert not payload["left"]
    cells = {c["shape"]: c for c in payload["cells"]}
    assert list(cells) == ["train_tiny", "prefill_tiny", "decode_32k"]
    for shape, cell in cells.items():
        assert cell["status"] == "OK", cell
        assert cell["mesh"] == mesh and cell["chips"] == 8
        assert cell["collective_reason"] is None, cell["collective_reason"]
        assert cell["collective_bytes_per_chip"] is not None
        assert cell["collective_bytes_per_chip"] == sum(
            cell["collective_by_kind"].values()) > 0, (shape, cell)
    assert cells["train_tiny"]["microbatches"] == 4
    # a sharded train step gathers weights and scatters gradients
    assert {"all-gather", "reduce-scatter"} <= set(
        cells["train_tiny"]["collective_by_kind"])
    assert payload["redistributions"]["hint"] > 0
    assert payload["redistributions"]["layout"] > 0
