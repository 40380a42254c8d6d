"""The port's training slice against the reference, on the CPU: synthetic
data, AdamW and its schedules, ``forward_train`` and its gradients, the
train step with microbatching and router statistics, checkpoints and
restart, int8 gradient compression, and the train and serve drivers.

Both packages start from one state: the reference's
``init_params``/``init_train_state`` converted by
:func:`repro_torch.models.convert.params_from_reference` and
``train_state_from_reference``.  Budgets: synthetic data, int8
compression, checkpoints and restarts bitwise; schedules within 1e-7;
``adamw_update`` within 1e-6 relative to each leaf's largest value; ``forward_train``'s loss within 1e-5
relative and every gradient leaf within 1e-4 of its largest magnitude
(observed 6e-7 to 4e-6: the forward runs the kernels' twins, the
gradient the reference's formulas, in f32); training steps within the
reference's own budget between microbatchings, rtol 5e-3 and atol 5e-4
(``tests/test_training.py``); router statistics within 1e-5.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.training import checkpoint as jcheckpoint
from repro.training import compression as jcomp
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_step as jstep
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models.convert import (params_from_reference,
                                        train_state_from_reference)
from repro_torch.training import checkpoint, compression
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tstep
from repro_torch.training.tree import flatten, map_tree

torch.set_num_threads(1)

GRAD_ARCHS = ["qwen1.5-4b", "granite-moe-1b-a400m", "mamba2-1.3b",
              "zamba2-7b", "musicgen-medium"]
STEP_TOL = dict(rtol=5e-3, atol=5e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _data_cfgs(jcfg, seq_len=32, global_batch=4):
    kw = dict(vocab_size=jcfg.vocab_size, seq_len=seq_len,
              global_batch=global_batch, input_kind=jcfg.input_kind,
              d_model=jcfg.d_model)
    return jdata.SyntheticDataConfig(**kw), tdata.SyntheticDataConfig(**kw)


def _batch_pair(jcfg, step, **kw):
    jd, td = _data_cfgs(jcfg, **kw)
    return jdata.synthetic_batch(jd, step), tdata.synthetic_batch(
        td, step, device="cpu")


def _state_pair(arch):
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    jstate = jstep.init_train_state(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jstate, train_state_from_reference(_np(jstate),
                                                          device="cpu")


def _leafwise(got_tree, want_tree, check):
    """``check(path, got, want)`` on the port's leaves against the
    reference's tree converted to the port's layout."""
    paths, got = flatten(got_tree)
    _, want = flatten(want_tree)
    assert len(got) == len(want)
    for path, g, w in zip(paths, got, want):
        check(path, g.detach().float().numpy(), w.float().numpy())


def _close_tree(got, want_ref, **tol):
    def check(path, g, w):
        np.testing.assert_allclose(g, w, err_msg=path, **tol)
    _leafwise(got, params_from_reference(_np(want_ref), device="cpu"), check)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["tokens", "embeddings"])
@pytest.mark.parametrize("step", [0, 7])
def test_synthetic_batch_bitwise(kind, step):
    kw = dict(vocab_size=64, seq_len=16, global_batch=4, seed=3,
              input_kind=kind, d_model=32 if kind == "embeddings" else 0)
    want = jdata.synthetic_batch(jdata.SyntheticDataConfig(**kw), step)
    got = tdata.synthetic_batch(tdata.SyntheticDataConfig(**kw), step,
                                device="cpu")
    assert set(got) == set(want)
    for name in want:
        w = np.asarray(want[name])
        g = got[name].numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), name


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------

def test_schedules_match_reference():
    steps = np.arange(0, 1000, dtype=np.int32)
    cos_j = np.asarray(jax.vmap(lambda s: jopt.cosine_schedule(
        s, peak_lr=1e-3, warmup=100, total=1000))(jnp.asarray(steps)))
    cos_t = topt.cosine_schedule(torch.from_numpy(steps), peak_lr=1e-3,
                                 warmup=100, total=1000).numpy()
    wsd_j = np.asarray(jax.vmap(lambda s: jopt.wsd_schedule(
        s, peak_lr=1e-3, warmup=50, stable=700, decay=100))(
            jnp.asarray(steps)))
    wsd_t = topt.wsd_schedule(torch.from_numpy(steps), peak_lr=1e-3,
                              warmup=50, stable=700, decay=100).numpy()
    for got, want in ((cos_t, cos_j), (wsd_t, wsd_j)):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    # a scalar step, as the train step passes it
    lr = topt.cosine_schedule(torch.tensor(5, dtype=torch.int32),
                              peak_lr=3e-4, warmup=2, total=20)
    want = jopt.cosine_schedule(jnp.int32(5), peak_lr=3e-4, warmup=2,
                                total=20)
    assert abs(float(lr) - float(want)) <= 1e-7


@pytest.mark.parametrize("arch", ["zamba2-7b", "granite-moe-1b-a400m"])
def test_adamw_update_matches_reference(arch):
    """Two updates of random gradients on a converted state: params and
    moments within 1e-6 of each leaf's largest magnitude, the global norm
    within 1e-6 relative."""
    _, _, jstate, tstate = _state_pair(arch)
    rng = np.random.default_rng(5)
    jparams, jo = jstate.params, jstate.opt
    tparams, to = tstate.params, tstate.opt
    update = jax.jit(jopt.adamw_update)
    for lr in (1e-3, 3e-4):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
            p.shape).astype(np.float32)).astype(p.dtype), jparams)
        jparams, jo, jn = update(grads, jo, jparams, jnp.float32(lr))
        tparams, to, tn = topt.adamw_update(
            params_from_reference(_np(grads), device="cpu"), to, tparams,
            torch.tensor(lr, dtype=torch.float32))
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    def check(path, g, w):
        # relative to the leaf: an entry near zero has no relative digits
        bound = 1e-6 * float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= bound, path
    for got, want in ((tparams, jparams), (to.mu, jo.mu), (to.nu, jo.nu)):
        _leafwise(got, params_from_reference(_np(want), device="cpu"), check)
    assert int(to.count) == int(jo.count) == 2


def test_adamw_decays_what_the_reference_decays():
    """The reference decays a leaf of ndim >= 2 in its stacked tree: every
    per-layer leaf (norms, A_log, dt_bias, D included), no top-level or
    shared-block vector."""
    _, _, jstate, tstate = _state_pair("zamba2-7b")
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate.params)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.ndim >= 2
            for path, leaf in flat}
    paths, leaves = flatten(tstate.params)
    got = {}
    for path, leaf in zip(paths, leaves):
        parts = path.split("/")
        ref = "/".join(parts[:1] + parts[2:]) if parts[0] == "blocks" \
            else path
        got.setdefault(ref, set()).add(topt.decays(path, leaf))
    assert got == {name: {flag} for name, flag in want.items()}
    by_name = dict(zip(paths, leaves))
    for name in ("blocks/0/norm", "blocks/1/ssm/A_log", "blocks/0/ssm/D",
                 "blocks/0/ssm/dt_bias", "blocks/0/ssm/gate_norm",
                 "shared/attn/wq", "embed"):
        assert topt.decays(name, by_name[name]), name
    for name in ("final_norm", "shared/attn_norm", "shared/ffn_norm"):
        assert not topt.decays(name, by_name[name]), name


def test_gradient_clipping_engages():
    params = {"w": torch.ones((4, 4))}
    opt = topt.adamw_init(params)
    huge = {"w": torch.full((4, 4), 1e6)}
    new_p, _, gnorm = topt.adamw_update(huge, opt, params, lr=1e-3,
                                        clip_norm=1.0)
    assert float(gnorm) == pytest.approx(4e6)
    # a clipped first step moves each entry by lr * (1 + wd)
    np.testing.assert_allclose(new_p["w"].numpy(), 1 - 1e-3 * 1.1,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# forward_train and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_forward_train_loss_and_grads_match_reference(arch):
    """Loss within 1e-5 relative, metrics within 1e-5, every gradient leaf
    within 1e-4 x its largest magnitude of ``jax.value_and_grad``; the
    twins' autograd (``attention``/``ssm="plain"``) gives the same."""
    jcfg, tcfg, jstate, tstate = _state_pair(arch)
    jb, tb = _batch_pair(jcfg, 0, global_batch=2)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jtf.forward_train(p, jcfg, jb), has_aux=True)(jstate.params)
    want = params_from_reference(_np(jg), device="cpu")
    for path in ("kernel", "plain"):
        tl, tm, tg = tstep.value_and_grad(tstate.params, tcfg, tb,
                                          attention=path, ssm=path)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
        for name in ("ce", "aux_loss", "expert_load", "coactivation"):
            np.testing.assert_allclose(tm[name].numpy(),
                                       np.asarray(jm[name]), rtol=1e-5,
                                       atol=1e-5, err_msg=name)

        def check(name, g, w):
            bound = 1e-4 * max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= bound, name
        _leafwise(tg, want, check)


def test_forward_train_mask_and_twin_free_kernel_path():
    """A mask weights the mean cross-entropy as the reference's does; the
    kernel path's forward is the adapter (the twin on the CPU) and its
    backward calls no twin."""
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import ssd_scan as S8
    from repro_torch.models import transformer as ttf
    jcfg, tcfg, jstate, tstate = _state_pair("zamba2-7b")
    jb, tb = _batch_pair(jcfg, 1, global_batch=2)
    mask = (np.arange(32)[None, :] < np.array([[20], [32]])).astype(
        np.float32)
    jb = dict(jb, mask=jnp.asarray(mask))
    tb = dict(tb, mask=torch.from_numpy(mask))
    jl, _ = jtf.forward_train(jstate.params, jcfg, jb)
    params = map_tree(lambda p: p.detach().requires_grad_(True),
                      tstate.params)
    F.reset_launches()
    S8.reset_launches()
    tl, _ = ttf.forward_train(params, tcfg, tb)
    forward_twins = (F.twin_calls["flash_attention_twin"],
                     S8.twin_calls["ssd_scan_twin"])
    tl.backward()
    # remat: each layer's forward runs again in the backward
    assert (F.twin_calls["flash_attention_twin"],
            S8.twin_calls["ssd_scan_twin"]) == tuple(
                2 * n for n in forward_twins)
    assert forward_twins == (tcfg.attention_layers, tcfg.num_layers)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))


def test_ssd_gradients_stay_finite_where_the_reference_overflows():
    """At Mamba2's real decays a chunk's cumulative decay passes exp's
    range: the reference's ``where(causal, exp(seg), 0)`` then gives NaN
    gradients for dt and a (0 * inf in the masked triangle).  The port's
    ``ssd_chunked`` and kernel 8's twin mask before the exp: the same
    forward (against the reference's within 1e-5), finite gradients, the
    two formulations' gradients within 1e-3 of each other."""
    from repro.models import ssm as jssm
    from repro_torch.kernels.ssd_scan import ssd_scan_twin
    from repro_torch.models import ssm as tssm
    rng = np.random.default_rng(0)
    b, seq, h, p, n = 1, 128, 2, 4, 3
    x = rng.standard_normal((b, seq, h, p)).astype(np.float32)
    dt = rng.uniform(0.5, 1.0, (b, seq, h)).astype(np.float32)
    a = -rng.uniform(8, 16, h).astype(np.float32)
    bm = rng.standard_normal((b, seq, n)).astype(np.float32)
    cm = rng.standard_normal((b, seq, n)).astype(np.float32)
    args = (x, dt, a, bm, cm)

    def ref_loss(*t):
        y, state = jssm.ssd_chunked(*t, 64)
        return jnp.sum(y ** 2) + jnp.sum(state)
    ref = jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, args))
    assert not all(np.isfinite(np.asarray(g)).all() for g in ref)
    grads, ys = [], []
    for scan in (tssm.ssd_chunked, ssd_scan_twin):
        inputs = [torch.from_numpy(v).requires_grad_(True) for v in args]
        y, state = scan(*inputs, 64)
        (torch.sum(y ** 2) + torch.sum(state)).backward()
        grads.append([t.grad for t in inputs])
        ys.append(y.detach())
    jy, _ = jssm.ssd_chunked(*map(jnp.asarray, args), 64)
    np.testing.assert_allclose(ys[0].numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for g1, g2 in zip(*grads):
        assert bool(torch.isfinite(g1).all() and torch.isfinite(g2).all())
        assert float((g1 - g2).abs().max()) <= 1e-3 * float(g2.abs().max())


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _run_reference(jcfg, jstate, steps, hyper):
    fn = jax.jit(jstep.make_train_step(jcfg, hyper))
    jd, _ = _data_cfgs(jcfg)
    metrics = []
    for i in range(steps):
        jstate, m = fn(jstate, jdata.synthetic_batch(jd, i))
        metrics.append({k: float(v) for k, v in m.items()})
    return jstate, metrics


def _run_port(tcfg, jcfg, tstate, steps, hyper):
    fn = tstep.make_train_step(tcfg, tstep.TrainHyper(**hyper))
    _, td = _data_cfgs(jcfg)
    metrics = []
    for i in range(steps):
        tstate, m = fn(tstate, tdata.synthetic_batch(td, i, device="cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return tstate, metrics


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "granite-moe-1b-a400m",
                                  "mamba2-1.3b"])
def test_train_step_five_steps_match_reference(arch):
    """Five steps from one state: params, moments and every metric within
    the reference's budget, the step count exact, and the router EMA
    statistics within 1e-5."""
    hyper = dict(total_steps=20, warmup=2)
    jcfg, tcfg, jstate, tstate = _state_pair(arch)
    jstate, jm = _run_reference(jcfg, jstate, 5, jstep.TrainHyper(**hyper))
    tstate, tm = _run_port(tcfg, jcfg, tstate, 5, hyper)
    for got, want in zip(tm, jm):
        for name in want:
            assert got[name] == pytest.approx(want[name], rel=5e-3,
                                              abs=5e-4), name
    _close_tree(tstate.params, jstate.params, **STEP_TOL)
    _close_tree(tstate.opt.mu, jstate.opt.mu, **STEP_TOL)
    assert int(tstate.step) == int(jstate.step) == 5
    assert int(tstate.opt.count) == 5
    for name in ("expert_load", "coactivation"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    if tcfg.num_experts:
        assert float(tstate.expert_load.sum()) > 0
        assert tstate.coactivation.shape == (tcfg.num_experts,) * 2


def test_microbatching_matches_full_batch_and_reference():
    """Four microbatches against one full batch, and against the
    reference's four, within its budget."""
    jcfg, tcfg, jstate, tstate = _state_pair("qwen1.5-4b")
    jb, tb = _batch_pair(jcfg, 0)
    hyper = dict(total_steps=20, warmup=2)
    step1 = tstep.make_train_step(tcfg, tstep.TrainHyper(**hyper))
    step4 = tstep.make_train_step(tcfg, tstep.TrainHyper(microbatches=4,
                                                         **hyper))
    s1, m1 = step1(tstate, tb)
    s4, m4 = step4(tstate, tb)
    j4, jm4 = jax.jit(jstep.make_train_step(
        jcfg, jstep.TrainHyper(microbatches=4, **hyper)))(jstate, jb)
    p1, l1 = flatten(s1.params)
    _, l4 = flatten(s4.params)
    for path, a, b in zip(p1, l4, l1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=path,
                                   **STEP_TOL)
    _close_tree(s4.params, j4.params, **STEP_TOL)
    assert float(m4["loss"]) == pytest.approx(float(jm4["loss"]), rel=1e-5)
    assert float(m4["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)


def test_loss_decreases_on_learnable_data():
    cfg = tconfigs.get_smoke_config("qwen1.5-4b")
    state = tstep.init_train_state(cfg, 0, device="cpu")
    fn = tstep.make_train_step(cfg, tstep.TrainHyper(total_steps=20,
                                                     warmup=2))
    data = tdata.SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                     global_batch=4)
    ce = []
    for i in range(15):
        state, m = fn(state, tdata.synthetic_batch(data, i, device="cpu"))
        ce.append(float(m["ce"]))
    assert ce[-1] < ce[0] - 0.1, ce


# ---------------------------------------------------------------------------
# checkpoints and restart
# ---------------------------------------------------------------------------

def _equal_states(a, b):
    pa, la = flatten(a)
    pb, lb = flatten(b)
    assert pa == pb
    for path, x, y in zip(pa, la, lb):
        assert x.dtype == y.dtype and x.device == y.device, path
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16
                           else y), path


def test_checkpoint_roundtrip_bitwise_bf16_leaves(tmp_path):
    cfg = dataclasses.replace(tconfigs.get_smoke_config("zamba2-7b"),
                              param_dtype="bfloat16")
    state = tstep.init_train_state(cfg, 0, device="cpu")
    assert flatten(state.params)[1][0].dtype == torch.bfloat16
    path = checkpoint.save(str(tmp_path), 3, state)
    assert os.path.exists(os.path.join(path, "manifest.json"))
    fresh = tstep.init_train_state(cfg, 1, device="cpu")
    restored, at = checkpoint.restore(str(tmp_path), fresh)
    assert at == 3
    _equal_states(restored, state)
    # the params alone, as the serve driver reads them
    params, at = checkpoint.restore(str(tmp_path), fresh.params,
                                    prefix="params")
    assert at == 3
    _equal_states(params, state.params)


def test_latest_step_and_atomicity(tmp_path):
    cfg = tconfigs.get_smoke_config("qwen1.5-4b")
    state = tstep.init_train_state(cfg, 0, device="cpu")
    assert checkpoint.latest_step(str(tmp_path)) is None
    assert checkpoint.restore(str(tmp_path), state) == (None, None)
    checkpoint.save(str(tmp_path), 1, state)
    checkpoint.save(str(tmp_path), 5, state)
    # a stale tmp dir from a crashed save must be ignored
    os.makedirs(os.path.join(str(tmp_path), ".tmp_save_crashed"))
    # an incomplete step dir (no manifest) must be ignored
    os.makedirs(os.path.join(str(tmp_path), "step_00000009"))
    assert checkpoint.latest_step(str(tmp_path)) == 5
    _, at = checkpoint.restore(str(tmp_path), state)
    assert at == 5


def test_restore_rejects_structure_mismatch(tmp_path):
    cfg = tconfigs.get_smoke_config("qwen1.5-4b")
    state = tstep.init_train_state(cfg, 0, device="cpu")
    checkpoint.save(str(tmp_path), 1, state)
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(str(tmp_path), {"different": torch.zeros(3)})
    other = tstep.init_train_state(
        tconfigs.get_smoke_config("mamba2-1.3b"), 0, device="cpu")
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(str(tmp_path), other)


def test_manifest_has_the_reference_layout(tmp_path):
    """``step_<n:08d>/arrays.npz`` + ``manifest.json`` with the
    reference's keys; the reference's own checkpoint of the same state
    holds the same arrays (numpy has no bfloat16 in either)."""
    jcfg, _, jstate, tstate = _state_pair("qwen1.5-4b")
    port = checkpoint.save(str(tmp_path / "port"), 2, tstate)
    ref = jcheckpoint.save(str(tmp_path / "ref"), 2, jstate)
    assert os.path.basename(port) == os.path.basename(ref) == "step_00000002"
    import json
    mp = json.load(open(os.path.join(port, "manifest.json")))
    mr = json.load(open(os.path.join(ref, "manifest.json")))
    assert set(mp) == set(mr) and mp["step"] == mr["step"] == 2
    assert len(mp["paths"]) > len(mr["paths"])    # one entry a layer
    assert "params/blocks/0/attn/wq" in mp["paths"]


def test_restart_is_bitwise_identical(tmp_path):
    """Train 4 steps straight vs train 2, checkpoint, restore into a fresh
    state, train 2 more: identical state, moments and statistics
    included."""
    cfg = tconfigs.get_smoke_config("granite-moe-1b-a400m")
    fn = tstep.make_train_step(cfg, tstep.TrainHyper(total_steps=20,
                                                     warmup=2))
    data = tdata.SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                     global_batch=4)
    state0 = tstep.init_train_state(cfg, 0, device="cpu")
    state = state0
    for i in range(4):
        state, _ = fn(state, tdata.synthetic_batch(data, i, device="cpu"))
    straight = state
    state = state0
    for i in range(2):
        state, _ = fn(state, tdata.synthetic_batch(data, i, device="cpu"))
    checkpoint.save(str(tmp_path), 2, state)
    state, at = checkpoint.restore(str(tmp_path), state0)
    assert at == 2
    for i in range(2, 4):
        state, _ = fn(state, tdata.synthetic_batch(data, i, device="cpu"))
    _equal_states(state, straight)


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_bitwise_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(1000) * 10 ** rng.uniform(-3, 3)).astype(
        np.float32)
    x[:7] = [0.5, -0.5, 1.5, 2.5, -2.5, 0.0, -0.0]
    qj, sj = jcomp.compress_int8(jnp.asarray(x))
    qt, st = compression.compress_int8(torch.from_numpy(x))
    assert qt.dtype == torch.int8
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert st.numpy().tobytes() == np.asarray(sj).tobytes()
    back_t = compression.decompress_int8(qt, st).numpy()
    back_j = np.asarray(jcomp.decompress_int8(qj, sj))
    assert back_t.tobytes() == back_j.tobytes()
    assert float(np.max(np.abs(back_t - x))) <= float(st) * 0.5 + 1e-7
    # half-way values round to even in both
    q, _ = compression.compress_int8(torch.tensor([127.0, 0.5, 1.5, 2.5]))
    assert q.tolist() == [127, 0, 2, 2]


def _reference_psum(grads, errors):
    def one_round(g, e):
        return jcomp.compressed_psum({"g": g}, "dp", {"g": e})
    out, new_e = jax.vmap(one_round, axis_name="dp")(
        jnp.asarray(grads), jnp.asarray(errors))
    return np.asarray(out["g"]), np.asarray(new_e["g"])


def test_compressed_psum_group_of_one(tmp_path):
    import torch.distributed as dist
    rng = np.random.default_rng(1)
    g = rng.standard_normal((1, 256)).astype(np.float32)
    e = (rng.standard_normal((1, 256)) * 1e-3).astype(np.float32)
    want, want_e = _reference_psum(g, e)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        grads = {"g": torch.from_numpy(g[0])}
        errors = compression.init_errors(grads)
        assert torch.equal(errors["g"], torch.zeros(256))
        out, new_e = compression.compressed_psum(
            grads, {"g": torch.from_numpy(e[0])})
    finally:
        dist.destroy_process_group()
    assert out["g"].numpy().tobytes() == want[0].tobytes()
    assert new_e["g"].numpy().tobytes() == want_e[0].tobytes()


_RANK = textwrap.dedent("""
    import sys
    import numpy as np, torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    from repro_torch.training.compression import compressed_psum
    rng = np.random.default_rng(1)
    grads = rng.standard_normal((world, 256)).astype(np.float32)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        e = {"g": torch.zeros(256)}
        means = []
        for _ in range(3):
            mean, e = compressed_psum({"g": torch.from_numpy(grads[rank])},
                                      e)
            means.append(mean["g"].numpy())
    finally:
        dist.destroy_process_group()
    np.savez(out, means=np.stack(means), error=e["g"].numpy())
""")


def test_compressed_psum_four_gloo_ranks(tmp_path):
    """4 ranks meeting on a ``FileStore``: three rounds of error-feedback
    compression, each rank's mean against the reference's ``vmap`` with an
    axis name (the 4-term sum within f32 rounding of its order), each
    rank's error bitwise."""
    world = 4
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world), store,
         str(tmp_path / f"rank{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), errs
    grads = np.random.default_rng(1).standard_normal((world, 256)).astype(
        np.float32)
    e = np.zeros((world, 256), np.float32)
    want = []
    for _ in range(3):
        mean, e = _reference_psum(grads, e)
        want.append(mean)
    true_mean = grads.mean(axis=0)
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        for i in range(3):
            np.testing.assert_allclose(got["means"][i], want[i][r],
                                       rtol=1e-6, atol=1e-7)
        assert got["error"].tobytes() == e[r].tobytes()
        np.testing.assert_allclose(got["means"][0], true_mean, atol=2e-2)


# ---------------------------------------------------------------------------
# the train and serve drivers
# ---------------------------------------------------------------------------

def test_train_driver_resumes_bitwise(tmp_path, capsys):
    """A run with checkpoints every 2 steps; its step-4 checkpoint taken
    away, a fresh ``train`` on the directory resumes at step 2 and ends on
    the uninterrupted run's state, bitwise (replans at steps 2 and 4)."""
    kw = dict(steps=4, global_batch=4, seq_len=32, replan=2, groups=2,
              log_every=1, device="cpu")
    d = str(tmp_path / "ckpt")
    straight, losses = tlaunch.train("granite-moe-1b-a400m", ckpt_dir=d,
                                     ckpt_every=2, **kw)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert checkpoint.latest_step(d) == 4
    os.rename(os.path.join(d, "step_00000004"), str(tmp_path / "step4"))
    resumed, tail = tlaunch.train("granite-moe-1b-a400m", ckpt_dir=d,
                                  ckpt_every=100, **kw)
    out = capsys.readouterr().out
    assert "[train] resumed from checkpoint step 2" in out
    assert "[planner] step=2 expert rebalance" in out
    assert tail == losses[2:]
    _equal_states(resumed, straight)


def test_train_cli_on_the_cpu(capsys):
    tlaunch.main(["--arch", "mamba2-1.3b", "--steps", "3", "--batch", "2",
                  "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step=0 loss=" in out and "[train] step=2 loss=" in out
    assert "3 steps in" in out


def test_serve_from_a_training_checkpoint(tmp_path, capsys, monkeypatch):
    """Train 2 steps with a checkpoint, then serve from it (the function
    and the CLI): the engine gets the trained params, bitwise."""
    d = str(tmp_path / "ckpt")
    state, _ = tlaunch.train("qwen1.5-4b", steps=2, global_batch=2,
                             seq_len=16, ckpt_dir=d, ckpt_every=2,
                             device="cpu")
    served = []

    class Engine(tserve.ServingEngine):
        def __init__(self, cfg, params, *args, **kwargs):
            served.append(params)
            super().__init__(cfg, params, *args, **kwargs)

    monkeypatch.setattr(tserve, "ServingEngine", Engine)
    stats = tserve.serve("qwen1.5-4b", requests=3, max_new=4, slots=2,
                         max_len=64, ckpt_dir=d, device="cpu")
    assert "[serve] loaded checkpoint step 2" in capsys.readouterr().out
    assert stats["generated_tokens"] == 12
    tserve.main(["--arch", "qwen1.5-4b", "--requests", "2", "--max-new",
                 "2", "--ckpt-dir", d, "--device", "cpu"])
    assert "[serve] loaded checkpoint step 2" in capsys.readouterr().out
    assert len(served) == 2
    for params in served:
        _equal_states(params, state.params)
