"""The port's LM stack against the reference: layers, the parameter
converter, and forward / prefill / decode on the smoke configs of the
five dense variants (qkv bias; tied embeddings with multipliers; MQA; GQA
with G=4; embedding inputs), of mamba2 (the SSM family), of
granite-moe-1b-a400m and qwen3-moe-235b-a22b (the MoE family: prefill
and forward drop tokens at the configs' capacities 1.5 and 1.25, decode
is dropless) and of zamba2 (the hybrid: Mamba2 layers and a shared
attention+MLP block after every second layer).

Weights come from the reference's ``init_params(cfg, PRNGKey(0))``,
converted by :func:`repro_torch.models.convert.params_from_reference`;
other inputs from ``numpy.random.default_rng``.  The smoke configs compute
in f32, where the port's attention kernels (twins on the CPU) and the
reference's jnp attention differ only by rounding: logits are held at
rtol = atol = 1e-4 (observed differences ~4e-6 on logits of magnitude ~4).
Within the port, decode against the teacher-forced forward at 1e-4 too
(the reference holds its own at 2e-2).  Layers at 1e-6 (norm, RoPE
frequencies) to 1e-5 (RoPE, SwiGLU; SwiGLU atol 1e-4 on outputs up to
~90).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import param_count, params_from_reference

DENSE_VARIANTS = ["qwen1.5-4b", "minicpm-2b", "granite-34b",
                  "chameleon-34b", "musicgen-medium"]
MOE_AND_HYBRID = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b", "zamba2-7b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _models(arch):
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    return jcfg, jparams, tcfg, tparams


def _inputs(cfg, b, t, seed):
    """Token ids (int32 for JAX, int64 for torch) or frame embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "embeddings":
        x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
        return jnp.asarray(x), torch.from_numpy(x)
    ids = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    return jnp.asarray(ids), torch.from_numpy(ids.astype(np.int64))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# layers and configs
# ---------------------------------------------------------------------------

def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    _close(tlayers.rms_norm(tx, tw, 1e-5),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), rtol=1e-6,
           atol=1e-6)
    _close(tlayers.rope_frequencies(16, 10_000.0),
           jlayers.rope_frequencies(16, 10_000.0), rtol=1e-6, atol=0)
    pos = np.asarray([[0, 3, 7, 100, 4095]])
    _close(tlayers.apply_rope(tx, torch.from_numpy(pos), 1e6),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6),
           rtol=1e-5, atol=1e-5)
    per_slot = np.asarray([[17], [4100]])        # (B, 1), as decode passes
    _close(tlayers.apply_rope(tx[:, :1], torch.from_numpy(per_slot), 1e4),
           jlayers.apply_rope(jnp.asarray(x[:, :1]), jnp.asarray(per_slot),
                              1e4), rtol=1e-5, atol=1e-5)
    g, u = (rng.standard_normal((16, 24)).astype(np.float32) for _ in "gu")
    dw = rng.standard_normal((24, 16)).astype(np.float32)
    _close(tlayers.swiglu(tx, *map(torch.from_numpy, (g, u, dw))),
           jlayers.swiglu(jnp.asarray(x), *map(jnp.asarray, (g, u, dw))),
           rtol=1e-5, atol=1e-4)         # outputs up to ~90


def test_config_modules_are_the_references():
    for arch in jconfigs.all_archs():
        for get in ("get_config", "get_smoke_config"):
            jc = getattr(jconfigs, get)(arch)
            tc = getattr(tconfigs, get)(arch)
            assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
            assert tc.param_count() == jc.param_count()
    assert tconfigs.get_config("qwen1.5-4b").cdtype() == torch.bfloat16
    assert tconfigs.get_config("qwen1.5-4b").pdtype() == torch.float32


@pytest.mark.parametrize("arch", DENSE_VARIANTS + ["yi-34b", "mamba2-1.3b"]
                         + MOE_AND_HYBRID)
def test_converted_params_keep_param_count(arch):
    """Every leaf of the reference's tree lands under its name (layer 1 of
    the stacked blocks, the hybrid's shared block as it is); the count is
    the config's, plus the shared block's for a hybrid."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    assert len(tparams["blocks"]) == tcfg.num_layers
    count = tcfg.param_count() + tcfg.shared_block_params()
    assert param_count(tparams) == count
    own = ttf.init_params(tcfg, torch.Generator().manual_seed(0))
    assert param_count(own) == count
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        node = tparams["blocks"][1] if keys[0] == "blocks" else tparams
        for key in keys[1:] if keys[0] == "blocks" else keys:
            node = node[key]
        want = np.asarray(leaf)[1] if keys[0] == "blocks" else leaf
        np.testing.assert_array_equal(node.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# forward, prefill, decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_VARIANTS + ["mamba2-1.3b"]
                         + MOE_AND_HYBRID)
def test_forward_prefill_decode_match_reference(arch):
    jcfg, jparams, tcfg, tparams = _models(arch)
    b, t = 2, 12
    jx, tx = _inputs(jcfg, b, t, seed=1)
    jlogits, jaux = jtf.forward_logits(jparams, jcfg, jx)
    tlogits, taux = ttf.forward_logits(tparams, tcfg, tx)
    _close(tlogits, jlogits)
    for got, want in zip(taux, jaux):      # MoE statistics; zeros elsewhere
        assert got.shape == np.asarray(want).shape
        _close(got, want)

    jlast, jcache = jtf.prefill(jparams, jcfg, jx[:, :t - 3], max_len=t + 4)
    tlast, tcache = ttf.prefill(tparams, tcfg, tx[:, :t - 3], max_len=t + 4)
    assert tlast.shape == (b, 1, tcfg.vocab_size)
    _close(tlast, jlast)
    names = {"ssm": ("ssm_state", "ssm_conv"),
             "hybrid": ("kv_k", "kv_v", "ssm_state", "ssm_conv")}.get(
                 tcfg.family, ("kv_k", "kv_v"))
    for name in names:
        _close(getattr(tcache, name), getattr(jcache, name))
    assert int(tcache.position) == int(jcache.position) == t - 3
    for step in range(t - 3, t):
        jstep, jcache = jtf.decode_step(jparams, jcfg, jx[:, step:step + 1],
                                        jcache)
        tstep, tcache = ttf.decode_step(tparams, tcfg, tx[:, step:step + 1],
                                        tcache)
        _close(tstep, jstep)
        if tcfg.family != "moe":    # the forward drops at capacity
            _close(tstep[:, 0], tlogits[:, step])
    for name in names:
        _close(getattr(tcache, name), getattr(jcache, name))
    assert torch.equal(torch.argmax(tstep, -1),
                       torch.from_numpy(np.array(jnp.argmax(jstep, -1))))


def test_decode_attention_step_matches_reference():
    """One layer's decode attention from ``init_kv_cache`` (GQA, G=4),
    step by step, against the reference's: outputs, cache rows, lengths."""
    jcfg = jconfigs.get_smoke_config("yi-34b")
    tcfg = tconfigs.get_smoke_config("yi-34b")
    jp = jattn.init_attention(jax.random.PRNGKey(0), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    b, s = 2, 8
    jcache = jattn.init_kv_cache(jcfg, b, s, jnp.float32)
    tcache = tattn.init_kv_cache(tcfg, b, s, torch.float32, device="cpu")
    rng = np.random.default_rng(8)
    for _ in range(4):
        x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        jout, jcache = jattn.decode_attention_step(jp, jcfg, jnp.asarray(x),
                                                   jcache)
        tout, tcache = tattn.decode_attention_step(tp, tcfg,
                                                   torch.from_numpy(x),
                                                   tcache)
        _close(tout, jout)
    assert int(tcache.length) == int(jcache.length) == 4
    _close(tcache.k, jcache.k)
    _close(tcache.v, jcache.v)


def test_decode_matches_teacher_forced_forward():
    """Tokens one by one through decode_step reproduce the full causal
    forward at every position (GQA, G=4)."""
    _, _, cfg, params = _models("chameleon-34b")
    b, t = 2, 12
    _, tokens = _inputs(cfg, b, t, seed=3)
    full, _ = ttf.forward_logits(params, cfg, tokens)
    cache = ttf.init_cache(cfg, b, max_len=t + 4, dtype=torch.float32,
                           device="cpu")
    got = []
    for step in range(t):
        logits, cache = ttf.decode_step(params, cfg,
                                        tokens[:, step:step + 1], cache)
        got.append(logits[:, 0])
    _close(torch.stack(got, dim=1), full.numpy())


def test_prefill_then_decode_continues_forward():
    _, _, cfg, params = _models("chameleon-34b")
    b, t = 2, 10
    _, tokens = _inputs(cfg, b, t + 1, seed=5)
    last, cache = ttf.prefill(params, cfg, tokens[:, :t], max_len=t + 4)
    full, _ = ttf.forward_logits(params, cfg, tokens)
    _close(last[:, 0], full[:, t - 1].numpy())
    step, _ = ttf.decode_step(params, cfg, tokens[:, t:t + 1], cache)
    _close(step[:, 0], full[:, t].numpy())


def test_plain_path_equals_kernel_path_on_the_cpu():
    """On CPU tensors the kernel adapters take the twins, so
    ``attention="plain"`` gives the same bits."""
    _, _, cfg, params = _models("qwen1.5-4b")
    _, tokens = _inputs(cfg, 1, 9, seed=6)
    a, ca = ttf.prefill(params, cfg, tokens, max_len=16)
    p, cp = ttf.prefill(params, cfg, tokens, max_len=16, attention="plain")
    assert torch.equal(a, p) and torch.equal(ca.kv_k, cp.kv_k)
    nxt = tokens[:, :1]
    a, _ = ttf.decode_step(params, cfg, nxt, ca)
    p, _ = ttf.decode_step(params, cfg, nxt, cp, attention="plain")
    assert torch.equal(a, p)
    with pytest.raises(ValueError, match="attention"):
        ttf.decode_step(params, cfg, nxt, cp, attention="fast")


def test_cast_params_casts_matrices_and_keeps_norms():
    _, _, cfg, params = _models("qwen1.5-4b")
    cast = ttf.cast_params(params, torch.bfloat16)
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["blocks"][0]["attn"]["bq"].dtype == torch.bfloat16
    assert cast["blocks"][0]["mlp"]["down"].dtype == torch.bfloat16
    assert cast["final_norm"] is params["final_norm"]
    assert cast["blocks"][1]["attn_norm"] is params["blocks"][1]["attn_norm"]
    same = ttf.cast_params(params, torch.float32)
    assert same["lm_head"] is params["lm_head"]


@pytest.mark.parametrize("build", ["init_cache", "init_kv_cache",
                                   "params_from_reference", "init_ssm_cache",
                                   "init_cache_ssm", "init_cache_hybrid"])
def test_builders_default_to_the_card(build, monkeypatch):
    """With no ``device``, the cache and parameter builders place their
    tensors on the package's default device (the card), through
    ``core.problem.resolve_device``; ``meta`` stands in for it here."""
    from repro_torch.core import problem
    monkeypatch.setattr(problem, "DEFAULT_DEVICE", "meta")
    cfg = tconfigs.get_smoke_config("qwen1.5-4b")
    if build == "init_cache":
        tensors = list(ttf.init_cache(cfg, 2, 8)[:2])
    elif build == "init_kv_cache":
        tensors = list(tattn.init_kv_cache(cfg, 2, 8))
    elif build == "init_ssm_cache":
        tensors = list(tssm.init_ssm_cache(
            tconfigs.get_smoke_config("mamba2-1.3b"), 2))
    elif build == "init_cache_ssm":
        tensors = list(ttf.init_cache(
            tconfigs.get_smoke_config("mamba2-1.3b"), 2, 8)[2:])
    elif build == "init_cache_hybrid":
        tensors = list(ttf.init_cache(
            tconfigs.get_smoke_config("zamba2-7b"), 2, 8))
    else:
        jparams = jtf.init_params(jconfigs.get_smoke_config("qwen1.5-4b"),
                                  jax.random.PRNGKey(0))
        params = params_from_reference(jax.tree.map(np.asarray, jparams))
        tensors = [params["embed"], params["blocks"][0]["attn"]["wq"]]
    assert all(t.device.type == "meta" for t in tensors)


def test_cast_params_keeps_the_ssm_f32_leaves():
    """``A_log``, ``dt_bias``, ``D`` and ``conv_w`` stay f32 (the reference
    reads them in f32) and the matrices go to bf16, so one bf16 decode
    step on the cast parameters equals one on the uncast ones."""
    _, _, cfg, params = _models("mamba2-1.3b")
    cast = ttf.cast_params(params, torch.bfloat16)
    ssm = cast["blocks"][1]["ssm"]
    for name in ("A_log", "dt_bias", "D", "conv_w", "gate_norm"):
        assert ssm[name].dtype == torch.float32
        assert ssm[name] is params["blocks"][1]["ssm"][name]
    for name in ("in_proj", "out_proj"):
        assert ssm[name].dtype == torch.bfloat16
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["blocks"][0]["norm"] is params["blocks"][0]["norm"]
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    _, tokens = _inputs(cfg, 2, 7, seed=9)
    steps = []
    for p in (params, cast):
        _, cache = ttf.prefill(p, cfg16, tokens[:, :6], max_len=16)
        steps.append(ttf.decode_step(p, cfg16, tokens[:, 6:], cache)[0])
    assert cache.ssm_conv.dtype == torch.bfloat16
    assert torch.equal(steps[0], steps[1])


def test_ssm_init_and_cache_shapes():
    cfg = tconfigs.get_smoke_config("mamba2-1.3b")
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    assert sorted(params["blocks"][0]) == ["norm", "ssm"]
    assert "lm_head" not in params                     # tied embeddings
    cache = ttf.init_cache(cfg, 3, 8, dtype=torch.bfloat16, device="cpu")
    assert cache.kv_k is None and cache.kv_v is None
    assert cache.ssm_state.dtype == torch.float32
    assert cache.ssm_state.shape == (cfg.num_layers, 3, cfg.ssm_heads,
                                     cfg.ssm_head_dim, cfg.ssm_state)
    assert cache.ssm_conv.dtype == torch.bfloat16
    assert cache.ssm_conv.shape == (cfg.num_layers, 3, cfg.ssm_conv - 1,
                                    cfg.d_inner + 2 * cfg.ssm_state)


def test_ssm_plain_path_equals_kernel_path_on_the_cpu():
    """On CPU tensors kernel 8's adapter takes its twin, so ``ssm="plain"``
    gives the same bits through prefill and forward_logits."""
    _, _, cfg, params = _models("mamba2-1.3b")
    _, tokens = _inputs(cfg, 1, 19, seed=10)
    a, ca = ttf.prefill(params, cfg, tokens, max_len=32)
    p, cp = ttf.prefill(params, cfg, tokens, max_len=32, ssm="plain")
    assert torch.equal(a, p) and torch.equal(ca.ssm_state, cp.ssm_state)
    fa, _ = ttf.forward_logits(params, cfg, tokens)
    fp, _ = ttf.forward_logits(params, cfg, tokens, ssm="plain")
    assert torch.equal(fa, fp)


# ---------------------------------------------------------------------------
# the MoE and hybrid families
# ---------------------------------------------------------------------------

def _ample(cfg):
    """``cfg`` with an MoE capacity that drops nothing (8.0), so the
    forward and decode route every token alike."""
    return dataclasses.replace(cfg, capacity_factor=8.0) \
        if cfg.family == "moe" else cfg


@pytest.mark.parametrize("arch", MOE_AND_HYBRID)
def test_moe_and_hybrid_decode_match_teacher_forced_forward(arch):
    """Tokens one by one through decode_step from ``init_cache`` reproduce
    the full causal forward at every position (the MoE at capacity 8.0),
    and a prefill then one decode step continue it."""
    _, _, cfg, params = _models(arch)
    cfg = _ample(cfg)
    b, t = 2, 12
    _, tokens = _inputs(cfg, b, t, seed=3)
    full, _ = ttf.forward_logits(params, cfg, tokens)
    cache = ttf.init_cache(cfg, b, max_len=t + 4, dtype=torch.float32,
                           device="cpu")
    got = []
    for step in range(t):
        logits, cache = ttf.decode_step(params, cfg,
                                        tokens[:, step:step + 1], cache)
        got.append(logits[:, 0])
    _close(torch.stack(got, dim=1), full.numpy())
    last, cache = ttf.prefill(params, cfg, tokens[:, :t - 1], max_len=t + 4)
    _close(last[:, 0], full[:, t - 2].numpy())
    step, _ = ttf.decode_step(params, cfg, tokens[:, t - 1:], cache)
    _close(step[:, 0], full[:, t - 1].numpy())


@pytest.mark.parametrize("arch", MOE_AND_HYBRID)
def test_moe_and_hybrid_plain_path_equals_kernel_path_on_the_cpu(arch):
    """On CPU tensors the kernel adapters take the twins, so
    ``attention="plain"`` and ``ssm="plain"`` give the same bits through
    prefill, decode and forward_logits."""
    _, _, cfg, params = _models(arch)
    _, tokens = _inputs(cfg, 1, 19, seed=6)
    a, ca = ttf.prefill(params, cfg, tokens, max_len=24)
    p, cp = ttf.prefill(params, cfg, tokens, max_len=24, attention="plain",
                        ssm="plain")
    assert torch.equal(a, p)
    for got, want in zip(ca, cp):
        assert (got is None and want is None) or torch.equal(got, want)
    nxt = tokens[:, :1]
    a, _ = ttf.decode_step(params, cfg, nxt, ca)
    p, _ = ttf.decode_step(params, cfg, nxt, cp, attention="plain")
    assert torch.equal(a, p)
    fa, aux_a = ttf.forward_logits(params, cfg, tokens)
    fp, aux_p = ttf.forward_logits(params, cfg, tokens, attention="plain",
                                   ssm="plain")
    assert torch.equal(fa, fp)
    assert all(torch.equal(x, y) for x, y in zip(aux_a, aux_p))


def test_cast_params_keeps_the_router_in_f32():
    """The router stays f32 (the reference routes in f32 on f32 weights;
    rounding it would move the routing) while the experts go to bf16, so
    one bf16 decode step on the cast parameters equals one on the uncast
    ones."""
    _, _, cfg, params = _models("granite-moe-1b-a400m")
    cast = ttf.cast_params(params, torch.bfloat16)
    moe = cast["blocks"][1]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["router"] is params["blocks"][1]["moe"]["router"]
    for name in ("gate", "up", "down"):
        assert moe[name].dtype == torch.bfloat16
    assert cast["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    _, tokens = _inputs(cfg, 2, 7, seed=9)
    steps = []
    for p in (params, cast):
        _, cache = ttf.prefill(p, cfg16, tokens[:, :6], max_len=16)
        steps.append(ttf.decode_step(p, cfg16, tokens[:, 6:], cache)[0])
    assert torch.equal(steps[0], steps[1])


def test_hybrid_init_and_cache_shapes():
    """zamba2 smoke: Mamba2 blocks, one shared block applied after layers
    1 and 3 (attn_period 2), a KV cache of 2 entries beside 4 layers' SSM
    states; the shared block is the one attention in the model."""
    cfg = tconfigs.get_smoke_config("zamba2-7b")
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    assert sorted(params["blocks"][0]) == ["norm", "ssm"]
    assert sorted(params["shared"]) == ["attn", "attn_norm", "ffn_norm",
                                        "mlp"]
    assert ttf._attention_layer_index(cfg) == \
        np.asarray(jtf._attention_layer_index(
            jconfigs.get_smoke_config("zamba2-7b"))).tolist() == [0, 0, 0, 1]
    assert [ttf._shared_after(cfg, l) for l in range(4)] == \
        [False, True, False, True]
    cache = ttf.init_cache(cfg, 3, 8, dtype=torch.bfloat16, device="cpu")
    assert cfg.attention_layers == 2
    assert cache.kv_k.shape == cache.kv_v.shape == (
        2, 3, 8, cfg.num_kv_heads, cfg.head_dim)
    assert cache.kv_k.dtype == torch.bfloat16
    assert cache.ssm_state.shape == (cfg.num_layers, 3, cfg.ssm_heads,
                                     cfg.ssm_head_dim, cfg.ssm_state)
    assert cache.ssm_conv.shape == (cfg.num_layers, 3, cfg.ssm_conv - 1,
                                    cfg.d_inner + 2 * cfg.ssm_state)
    _, tokens = _inputs(cfg, 1, 5, seed=2)
    with pytest.raises(ValueError, match="max_len"):
        ttf.prefill(params, cfg, tokens, max_len=4)


def test_moe_init_and_stats_shapes():
    cfg = tconfigs.get_smoke_config("qwen3-moe-235b-a22b")
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    block = params["blocks"][0]
    assert sorted(block) == ["attn", "attn_norm", "ffn_norm", "moe"]
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert block["moe"]["router"].shape == (d, e)
    assert block["moe"]["down"].shape == (e, f, d)
    _, tokens = _inputs(cfg, 2, 9, seed=4)
    _, (aux, load, coact) = ttf.forward_logits(params, cfg, tokens)
    assert aux.shape == () and load.shape == (e,) and coact.shape == (e, e)
    assert abs(float(load.sum()) - cfg.top_k) < 1e-5
    assert torch.equal(coact, coact.T)
    assert float(torch.diagonal(coact).abs().sum()) == 0.0


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "prefill"])
def test_an_unknown_family_raises(entry):
    cfg = dataclasses.replace(tconfigs.get_smoke_config("qwen1.5-4b"),
                              family="rnn")
    with pytest.raises(ValueError, match="unknown family"):
        if entry == "init_params":
            ttf.init_params(cfg, torch.Generator().manual_seed(0))
        elif entry == "init_cache":
            ttf.init_cache(cfg, 1, 8, device="cpu")
        else:
            ttf.prefill({"embed": torch.zeros(cfg.vocab_size, cfg.d_model)},
                        cfg, torch.zeros((1, 3), dtype=torch.int64), 8)
