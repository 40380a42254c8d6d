"""The port's serving engine and samplers against the reference's.

Weights come from the reference's ``init_params(cfg, PRNGKey(0))``,
converted; requests from ``numpy.random.default_rng``.  Both engines run
greedy decoding on the f32 smoke configs (dense, mamba2 for the SSM
family, granite-moe-1b-a400m for the MoE family and zamba2 for the
hybrid) with f32 caches, so they must agree exactly on every token and on
the number of decode steps and prefills.  The idle-slot test holds the
port's decode logits against the reference's at rtol = atol = 1e-4 (f32,
see ``test_torch_models.py``).
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving.sampler import greedy as jgreedy
from repro_torch import configs as tconfigs
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_reference
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.serving.sampler import greedy, sample_logits

REPO = Path(__file__).resolve().parent.parent


def _models(arch):
    jcfg = jconfigs.get_smoke_config(arch)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    return jcfg, jparams, tconfigs.get_smoke_config(arch), tparams


def _engine(arch="qwen1.5-4b", max_batch=3, max_len=64, **serve):
    cfg = tconfigs.get_smoke_config(arch)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, params, ServingEngine(
        cfg, params, ServeConfig(max_batch=max_batch, max_len=max_len,
                                 cache_dtype="float32", **serve))


def _generate(cfg, params, prompt: np.ndarray, n: int) -> list[int]:
    """Greedy generation by repeated full forwards (the oracle)."""
    toks = list(prompt.tolist())
    for _ in range(n):
        logits, _ = ttf.forward_logits(params, cfg,
                                       torch.tensor([toks], dtype=torch.int64))
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "chameleon-34b"])
def test_engine_matches_reference_engine(arch):
    """Same weights, same requests (more than slots, mixed lengths): every
    request's tokens, the decode steps and the prefills are equal."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    serve = dict(max_batch=3, max_len=48, cache_dtype="float32")
    jeng = JServingEngine(jcfg, jparams, JServeConfig(**serve))
    teng = ServingEngine(tcfg, tparams, ServeConfig(**serve))
    rng = np.random.default_rng(11)
    for uid in range(8):
        prompt = rng.integers(0, jcfg.vocab_size,
                              int(rng.integers(1, 24))).astype(np.int32)
        n = int(rng.integers(1, 16))
        jeng.submit(JRequest(uid, prompt, max_new_tokens=n))
        teng.submit(Request(uid, prompt, max_new_tokens=n))
    jstats, tstats = jeng.run(), teng.run()
    for key in ("requests", "decode_steps", "prefills", "generated_tokens"):
        assert tstats[key] == jstats[key], key
    want = {r.uid: r.output for r in jeng.finished}
    assert {r.uid: r.output for r in teng.finished} == want
    assert [r.uid for r in teng.finished] == [r.uid for r in jeng.finished]


def test_ssm_engine_matches_reference_engine():
    """mamba2 smoke through both engines: prompts shorter than the conv
    window (1 and 2 tokens against W-1 = 3) and longer than a chunk, more
    requests than slots, so slots are reused; every token, decode step
    and prefill equal."""
    jcfg, jparams, tcfg, tparams = _models("mamba2-1.3b")
    serve = dict(max_batch=3, max_len=64, cache_dtype="float32")
    jeng = JServingEngine(jcfg, jparams, JServeConfig(**serve))
    teng = ServingEngine(tcfg, tparams, ServeConfig(**serve))
    rng = np.random.default_rng(12)
    for uid, s in enumerate((1, 2, 37, 3, 1, 20, 9, 2, 30)):
        prompt = rng.integers(0, jcfg.vocab_size, s).astype(np.int32)
        n = int(rng.integers(1, 12))
        jeng.submit(JRequest(uid, prompt, max_new_tokens=n))
        teng.submit(Request(uid, prompt, max_new_tokens=n))
    jstats, tstats = jeng.run(), teng.run()
    assert tstats["prefills"] == 9 > serve["max_batch"]
    for key in ("requests", "decode_steps", "prefills", "generated_tokens"):
        assert tstats[key] == jstats[key], key
    assert {r.uid: r.output for r in teng.finished} == \
        {r.uid: r.output for r in jeng.finished}


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-7b"])
def test_moe_and_hybrid_engines_match_reference_engine(arch):
    """The MoE (prefill at the config's capacity, dropless decode) and the
    hybrid (KV and SSM fields in one cache) through both engines: more
    requests than slots, so slots are reused, prompts from 1 token (shorter
    than the conv window) to longer than a group and a chunk; every
    token, decode step and prefill equal."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    serve = dict(max_batch=3, max_len=64, cache_dtype="float32")
    jeng = JServingEngine(jcfg, jparams, JServeConfig(**serve))
    teng = ServingEngine(tcfg, tparams, ServeConfig(**serve))
    rng = np.random.default_rng(13)
    for uid, s in enumerate((1, 2, 37, 3, 20, 9, 17, 30)):
        prompt = rng.integers(0, jcfg.vocab_size, s).astype(np.int32)
        n = int(rng.integers(1, 12))
        jeng.submit(JRequest(uid, prompt, max_new_tokens=n))
        teng.submit(Request(uid, prompt, max_new_tokens=n))
    jstats, tstats = jeng.run(), teng.run()
    assert tstats["prefills"] == 8 > serve["max_batch"]
    for key in ("requests", "decode_steps", "prefills", "generated_tokens"):
        assert tstats[key] == jstats[key], key
    assert {r.uid: r.output for r in teng.finished} == \
        {r.uid: r.output for r in jeng.finished}
    if tcfg.family == "hybrid":
        assert teng.cache.kv_k is not None and teng.cache.ssm_state is not None


def test_ssm_slot_reuse_overwrites_the_state():
    """Writing a prefill into a used slot leaves exactly the new request's
    state and conv window there (cast to the batched cache's dtype), and
    the other slots as they were."""
    from repro_torch.serving.engine import _write_slot
    cfg = tconfigs.get_smoke_config("mamba2-1.3b")
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    batched = ttf.init_cache(cfg, 3, 32, torch.bfloat16, device="cpu")
    batched = batched._replace(position=torch.zeros(3, dtype=torch.int32))
    batched.ssm_state.fill_(7.0)
    batched.ssm_conv.fill_(7.0)
    tokens = torch.randint(0, cfg.vocab_size, (1, 5),
                           generator=torch.Generator().manual_seed(1))
    _, single = ttf.prefill(params, cfg, tokens, max_len=32)
    _write_slot(batched, single, 1, 5)
    assert torch.equal(batched.ssm_state[:, 1], single.ssm_state[:, 0])
    assert torch.equal(batched.ssm_conv[:, 1],
                       single.ssm_conv[:, 0].to(torch.bfloat16))
    for slot in (0, 2):
        assert bool((batched.ssm_state[:, slot] == 7.0).all())
        assert bool((batched.ssm_conv[:, slot] == 7.0).all())
    assert batched.position.tolist() == [0, 5, 0]


def test_continuous_batching_admits_from_queue():
    cfg, _, eng = _engine(max_batch=2)
    rng = np.random.default_rng(1)
    for i in range(5):                       # more requests than slots
        eng.submit(Request(i, rng.integers(0, cfg.vocab_size, 4).astype(
            np.int32), max_new_tokens=4))
    stats = eng.run()
    assert stats["requests"] == 5 and stats["prefills"] == 5
    assert stats["prefill_tokens"] == 20
    assert all(len(r.output) == 4 for r in eng.finished)


def test_heterogeneous_lengths_decode_together():
    """Prompts of different lengths share decode steps; each output equals
    the full-forward oracle's."""
    cfg, params, eng = _engine(max_batch=4)
    rng = np.random.default_rng(2)
    for i, s in enumerate((2, 11, 7, 4)):
        eng.submit(Request(i, rng.integers(0, cfg.vocab_size, s).astype(
            np.int32), max_new_tokens=5))
    eng.run()
    for req in sorted(eng.finished, key=lambda r: r.uid):
        assert req.output == _generate(cfg, params, req.prompt, 5), req.uid


def test_eos_stops_early():
    cfg, params, eng = _engine()
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 6).astype(
        np.int32)
    ref = _generate(cfg, params, prompt, 8)
    eos = ref[3]
    eng.serve = ServeConfig(max_batch=3, max_len=64, eos_id=eos,
                            cache_dtype="float32")
    eng.submit(Request(0, prompt, max_new_tokens=8))
    eng.run()
    out = eng.finished[0].output
    assert out == ref[:ref.index(eos) + 1]


def test_capacity_guard():
    _, _, eng = _engine(max_len=16)
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(Request(0, np.zeros(10, np.int32), max_new_tokens=10))
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit(Request(1, np.zeros(0, np.int32), max_new_tokens=1))


def test_idle_slot_past_max_len_matches_reference():
    """A slot whose position runs past the cache writes its last row (XLA
    clamps the reference's ``dynamic_update_slice``) and attends over all
    of it; the port's logits for every slot follow the reference's."""
    jcfg, jparams, tcfg, tparams = _models("qwen1.5-4b")
    b, s = 2, 8
    rng = np.random.default_rng(4)
    shape = (tcfg.num_layers, b, s, tcfg.num_kv_heads, tcfg.head_dim)
    kv = [rng.standard_normal(shape).astype(np.float32) for _ in "kv"]
    pos = np.asarray([2, 6], np.int32)
    jcache = jtf.init_cache(jcfg, b, s, jnp.float32)._replace(
        kv_k=jnp.asarray(kv[0]), kv_v=jnp.asarray(kv[1]),
        position=jnp.asarray(pos))
    tcache = ttf.init_cache(tcfg, b, s, torch.float32,
                            device="cpu")._replace(
        kv_k=torch.from_numpy(kv[0].copy()),
        kv_v=torch.from_numpy(kv[1].copy()), position=torch.from_numpy(pos))
    for _ in range(5):                   # slot 1 reaches 11 > max_len 8
        ids = rng.integers(0, tcfg.vocab_size, (b, 1)).astype(np.int32)
        jl, jcache = jtf.decode_step(jparams, jcfg, jnp.asarray(ids), jcache)
        tl, tcache = ttf.decode_step(tparams, tcfg,
                                     torch.from_numpy(ids.astype(np.int64)),
                                     tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    assert tcache.position.tolist() == [7, 11]
    np.testing.assert_allclose(tcache.kv_k.numpy(), np.asarray(jcache.kv_k),
                               rtol=1e-4, atol=1e-4)


def test_engine_idle_slot_drift_matches_reference():
    """An engine whose second slot sits idle after a long prompt (its
    position then passes max_len) serves the first request as the
    reference's engine does."""
    jcfg, jparams, tcfg, tparams = _models("qwen1.5-4b")
    serve = dict(max_batch=2, max_len=16, cache_dtype="float32")
    jeng = JServingEngine(jcfg, jparams, JServeConfig(**serve))
    teng = ServingEngine(tcfg, tparams, ServeConfig(**serve))
    rng = np.random.default_rng(5)
    long_run = rng.integers(0, jcfg.vocab_size, 1).astype(np.int32)
    short = rng.integers(0, jcfg.vocab_size, 14).astype(np.int32)
    for eng, req in ((jeng, JRequest), (teng, Request)):
        eng.submit(req(0, long_run, max_new_tokens=15))
        eng.submit(req(1, short, max_new_tokens=1))
        eng.run()
    assert int(teng.cache.position[1]) > serve["max_len"]
    assert [r.output for r in teng.finished] == \
        [r.output for r in jeng.finished]


# ---------------------------------------------------------------------------
# samplers and the driver
# ---------------------------------------------------------------------------

def test_greedy_matches_jnp_argmax_on_ties():
    logits = np.asarray([[0.1, 3.0, -1.0, 3.0], [2.0, 2.0, 2.0, 1.0],
                         [-1.0, -1.0, -5.0, -1.0]], np.float32)
    want = np.asarray(jgreedy(jnp.asarray(logits)))
    assert greedy(torch.from_numpy(logits)).tolist() == want.tolist() \
        == [1, 0, 0]
    assert greedy(torch.from_numpy(logits)[:, None, :]).dtype == torch.int32


def test_sample_logits():
    logits = torch.tensor([[0.1, 3.0, -1.0], [2.0, 0.0, 1.0]])
    gen = torch.Generator().manual_seed(0)
    assert sample_logits(gen, logits, temperature=0.0).tolist() == [1, 0]
    assert sample_logits(gen, logits, temperature=5.0,
                         top_k=1).tolist() == [1, 0]
    draws = [sample_logits(torch.Generator().manual_seed(7), logits,
                           temperature=1.0).tolist() for _ in range(2)]
    assert draws[0] == draws[1]
    gen = torch.Generator().manual_seed(1)
    many = torch.stack([sample_logits(gen, logits) for _ in range(64)])
    assert many.dtype == torch.int32 and int(many.max()) < 3
    assert len(set(many[:, 0].tolist())) > 1     # it does sample


def test_serve_driver_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen1.5-4b", "--device", "cpu", "--requests", "6", "--max-new",
         "5", "--slots", "2", "--max-len", "64"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "6 requests | 30 tokens" in out.stdout


def test_serve_driver_runs_mamba2_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2-1.3b", "--device", "cpu", "--requests", "5", "--max-new",
         "4", "--slots", "2", "--max-len", "64"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "5 requests | 20 tokens" in out.stdout


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-7b"])
def test_serve_driver_runs_moe_and_hybrid_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--device", "cpu", "--requests", "5", "--max-new", "4", "--slots",
         "2", "--max-len", "64"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "5 requests | 20 tokens" in out.stdout
