"""The port's LM examples (``repro_torch.moe_expert_rebalance``,
``train_lm``, ``serve_lm``) against the reference's
(``examples/moe_expert_rebalance.py``, ``train_lm.py``, ``serve_lm.py``),
on the CPU; ``train_lm``'s steps are in ``test_torch_examples_train.py``.

Threefry draws cannot be reproduced by a ``torch.Generator``, so each
example starts from the reference's converted state or parameters
(``models.convert``).  The expert-rebalance loop gives the reference
loop's replans — stats and permutations — replan for replan, its states
within the training budget of ``tests/test_torch_planner.py`` (losses rel
5e-3, state rtol 5e-3 / atol 5e-4); ``train_lm``'s config is the
reference's field by field; ``serve_lm`` at temperature 0 gives the
reference example's tokens exactly, and at T > 0 the same tokens for the
same seeds.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro import configs as jconfigs
from repro.models import init_params as jinit_params
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.sharding import planner as jplanner
from repro.training import data as jdata
from repro.training import train_step as jstep
from repro_torch import moe_expert_rebalance, serve_lm, train_lm
from repro_torch.models.convert import (params_from_reference,
                                        train_state_from_reference)
from repro_torch.training.tree import flatten

torch.set_num_threads(1)
EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def example(name: str):
    """The reference's example script as a module (its main not run)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_port(jstate):
    return train_state_from_reference(jax.tree.map(np.asarray, jstate),
                                      device="cpu")


def assert_states_close(got, jstate):
    want = flatten(to_port(jstate))[1]
    for a, b in zip(flatten(got)[1], want):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=5e-3, atol=5e-4)


def test_moe_expert_rebalance_matches_reference_replans():
    """The 60-step loop with its data shift at step 30 and replans every
    15 steps (4 groups, mu 0.5), from the reference's state: each replan's
    stats and permutation are the reference loop's."""
    cfg = jconfigs.get_smoke_config(moe_expert_rebalance.ARCH)
    steps = moe_expert_rebalance.STEPS
    jstate = jstep.init_train_state(cfg, jax.random.PRNGKey(0))
    tstate = to_port(jstate)

    # the reference example's loop, replan records kept
    step = jax.jit(jstep.make_train_step(
        cfg, jstep.TrainHyper(total_steps=steps, warmup=5)))
    planner = jplanner.PartitionPlanner(num_groups=4, interval=15, mu=0.5)
    data_a = jdata.SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                       global_batch=8, zipf_a=1.4, seed=0)
    data_b = dataclasses.replace(data_a, zipf_a=0.6, seed=7)
    ref = []
    for i in range(steps):
        data = data_a if i < steps // 2 else data_b
        jstate, metrics = step(jstate, jdata.synthetic_batch(data, i))
        planner._last_perm = None
        jstate, stats = planner.maybe_replan(i + 1, jstate)
        if stats:
            ref.append((i + 1, float(metrics["loss"]), stats,
                        planner._last_perm))

    final, records = moe_expert_rebalance.run(tstate, device="cpu",
                                              verbose=False)
    assert [r["step"] for r in records] == [s for s, *_ in ref] \
        == [15, 30, 45, 60]
    for rec, (at, loss, stats, perm) in zip(records, ref):
        assert rec["loss"] == pytest.approx(loss, rel=5e-3), at
        assert rec["stats"]["moves"] == stats["moves"], at
        for name in ("imbalance_before", "imbalance_after"):
            assert rec["stats"][name] == pytest.approx(stats[name],
                                                       rel=1e-5), (at, name)
        assert (rec["perm"] is None) == (perm is None), at
        if perm is not None:
            assert np.array_equal(rec["perm"].numpy(), np.asarray(perm)), at
    assert any(r["perm"] is not None for r in records)
    assert_states_close(final, jstate)


def test_midi_config_matches_reference():
    want = example("train_lm").midi_config()
    got = train_lm.midi_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def _reference_serve():
    """The reference example's engine run; returns (params, tokens)."""
    cfg = jconfigs.get_smoke_config("qwen1.5-4b")
    params = jinit_params(cfg, jax.random.PRNGKey(0))
    eng = JServingEngine(cfg, params, JServeConfig(
        max_batch=4, max_len=128, cache_dtype="float32"))
    rng = np.random.default_rng(0)
    for i in range(16):
        prompt = rng.integers(0, cfg.vocab_size,
                              int(rng.integers(4, 24))).astype(np.int32)
        eng.submit(JRequest(i, prompt, max_new_tokens=24))
    eng.run()
    return params, {r.uid: list(map(int, r.output)) for r in eng.finished}


def test_serve_lm_matches_reference_and_samples_deterministically():
    jparams, want = _reference_serve()
    params = params_from_reference(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    stats, eng = serve_lm.run(params=params, device="cpu", verbose=False)
    got = {r.uid: list(map(int, r.output)) for r in eng.finished}
    assert stats["requests"] == 16 and got == want
    sampled = []
    for _ in range(2):
        _, eng = serve_lm.run(params=params, temperature=0.8, device="cpu",
                              verbose=False)
        sampled.append({r.uid: list(map(int, r.output))
                        for r in eng.finished})
    assert sampled[0] == sampled[1]
    assert sampled[0] != want
    assert all(len(v) == 24 for v in sampled[0].values())


def test_sampling_tv_check_on_the_cpu():
    """``chip_smoke.sampling_tv`` — the card's check of temperature
    sampling — on CPU draws: within its bound, nothing outside the
    top-k; and a wrong temperature is caught."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.serving import sampler
    row = 3.0 * torch.randn(256, generator=torch.Generator().manual_seed(0))
    for top_k in (0, 20):
        gen = torch.Generator().manual_seed(top_k)
        tv, bound, outside = smoke.sampling_tv(gen, row, 0.8, top_k, 2 ** 14)
        assert tv <= bound and outside == 0, (top_k, tv, bound)
    # draws at T = 1.6 held against softmax(logits / 0.8) fail the bound
    real = sampler.sample_logits
    try:
        sampler.sample_logits = lambda g, x, temperature, top_k: real(
            g, x, temperature=2 * temperature, top_k=top_k)
        tv, bound, _ = smoke.sampling_tv(torch.Generator().manual_seed(1),
                                         row, 0.8, 0, 2 ** 14)
    finally:
        sampler.sample_logits = real
    assert tv > bound
