"""The port's SSM slice against the reference: kernel 8's twin against the
Pallas SSD kernel (interpret mode) and the per-token recurrence, and the
Mamba2 block — ``causal_conv1d``, ``ssd_chunked``, ``ssm_block``,
``ssm_decode_step`` — on parameters carried across by
``params_from_reference``.

Tolerances: the twin against the Pallas kernel and ``ssd_scan_ref`` at
rtol = atol = 3e-4, the reference's own (``tests/test_kernels.py``) for
its kernel against its oracle; bf16 inputs need no more, since both sides
widen the same bf16 values to f32.  The twin against the reference's
``ssd_chunked`` (another chunking of the same sums) at 3e-4 too, the
reference's tolerance between two chunkings.  The port's own ports of
the reference's functions at rtol = atol = 1e-5 (the same f32 math in
another library; observed differences ~1e-6), the block's outputs at
1e-5 as well.  Decode continuing prefill's state at 1e-4 (the reference
holds its own at 2e-3).  Inputs come from ``numpy.random.default_rng``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tscan
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_reference

SCAN_TOL = dict(rtol=3e-4, atol=3e-4)
PORT_TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **tol)


def _scan_inputs(b, seq, h, p, n, seed, dtype="float32"):
    """The reference kernel tests' draws; x, bm, cm rounded to ``dtype``
    first, so both libraries see the same values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, seq, h, p))
    dt = rng.uniform(0.01, 0.5, (b, seq, h))
    a = -rng.uniform(0.1, 2.0, h)
    bm = rng.standard_normal((b, seq, n))
    cm = rng.standard_normal((b, seq, n))
    j = [jnp.asarray(v, jnp.float32) for v in (x, dt, a, bm, cm)]
    for i in (0, 3, 4):
        j[i] = j[i].astype(dtype)
    t = [torch.from_numpy(np.array(v, np.float32)).to(getattr(torch, dtype)
                                                        if i in (0, 3, 4)
                                                        else torch.float32)
         for i, v in enumerate(j)]
    return j, t


def _block(seed=0):
    jcfg = jconfigs.get_smoke_config("mamba2-1.3b")
    tcfg = tconfigs.get_smoke_config("mamba2-1.3b")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    jblock = jax.tree.map(lambda v: v[0], jparams["blocks"])["ssm"]
    return jcfg, jblock, tcfg, tparams["blocks"][0]["ssm"]


def _u(cfg, b, seq, seed):
    u = np.random.default_rng(seed).standard_normal(
        (b, seq, cfg.d_model)).astype(np.float32)
    return jnp.asarray(u), torch.from_numpy(u)


# ---------------------------------------------------------------------------
# kernel 8's twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,seq,h,p,n,q", [
    (2, 64, 3, 8, 5, 16), (1, 100, 2, 16, 8, 32),
    (2, 128, 4, 64, 32, 128), (1, 48, 1, 4, 3, 64),    # the reference's
    (2, 77, 3, 8, 5, 32),                              # odd L, 3 chunks
    (1, 10, 2, 8, 4, 16),                              # L < chunk
])
def test_twin_matches_pallas_and_recurrence(b, seq, h, p, n, q):
    (jx, jdt, ja, jbm, jcm), t = _scan_inputs(b, seq, h, p, n, b * 53 + seq)
    y, s = tscan.ssd_scan_twin(*t, chunk=q)
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (b, seq, h, p) and s.shape == (b, h, p, n)
    py, ps = ssd_scan_pallas(jx, jdt, ja, jbm, jcm, chunk=q, interpret=True)
    _close(y, py, SCAN_TOL)
    _close(s, ps, SCAN_TOL)
    ry, rs = jref.ssd_scan_ref(jx, jdt, ja, jbm, jcm)
    _close(y, ry, SCAN_TOL)
    _close(s, rs, SCAN_TOL)


def test_twin_bf16_inputs_match_pallas():
    (jx, jdt, ja, jbm, jcm), t = _scan_inputs(2, 90, 3, 16, 8, 4,
                                              "bfloat16")
    assert t[0].dtype == t[3].dtype == torch.bfloat16
    y, s = tscan.ssd_scan_twin(*t, chunk=32)
    py, ps = ssd_scan_pallas(jx, jdt, ja, jbm, jcm, chunk=32,
                             interpret=True)
    _close(y, py, SCAN_TOL)
    _close(s, ps, SCAN_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_twin_matches_reference_chunked(with_state):
    """The twin at chunk 32 against the reference model's ``ssd_chunked``
    at chunk 48, from zeros and from an initial state."""
    (jx, jdt, ja, jbm, jcm), t = _scan_inputs(2, 96, 4, 32, 16, 5)
    init = np.random.default_rng(6).standard_normal(
        (2, 4, 32, 16)).astype(np.float32) if with_state else None
    y, s = tscan.ssd_scan_twin(
        *t, chunk=32, init_state=None if init is None
        else torch.from_numpy(init))
    wy, ws = jssm.ssd_chunked(jx, jdt, ja, jbm, jcm, chunk=48,
                              init_state=None if init is None
                              else jnp.asarray(init))
    _close(y, wy, SCAN_TOL)
    _close(s, ws, SCAN_TOL)


def test_twin_pad_steps_leave_the_state():
    """Steps with dt = 0 (what padding appends) change nothing: the final
    state of L steps equals that of the same steps followed by zeros."""
    _, (x, dt, a, bm, cm) = _scan_inputs(1, 37, 2, 8, 4, 7)
    y, s = tscan.ssd_scan_twin(x, dt, a, bm, cm, chunk=16)
    tail = [torch.cat([v, torch.zeros_like(v[:, :11])], dim=1)
            for v in (x, dt, bm, cm)]
    tail[1][:, 37:] = 0.0
    y2, s2 = tscan.ssd_scan_twin(tail[0], tail[1], a, tail[2], tail[3],
                                 chunk=16)
    _close(s2, s.numpy(), PORT_TOL)
    _close(y2[:, :37], y.numpy(), PORT_TOL)


def test_port_recurrence_matches_reference():
    """``kernels/ref.py``'s per-token recurrence (the card tests' oracle)
    against the reference's."""
    (jx, jdt, ja, jbm, jcm), t = _scan_inputs(2, 40, 3, 8, 5, 8)
    y, s = tref.ssd_scan_ref(*t)
    ry, rs = jref.ssd_scan_ref(jx, jdt, ja, jbm, jcm)
    _close(y, ry, PORT_TOL)
    _close(s, rs, PORT_TOL)


def test_adapter_takes_the_twin_on_the_cpu():
    _, t = _scan_inputs(1, 20, 2, 8, 4, 9)
    tscan.reset_launches()
    got = ops.ssd_scan(*t, chunk=8)
    want = tscan.ssd_scan_twin(*t, chunk=8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tscan.twin_calls["ssd_scan_twin"] == 2
    assert tscan.launches["ssd_scan"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tscan.ssd_scan_cuda(*t)


# ---------------------------------------------------------------------------
# the Mamba2 block against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(with_state):
    (jx, jdt, ja, jbm, jcm), t = _scan_inputs(2, 70, 3, 8, 5, 10)
    init = np.random.default_rng(11).standard_normal(
        (2, 3, 8, 5)).astype(np.float32) if with_state else None
    y, s = tssm.ssd_chunked(*t, chunk=16, init_state=None if init is None
                            else torch.from_numpy(init))
    wy, ws = jssm.ssd_chunked(jx, jdt, ja, jbm, jcm, chunk=16,
                              init_state=None if init is None
                              else jnp.asarray(init))
    _close(y, wy, PORT_TOL)
    _close(s, ws, PORT_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_reference(dtype):
    rng = np.random.default_rng(12)
    x = jnp.asarray(rng.standard_normal((2, 9, 24)), dtype)
    w = jnp.asarray(rng.standard_normal((24, 4)), jnp.float32)
    got = tlayers.causal_conv1d(torch.from_numpy(np.array(x, np.float32))
                                .to(getattr(torch, dtype)),
                                torch.from_numpy(np.array(w)))
    assert got.dtype == getattr(torch, dtype)
    want = jlayers.causal_conv1d(x, w)
    # bf16: the same f32 sums, rounded once to bf16 (2^-8 relative)
    tol = PORT_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    _close(got, np.asarray(want, np.float32), tol)


@pytest.mark.parametrize("tail", [False, True])
def test_ssm_block_matches_reference(tail):
    jcfg, jblock, tcfg, tblock = _block()
    ju, tu = _u(tcfg, 2, 37, 13)                 # 3 chunks of 16, ragged
    got = tssm.ssm_block(tblock, tcfg, tu, return_conv_tail=tail)
    want = jssm.ssm_block(jblock, jcfg, ju, return_conv_tail=tail)
    assert len(got) == len(want) == (3 if tail else 2)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, PORT_TOL)


def test_ssm_block_plain_path_is_the_twin():
    """On CPU tensors the adapter takes the twin, so ``ssm="plain"`` gives
    the same bits; an unknown path is refused."""
    _, _, cfg, block = _block()
    _, u = _u(cfg, 1, 20, 14)
    a = tssm.ssm_block(block, cfg, u)
    p = tssm.ssm_block(block, cfg, u, ssm="plain")
    assert torch.equal(a[0], p[0]) and torch.equal(a[1], p[1])
    with pytest.raises(ValueError, match="ssm"):
        tssm.ssm_block(block, cfg, u, ssm="fast")


def test_ssm_decode_step_matches_reference():
    jcfg, jblock, tcfg, tblock = _block()
    b = 2
    jcache = jssm.init_ssm_cache(jcfg, b, jnp.float32)
    tcache = tssm.init_ssm_cache(tcfg, b, torch.float32, device="cpu")
    rng = np.random.default_rng(15)
    for _ in range(5):
        u = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
        jout, jcache = jssm.ssm_decode_step(jblock, jcfg, jnp.asarray(u),
                                            jcache)
        tout, tcache = tssm.ssm_decode_step(tblock, tcfg,
                                            torch.from_numpy(u), tcache)
        _close(tout, jout, PORT_TOL)
    _close(tcache.state, jcache.state, PORT_TOL)
    _close(tcache.conv, jcache.conv, PORT_TOL)


def test_decode_continues_prefill_state():
    """``ssm_block`` over L tokens, and L decode steps from an empty cache,
    give the same outputs and final state; decode from the block's state
    and conv tail continues the longer sequence's block."""
    _, _, cfg, block = _block()
    b, seq = 2, 21
    _, u = _u(cfg, b, seq + 3, 16)
    full, final = tssm.ssm_block(block, cfg, u[:, :seq])
    cache = tssm.init_ssm_cache(cfg, b, torch.float32, device="cpu")
    ys = []
    for t in range(seq):
        y, cache = tssm.ssm_decode_step(block, cfg, u[:, t:t + 1], cache)
        ys.append(y[:, 0])
    tol = dict(rtol=1e-4, atol=1e-4)
    _close(torch.stack(ys, 1), full.numpy(), tol)
    _close(cache.state, final.numpy(), tol)
    longer, _ = tssm.ssm_block(block, cfg, u)
    _, state, conv = tssm.ssm_block(block, cfg, u[:, :seq],
                                    return_conv_tail=True)
    cache = tssm.SSMCache(state=state, conv=conv)
    for t in range(seq, seq + 3):
        y, cache = tssm.ssm_decode_step(block, cfg, u[:, t:t + 1], cache)
        _close(y[:, 0], longer[:, t].numpy(), tol)


def test_init_ssm_keeps_the_references_dtypes_and_ranges():
    cfg = dataclasses.replace(tconfigs.get_smoke_config("mamba2-1.3b"),
                              param_dtype="bfloat16")
    p = tssm.init_ssm(torch.Generator().manual_seed(0), cfg)
    for name in ("A_log", "dt_bias", "D"):
        assert p[name].dtype == torch.float32 and p[name].shape == \
            (cfg.ssm_heads,)
    for name in ("in_proj", "conv_w", "gate_norm", "out_proj"):
        assert p[name].dtype == torch.bfloat16
    assert p["in_proj"].shape == (cfg.d_model, 2 * cfg.d_inner
                                  + 2 * cfg.ssm_state + cfg.ssm_heads)
    assert p["conv_w"].shape == (tssm.conv_dim(cfg), cfg.ssm_conv)
    a = torch.exp(p["A_log"])
    assert bool(((a >= 1.0) & (a <= 16.0)).all())
    dt = torch.nn.functional.softplus(p["dt_bias"])   # inverse softplus
    assert bool(((dt >= 0.999e-3) & (dt <= 0.1001)).all())
    assert torch.equal(p["D"], torch.ones(cfg.ssm_heads))
    cache = tssm.init_ssm_cache(cfg, 3, torch.bfloat16, device="cpu")
    assert cache.state.dtype == torch.float32
    assert cache.state.shape == (3, cfg.ssm_heads, cfg.ssm_head_dim,
                                 cfg.ssm_state)
    assert cache.conv.dtype == torch.bfloat16
    assert cache.conv.shape == (3, cfg.ssm_conv - 1, tssm.conv_dim(cfg))
