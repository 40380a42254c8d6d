"""Kernels 6–7 of the port: the plain twins of the attention kernels against
the reference's Pallas kernels (interpret mode) and its jnp oracles.

Tolerances: f32 rtol = atol = 3e-4 and bf16 rtol 3e-2, atol 3e-1 — the
reference's own (``tests/test_kernels.py``) for its kernels against its
oracles; the port's oracles against the reference's at 1e-5 (the same f32
math in another library).  Inputs come from ``numpy.random.default_rng``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_twin)
from repro_torch.kernels.flash_attention import (_padded_head_dim,
                                                 flash_attention_cuda,
                                                 flash_attention_twin)

TOL = {"float32": 3e-4, "bfloat16": 3e-2}


def _inputs(shapes, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a, dtype) for a in arrays]
    tx = [torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype))
          for j in jx]
    return jx, tx


def _close(got, want, dtype="float32"):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol * (10 if dtype == "bfloat16"
                                                     else 1))


# ---------------------------------------------------------------------------
# kernel 6: decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,hkv,d", [
    (1, 4, 4, 64), (2, 8, 2, 64), (3, 8, 1, 128), (2, 7, 7, 64),
    (2, 8, 4, 16), (2, 8, 4, 112), (1, 4, 2, 37),
])
@pytest.mark.parametrize("s", [100, 512, 1000])
def test_decode_twin_matches_pallas(b, h, hkv, d, s):
    """The twin == the TPU kernel in interpret mode (the reference's decode
    shapes, G in {1, 2, 4, 8}, zamba2-7b's head_dim 112 and an odd one)
    and the reference oracle."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, h, d), (b, s, hkv, d), (b, s, hkv, d)], seed=b * 131 + s)
    lens = np.random.default_rng(s).integers(1, s + 1, b).astype(np.int32)
    got = decode_attention_twin(tq, tk, tv, torch.from_numpy(lens))
    _close(got, decode_attention_pallas(jq, jk, jv, jnp.asarray(lens),
                                        interpret=True))
    _close(got, jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_twin_dtypes(dtype):
    b, h, hkv, d, s = 2, 8, 2, 64, 384
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, h, d), (b, s, hkv, d), (b, s, hkv, d)], seed=0, dtype=dtype)
    lens = np.asarray([s, s // 3], np.int32)
    got = decode_attention_twin(tq, tk, tv, torch.from_numpy(lens))
    assert got.dtype == getattr(torch, dtype)
    _close(got, decode_attention_pallas(jq, jk, jv, jnp.asarray(lens),
                                        interpret=True), dtype)


def test_decode_twin_length_masking_and_clamp():
    """Values past ``length`` change nothing; a length above S is S."""
    (_, _, _), (q, k, v) = _inputs([(1, 4, 64), (1, 256, 2, 64),
                                    (1, 256, 2, 64)], seed=1)
    length = torch.tensor([100], dtype=torch.int32)
    out1 = decode_attention_twin(q, k, v, length)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:] = 1e4
    v2[:, 100:] = -1e4
    assert torch.equal(out1, decode_attention_twin(q, k2, v2, length))
    full = decode_attention_twin(q, k, v, torch.tensor([256], dtype=torch.int32))
    over = decode_attention_twin(q, k, v, torch.tensor([999], dtype=torch.int32))
    assert torch.equal(full, over)


def test_decode_port_oracle_matches_reference_oracle():
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(3, 8, 64), (3, 200, 2, 64), (3, 200, 2, 64)], seed=2)
    lens = np.asarray([1, 77, 200], np.int32)
    np.testing.assert_allclose(
        tref.decode_attention_ref(tq, tk, tv, torch.from_numpy(lens)).numpy(),
        np.asarray(jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens))),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# kernel 7: causal flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,hkv,d", [
    (1, 128, 4, 2, 64), (2, 200, 8, 2, 64), (1, 384, 6, 1, 128),
    (1, 96, 7, 7, 64), (2, 64, 4, 4, 32), (1, 100, 8, 1, 16),
    (1, 130, 4, 2, 112), (1, 77, 6, 3, 37),
])
def test_flash_twin_matches_pallas(b, s, h, hkv, d):
    """The twin == the TPU kernel in interpret mode (the reference's flash
    shapes plus G=8, zamba2-7b's head_dim 112 and an odd one) and the
    reference oracle."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)], seed=b * 997 + s)
    got = flash_attention_twin(tq, tk, tv)
    _close(got, flash_attention_pallas(jq, jk, jv, interpret=True))
    _close(got, jref.flash_attention_ref(jq, jk, jv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_twin_dtypes(dtype):
    b, s, h, hkv, d = 1, 192, 8, 4, 64
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)], seed=7, dtype=dtype)
    got = flash_attention_twin(tq, tk, tv)
    assert got.dtype == getattr(torch, dtype)
    _close(got, flash_attention_pallas(jq, jk, jv, interpret=True), dtype)


def test_flash_twin_is_causal():
    """Changing the last key and value changes only the last position."""
    (_, _, _), (q, k, v) = _inputs([(1, 50, 4, 16), (1, 50, 2, 16),
                                    (1, 50, 2, 16)], seed=3)
    out1 = flash_attention_twin(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] = 5.0
    v2[:, -1] = -5.0
    out2 = flash_attention_twin(q, k2, v2)
    assert torch.equal(out1[:, :-1], out2[:, :-1])
    assert not torch.equal(out1[:, -1], out2[:, -1])


@pytest.mark.parametrize("d,width", [(1, 8), (8, 8), (100, 104),
                                     (112, 112), (256, 256)])
def test_padded_head_dim(d, width):
    """The bf16 kernel 7 reads rows of whole 16-byte vectors: other head
    widths are padded with zeros to the next multiple of 8."""
    assert _padded_head_dim(d) == width


@pytest.mark.parametrize("d", [0, 257])
def test_padded_head_dim_refuses_widths_past_the_kernels(d):
    with pytest.raises(ValueError, match="head_dim"):
        _padded_head_dim(d)


def test_flash_port_oracle_matches_reference_oracle():
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(2, 77, 8, 32), (2, 77, 2, 32), (2, 77, 2, 32)], seed=4)
    np.testing.assert_allclose(
        tref.flash_attention_ref(tq, tk, tv).numpy(),
        np.asarray(jref.flash_attention_ref(jq, jk, jv)),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_twins():
    (_, _, _), (q, k, v) = _inputs([(2, 8, 16), (2, 40, 2, 16),
                                    (2, 40, 2, 16)], seed=5)
    length = torch.tensor([3, 40], dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q, k, v, length),
                       decode_attention_twin(q, k, v, length))
    (_, _, _), (q, k, v) = _inputs([(1, 40, 8, 16), (1, 40, 2, 16),
                                    (1, 40, 2, 16)], seed=6)
    assert torch.equal(ops.flash_attention(q, k, v),
                       flash_attention_twin(q, k, v))


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros((1, 4, 16))
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(q, k, k, torch.ones((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(torch.zeros((1, 8, 4, 16)), k, k)
