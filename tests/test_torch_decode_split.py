"""The order of operations of kernel 6's split-S design
(``csrc/decode_attention.cu``), emulated in plain torch on the CPU, against
the twin and the reference's Pallas kernel in interpret mode; the wrapper's
split chooser; the kernel source's constants.

The emulation follows the kernel step for step: splits of
:func:`split_size` positions, 64-position tiles, (query row, key part)
pairs (8 // G parts a row, one from G = 8 on) with their own running
max, sum and f32 accumulator, updated in rounds of at most 8 of a tile's
keys (two a worker of 8 lanes), the parts of a row folded in part order, then the live splits
folded in split order, the last step divided by max(l, 1e-30).  Tolerances: f32 rtol = atol = 2e-5
and bf16 rtol 1e-2, atol 1e-3, the card's for kernel 6 against its twin
(``chip_smoke.ATTN_TOL``, ``tests/test_torch_gpu.py``).  A row of length
0 gives zeros, as the twin does; the Pallas kernel gives the mean of V
there (ROADMAP queue 3), and it takes a length above S as it is (its
zero-padded rows then count), where the port clamps to S as XLA clamps
the reference's cache write; so it is compared on the other rows.  Inputs
come from ``numpy.random.default_rng``.
"""
from __future__ import annotations

import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.decode_attention import decode_attention_pallas
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as A

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-3)}
H100_SMS = 132


def _key_parts(g: int) -> int:
    """kernel 6's key parts per query row: 8 warps share a group"""
    return 1 if g >= 8 else 8 // g


def emulate(q, k, v, length, split):
    """Kernel 6's arithmetic, in its order, on f32 copies of q, k, v."""
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    kp = _key_parts(g)
    qs = q.float().reshape(b, hkv, g, d) * np.float32(1.0 / math.sqrt(d))
    kf, vf = k.float(), v.float()
    out = torch.zeros((b, hkv, g, d))
    for bi in range(b):
        n_len = min(max(int(length[bi]), 0), s)
        n_live = -(-n_len // split)
        for hi in range(hkv):
            parts = []
            for sp in range(n_live):
                start, end = sp * split, min(sp * split + split, n_len)
                m = torch.full((g, kp), A.NEG_BIG)
                l = torch.zeros((g, kp))
                acc = torch.zeros((g, kp, d))
                for t0 in range(start, end, A.TILE):
                    n = min(A.TILE, end - t0)
                    for p in range(min(kp, n)):
                        part = torch.arange(t0 + p, t0 + n, kp)
                        for r0 in range(0, part.numel(), 8):  # rounds
                            keys = part[r0:r0 + 8]
                            logits = qs[bi, hi] @ kf[bi, keys, hi].T
                            m_new = torch.maximum(m[:, p],
                                                  logits.max(1).values)
                            corr = torch.exp(m[:, p] - m_new)
                            prob = torch.exp(logits - m_new[:, None])
                            l[:, p] = l[:, p] * corr + prob.sum(1)
                            acc[:, p] = acc[:, p] * corr[:, None] \
                                + prob @ vf[bi, keys, hi]
                            m[:, p] = m_new
                mm = m.max(1).values
                sc = torch.exp(m - mm[:, None])
                ls, accs = torch.zeros(g), torch.zeros((g, d))
                for p in range(kp):
                    ls = ls + sc[:, p] * l[:, p]
                    accs = accs + sc[:, p, None] * acc[:, p]
                parts.append((mm, ls, accs))
            if n_live == 0:
                continue
            mm = torch.stack([x[0] for x in parts]).max(0).values
            ls, accs = torch.zeros(g), torch.zeros((g, d))
            for m_s, l_s, acc_s in parts:
                sc = torch.exp(m_s - mm)
                ls = ls + sc * l_s
                accs = accs + sc[:, None] * acc_s
            out[bi, hi] = accs / torch.clamp(ls, min=A.MIN_DENOM)[:, None]
    return out.reshape(b, h, d).to(q.dtype)


def _inputs(b, h, hkv, d, s, seed, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, h, d), (b, s, hkv, d), (b, s, hkv, d))]
    jx = [jnp.asarray(a, dtype) for a in arrays]
    tx = [torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype))
          for j in jx]
    return jx, tx


S = 300


def _lengths(split):
    """0, 1, one split, a split border, one past it, above S."""
    return np.asarray([0, 1, split, 2 * split, 2 * split + 1, S + 50],
                      np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 4, 7, 40])
@pytest.mark.parametrize("d", [16, 37, 112])
def test_split_order_matches_twin_and_pallas(d, g, dtype):
    b, hkv = 6, 2
    split = A.split_size(S, b * hkv, H100_SMS)
    assert split == A.MIN_SPLIT and -(-S // split) == 3
    lens = _lengths(split)
    (jq, jk, jv), (q, k, v) = _inputs(b, g * hkv, hkv, d, S, d * 7 + g,
                                      dtype)
    length = torch.from_numpy(lens)
    got = emulate(q, k, v, length, split)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    torch.testing.assert_close(got.float(), A.decode_attention_twin(
        q, k, v, length).float(), **TOL[dtype])
    pallas = decode_attention_pallas(jq, jk, jv, jnp.asarray(lens),
                                     interpret=True)
    np.testing.assert_allclose(got[1:-1].float().numpy(),
                               np.asarray(pallas[1:-1], np.float32),
                               **TOL[dtype])


def test_split_order_ignores_values_past_length():
    """Rows past a row's length never enter the arithmetic: a poisoned
    tail changes nothing, bitwise."""
    (_, _, _), (q, k, v) = _inputs(3, 8, 2, 64, S, 3, "float32")
    length = torch.tensor([40, 129, 257], dtype=torch.int32)
    pk, pv = k.clone(), v.clone()
    for bi, n in enumerate(length.tolist()):
        pk[bi, n:] = 1e4
        pv[bi, n:] = -1e4
    assert torch.equal(emulate(q, k, v, length, 128),
                       emulate(q, pk, pv, length, 128))


@pytest.mark.parametrize("split", [32, 64, 512])
def test_every_split_gives_the_same_function(split):
    """The split changes the order of the sums, not the function."""
    (_, _, _), (q, k, v) = _inputs(3, 4, 4, 32, S, 9, "float32")
    length = torch.tensor([S, 97, 1], dtype=torch.int32)
    torch.testing.assert_close(emulate(q, k, v, length, split),
                               A.decode_attention_twin(q, k, v, length),
                               **TOL["float32"])


def test_split_size_at_the_serving_shape():
    """qwen1.5-4b's engine: (B, Hkv, S) = (16, 20, 4096) on 132 SMs ->
    8 splits of 512, 2560 blocks if every row were full."""
    split = A.split_size(4096, 16 * 20, H100_SMS)
    assert split == 512
    assert 16 * 20 * -(-4096 // split) <= A.SPLIT_BLOCKS_PER_SM * H100_SMS
    # yi-34b's head layout at the same B and S: fewer (row, kv head) pairs
    assert A.split_size(4096, 16 * 8, H100_SMS) == 256


@pytest.mark.parametrize("s,rows,want", [
    (1, 1, 64), (64, 4, 64), (65, 4, 128), (129, 4, 128), (300, 12, 128),
    (1024, 40, 128), (4096, 8, 128), (100_000, 320, 16384),
])
def test_split_size_small_and_large(s, rows, want):
    split = A.split_size(s, rows, H100_SMS)
    assert split == want
    assert split % A.TILE == 0 and split & (split - 1) == 0
    assert -(-s // split) <= A.MAX_SPLITS
    assert split >= A.MIN_SPLIT or split >= s


def test_constants_match_the_kernel_source():
    src = (_build.CSRC / "decode_attention.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kTile") == A.TILE
    assert const("kStages") == A.STAGES
    assert const("kMaxSplits") == A.MAX_SPLITS
    assert "decode_attention_kernel" in src
    assert "decode_attention" in _build.SIGNATURES["decode_attention"]
