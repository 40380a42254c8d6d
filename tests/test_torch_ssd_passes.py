"""The arithmetic of kernel 8's bf16 instance (``csrc/ssd_scan_bf16.cu``),
emulated in plain PyTorch on the CPU, against the reference: the three
passes at the kernel's chunk, every f32 operand that enters the tensor
cores split into bf16 hi + lo as the kernel splits it (x ⊙ w in pass 1,
the state s_in and the masked scores in pass 3), bf16 products exact and
sums in f32.  Held against the Pallas SSD kernel (interpret mode) and the
twin at the tolerance the card holds the kernel to: max |got - want| <=
3e-4 * max(1, max |want|), the reference's tolerance between two chunkings
of the scan (``tests/test_kernels.py``).  Also the wrapper's padding of
widths that are not multiples of 8.  Inputs come from
``numpy.random.default_rng`` with the Mamba2 initialisation's decays (a in
[-16, -1], dt in [1e-3, 0.1]).
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ssd_scan import ssd_scan_pallas
from repro_torch.kernels import _build
from repro_torch.kernels import ssd_scan as tscan

CHUNK = 256     # kChunk of csrc/ssd_scan_bf16.cu
TOL = 3e-4


def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).to(torch.float32)


def _split(v: torch.Tensor):
    """hi = bf16(v), lo = bf16(v - hi): the kernel's split()."""
    hi = _bf16(v)
    return hi, _bf16(v - hi)


def emulate_bf16_kernel(x, dt, a, bm, cm, init_state=None, chunk=CHUNK,
                        split=True):
    """Kernel 8's bf16 instance, pass by pass, on f32 tensors that hold
    x, bm, cm's bf16 values.  ``split=False`` rounds each f32 operand once
    to bf16 instead (what the hi/lo split buys)."""
    halves = _split if split else (lambda v: (_bf16(v), torch.zeros_like(v)))
    b, seq, h, p = x.shape
    n = bm.shape[-1]
    nc = -(-seq // chunk)
    pad = nc * chunk - seq                       # TMA's zero fill, dt = 0
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    bm = torch.nn.functional.pad(bm, (0, 0, 0, pad))
    cm = torch.nn.functional.pad(cm, (0, 0, 0, pad))
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    bc = bm.reshape(b, nc, chunk, n)
    cc = cm.reshape(b, nc, chunk, n)
    cum = torch.cumsum(dtc * a, dim=2)           # (B, nc, Q, H)

    # pass 1: S^c = (x ⊙ w)^T B, x ⊙ w as hi + lo
    w = torch.exp(cum[:, :, -1:] - cum) * dtc
    hi, lo = halves(xc * w[..., None])
    states = (torch.einsum("bcqhp,bcqn->bchpn", hi, bc)
              + torch.einsum("bcqhp,bcqn->bchpn", lo, bc))

    # pass 2: s_in^c = s; s <- s e^(cum_Q) + S^c, in f32
    s = torch.zeros((b, h, p, n)) if init_state is None else init_state
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * torch.exp(cum[:, c, -1])[..., None, None] + states[:, c]
    s_hi, s_lo = halves(torch.stack(s_in, dim=1))  # (B, nc, H, P, N)

    # pass 3: e^(cum_i) (C s_in^T) + the masked, scaled C B^T times x
    y = (torch.einsum("bcin,bchpn->bcihp", cc, s_hi)
         + torch.einsum("bcin,bchpn->bcihp", cc, s_lo)) \
        * torch.exp(cum)[..., None]
    g = torch.einsum("bcin,bcjn->bcij", cc, bc)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B, nc, i, j, H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)
    scores = g[..., None] * decay * dtc[:, :, None, :, :]
    sh, sl = halves(scores)
    y = y + torch.einsum("bcijh,bcjhp->bcihp", sh, xc) \
        + torch.einsum("bcijh,bcjhp->bcihp", sl, xc)
    return y.reshape(b, nc * chunk, h, p)[:, :seq], s


def _inputs(b, seq, h, p, n, seed, with_state):
    rng = np.random.default_rng(seed)
    x, bm, cm = (_bf16(torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))) for s in ((b, seq, h, p), (b, seq, n), (b, seq, n)))
    dt = torch.from_numpy(rng.uniform(1e-3, 0.1, (b, seq, h)).astype(
        np.float32))
    a = torch.from_numpy(-rng.uniform(1.0, 16.0, h).astype(np.float32))
    init = torch.from_numpy(rng.standard_normal((b, h, p, n)).astype(
        np.float32)) if with_state else None
    return x, dt, a, bm, cm, init


def _err(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    want = torch.as_tensor(np.array(want, np.float32))
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("seq", [1, CHUNK - 1, CHUNK + 1, 600])
def test_bf16_kernel_arithmetic_matches_pallas_and_twin(seq, with_state):
    x, dt, a, bm, cm, init = _inputs(2, seq, 3, 16, 8, seq + with_state,
                                     with_state)
    y, s = emulate_bf16_kernel(x, dt, a, bm, cm, init)
    assert y.shape == (2, seq, 3, 16) and s.shape == (2, 3, 16, 8)
    ty, ts = tscan.ssd_scan_twin(x, dt, a, bm, cm, 64, init)
    assert _err(y, ty) <= TOL and _err(s, ts) <= TOL
    if not with_state:   # the TPU kernel starts from zeros
        j = [jnp.asarray(v.numpy()) for v in (x, dt, a, bm, cm)]
        py, ps = ssd_scan_pallas(*j, chunk=128, interpret=True)
        assert _err(y, py) <= TOL and _err(s, ps) <= TOL


def test_hi_lo_split_keeps_f32_accuracy():
    """The split's terms keep ~16 bits: the emulation sits orders of
    magnitude inside the tolerance, where one bf16 rounding of each f32
    operand (~2^-9 relative a term) lands beyond it."""
    x, dt, a, bm, cm, init = _inputs(1, 600, 4, 64, 32, 11, True)
    ty, ts = tscan.ssd_scan_twin(x, dt, a, bm, cm, 64, init)
    split = max(_err(*pair) for pair in zip(
        emulate_bf16_kernel(x, dt, a, bm, cm, init), (ty, ts)))
    once = max(_err(*pair) for pair in zip(
        emulate_bf16_kernel(x, dt, a, bm, cm, init, split=False), (ty, ts)))
    assert split <= TOL / 10
    assert once > TOL


@pytest.mark.parametrize("p,n,want", [
    (64, 128, (64, 128)), (33, 24, (40, 24)), (64, 5, (64, 8)),
    (1, 1, (8, 8)), (64, 256, (64, 256))])
def test_padded_widths(p, n, want):
    assert tscan._padded_widths(p, n) == want


@pytest.mark.parametrize("p,n", [(72, 16), (16, 264), (0, 8)])
def test_padded_widths_refuses_past_the_kernel(p, n):
    with pytest.raises(ValueError, match="the bf16 kernel takes P"):
        tscan._padded_widths(p, n)


@pytest.mark.parametrize("with_state", [False, True])
def test_zero_padded_widths_leave_the_scan(with_state):
    """The wrapper's zero padding of P and N (``_pad_widths``) leaves y
    and the state's first P x N block as they are."""
    x, dt, a, bm, cm, init = _inputs(2, 90, 3, 33, 5, 3, with_state)
    pw, nw = tscan._padded_widths(33, 5)
    px, pb, pc, pinit = tscan._pad_widths(x, bm, cm, init, pw, nw)
    assert px.shape[-1] == pw and pb.shape[-1] == pc.shape[-1] == nw
    y, s = tscan.ssd_scan_twin(x, dt, a, bm, cm, 32, init)
    py, ps = tscan.ssd_scan_twin(px, dt, a, pb, pc, 32, pinit)
    torch.testing.assert_close(py[..., :33], y, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ps[:, :, :33, :5], s, rtol=1e-6, atol=1e-6)
    assert float(py[..., 33:].abs().max()) == 0.0
    assert float(ps[:, :, 33:].abs().max()) == 0.0
    assert float(ps[:, :, :, 5:].abs().max()) == 0.0


def test_constants_match_the_kernel_source():
    """The chunk emulated here and the widths the wrapper refuses are the
    kernel's own."""
    src = (_build.CSRC / "ssd_scan_bf16.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kChunk") == CHUNK
    assert const("kMaxP") == tscan.BF16_MAX_P
    assert const("kMaxN") == tscan.BF16_MAX_N
