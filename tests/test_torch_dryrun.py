"""The port's dry run (``repro_torch.launch.dryrun``) and what it reads —
the input shapes (``configs.shapes``), the analytic traffic floor
(``launch.traffic``), the FLOP counter (``launch.flops``) and the
collective counter (``launch.collectives``) — against the reference, on
the CPU.

Shapes, applicability and traffic equal the reference's exactly.  The
counter passes the counterparts of ``tests/test_analysis.py``'s jaxpr
tests (dots exact, a loop of 7 equal to 7 matmuls, a smoke model's forward
within 0.4-3.0x of 2 * N_active * tokens).  Cells on a fake process group
run in subprocesses, so no group is left in the test worker; they use the
smoke configs of the four families, with reduced train and prefill shapes
added to ``SHAPES`` in the subprocess (the production shapes' DTensor runs
take minutes at smoke width; ``python -m repro_torch.launch.dryrun --all
--mesh both`` runs them).
"""
from __future__ import annotations

import json
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
from repro.launch import jaxpr_flops
from repro.launch import traffic as jtraffic
from repro_torch import configs as tconfigs
from repro_torch.launch import flops, traffic
from repro_torch.models import init_params
from repro_torch.models.transformer import forward_train

FAMILY_ARCHS = ("qwen1.5-4b", "granite-moe-1b-a400m", "mamba2-1.3b",
                "zamba2-7b")


def _env():
    return dict(os.environ, PYTHONPATH=os.path.abspath("src"),
                OMP_NUM_THREADS="1")


@pytest.mark.parametrize("arch", jconfigs.all_archs())
def test_shapes_and_input_specs_match_reference(arch):
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for name, jshape in jconfigs.SHAPES.items():
        tshape = tconfigs.SHAPES[name]
        assert (tshape.name, tshape.kind, tshape.seq_len,
                tshape.global_batch) == (jshape.name, jshape.kind,
                                         jshape.seq_len, jshape.global_batch)
        assert tconfigs.shape_is_applicable(tcfg, tshape) \
            == jconfigs.shape_is_applicable(jcfg, jshape)
        want = jconfigs.input_specs(jcfg, jshape)
        got = tconfigs.input_specs(tcfg, tshape)
        assert set(got) == set(want)
        for key, spec in want.items():
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == tuple(spec.shape)
            assert str(got[key].dtype).split(".")[-1] == spec.dtype.name


@pytest.mark.parametrize("arch", jconfigs.all_archs())
def test_analytic_traffic_matches_reference(arch):
    """Every term of every arch x shape x mesh (and microbatch count),
    exactly: the module is the reference's, copied."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for name in jconfigs.SHAPES:
        for chips in (256, 512):
            for mb in (1, 4, 8):
                want = jtraffic.analytic_traffic(
                    jcfg, jconfigs.SHAPES[name], chips, tp=16,
                    microbatches=mb)
                got = traffic.analytic_traffic(
                    tcfg, tconfigs.SHAPES[name], chips, tp=16,
                    microbatches=mb)
                assert got == want, (name, chips, mb)


def test_dot_flops_exact():
    a, b = torch.zeros((64, 32)), torch.zeros((32, 48))
    got, nbytes = flops.count_fn(lambda a, b: a @ b, a, b)
    want, _ = jaxpr_flops.count_fn(lambda a, b: a @ b, jnp.zeros((64, 32)),
                                   jnp.zeros((32, 48)))
    assert got == want == 2 * 64 * 32 * 48
    assert nbytes == 4 * (64 * 32 + 32 * 48 + 64 * 48)


def test_batched_dot_flops():
    def f(a, b):
        return torch.einsum("bij,bjk->bik", a, b)

    got, _ = flops.count_fn(f, torch.zeros((4, 8, 16)),
                            torch.zeros((4, 16, 32)))
    assert got == 2 * 4 * 8 * 16 * 32


def test_loop_counts_every_trip():
    """The port's layers are a Python loop: a loop of 7 matmuls counts 7
    times one (the reference needs a trip factor for its scan)."""
    w = torch.zeros((16, 16))

    def f(x):
        for _ in range(7):
            x = x @ w
        return x

    once, _ = flops.count_fn(lambda x: x @ w, torch.zeros((16, 16)))
    seven, _ = flops.count_fn(f, torch.zeros((16, 16)))
    assert once == 2 * 16 ** 3 and seven == 7 * once


def test_elementwise_and_transcendental_rules():
    x = torch.zeros((8, 16))
    assert flops.count_fn(lambda x: x + 1.0, x)[0] == 128
    assert flops.count_fn(torch.exp, x)[0] == 8 * 128
    assert flops.count_fn(lambda x: torch.sum(x, dim=-1), x)[0] == 128
    assert flops.count_fn(lambda x: torch.softmax(x, -1), x)[0] == 12 * 128
    assert flops.count_fn(lambda x: x.reshape(16, 8), x)[0] == 0


def test_analytic_model_flops_sanity():
    """The count of a smoke model's training forward is within 0.4-3.0x
    of 2 * N_active * tokens, on the CPU and on ``meta`` alike."""
    cfg = tconfigs.get_smoke_config("musicgen-medium")
    B, S = 2, 64
    counts = []
    for device in ("cpu", "meta"):
        params = init_params(cfg, 0, device=device)
        batch = {"inputs": torch.zeros((B, S, cfg.d_model), device=device),
                 "targets": torch.zeros((B, S), dtype=torch.int32,
                                        device=device)}
        counts.append(flops.count_fn(
            lambda p, bt: forward_train(p, cfg, bt)[0], params, batch)[0])
    approx = 2 * cfg.active_param_count() * B * S
    assert counts[0] == counts[1]
    assert 0.4 * approx < counts[0] < 3.0 * approx, (counts, approx)


_MATMUL = textwrap.dedent("""
    import json
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import make_production_mesh, release_mesh
    mesh = make_production_mesh()
    a = distribute_tensor(torch.empty((64, 256), device="meta"), mesh,
                          [Shard(0), Replicate()])
    b = distribute_tensor(torch.empty((256, 512), device="meta"), mesh,
                          [Shard(0), Shard(1)])
    stats = collectives.collective_stats(lambda a, b: a @ b, a, b)
    release_mesh()
    print(json.dumps(stats))
""")


def test_collective_count_of_one_dtensor_matmul_is_exact():
    """(64, 256) rows over 'data' @ (256, 512) over ('data', 'model') on
    the fake 16x16 mesh: one all-gather of the (64, 256) f32 activation,
    65,536 bytes on this rank, and nothing else."""
    out = subprocess.run([sys.executable, "-c", _MATMUL], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert stats == {"total_bytes": 64 * 256 * 4,
                     "by_kind": {"all-gather": 64 * 256 * 4},
                     "count": {"all-gather": 1}}


_CELLS = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch import configs
    from repro_torch.configs import SHAPES, Shape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, release_mesh
    SHAPES["train_tiny"] = Shape("train_tiny", "train", 32, 8)
    SHAPES["prefill_tiny"] = Shape("prefill_tiny", "prefill", 32, 8)
    mesh = make_mesh((4, 2), ("data", "model"))
    out = []
    for arch in sys.argv[1:]:
        for shape in ("train_tiny", "prefill_tiny", "decode_32k",
                      "long_500k"):
            cell = dryrun.run_cell(arch, shape, False, mesh=mesh, smoke=True)
            out.append(cell)
    release_mesh()
    print(json.dumps({"cells": out,
                      "left": torch.distributed.is_initialized()}))
""")


def test_run_cell_on_a_fake_mesh_per_family():
    """``run_cell`` on a fake 8-rank (4, 2) mesh, the smoke config of each
    family: every cell ``OK`` (rules coherent, memory from the local
    shards, FLOPs, the floor) or the reference's ``SKIP`` for long_500k
    on full attention; the DTensor runs that complete count collectives,
    the others name the op they stopped at."""
    out = subprocess.run([sys.executable, "-c", _CELLS, *FAMILY_ARCHS],
                         env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert not payload["left"]
    cells = {(c["arch"], c["shape"]): c for c in payload["cells"]}
    assert len(cells) == 4 * len(FAMILY_ARCHS)
    for (arch, shape), cell in cells.items():
        jcfg = jconfigs.get_smoke_config(arch)
        runnable, reason = jconfigs.shape_is_applicable(
            jcfg, jconfigs.SHAPES.get(shape, jconfigs.SHAPES["train_4k"]))
        if not runnable:
            assert cell["status"] == "SKIP" and cell["reason"] == reason
            continue
        assert cell["status"] == "OK", cell
        assert cell["mesh"] == "4x2" and cell["chips"] == 8
        mem = cell["memory_analysis"]
        assert mem["argument_size_in_bytes"] > 0
        assert mem["output_size_in_bytes"] > 0
        assert mem["temp_size_in_bytes"] is None and mem["temp_size_reason"]
        assert cell["flops_per_chip"] > 0 and cell["compute_term_s"] > 0
        assert cell["analytic_memory_bytes"] > 0
        if cell["collective_bytes_per_chip"] is None:
            assert ":" in cell["collective_reason"], cell
        else:
            assert cell["collective_reason"] is None
            assert cell["collective_bytes_per_chip"] == sum(
                cell["collective_by_kind"].values())
    assert ("qwen1.5-4b", "long_500k") in cells
    assert cells[("qwen1.5-4b", "long_500k")]["status"] == "SKIP"
    assert cells[("mamba2-1.3b", "long_500k")]["status"] == "OK"
    # a sharded train step moves gradients and weights between ranks
    train = cells[("qwen1.5-4b", "train_tiny")]
    assert train["collective_bytes_per_chip"] > 0, train
    assert {"all-gather", "reduce-scatter"} <= set(
        train["collective_by_kind"])
    np.testing.assert_array_less(0, [c["flops_per_chip"] for c in
                                     cells.values() if c["status"] == "OK"])
