"""The port's sharding hints (``repro_torch.sharding.hints``): the
counterparts of ``tests/test_hints.py``'s five tests — guards, fallbacks,
and the effect under a mesh.  The mesh case runs on a fake (4, 2)
``DeviceMesh`` in a subprocess, so no process group is left in the test
worker."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import torch
import torch.fx

from repro.sharding import hints as jhints
from repro_torch.sharding.hints import (DP, dp_axes, fitted_spec, hint,
                                        mesh_axis_sizes)


def test_no_mesh_is_noop():
    x = torch.ones((8, 16))
    assert mesh_axis_sizes() is None
    y = hint(x, "data", "model")
    assert y is x
    torch.testing.assert_close(y, torch.ones((8, 16)))


def test_noop_inside_a_traced_function_without_mesh():
    """The counterpart of the reference's jit case: ``hint`` inside a
    function traced by ``torch.fx`` leaves the graph as it was."""
    def f(x):
        return hint(x, DP, "model") * 2.0

    traced = torch.fx.symbolic_trace(f)
    targets = [n.target for n in traced.graph.nodes
               if n.op == "call_function"]
    assert len(targets) == 1            # the multiply alone
    torch.testing.assert_close(traced(torch.ones((4, 8))),
                               torch.full((4, 8), 2.0))


def test_dp_axes_selection():
    for shape in ({"pod": 2, "data": 16, "model": 16},
                  {"data": 16, "model": 16}, {"model": 16},
                  {"pod": 1, "data": 4}):
        assert dp_axes(shape) == jhints.dp_axes(shape)
    assert dp_axes({"pod": 2, "data": 16, "model": 16}) == ("pod", "data")
    assert dp_axes({"data": 16, "model": 16}) == ("data",)
    assert dp_axes({"model": 16}) == ()
    assert dp_axes({"pod": 1, "data": 4}) == ("data",)   # size-1 axes drop


_SUBPROCESS = textwrap.dedent("""
    import json, os
    import torch
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from repro_torch.launch.mesh import make_mesh, release_mesh
    from repro_torch.sharding.hints import DP, hint, mesh_axis_sizes, use_mesh

    mesh = make_mesh((4, 2), ("data", "model"))
    rep = [Replicate(), Replicate()]
    x = distribute_tensor(torch.ones((8, 12)), mesh, rep)
    odd = distribute_tensor(torch.ones((7, 12)), mesh, rep)
    plain = torch.ones((8, 12))
    outside = hint(x, DP, "model")
    with use_mesh(mesh):
        sizes = mesh_axis_sizes()
        a = hint(x, DP, "model")          # (8, 12): both shard
        b = hint(odd, "model", None)      # 7 % 2 != 0 -> replicate
        c = hint(plain, DP, "model")      # not a DTensor: itself
        os.environ["REPRO_NO_HINTS"] = "1"
        d = hint(x, DP, "model")          # the kill switch: itself
        del os.environ["REPRO_NO_HINTS"]
    out = {"ok": True, "sizes": sizes,
           "outside_is_x": outside is x,
           "a": [repr(p) for p in a.placements],
           "a_local": list(a.to_local().shape),
           "a_full": a.full_tensor().sum().item(),
           "b": [repr(p) for p in b.placements],
           "c_is_plain": c is plain, "d_is_x": d is x}
    release_mesh()
    out["left"] = torch.distributed.is_initialized()
    print(json.dumps(out))
""")


def test_hint_applies_under_mesh_subprocess():
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _SUBPROCESS],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["ok"] and not payload["left"]
    assert payload["sizes"] == {"data": 4, "model": 2}
    assert payload["outside_is_x"]
    assert payload["a"] == ["Shard(dim=0)", "Shard(dim=1)"]
    assert payload["a_local"] == [2, 6]
    assert payload["a_full"] == 96.0
    assert payload["b"] == ["Replicate()", "Replicate()"]
    assert payload["c_is_plain"] and payload["d_is_x"]
    # the fallbacks of the spec ``hint`` fits
    assert fitted_spec({"data": 4, "model": 2}, (7, 12), ("model", None)) \
        == (None, None)
    assert fitted_spec({"pod": 2, "data": 4, "model": 2}, (8, 12),
                       (DP, "model")) == (("pod", "data"), "model")


def test_no_hints_env_kill_switch(monkeypatch):
    monkeypatch.setenv("REPRO_NO_HINTS", "1")
    x = torch.ones((8, 16))
    y = hint(x, "data", "model")
    assert y is x          # exact object: nothing applied
