"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, pulls in JAX or any module of the reference package."""
from __future__ import annotations

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, "src")
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import runpy
runpy.run_path("chip_smoke.py", run_name="chip_smoke_probe")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": len(names), "imported": bad}))
"""


def test_port_imports_no_jax_and_no_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["modules"] >= 94
    assert report["imported"] == []


def test_every_port_module_is_listed():
    """The probe above walks the package; make sure the walk sees the
    kernel, core, model, serving, launch, partitioner, DES, distributed,
    telemetry, training, planner, sharding, dry-run, example and
    contract-linter modules the slices ship."""
    names = {m.name for m in pkgutil.walk_packages(
        [str(REPO / "src" / "repro_torch")], "repro_torch.")}
    for mod in ("core.problem", "core.costs", "core.aggregate",
                "core.checkpoint", "core.refine", "core.initial",
                "core.sparse", "core.cluster", "core.batch",
                "kernels.dissatisfaction", "kernels.edge_block",
                "kernels.ops", "kernels.ref",
                "kernels._build", "graphs.generators", "provenance",
                "quickstart", "sweeps", "sweeps.runtime", "sweeps.metrics",
                "sweep_study", "kernels.decode_attention",
                "kernels.flash_attention", "kernels.ssd_scan", "models.ssm",
                "configs", "configs.qwen1p5_4b",
                "configs.minicpm_2b", "configs.yi_34b", "configs.granite_34b",
                "configs.chameleon_34b", "configs.musicgen_medium",
                "configs.mamba2_1p3b", "configs.zamba2_7b",
                "configs.granite_moe_1b_a400m", "configs.qwen3_moe_235b_a22b",
                "models", "models.config", "models.layers",
                "models.attention", "models.transformer", "models.convert",
                "models.moe",
                "serving", "serving.engine", "serving.sampler", "launch",
                "launch.serve", "core.annealing", "core.constrained",
                "partitioners", "partitioners.baselines", "des",
                "des.engine", "des.scenarios", "des.workload",
                "des_partitioning", "distributed", "distributed.views",
                "distributed.protocol", "distributed.accounting",
                "distributed.faults", "distributed.runtime", "obs",
                "obs.events", "obs.sinks", "obs.recorder", "obs.report",
                "obs.rows", "training", "training.data",
                "training.optimizer", "training.train_step",
                "training.checkpoint", "training.compression",
                "training.tree", "sharding", "sharding.planner",
                "launch.train", "sharding.rules", "sharding.hints",
                "configs.shapes", "launch.mesh", "launch.traffic",
                "launch.flops", "launch.collectives", "launch.dryrun",
                "moe_expert_rebalance", "train_lm", "serve_lm",
                "analysis", "analysis.registry", "analysis.docs_rules",
                "analysis.ast_rules", "analysis.entrypoints",
                "analysis.jaxpr_rules", "analysis.wire_rules",
                "analysis.complexity_rules", "analysis.__main__"):
        assert f"repro_torch.{mod}" in names


def test_build_signatures_cover_every_entry_point():
    """Each ``csrc/*.cu`` is one library, and ``_build.SIGNATURES`` binds
    functions that its source defines, every one declared ``extern "C"``
    on its own line among them."""
    import re
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import _build
    sources = {src.stem: src.read_text()
               for src in sorted(_build.CSRC.glob("*.cu"))}
    assert set(sources) == set(_build.SIGNATURES)
    for stem, text in sources.items():
        for name in _build.SIGNATURES[stem]:
            assert re.search(rf"\b{name}\(", text), (stem, name)
        for name in re.findall(r'extern "C" [\w ]+?\b(\w+)\(', text):
            assert name in _build.SIGNATURES[stem], (stem, name)


def test_distributed_exports_the_reference_names():
    """``repro_torch.distributed`` exports the reference's public names."""
    import ast
    tree = ast.parse((REPO / "src" / "repro" / "distributed"
                      / "__init__.py").read_text())
    want = next(node.value for node in tree.body
                if isinstance(node, ast.Assign)
                and node.targets[0].id == "__all__")
    want = [elt.value for elt in want.elts]
    sys.path.insert(0, str(REPO / "src"))
    import repro_torch.distributed as port
    assert len(want) == 21
    assert sorted(port.__all__) == sorted(want)
    for name in want:
        assert hasattr(port, name), name


def test_obs_exports_the_reference_names():
    """``repro_torch.obs`` exports the reference's 8 public names."""
    import ast
    tree = ast.parse((REPO / "src" / "repro" / "obs"
                      / "__init__.py").read_text())
    want = next(node.value for node in tree.body
                if isinstance(node, ast.Assign)
                and node.targets[0].id == "__all__")
    want = [elt.value for elt in want.elts]
    sys.path.insert(0, str(REPO / "src"))
    import repro_torch.obs as port
    assert len(want) == 8
    assert sorted(port.__all__) == sorted(want)
    for name in want:
        assert hasattr(port, name), name


def test_training_and_sharding_export_the_reference_names():
    """``repro_torch.training`` and ``repro_torch.sharding`` export the
    reference's public names (sharding's seven: the rules' four and the
    planner's three, with the port's ``apply_expert_permutation``), and
    ``models`` has ``forward_train``."""
    import ast
    sys.path.insert(0, str(REPO / "src"))
    import repro_torch.models as models
    import repro_torch.sharding as sharding
    import repro_torch.training as training

    def imported(pkg):
        tree = ast.parse((REPO / "src" / "repro" / pkg
                          / "__init__.py").read_text())
        return {alias.name for node in tree.body
                if isinstance(node, ast.ImportFrom) for alias in node.names}

    for name in imported("training"):
        assert hasattr(training, name), name
    want = imported("sharding")
    assert want == {"batch_spec", "cache_shardings", "param_shardings",
                    "state_shardings", "PartitionPlanner",
                    "expert_placement", "stage_assignment"}
    for name in want | {"apply_expert_permutation"}:
        assert hasattr(sharding, name), name
    assert callable(models.forward_train)
