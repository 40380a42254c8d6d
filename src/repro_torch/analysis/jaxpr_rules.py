"""Record-family analyzers: walk the entry points' aten-op records
(DESIGN.md §16.3), PyTorch port of ``repro.analysis.jaxpr_rules``.

The family keeps the reference's name and rule names; what it walks is
the :class:`~repro_torch.analysis.entrypoints.Record` of each entry
point's run (set-up plus one turn) instead of a staged jaxpr.  Three
properties:

  * **zero-callback** — with ``recorder=None`` no op of any registered
    entry point is dispatched from a frame under ``repro_torch/obs/``
    (the telemetry seams of DESIGN.md §14 must run NOTHING when
    disabled), and its host reads (``aten._local_scalar_dense``) do not
    exceed what the recorder-free loop needs, pinned per entry point in
    :data:`HOST_READS` as ``tests/test_torch_obs.py`` pins op counts.
    A read the pins do not expect is a finding.
  * **dtype-drift** — no op output anywhere in any entry point's record
    leaves the f32 dataflow: no float64, float16, bfloat16 or complex.
    One difference from the reference's ``_ALLOWED_DTYPES``: int64 is
    allowed, because torch's index ops (``argmax``, ``topk``,
    ``nonzero``, ``sort`` indices, ``arange`` defaults) return it by
    contract, where jax keeps 32-bit indices; the potentials and
    dissatisfaction values themselves stay f32.
  * **compile-cache audit** — over the canonical sweep grouping grid,
    every case inside one ``sweeps.runtime._group_key`` group must stack
    into operands of one signature (pytree structure + per-element leaf
    shapes/dtypes), i.e. each group runs as one batched program.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten

from .registry import AnalysisContext, Finding, rule
from .entrypoints import (HOST_READ_OP, as_pytree, canonical_assignment,
                          canonical_problem, canonical_sparse)

__all__ = ["callback_primitives", "obs_dispatches",
           "host_reads", "dtype_drift", "HOST_READS", "canonical_sweep_cases",
           "case_signature", "group_signature_findings"]

# the dtypes the potential/dissatisfaction dataflow may produce;
# everything else (f64, f16/bf16, complex) is drift
_ALLOWED_DTYPES = frozenset({
    "bool", "int8", "uint8", "int16", "uint16", "int32", "uint32",
    "int64", "float32",
})

_OBS_DIR = "src/repro_torch/obs/"

# The most host reads the recorder-free set-up + one turn needs: the
# sweep loops read their convergence flag once a sweep (``refine_sweeps``'
# ``bool``), the batched sweep drivers once a sweep per element; the turn
# loops read nothing before their first ``_SYNC_EVERY`` boundary.  The
# unbounded sweep reads its flag and count with ``.tolist()`` (a
# device-to-host copy, not ``_local_scalar_dense``) and, when a node
# moves, ``add_windows``' deepest row group (one read; whether a node
# moves in the first sweep depends on the device's coin draws).
HOST_READS = {
    "refine": 0, "refine.recompute": 0, "refine.theta": 0,
    "refine.kernel": 0, "refine_traced": 0, "refine_simultaneous": 1,
    "refine.sparse": 0, "refine_traced.sparse": 0,
    "refine.sparse.edge_kernel": 0, "refine_sweeps": 1,
    "refine_sweeps.multi": 1, "refine_sweeps.sparse.unbounded": 1,
    "batch.refine": 0, "batch.refine_traced": 0,
    "batch.refine_simultaneous": 2, "batch.refine_sweeps": 2,
    "distributed.refine": 0, "distributed.refine_traced": 0,
    "distributed.refine_simultaneous": 1, "distributed.shard_map": 0,
    "des.tick": 0,
}


def obs_dispatches(record) -> list[str]:
    """Overload names of every op dispatched with a ``repro_torch/obs/``
    source on the stack."""
    return [op.overload for op in record.ops
            if any(f.startswith(_OBS_DIR) for f in op.files)]


def host_reads(record) -> int:
    return sum(op.name == HOST_READ_OP for op in record.ops)


def callback_primitives(record, name: str | None = None) -> list[str]:
    """The record's telemetry dispatches, plus one ``host-read`` entry for
    each host read beyond ``name``'s pin (every read, without a name)."""
    extra = host_reads(record) - (HOST_READS.get(name, 0) if name else 0)
    return obs_dispatches(record) + ["host-read"] * max(extra, 0)


def dtype_drift(record) -> list[tuple[str, str]]:
    """Sorted ``(dtype, op)`` pairs for every off-contract dtype produced
    by any op output (one representative op each)."""
    seen: dict[str, str] = {}
    for op in record.ops:
        for name in op.dtypes:
            if name not in _ALLOWED_DTYPES:
                seen.setdefault(name, op.overload)
    return sorted(seen.items())


@rule("jaxpr-zero-callback", "jaxpr")
def _rule_zero_callback(ctx: AnalysisContext) -> list[Finding]:
    """recorder=None runs dispatch nothing from obs and no extra host read."""
    findings = []
    for name, rec in ctx.entry_jaxprs().items():
        for op in sorted(set(obs_dispatches(rec))):
            findings.append(Finding(
                rule="jaxpr-zero-callback", key=f"{name}:{op}",
                message=f"entry point {name!r} dispatches {op!r} from "
                        f"repro_torch.obs on its telemetry-disabled path "
                        f"(must be identical to the pre-telemetry "
                        f"program — DESIGN.md §14.2)"))
        reads, pinned = host_reads(rec), HOST_READS.get(name)
        if pinned is None or reads > pinned:
            findings.append(Finding(
                rule="jaxpr-zero-callback", key=f"{name}:host-reads",
                message=f"entry point {name!r} makes {reads} host reads "
                        f"({HOST_READ_OP}) in its set-up and first turn; "
                        f"the recorder-free loop needs {pinned} "
                        f"(jaxpr_rules.HOST_READS)"))
    ctx.reports["jaxpr-zero-callback"] = {
        "entry_points": sorted(ctx.entry_jaxprs()),
        "host_reads": {name: host_reads(rec)
                       for name, rec in sorted(ctx.entry_jaxprs().items())}}
    return findings


@rule("jaxpr-dtype-drift", "jaxpr")
def _rule_dtype_drift(ctx: AnalysisContext) -> list[Finding]:
    """No op output leaves the f32 dataflow (any entry point)."""
    findings = []
    for name, rec in ctx.entry_jaxprs().items():
        for dtype, op in dtype_drift(rec):
            findings.append(Finding(
                rule="jaxpr-dtype-drift", key=f"{name}:{dtype}",
                message=f"entry point {name!r} produces a {dtype} value "
                        f"(first seen at {op!r}); the bitwise contracts "
                        f"require the f32 dataflow"))
    return findings


# -- stacking audit over the sweep grouping grid ----------------------------

def canonical_sweep_cases(device: str = "cpu"):
    """The canonical grouping grid: (framework, theta-ness, problem shape)
    with two same-shape dense problems per combination, a second dense
    shape, and a sparse problem — 16 cases in 12 groups."""
    from ..sweeps.runtime import SweepCase
    probs = [canonical_problem(16, 3, seed=3, device=device),
             canonical_problem(16, 3, seed=11, device=device),
             canonical_problem(24, 3, seed=5, device=device),
             canonical_sparse(16, 3, seed=3, device=device)]
    cases = []
    for p in probs:
        n = p.num_nodes
        r0 = canonical_assignment(n, 3, device)
        for fw in ("c", "ct"):
            for theta in (None, 0.3):
                cases.append(SweepCase(problem=p, assignment=r0,
                                       framework=fw, theta=theta,
                                       label=f"n{n}-{fw}-{theta}"))
    return cases


def case_signature(case):
    """The signature surrogate of one case: the pytree structure and
    per-element leaf (shape, dtype) of its single-case stack (a static
    leaf, such as a sparse problem's ``max_degree``, by value).  Two
    cases in the same group stack into one batched program iff these
    agree."""
    from ..sweeps.runtime import _stack_group
    operands = _stack_group([case])
    leaves, treedef = tree_flatten(as_pytree(operands))
    return (str(treedef),
            tuple((tuple(leaf.shape[1:]), str(leaf.dtype))
                  if isinstance(leaf, torch.Tensor) else repr(leaf)
                  for leaf in leaves))


def group_signature_findings(cases) -> tuple[list[Finding], dict]:
    """Audit: every ``_group_key`` group must hold exactly one signature."""
    from ..sweeps.runtime import _group_key
    groups: dict = {}
    for case in cases:
        groups.setdefault(_group_key(case), []).append(case)
    findings = []
    for gkey, gcases in groups.items():
        sigs = {}
        for case in gcases:
            sigs.setdefault(case_signature(case), []).append(case.label)
        if len(sigs) > 1:
            fw, theta_none, shape = gkey
            labels = sorted(l for ls in sigs.values() for l in ls)
            findings.append(Finding(
                rule="sweep-compile-groups",
                key=f"{fw}:{'nothet' if theta_none else 'theta'}:{shape}",
                message=f"sweep group {gkey} holds {len(sigs)} distinct "
                        f"stacking signatures across cases {labels} — the "
                        f"group would run {len(sigs)} programs instead of "
                        f"one"))
    report = {"cases": len(cases), "groups": len(groups),
              "violations": len(findings)}
    return findings, report


@rule("sweep-compile-groups", "jaxpr")
def _rule_compile_groups(ctx: AnalysisContext) -> list[Finding]:
    """Each canonical sweep group presents exactly one stacking signature."""
    findings, report = group_signature_findings(
        canonical_sweep_cases(str(ctx.device)))
    ctx.reports["sweep-compile-groups"] = report
    return findings
