"""repro_torch.analysis — the contract linter (DESIGN.md §16), PyTorch port
of ``repro.analysis``.

Verifies the invariants the whole stack rests on: nothing extra on
telemetry-disabled paths, an f32-only dataflow, one-signature sweep
groups, the canonical 9-arg ``dissat_fn`` convention, the single Eq.-4
θ-subtraction site (in the Python and the CUDA sources), no host reads
in CUDA-graph-captured bodies, the dense/sparse × runtime dispatch
matrix, the O(K) wire contract, and memory and work that grow no faster
than each module declares (DESIGN.md §18).

Module, rule and finding names and CLI flags are the reference's
wherever the statement is the same, so the two packages' ``--json``
reports diff line by line.  One difference of means: the reference's
"jaxpr" family walks staged jaxprs; the port's walks the aten-op
**record** of each entry point's run (set-up plus one turn), captured
by a ``TorchDispatchMode`` (:mod:`repro_torch.analysis.entrypoints`).

Entry points run on the card unless the caller asks for the CPU::

    python -m repro_torch.analysis --check [--json out.json]
    python -m repro_torch.analysis --check --device cpu \\
        --complexity-grid quick

Known gaps live in the checked-in ``baseline.json``; ``--check`` fails
only on NEW findings.  The package imports torch, numpy and the
standard library, and nothing of the JAX reference.
"""
from .registry import (AnalysisContext, FAMILIES, Finding, Rule,
                       check_device, default_baseline_path, load_baseline,
                       registered_rules, rule, run_rules, split_findings)

# importing the rule modules populates the registry
from . import (ast_rules, complexity_rules, docs_rules,  # noqa: E402,F401
               jaxpr_rules, wire_rules)
from . import entrypoints  # noqa: E402,F401

__all__ = [
    "AnalysisContext", "FAMILIES", "Finding", "Rule", "rule",
    "registered_rules", "run_rules", "load_baseline", "split_findings",
    "default_baseline_path", "check_device", "entrypoints", "ast_rules",
    "complexity_rules", "docs_rules", "jaxpr_rules", "wire_rules",
]
