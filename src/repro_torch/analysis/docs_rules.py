"""Docs-consistency rules (formerly inlined in ``tests/test_docs.py``).

Two rot modes are caught, now as registry rules so the CLI and CI get
them alongside the contract lint (``tests/test_docs.py`` remains as a
thin wrapper so tier-1 behavior is unchanged):

  * ``docs-design-refs`` — every ``DESIGN.md §N[.M]`` citation in
    ``src/`` resolves to an actual DESIGN.md header; the extraction
    itself is guarded (≥ 10 citing files, the anchor sections exist).
  * ``docs-file-refs`` — every all-caps doc-file mention under
    ``src``/``tests``/``benchmarks``/``examples`` names a file that is
    actually in the repo root.
"""
from __future__ import annotations

import re

from .registry import AnalysisContext, Finding, rule

__all__ = ["REF_RE", "HEADER_RE", "DOCFILE_RE", "DOCFILE_SCAN_DIRS",
           "design_sections", "design_ref_findings", "doc_file_findings"]

REF_RE = re.compile(r"DESIGN\.md\s+§(\d+(?:\.\d+)?)")
HEADER_RE = re.compile(r"^#{1,6}\s.*?§(\d+(?:\.\d+)?)", re.MULTILINE)
DOCFILE_RE = re.compile(r"\b([A-Z][A-Z0-9_]*\.md)\b")
DOCFILE_SCAN_DIRS = ("src", "tests", "benchmarks", "examples")
# files that legitimately name nonexistent docs (as examples/messages)
_DOCFILE_EXEMPT = ("tests/test_docs.py",)
_MIN_CITING_FILES = 10


def design_sections(ctx: AnalysisContext) -> set[str]:
    return set(HEADER_RE.findall(ctx.source("DESIGN.md")))


def design_ref_findings(ctx: AnalysisContext) -> list[Finding]:
    findings: list[Finding] = []
    sections = design_sections(ctx)
    for anchor in ("1", "12"):
        if anchor not in sections:
            findings.append(Finding(
                rule="docs-design-refs", key=f"anchor:{anchor}",
                file="DESIGN.md",
                message=f"DESIGN.md anchor section §{anchor} is gone — "
                        f"header extraction is likely broken"))
    citing = 0
    for path in ctx.py_files("src"):
        found = set(REF_RE.findall(ctx.source(path)))
        if found:
            citing += 1
        for ref in sorted(found - sections):
            findings.append(Finding(
                rule="docs-design-refs", key=f"{path}:§{ref}", file=path,
                message=f"{path} cites DESIGN.md §{ref}, which has no "
                        f"header (valid: {sorted(sections)})"))
    if citing < _MIN_CITING_FILES:
        findings.append(Finding(
            rule="docs-design-refs", key="too-few-citing-files",
            message=f"only {citing} files under src/ cite DESIGN.md "
                    f"sections (expected ≥ {_MIN_CITING_FILES}) — the "
                    f"reference extraction is probably matching nothing"))
    return findings


@rule("docs-design-refs", "docs")
def _rule_design_refs(ctx: AnalysisContext) -> list[Finding]:
    """Every DESIGN.md § citation in src/ resolves to a real header."""
    return design_ref_findings(ctx)


def doc_file_findings(ctx: AnalysisContext) -> list[Finding]:
    findings: list[Finding] = []
    for d in DOCFILE_SCAN_DIRS:
        for path in ctx.py_files(d):
            if path in _DOCFILE_EXEMPT:
                continue
            for name in sorted(set(DOCFILE_RE.findall(ctx.source(path)))):
                if not (ctx.repo / name).is_file():
                    findings.append(Finding(
                        rule="docs-file-refs", key=f"{path}:{name}",
                        file=path,
                        message=f"{path} references repo doc {name!r}, "
                                f"which does not exist in the repo root"))
    return findings


@rule("docs-file-refs", "docs")
def _rule_doc_files(ctx: AnalysisContext) -> list[Finding]:
    """Every all-caps doc-file mention in code names an existing root doc."""
    return doc_file_findings(ctx)
