"""Rule registry + analysis context for the contract linter (DESIGN.md §16),
PyTorch port of ``repro.analysis.registry``.

The linter is a flat registry of named rules grouped into five families:

  * ``jaxpr`` — run the registered public entry points
    (:mod:`repro_torch.analysis.entrypoints`) under a recording
    ``TorchDispatchMode`` and walk the aten-op records: nothing
    dispatched from the telemetry package on ``recorder=None`` paths and
    no more host reads than the recorder-free loop needs, no dtype drift
    out of the f32 potential dataflow, and a stacking audit over the
    sweep grouping grid.  (The family keeps the reference's name; in the
    port a "jaxpr" is the aten-op record of one run.)
  * ``ast``   — stdlib-``ast`` lint over ``src/repro_torch`` (and a text
    scan of the CUDA sources): the canonical 9-arg ``dissat_fn``
    signature, the single Eq.-4 θ-subtraction site, host reads inside
    CUDA-graph-captured bodies, and the dense/sparse × runtime
    dispatch-coverage matrix.
  * ``wire``  — size the exchange buffers on ``meta`` tensors over
    :mod:`repro_torch.distributed.protocol` and prove the per-round
    ledger bytes are independent of N.
  * ``docs``  — the DESIGN.md-§ and doc-file reference scans.
  * ``complexity`` — rerun every entry point over a geometric size grid,
    fit peak-bytes/op-count power laws against per-module declared
    budgets, audit collective schedules, and diff fitted exponents
    against the checked-in ``complexity.json`` (DESIGN.md §18).

Findings carry a stable id ``rule:key``.  A checked-in baseline file
(:func:`load_baseline`) absorbs *known* gaps so CI fails only on NEW
findings, never on the documented ones.

Entry points run on ``AnalysisContext.device``: the card unless the
caller asks for the CPU (``device="cpu"``).  A CUDA device on a host
without CUDA raises at once; nothing carries on on the CPU.
"""
from __future__ import annotations

import ast
import contextlib
import dataclasses
import json
import pathlib
from typing import Callable, Iterable

import torch

__all__ = [
    "Finding", "Rule", "AnalysisContext", "rule", "registered_rules",
    "run_rules", "load_baseline", "split_findings", "default_baseline_path",
    "FAMILIES", "check_device", "walk_functions",
]

FAMILIES = ("jaxpr", "ast", "wire", "docs", "complexity")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation (or documented gap) with a stable identity."""
    rule: str
    key: str          # stable within the rule — the baseline matches on it
    message: str
    file: str = ""    # repo-relative path, when the finding has a location
    line: int = 0

    @property
    def id(self) -> str:
        return f"{self.rule}:{self.key}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "key": self.key, "message": self.message,
                "file": self.file, "line": self.line, "id": self.id}


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    family: str
    doc: str
    fn: Callable[["AnalysisContext"], list[Finding]]


_RULES: dict[str, Rule] = {}


def rule(name: str, family: str):
    """Register ``fn(ctx) -> list[Finding]`` under ``name``.

    Adding a rule is: write the function, decorate it, done — the CLI,
    the baseline machinery and ``tests/test_torch_analysis.py`` pick it
    up from the registry (DESIGN.md §16.2).
    """
    if family not in FAMILIES:
        raise ValueError(f"unknown rule family {family!r}; "
                         f"expected one of {FAMILIES}")

    def deco(fn):
        if name in _RULES:
            raise ValueError(f"duplicate rule name {name!r}")
        _RULES[name] = Rule(name=name, family=family,
                            doc=(fn.__doc__ or "").strip().splitlines()[0]
                            if fn.__doc__ else "", fn=fn)
        return fn
    return deco


def registered_rules(families: Iterable[str] | None = None) -> list[Rule]:
    fams = set(families) if families is not None else set(FAMILIES)
    return [r for r in _RULES.values() if r.family in fams]


def walk_functions(tree: ast.Module):
    """Yield ``(qualname, node)`` for every (async) function def, with
    class / enclosing-function qualification."""
    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                yield qual, child
                yield from walk(child, qual + ".")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)
    yield from walk(tree, "")


def _default_repo_root() -> pathlib.Path:
    # src/repro_torch/analysis/registry.py -> repo root is three levels
    # above src
    return pathlib.Path(__file__).resolve().parents[3]


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device where CUDA is not
    available raises ``RuntimeError`` (the linter never moves to the
    CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch.analysis runs its entry points on the card by "
            "default, and CUDA is not available here; pass device='cpu' "
            "(--device cpu) to run them on the CPU")
    return dev


class AnalysisContext:
    """Shared state for one analysis run: cached sources/ASTs, lazily
    recorded entry-point runs, and the per-rule report stash.

    ``source_overrides`` maps repo-relative paths to replacement source
    text — the seeded-violation tests use it to lint a deliberately
    broken copy of a module (Python or CUDA) without touching the tree
    on disk.

    ``complexity_grid`` selects the size grid the complexity family
    reruns on ("full" for the CLI and the card, "quick" for the test
    suite — see ``complexity_rules.GRIDS``).  ``device`` is where every
    entry point runs (default: the card).
    """

    def __init__(self, repo_root: pathlib.Path | str | None = None,
                 source_overrides: dict[str, str] | None = None,
                 complexity_grid: str = "full", device="cuda"):
        self.repo = pathlib.Path(repo_root) if repo_root else \
            _default_repo_root()
        self.source_overrides = dict(source_overrides or {})
        self.complexity_grid = complexity_grid
        self.device = check_device(device)
        self._sources: dict[str, str] = {}
        self._trees: dict[str, ast.Module] = {}
        self._files: dict[tuple, list[str]] = {}
        self._functions: dict[str, list] = {}
        self._jaxprs = None
        self.reports: dict[str, dict] = {}

    # -- sources / ASTs ----------------------------------------------------
    def source(self, relpath: str) -> str:
        if relpath not in self._sources:
            if relpath in self.source_overrides:
                self._sources[relpath] = self.source_overrides[relpath]
            else:
                self._sources[relpath] = (self.repo / relpath).read_text()
        return self._sources[relpath]

    def tree(self, relpath: str) -> ast.Module:
        if relpath not in self._trees:
            self._trees[relpath] = ast.parse(self.source(relpath),
                                             filename=relpath)
        return self._trees[relpath]

    def functions(self, relpath: str) -> list:
        """``(qualname, node)`` of every function defined in the file
        (cached)."""
        if relpath not in self._functions:
            self._functions[relpath] = list(walk_functions(
                self.tree(relpath)))
        return self._functions[relpath]

    def files(self, *dirs: str, suffixes: tuple[str, ...] = (".py",)
              ) -> list[str]:
        """Repo-relative paths of every file with one of ``suffixes``
        under the given dirs, plus any override paths that fall under
        them."""
        if (dirs, suffixes) in self._files:
            return self._files[dirs, suffixes]
        out: set[str] = set()
        for d in dirs:
            base = self.repo / d
            prefix = d.rstrip("/") + "/"
            if base.is_dir():
                out.update(str(p.relative_to(self.repo))
                           for p in base.rglob("*")
                           if p.is_file() and p.suffix in suffixes)
            out.update(p for p in self.source_overrides
                       if p.startswith(prefix)
                       and pathlib.PurePath(p).suffix in suffixes)
        self._files[dirs, suffixes] = sorted(out)
        return self._files[dirs, suffixes]

    def py_files(self, *dirs: str) -> list[str]:
        """Repo-relative paths of every .py file under the given dirs,
        plus any override paths that fall under them."""
        return self.files(*dirs)

    # -- entry-point records ----------------------------------------------
    @contextlib.contextmanager
    def sessions(self):
        """Hold every entry point's session (the collective driver's
        one-rank process group) open while the body runs, so the rules
        inside make it once, not once a run or a profile."""
        from . import entrypoints
        with contextlib.ExitStack() as stack:
            for ep in entrypoints.registered_entry_points():
                if ep.session is not None:
                    stack.enter_context(ep.session(str(self.device)))
            yield self

    def entry_jaxprs(self) -> dict[str, object]:
        """name -> :class:`~repro_torch.analysis.entrypoints.Record` of
        every registered entry point's run on ``self.device`` (lazy; each
        runs once per context, and once per process and device thanks to
        the ``entrypoints`` module cache).  The reference's name is kept:
        the record is the port's counterpart of the traced jaxpr."""
        if self._jaxprs is None:
            from . import entrypoints
            self._jaxprs = entrypoints.trace_all(str(self.device))
        return self._jaxprs


_RUNNING = ("jaxpr", "complexity")     # the families that run entry points


def run_rules(ctx: AnalysisContext,
              families: Iterable[str] | None = None) -> list[Finding]:
    rules = registered_rules(families)
    findings: list[Finding] = []
    hold = any(r.family in _RUNNING for r in rules)
    with ctx.sessions() if hold else contextlib.nullcontext():
        for r in rules:
            findings.extend(r.fn(ctx))
    return findings


# -- baseline --------------------------------------------------------------

def default_baseline_path() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent / "baseline.json"


def load_baseline(path: pathlib.Path | str | None = None) -> set[str]:
    """The set of finding ids (``rule:key``) that are known and accepted."""
    p = pathlib.Path(path) if path else default_baseline_path()
    if not p.is_file():
        return set()
    data = json.loads(p.read_text())
    return {f"{e['rule']}:{e['key']}" for e in data.get("findings", [])}


def split_findings(findings: list[Finding], baseline: set[str]):
    """Partition into (new, known) and report stale baseline ids.

    Returns ``(new, known, stale)`` where ``stale`` is the set of
    baseline ids no current finding matches — the gap got fixed, so the
    baseline entry should be deleted (reported, never fatal).
    """
    new = [f for f in findings if f.id not in baseline]
    known = [f for f in findings if f.id in baseline]
    stale = baseline - {f.id for f in findings}
    return new, known, stale
