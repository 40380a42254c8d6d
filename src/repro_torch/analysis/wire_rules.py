"""Static wire-contract checker (DESIGN.md §16.5, §14.5), PyTorch port of
``repro.analysis.wire_rules``.

Sizes the distributed exchange buffers *symbolically* — the port's
shard-stacked reducers of :mod:`repro_torch.distributed.protocol`
(``shard_cost_from_aggregate``, ``local_candidates``,
``candidate_deltas``, ``shard_load_partials``) run on ``meta`` tensors,
the torch counterpart of ``jax.eval_shape``, so nothing executes — and
proves two properties without running a driver:

  * the per-turn payload a shard ships (its :class:`protocol.Candidate`,
    the traced identity deltas, the O(K) load partial) has a byte size
    that does not depend on N: evaluated over an N grid the symbolic
    sizes are constant and equal to the measured-wire constants
    (``CANDIDATE_BYTES`` = 16, ``TRACE_PARTIAL_BYTES`` = 8,
    ``load_partial_bytes(K)`` = 4K).  The port's reducers take an
    (S, Ns, ...) stack of every shard's block, so a shard's bytes are
    the stack's bytes divided by S;
  * the analytic ledger (:func:`accounting.ledger_for_run`) charges
    per-round bytes that are independent of N for every driver flag
    combination — only the ONE-TIME ghost sync may scale with the
    boundary size.

Both checks take the sizing/ledger callables as injectable arguments so
the seeded-violation tests can prove the rule fires on an N-dependent
payload.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch.utils._pytree import tree_flatten

from .registry import AnalysisContext, Finding, rule

__all__ = ["tree_bytes", "stacked_candidate", "symbolic_candidate_bytes",
           "symbolic_delta_bytes", "symbolic_load_partial_bytes",
           "candidate_findings", "ledger_findings", "N_GRID", "SHARDS"]

N_GRID = (32, 256, 4096)
_K_GRID = (2, 4, 7)
SHARDS = 4          # the stack's S; the reference sizes one shard of N/4


def tree_bytes(tree) -> int:
    """Total byte size of a pytree of tensors (``meta`` ones included)."""
    return sum(int(math.prod(leaf.shape)) * leaf.element_size()
               for leaf in tree_flatten(tree)[0]
               if isinstance(leaf, torch.Tensor))


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def stacked_candidate(agg, r_local, b, ids, valid, r, loads, speeds, mu,
                      total_b, machine, framework, with_deltas=False):
    """Every shard's candidate for ``machine``'s turn from the (S, Ns, K)
    stack of block aggregates, as the emulated incremental drivers build
    it: the shared cost assembly, the Eq.-4 reduction, the per-shard
    election and (traced) the identity deltas.  Returns the (S,)
    :class:`protocol.Candidate` (and the (S,) ΔC_0, ΔCt_0)."""
    from ..core import costs
    from ..distributed import protocol
    s, ns, k = agg.shape
    cost = protocol.shard_cost_from_aggregate(
        agg.reshape(s * ns, k), r_local.reshape(-1), b.reshape(-1), loads,
        speeds, mu, total_b, framework)
    dissat, best = costs.dissatisfaction_from_cost(cost, r_local.reshape(-1))
    cand, loc = protocol.local_candidates(
        dissat.view(s, ns), best.view(s, ns), r_local, b, ids, valid,
        machine)
    if not with_deltas:
        return cand
    dc0, dct0 = protocol.candidate_deltas(
        agg, cand, loc, machine, loads.expand(s, k), speeds.expand(s, k),
        mu.reshape(1).expand(s), total_b.reshape(1).expand(s))
    return cand, dc0, dct0


def _stack_operands(n: int, k: int, s: int = SHARDS):
    rows = max(n // s, 1)
    f32, i32 = torch.float32, torch.int32
    return (_meta((s, rows, k), f32), _meta((s, rows), i32),
            _meta((s, rows), f32), _meta((s, rows), i32),
            _meta((s, rows), torch.bool), _meta((n,), i32),
            _meta((k,), f32), _meta((k,), f32), _meta((), f32),
            _meta((), f32))


def symbolic_candidate_bytes(n: int, k: int, *, with_deltas: bool = False,
                             candidate_fn: Callable | None = None):
    """(candidate_bytes, delta_bytes) ONE shard of an S-shard stack of
    ``n // S`` rows each ships, sized on meta tensors — no FLOP runs."""
    fn = candidate_fn or stacked_candidate
    out = fn(*_stack_operands(n, k), 0, "c", with_deltas=with_deltas)
    if with_deltas:
        cand, dc0, dct0 = out
        return tree_bytes(cand) // SHARDS, tree_bytes((dc0, dct0)) // SHARDS
    return tree_bytes(out) // SHARDS, 0


def symbolic_delta_bytes(n: int, k: int,
                         candidate_fn: Callable | None = None) -> int:
    return symbolic_candidate_bytes(n, k, with_deltas=True,
                                    candidate_fn=candidate_fn)[1]


def symbolic_load_partial_bytes(n: int, k: int) -> int:
    from ..distributed import protocol
    _, r_local, b, _, valid, *_ = _stack_operands(n, k)
    out = protocol.shard_load_partials(b, valid, r_local, k)
    return tree_bytes(out) // SHARDS


def candidate_findings(candidate_fn: Callable | None = None) -> list[Finding]:
    """Per-exchange buffers: constant over N, equal to the ledger constants."""
    from ..distributed import protocol
    findings: list[Finding] = []
    for k in _K_GRID:
        cand_sizes = {symbolic_candidate_bytes(n, k,
                                               candidate_fn=candidate_fn)[0]
                      for n in N_GRID}
        delta_sizes = {symbolic_delta_bytes(n, k, candidate_fn=candidate_fn)
                       for n in N_GRID}
        load_sizes = {symbolic_load_partial_bytes(n, k) for n in N_GRID}
        if len(cand_sizes) > 1:
            findings.append(Finding(
                rule="wire-candidate-bytes", key=f"candidate-n-dep:k{k}",
                message=f"candidate payload depends on N at K={k}: "
                        f"sizes {sorted(cand_sizes)} over N grid {N_GRID} "
                        f"— the O(K) wire contract is broken"))
        elif cand_sizes != {protocol.CANDIDATE_BYTES}:
            findings.append(Finding(
                rule="wire-candidate-bytes", key=f"candidate-const:k{k}",
                message=f"symbolic candidate size {cand_sizes} != "
                        f"protocol.CANDIDATE_BYTES="
                        f"{protocol.CANDIDATE_BYTES} at K={k}"))
        if len(delta_sizes) > 1 or \
                delta_sizes != {protocol.TRACE_PARTIAL_BYTES}:
            findings.append(Finding(
                rule="wire-candidate-bytes", key=f"deltas:k{k}",
                message=f"traced identity-delta payload {sorted(delta_sizes)}"
                        f" != TRACE_PARTIAL_BYTES="
                        f"{protocol.TRACE_PARTIAL_BYTES} (or varies with N) "
                        f"at K={k}"))
        if len(load_sizes) > 1 or \
                load_sizes != {protocol.load_partial_bytes(k)}:
            findings.append(Finding(
                rule="wire-candidate-bytes", key=f"load-partial:k{k}",
                message=f"load partial {sorted(load_sizes)} != "
                        f"load_partial_bytes({k})="
                        f"{protocol.load_partial_bytes(k)} (or varies "
                        f"with N)"))
    return findings


@rule("wire-candidate-bytes", "wire")
def _rule_candidate_bytes(ctx: AnalysisContext) -> list[Finding]:
    """Exchange buffers sized on meta tensors match the O(K) constants."""
    findings = candidate_findings()
    ctx.reports["wire-candidate-bytes"] = {
        "n_grid": list(N_GRID), "k_grid": list(_K_GRID),
        "violations": len(findings)}
    return findings


def _synthetic_stats(n: int, s: int = 4):
    """BoundaryStats whose every N-scalable field actually scales with N,
    so an N-dependent ledger term cannot hide."""
    from ..distributed.views import BoundaryStats
    return BoundaryStats(
        num_shards=s, num_nodes=n,
        boundary_nodes=np.full(s, n // 8, np.int64),
        ghost_nodes=np.full(s, n // 4, np.int64),
        cross_edges=np.full(s, n // 2, np.int64))


_FLAG_COMBOS = (
    # (traced, simultaneous, incremental) — the driver flag space
    (False, False, True), (False, False, False),
    (True, False, True), (True, False, False),
    (False, True, True), (False, True, False),
)


def ledger_recurring_bytes(k: int, n: int, traced: bool, simultaneous: bool,
                           incremental: bool, rounds: int = 10,
                           ledger_fn: Callable | None = None) -> int:
    """The ledger's candidate + trace + setup bytes of a ``rounds``-round
    run at (N, K) — what must not depend on N."""
    from ..distributed import accounting
    fn = ledger_fn or accounting.ledger_for_run
    led = fn(_synthetic_stats(n), k, rounds, traced=traced,
             simultaneous=simultaneous, incremental=incremental)
    return led.candidate_bytes + led.trace_bytes + led.setup_bytes


def ledger_findings(ledger_fn: Callable | None = None,
                    rounds: int = 10) -> list[Finding]:
    """Every recurring ledger term is independent of N (ghost sync is the
    one documented one-time N-scaling term and is excluded)."""
    findings: list[Finding] = []
    for k in _K_GRID:
        for traced, simultaneous, incremental in _FLAG_COMBOS:
            recurring = {n: ledger_recurring_bytes(
                k, n, traced, simultaneous, incremental, rounds, ledger_fn)
                for n in N_GRID}
            if len(set(recurring.values())) > 1:
                flags = f"traced={traced},simult={simultaneous}," \
                        f"incr={incremental}"
                findings.append(Finding(
                    rule="wire-ledger-n-independent",
                    key=f"k{k}:{flags}",
                    message=f"ledger recurring bytes depend on N at K={k} "
                            f"({flags}): {recurring} — per-round wire "
                            f"must be O(K), not O(N) (DESIGN.md §14.5)"))
    return findings


@rule("wire-ledger-n-independent", "wire")
def _rule_ledger(ctx: AnalysisContext) -> list[Finding]:
    """ledger_for_run recurring bytes are N-independent for all flags."""
    findings = ledger_findings()
    ctx.reports["wire-ledger-n-independent"] = {
        "n_grid": list(N_GRID), "flag_combos": len(_FLAG_COMBOS),
        "violations": len(findings)}
    return findings


@rule("wire-ledger-formulas", "wire")
def _rule_formulas(ctx: AnalysisContext) -> list[Finding]:
    """Ledger formulas reconcile with the symbolically sized buffers."""
    from ..distributed import accounting, protocol
    findings: list[Finding] = []
    for k in _K_GRID:
        cand = symbolic_candidate_bytes(256, k)[0]
        delta = symbolic_delta_bytes(256, k)
        load = symbolic_load_partial_bytes(256, k)
        for s in (2, 5):
            # sequential-turn payloads, re-derived from symbolic sizes
            expect = {
                (False, True): s * cand,
                (False, False): s * cand,
                (True, True): s * (cand + delta),
                (True, False): s * (cand + delta + load),
            }
            for (traced, incremental), want in expect.items():
                got = accounting.turn_payload_bytes(
                    s, k, traced=traced, incremental=incremental)
                if got != want:
                    findings.append(Finding(
                        rule="wire-ledger-formulas",
                        key=f"turn:s{s}:k{k}:traced{traced}:"
                            f"incr{incremental}",
                        message=f"turn_payload_bytes(S={s}, K={k}, "
                                f"traced={traced}, incr={incremental})="
                                f"{got} != {want} derived from the "
                                f"meta-tensor buffer sizes"))
        if accounting.setup_bytes(k) != load + 4:
            findings.append(Finding(
                rule="wire-ledger-formulas", key=f"setup:k{k}",
                message=f"setup_bytes({k})={accounting.setup_bytes(k)} != "
                        f"load partial + scalar B = {load + 4}"))
    if protocol.CANDIDATE_BYTES != symbolic_candidate_bytes(256, 4)[0]:
        findings.append(Finding(
            rule="wire-ledger-formulas", key="candidate-const",
            message="CANDIDATE_BYTES no longer matches the Candidate "
                    "NamedTuple's symbolic size"))
    return findings
