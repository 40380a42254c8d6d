"""Registry of public entry points the record analyzers run (DESIGN.md §16.3),
PyTorch port of ``repro.analysis.entrypoints``.

Every public execution path of the stack — controller refinement (three
modes, dense and sparse, plain and fused-kernel reductions), the batched
drivers, all four distributed drivers, and the DES tick — is registered
here with a thunk that runs it on a small canonical problem with
telemetry disabled (``recorder=None`` / ``emit_*=None``).

What a "trace" is in the port.  The reference stages each path with
``jax.make_jaxpr``, which walks each loop body once and executes nothing.
The port has no staged program, so a trace is a *run*: the path's
set-up plus ONE turn, sweep or tick (``max_turns=1``, ``max_sweeps=1``,
one ``des_tick``), on the given device, under a recording
``TorchDispatchMode`` that keeps every aten op's name, output shapes and
dtypes (and, when asked, the port's source files on the Python stack
that dispatched it) — the :class:`Record`.  Collectives are read by
``CommDebugMode`` (:class:`repro_torch.launch.collectives.
CollectiveCounter`), and on the card the caching allocator's peak bytes
ride along.  A kernel launched through ``ctypes`` is not an aten op, so
a kernel route's record differs from its twin's on the CPU; the
complexity table keys its sections by device for that reason.

Plain and kernel variants keep the reference's split: ``refine``,
``refine.theta``, ``refine.sparse`` and ``refine_traced*`` pass (or
default to) the plain reductions on every device, while
``refine.kernel`` and ``refine.sparse.edge_kernel`` pass
``make_aggregate_dissat_fn()`` and ``make_edge_dissat_fn(sp)`` — kernels
1 and 4 on the card.  ``batch.refine`` and ``distributed.refine`` reduce
with kernel 3 on the card, and ``distributed.shard_map`` with kernel 1
on a one-rank group (gloo on the CPU, NCCL on the card), the reference's
``num_shards=1``.

Every thunk is size-parameterized (``n``, ``k``, ``degree`` and the
number of ``turns``) so the complexity family (DESIGN.md §18) reruns
each path over a geometric grid.  Records are cached per process
(``lru_cache``), so the CLI and the test suite share the work.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import pathlib
import sys
import tempfile
from functools import lru_cache
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..launch.collectives import CollectiveCounter, _kind, _result_bytes
from ..launch.flops import _dot_flops

__all__ = ["EntryPoint", "OpRecord", "Record", "record",
           "registered_entry_points", "entry_point", "trace_entry_point",
           "trace_entry_point_sized", "trace_all", "canonical_problem",
           "canonical_sparse", "canonical_sparse_degree", "canonical_batch",
           "canonical_assignment", "as_pytree", "HOST_READ_OP"]

_N, _K = 16, 3
_PKG = pathlib.Path(__file__).resolve().parents[1]        # src/repro_torch
_SRC = _PKG.parent
HOST_READ_OP = "_local_scalar_dense"


# -- the record -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched aten op."""
    name: str                      # overload packet, e.g. "mm"
    overload: str                  # e.g. "aten.mm.default"
    shapes: tuple                  # output shapes
    dtypes: tuple                  # output dtypes, torch names ("float32")
    out_bytes: int                 # output bytes (0 for a view)
    count: int                     # op-count proxy (0 for a view)
    files: tuple = ()              # repro_torch sources on the stack


@dataclasses.dataclass(frozen=True)
class Record:
    """Everything one run dispatched: its ops, its collectives (kind,
    per-rank operand bytes) in order, the bytes of its inputs, and — on
    the card — the allocator's peak above what was allocated before."""
    ops: tuple
    collectives: tuple = ()
    arg_bytes: int = 0
    mem_device: int | None = None


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@lru_cache(maxsize=None)
def _port_source(filename: str) -> str | None:
    """``src/repro_torch/...`` for a source of the port outside this
    package, else None."""
    here = str(pathlib.Path(__file__).resolve().parent)
    if not filename.startswith(str(_PKG)) or filename.startswith(here):
        return None
    return "src/" + os.path.relpath(filename, _SRC)


def _stack_files() -> tuple[str, ...]:
    """repo-relative paths of the port's sources on the Python stack,
    innermost first, the analysis package itself left out."""
    out = []
    frame = sys._getframe(2)
    while frame is not None:
        rel = _port_source(frame.f_code.co_filename)
        if rel is not None and (not out or out[-1] != rel):
            out.append(rel)
        frame = frame.f_back
    return tuple(out)


class _Recording(TorchDispatchMode):
    """Keeps an :class:`OpRecord` for every aten op dispatched inside it."""

    def __init__(self, frames: bool = False):
        super().__init__()
        self.frames = frames
        self.ops: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        name = func._overloadpacket.__name__
        outs = [x for x in tree_flatten(out)[0]
                if isinstance(x, torch.Tensor)]
        view = bool(getattr(func, "is_view", False))
        elems = sum(math.prod(x.shape) for x in outs)
        nbytes = sum(math.prod(x.shape) * x.element_size() for x in outs)
        dot = _dot_flops(name.rstrip("_"), args)
        self.ops.append(OpRecord(
            name=name, overload=str(func),
            shapes=tuple(tuple(x.shape) for x in outs),
            dtypes=tuple(_dtype_name(x.dtype) for x in outs),
            out_bytes=0 if view else nbytes,
            count=0 if view else (dot if dot is not None else elems),
            files=_stack_files() if self.frames else ()))
        return out


class _Collectives(CollectiveCounter):
    """``CommDebugMode`` that keeps each collective's kind and per-rank
    operand bytes in order (an all-gather's result divided by the world
    size, any other collective's result)."""

    def __init__(self):
        super().__init__()
        self.events: list[tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        kind = _kind(func)
        if kind is not None:
            nbytes = _result_bytes(out)
            if kind == "all-gather":
                import torch.distributed as dist
                nbytes //= dist.get_world_size()
            self.events.append((kind, nbytes))
        return out


def as_pytree(x):
    """``x`` with its dataclasses (the problems) as ``(type name, field
    dict)`` pairs and its named tuples as tuples, which
    ``torch.utils._pytree`` walks."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: as_pytree(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return tuple(as_pytree(v) for v in x)
    return x


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(as_pytree(tree))
    return sum(math.prod(x.shape) * x.element_size() for x in leaves
               if isinstance(x, torch.Tensor))


_WARM: set = set()


def _warm(dev: torch.device) -> None:
    """Make the card's one-time lazy allocations — the BLAS workspaces of
    the first matrix products — before the first measured run, so they
    land in no run's peak."""
    if dev in _WARM:
        return
    a = torch.ones((2, 8, 8), device=dev)
    torch.bmm(a, a)
    torch.addmm(a[0], a[0], a[0])
    torch.mm(a[0], a[0])
    torch.cuda.synchronize(dev)
    _WARM.add(dev)


def record(fn: Callable[[], object], *, device=None, frames: bool = False,
           args=()) -> Record:
    """Run ``fn()`` under the recording modes and return its
    :class:`Record`.  ``args`` (tensors, or trees of them) are counted as
    the run's input bytes; on a CUDA ``device`` the allocator's peak
    during the run, above what was allocated before it, is kept too."""
    dev = torch.device(device) if device is not None else None
    on_card = dev is not None and dev.type == "cuda"
    if on_card:     # the allocator counts on the host: no sync needed
        _warm(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with _Collectives() as comm, _Recording(frames) as rec:
        fn()
    peak = None
    if on_card:
        peak = torch.cuda.max_memory_allocated(dev) - base
    return Record(ops=tuple(rec.ops), collectives=tuple(comm.events),
                  arg_bytes=_tensor_bytes(args), mem_device=peak)


# -- the registry -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """One recorded public execution path.

    ``trace(n=..., k=..., degree=..., device=..., turns=..., frames=...)``
    returns the :class:`Record` of the path's set-up plus ``turns``
    turns (sweeps, ticks) with telemetry disabled; with no size
    arguments it runs the canonical small problem.  ``degree`` only
    varies the sparse representations and is ignored by dense paths.

    ``rep`` records which representation the path consumes ("dense" or
    "sparse") — the complexity registry keys its declared budgets on it.
    ``max_n`` caps the N grid for paths whose set-up is
    quadratic-or-worse on the host (batched stacks, the DES scenario).
    ``session``, when set, is a context manager factory taking the device
    that every run of a profile runs inside (the collective driver's
    process group, made once instead of once a run).
    """
    name: str
    runtime: str   # "controller" | "batched" | "distributed" | "des"
    trace: Callable[..., Record]
    rep: str = "dense"
    max_n: int | None = None
    session: Callable | None = None


def _dev(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


@lru_cache(maxsize=None)
def canonical_problem(n: int = _N, k: int = _K, seed: int = 3,
                      device: str = "cpu"):
    """The canonical small dense problem every analyzer runs on."""
    from ..core.problem import make_problem
    from ..graphs.generators import random_degree_graph, random_weights
    adj = random_degree_graph(n, seed=seed)
    b, c = random_weights(adj, seed=seed + 1, mean=5.0)
    return make_problem(c, b, np.ones(k) / k, mu=8.0, device=device)


@lru_cache(maxsize=None)
def canonical_sparse(n: int = _N, k: int = _K, seed: int = 3,
                     device: str = "cpu"):
    from ..core.sparse import sparse_from_dense
    return sparse_from_dense(canonical_problem(n, k, seed, device))


@lru_cache(maxsize=None)
def canonical_sparse_degree(n: int, k: int, degree: int, seed: int = 3,
                            device: str = "cpu"):
    """A sparse problem with controlled per-node degree, built on the
    edge-list path (no (N, N) host array)."""
    from ..core.sparse import make_sparse_problem
    from ..graphs.generators import (random_degree_graph_edges,
                                     random_weights_edges)
    s, r = random_degree_graph_edges(n, seed=seed, dmin=degree, dmax=degree)
    b, w = random_weights_edges(n, s, seed=seed + 1, mean=5.0)
    return make_sparse_problem(s, r, w, b, np.ones(k) / k, mu=8.0,
                               device=device)


def _sparse_problem(n: int, k: int, degree: int | None, device: str):
    if degree is None:
        return canonical_sparse(n, k, device=device)
    return canonical_sparse_degree(n, k, degree, device=device)


def canonical_assignment(n: int = _N, k: int = _K, device="cpu"):
    return torch.as_tensor(np.arange(n) % k, dtype=torch.int32,
                           device=device)


@lru_cache(maxsize=None)
def canonical_batch(b: int = 2, n: int = _N, k: int = _K,
                    device: str = "cpu"):
    """A stacked pair of same-shape problems + (B, N) assignments."""
    from ..core.batch import stack_problems
    probs = stack_problems([canonical_problem(n, k, seed=3 + i,
                                              device=device)
                            for i in range(b)])
    r0 = torch.stack([canonical_assignment(n, k, device)] * b)
    return probs, r0


@lru_cache(maxsize=None)
def _canonical_des(n: int = 12, k: int = 2, device: str = "cpu"):
    """A tiny DES scenario (config, adjacency, initial state)."""
    from ..des.engine import DESConfig, make_initial_state
    from ..des.workload import flooded_packet_workload
    from ..graphs.generators import preferential_attachment
    threads = 4
    adj = preferential_attachment(n, 5, m=2)
    spec = flooded_packet_workload(adj, min(9, n - 1), num_threads=threads,
                                   num_windows=1, scope=2,
                                   window_sim_time=20.0, max_per_lp=2)
    speeds = tuple(float(s) for s in np.linspace(1.0, 0.7, k).round(2))
    cfg = DESConfig(num_lps=n, num_machines=k, num_threads=threads,
                    event_capacity=32, history_capacity=64,
                    inter_delay=6, intra_delay=1, trace_stride=10,
                    max_ticks=1_000, machine_speeds=speeds,
                    refine_freq=40, refine_theta_scale=5.0,
                    migration_freeze=0.25)
    m0 = np.arange(n) % k
    state0 = make_initial_state(cfg, m0, spec.src, spec.time, spec.count,
                                device=device)
    return cfg, torch.as_tensor(adj, dtype=torch.float32,
                                device=device), state0


# -- the individual trace thunks (one per registered path) -----------------
#
# Each accepts (n, k, degree, device, turns, frames) so the complexity
# grids can rerun it at any size; ``degree`` selects the
# controlled-degree sparse problem and is ignored on dense paths.

def _turn_kw(fn_name: str, turns: int) -> dict:
    sweeps = fn_name.endswith(("sweeps", "simultaneous",
                               "simultaneous_batched", "sweeps_batched"))
    return {"max_sweeps" if sweeps else "max_turns": turns}


def _controller(fn_name: str, sparse: bool = False, n: int = _N,
                k: int = _K, degree: int | None = None, device=None,
                turns: int = 1, frames: bool = False, plain: bool = True,
                **kwargs):
    import importlib
    from ..kernels import ops
    refine_mod = importlib.import_module("repro_torch.core.refine")
    fn = getattr(refine_mod, fn_name)
    dev = str(_dev(device))
    prob = (_sparse_problem(n, k, degree, dev) if sparse
            else canonical_problem(n, k, device=dev))
    if plain and fn_name == "refine" and kwargs.get("incremental", True):
        kwargs["dissat_fn"] = ops.make_aggregate_dissat_fn_plain()
    r0 = canonical_assignment(n, k, dev)
    kw = dict(kwargs, **_turn_kw(fn_name, turns))
    return record(lambda: fn(prob, r0, **kw), device=dev, frames=frames,
                  args=(prob, r0))


def _kernel_dissat(n: int = _N, k: int = _K, degree: int | None = None,
                   device=None, turns: int = 1, frames: bool = False):
    from ..core.refine import refine
    from ..kernels.ops import make_aggregate_dissat_fn
    dev = str(_dev(device))
    prob = canonical_problem(n, k, device=dev)
    dfn = make_aggregate_dissat_fn()
    r0 = canonical_assignment(n, k, dev)
    return record(lambda: refine(prob, r0, "c", max_turns=turns,
                                 dissat_fn=dfn),
                  device=dev, frames=frames, args=(prob, r0))


def _edge_kernel_dissat(n: int = _N, k: int = _K, degree: int | None = None,
                        device=None, turns: int = 1, frames: bool = False):
    from ..core.refine import refine
    from ..kernels.ops import make_edge_dissat_fn
    dev = str(_dev(device))
    sp = _sparse_problem(n, k, degree, dev)
    dfn = make_edge_dissat_fn(sp)
    r0 = canonical_assignment(n, k, dev)
    return record(lambda: refine(sp, r0, "c", max_turns=turns,
                                 dissat_fn=dfn),
                  device=dev, frames=frames, args=(sp, r0))


def _sweeps_prob(sparse: bool = False, n: int = _N, k: int = _K,
                 degree: int | None = None, device=None, turns: int = 1,
                 frames: bool = False, **kwargs):
    """Probabilistic refine_sweeps configs: where the reference draws a
    ``PRNGKey(0)``, the port passes a ``torch.Generator`` seeded 0."""
    import importlib
    refine_mod = importlib.import_module("repro_torch.core.refine")
    dev = str(_dev(device))
    prob = (_sparse_problem(n, k, degree, dev) if sparse
            else canonical_problem(n, k, device=dev))
    r0 = canonical_assignment(n, k, dev)

    def run():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return refine_mod.refine_sweeps(prob, r0, max_sweeps=turns,
                                        generator=gen, **kwargs)
    return record(run, device=dev, frames=frames, args=(prob, r0))


def _batched(fn_name: str, n: int = _N, k: int = _K,
             degree: int | None = None, device=None, turns: int = 1,
             frames: bool = False, **kwargs):
    from ..core import batch as batch_mod
    fn = getattr(batch_mod, fn_name)
    dev = str(_dev(device))
    probs, r0 = canonical_batch(2, n, k, dev)
    kw = dict(kwargs, **_turn_kw(fn_name, turns))
    return record(lambda: fn(probs, r0, "c", **kw), device=dev,
                  frames=frames, args=(probs, r0))


def _distributed(fn_name: str, n: int = _N, k: int = _K,
                 degree: int | None = None, device=None, turns: int = 1,
                 frames: bool = False, **kwargs):
    from ..distributed import runtime as rt
    fn = getattr(rt, fn_name)
    dev = str(_dev(device))
    prob = canonical_problem(n, k, device=dev)
    r0 = canonical_assignment(n, k, dev)
    kw = dict(kwargs, **_turn_kw(fn_name, turns))
    return record(lambda: fn(prob, r0, "c", num_shards=3, **kw),
                  device=dev, frames=frames, args=(prob, r0))


@contextlib.contextmanager
def one_rank_group(device):
    """A one-rank ``torch.distributed`` group (NCCL for a CUDA device,
    gloo otherwise) on a ``FileStore`` in a temporary directory, made on
    entry and destroyed on exit; an existing default group is used as it
    is.  The collective driver then runs all of a profile's runs in one
    group instead of making one a run."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    dev = _dev(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with tempfile.TemporaryDirectory(prefix="repro_analysis_") as tmp:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        kwargs = {"device_id": dev} if dev.type == "cuda" else {}
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, **kwargs)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _shard_map(n: int = _N, k: int = _K, degree: int | None = None,
               device=None, turns: int = 1, frames: bool = False):
    from ..distributed.runtime import refine_distributed_shard_map
    dev = str(_dev(device))
    prob = canonical_problem(n, k, device=dev)
    r0 = canonical_assignment(n, k, dev)
    # num_shards=1: the real collective path on a group of one rank
    with one_rank_group(dev):
        return record(lambda: refine_distributed_shard_map(
            prob, r0, "c", num_shards=1, max_turns=turns),
            device=dev, frames=frames, args=(prob, r0))


def _des_tick(n: int = 12, k: int = 2, degree: int | None = None,
              device=None, turns: int = 1, frames: bool = False):
    from ..des.engine import des_tick
    dev = str(_dev(device))
    cfg, adj, state0 = _canonical_des(n, k, dev)

    def run():
        s = state0
        for _ in range(turns):
            s = des_tick(cfg, adj, s)
        return s
    return record(run, device=dev, frames=frames, args=(adj, state0))


def _sized(fn: Callable[..., Record], **fixed) -> Callable[..., Record]:
    """Bind an entry point's non-size arguments, leaving (n, k, degree,
    device, turns, frames) open (defaults = the canonical problem on the
    card, one turn)."""
    def thunk(n: int = _N, k: int = _K, degree: int | None = None,
              device=None, turns: int = 1, frames: bool = False):
        return fn(n=n, k=k, degree=degree, device=device, turns=turns,
                  frames=frames, **fixed)
    return thunk


_ENTRY_POINTS: tuple[EntryPoint, ...] = (
    EntryPoint("refine", "controller", _sized(_controller, fn_name="refine")),
    EntryPoint("refine.recompute", "controller",
               _sized(_controller, fn_name="refine", incremental=False)),
    EntryPoint("refine.theta", "controller",
               _sized(_controller, fn_name="refine", framework="ct",
                      theta=0.25)),
    EntryPoint("refine.kernel", "controller", _kernel_dissat),
    EntryPoint("refine_traced", "controller",
               _sized(_controller, fn_name="refine_traced")),
    EntryPoint("refine_simultaneous", "controller",
               _sized(_controller, fn_name="refine_simultaneous")),
    EntryPoint("refine.sparse", "controller",
               _sized(_controller, fn_name="refine", sparse=True),
               rep="sparse"),
    EntryPoint("refine_traced.sparse", "controller",
               _sized(_controller, fn_name="refine_traced", sparse=True),
               rep="sparse"),
    EntryPoint("refine.sparse.edge_kernel", "controller",
               _edge_kernel_dissat, rep="sparse"),
    EntryPoint("refine_sweeps", "controller",
               _sized(_controller, fn_name="refine_sweeps")),
    EntryPoint("refine_sweeps.multi", "controller",
               _sized(_sweeps_prob, moves_per_machine=2, move_prob=0.5,
                      epsilon=1e-3)),
    EntryPoint("refine_sweeps.sparse.unbounded", "controller",
               _sized(_sweeps_prob, sparse=True, moves_per_machine=None,
                      move_prob=0.5, epsilon=1e-3), rep="sparse"),
    EntryPoint("batch.refine", "batched",
               _sized(_batched, fn_name="refine_batched"), max_n=1024),
    EntryPoint("batch.refine_traced", "batched",
               _sized(_batched, fn_name="refine_traced_batched"),
               max_n=1024),
    EntryPoint("batch.refine_simultaneous", "batched",
               _sized(_batched, fn_name="refine_simultaneous_batched"),
               max_n=1024),
    EntryPoint("batch.refine_sweeps", "batched",
               _sized(_batched, fn_name="refine_sweeps_batched"),
               max_n=1024),
    EntryPoint("distributed.refine", "distributed",
               _sized(_distributed, fn_name="refine_distributed")),
    EntryPoint("distributed.refine_traced", "distributed",
               _sized(_distributed, fn_name="refine_distributed_traced")),
    EntryPoint("distributed.refine_simultaneous", "distributed",
               _sized(_distributed,
                      fn_name="refine_distributed_simultaneous")),
    EntryPoint("distributed.shard_map", "distributed", _shard_map,
               session=one_rank_group),
    EntryPoint("des.tick", "des", _des_tick, max_n=1024),
)


def registered_entry_points() -> tuple[EntryPoint, ...]:
    return _ENTRY_POINTS


def entry_point(name: str) -> EntryPoint:
    for ep in _ENTRY_POINTS:
        if ep.name == name:
            return ep
    raise KeyError(f"unknown entry point {name!r}; registered: "
                   f"{[e.name for e in _ENTRY_POINTS]}")


@lru_cache(maxsize=None)
def trace_entry_point(name: str, device: str = "cuda") -> Record:
    """The :class:`Record` of the named entry point's canonical run on
    ``device``, with the dispatching source files kept on every op
    (cached per process)."""
    return entry_point(name).trace(device=device, frames=True)


@lru_cache(maxsize=None)
def trace_entry_point_sized(name: str, n: int, k: int,
                            degree: int | None = None,
                            device: str = "cuda", turns: int = 1) -> Record:
    """The :class:`Record` of the named entry point rerun at (n, k,
    degree) for ``turns`` turns — the complexity grids' workhorse
    (cached per process)."""
    return entry_point(name).trace(n=n, k=k, degree=degree, device=device,
                                   turns=turns)


def trace_all(device: str = "cuda") -> dict[str, Record]:
    return {ep.name: trace_entry_point(ep.name, device)
            for ep in _ENTRY_POINTS}
