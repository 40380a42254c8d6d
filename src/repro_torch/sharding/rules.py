"""Sharding rules: parameter-tree paths -> partition specs (port of
``repro.sharding.rules``).

Strategy (2-D "TP x FSDP" over the ('data', 'model') mesh axes, with the
'pod' axis joining 'data' for batch parallelism on the multi-pod mesh):

  * matmul weights carry tensor parallelism on their TP-natural dim
    ('model') and ZeRO/FSDP on the other dim ('data'), so parameters AND
    Adam moments shard over every rank.
  * MoE expert stacks shard experts over 'model' (expert parallelism, the
    partition planner permutes along this axis) and d_model over 'data'.
  * small tensors (norms, biases, scalars) replicate.

A dim is only sharded when divisible by the axis size; otherwise the rule
falls back to replication on that dim (checked at spec-build time, so every
(arch x mesh) combination yields a valid sharding).

A spec is a plain tuple, the counterpart of ``PartitionSpec``: one entry
per tensor dim, each ``None``, an axis name or a tuple of axis names.  The
spec functions take a ``{axis: size}`` dict or anything with ``.shape``
and ``.mesh_dim_names`` (a ``DeviceMesh``), and need no process group.
``to_placements`` turns a spec into DTensor placements over a
``DeviceMesh``; the ``*_shardings`` functions give a :class:`Sharding`
(mesh and spec, the counterpart of ``NamedSharding``) per leaf.

The port keeps one dict per layer under ``blocks`` (``models/convert.py``)
where the reference stacks the layers on a leading axis, so no spec here
carries the reference's leading ``None`` for that axis: for the same leaf
the port's spec for ``blocks/<i>/...`` is the reference's without it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

from ..models.config import ModelConfig

Spec = tuple


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def map_leaves(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, lists and NamedTuples
    (``training.tree``'s paths); anything else, a spec tuple included, is
    a leaf."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, _join(path, k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_leaves(fn, v, _join(path, i)) for i, v in enumerate(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(fn, v, _join(path, f))
                            for f, v in zip(tree._fields, tree)))
    return fn(path, tree)


def leaves(tree) -> list:
    """(path, leaf) pairs of a tree, as ``map_leaves`` walks it."""
    out = []
    map_leaves(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a dict or a ``DeviceMesh``-like mesh."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= sizes[a]
        return out
    return sizes[axis]


def _fit(sizes: dict, shape, spec_dims) -> Spec:
    """Replace axis entries that do not divide the dim with None."""
    return tuple(axis if size % _axis_size(sizes, axis) == 0 else None
                 for size, axis in zip(shape, spec_dims))


# rules: (path regex, spec dims for the leaf's dims)
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$",              ("model", "data")),
    (r"lm_head$",            ("data", "model")),
    (r"attn/wq$",            ("data", "model")),
    (r"attn/wk$",            ("data", "model")),
    (r"attn/wv$",            ("data", "model")),
    (r"attn/wo$",            ("model", "data")),
    (r"attn/b[qkv]$",        ("model",)),
    (r"mlp/gate$",           ("data", "model")),
    (r"mlp/up$",             ("data", "model")),
    (r"mlp/down$",           ("model", "data")),
    (r"moe/router$",         ("data", None)),
    (r"moe/gate$",           ("model", "data", None)),   # (E, d, f)
    (r"moe/up$",             ("model", "data", None)),
    (r"moe/down$",           ("model", None, "data")),   # (E, f, d)
    (r"ssm/in_proj$",        ("data", "model")),
    (r"ssm/out_proj$",       ("model", "data")),
    (r"ssm/conv_w$",         (None, None)),
    (r"ssm/.*$",             (None,)),                   # A_log, dt_bias, D...
    (r".*norm.*$",           (None,)),
]


def _spec_for_path(path: str, leaf, sizes: dict) -> Spec:
    ndim = leaf.ndim
    for pattern, dims in _PARAM_RULES:
        if re.search(pattern, path):
            dims = tuple(dims[:ndim])
            dims = dims + (None,) * (ndim - len(dims))
            return _fit(sizes, leaf.shape, dims)
    return (None,) * ndim       # replicate anything unmatched


def _drop_data_axis(spec: Spec) -> Spec:
    """ZeRO-1 parameter layout: keep tensor parallelism ('model'), drop the
    ZeRO/FSDP sharding over the data axes — weights are read locally with
    NO per-layer all-gather; only the optimizer step communicates (grad
    reduce-scatter + param all-gather, once per step)."""
    def fix(ax):
        if ax is None:
            return None
        axes = ax if isinstance(ax, tuple) else (ax,)
        kept = tuple(a for a in axes if a not in ("data", "pod"))
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]

    return tuple(fix(ax) for ax in spec)


def param_specs(cfg: ModelConfig, mesh, params, *,
                strategy: str = "fsdp") -> Any:
    """Specs matching the params tree (leaves may be ``meta`` tensors).

    strategy:
      * "fsdp"  — weights shard over (data x model); ZeRO-3-style gathers
                  on use (smallest per-rank memory, per-microbatch gather
                  traffic).
      * "zero1" — weights shard over 'model' only (read locally, no
                  gathers); pick when P/tp fits the device's memory.
    """
    sizes = axis_sizes(mesh)

    def assign(path, leaf):
        spec = _spec_for_path(path, leaf, sizes)
        return _drop_data_axis(spec) if strategy == "zero1" else spec

    return map_leaves(assign, params)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the counterpart of ``NamedSharding``)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements over ``mesh`` (a ``DeviceMesh``) for ``spec``:
    ``Shard(d)`` on every mesh dim that tensor dim d is sharded over,
    ``Replicate()`` elsewhere.  A dim sharded over a tuple of axes is split
    outer axis first, as JAX orders it; the tuple must follow the mesh's
    axis order, which is how DTensor orders the shards of one dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {dim} is sharded over {axes}, not in the "
                             f"mesh's axis order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def _named(mesh, specs):
    return map_leaves(
        lambda _, s: None if s is None else Sharding(mesh, s), specs)


def param_shardings(cfg: ModelConfig, mesh, params, *,
                    strategy: str = "fsdp") -> Any:
    """A :class:`Sharding` per leaf of the params tree."""
    return _named(mesh, param_specs(cfg, mesh, params, strategy=strategy))


def batch_spec(mesh, kind: str = "train") -> Spec:
    """Batch dim spreads over every data-like axis present in the mesh."""
    sizes = axis_sizes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = dp_axes if len(dp_axes) > 1 else (dp_axes[0] if dp_axes else None)
    return (dp,)


def batch_specs(cfg: ModelConfig, mesh, batch) -> Any:
    sizes = axis_sizes(mesh)
    dp = batch_spec(mesh)[0]

    def assign(_, leaf):
        first = dp if leaf.shape[0] % _axis_size(sizes, dp) == 0 else None
        return (first,) + (None,) * (leaf.ndim - 1)

    return map_leaves(assign, batch)


def batch_shardings(cfg: ModelConfig, mesh, batch) -> Any:
    return _named(mesh, batch_specs(cfg, mesh, batch))


def cache_specs(cfg: ModelConfig, mesh, cache) -> Any:
    """Decode cache (``models.transformer.DecodeCache``): batch over data
    axes; heads (or cache sequence for MQA archs where kv_heads <
    model-axis size) over 'model'.  Absent fields stay ``None``."""
    sizes = axis_sizes(mesh)
    dp_axis = batch_spec(mesh)[0]
    model = "model" if "model" in sizes else None
    msize = _axis_size(sizes, model)

    def batch_dim(b):
        return dp_axis if b % _axis_size(sizes, dp_axis) == 0 else None

    def assign(path, leaf):
        if leaf is None:
            return None
        if leaf.ndim == 0:
            return ()
        if "kv_" in path:
            # (L, B, S, Hkv, D): try heads on model, else sequence on model
            _, b, s, hkv, _ = leaf.shape
            if hkv % msize == 0:
                return (None, batch_dim(b), None, model, None)
            return (None, batch_dim(b), model if s % msize == 0 else None,
                    None, None)
        if "ssm_state" in path:
            # (L, B, H, P, N): heads over model
            _, b, h, _, _ = leaf.shape
            return (None, batch_dim(b), model if h % msize == 0 else None,
                    None, None)
        if "ssm_conv" in path:
            _, b, _, c = leaf.shape
            return (None, batch_dim(b), None,
                    model if c % msize == 0 else None)
        return (None,) * leaf.ndim

    return map_leaves(assign, cache)


def cache_shardings(cfg: ModelConfig, mesh, cache) -> Any:
    return _named(mesh, cache_specs(cfg, mesh, cache))


def state_specs(cfg: ModelConfig, mesh, state, *,
                strategy: str = "fsdp") -> Any:
    """TrainState specs.

    fsdp:  params AND Adam moments shard over (data x model).
    zero1: params shard over 'model' only (local reads, no per-layer
           gathers); Adam moments keep the full (data x model) sharding —
           the optimizer state is the ZeRO-1 sharded part.
    """
    return type(state)(
        params=param_specs(cfg, mesh, state.params, strategy=strategy),
        opt=type(state.opt)(mu=param_specs(cfg, mesh, state.opt.mu),
                            nu=param_specs(cfg, mesh, state.opt.nu),
                            count=()),
        step=(),
        expert_load=(None,) * state.expert_load.ndim,
        coactivation=(None,) * state.coactivation.ndim,
    )


def state_shardings(cfg: ModelConfig, mesh, state, *,
                    strategy: str = "fsdp") -> Any:
    specs = state_specs(cfg, mesh, state, strategy=strategy)
    return type(state)(
        params=_named(mesh, specs.params),
        opt=type(state.opt)(mu=_named(mesh, specs.opt.mu),
                            nu=_named(mesh, specs.opt.nu),
                            count=Sharding(mesh, ())),
        step=Sharding(mesh, ()),
        expert_load=Sharding(mesh, specs.expert_load),
        coactivation=Sharding(mesh, specs.coactivation),
    )
