"""In-model sharding hints (activation partitioning; port of
``repro.sharding.hints``).

``hint(x, ...)`` redistributes a DTensor to the placements its dims ask
for, with axis-presence and divisibility guards, and returns ``x`` itself
when no mesh is active, when ``REPRO_NO_HINTS=1``, or when ``x`` is not a
DTensor — so model code stays runnable on plain tensors while the sharded
paths get explicit activation layouts.  ``use_mesh(mesh)`` sets the active
mesh, the counterpart of JAX's ``with mesh:``.

Why this exists: without constraints a partitioner must GUESS how to shard
the (heads, head_dim) split of fused QKV projections.  When the head count
does not divide the model axis (yi-34b: 56 heads on a 16-wide axis) it
shards head_dim — the attention CONTRACTION dim — which turns every S x S
logits tensor into a partial sum that is all-reduced.  The fix is
sequence-parallel attention: shard q's sequence over 'model', keep k/v
unsharded on the feature dims, and keep the residual stream
sequence-sharded between layers.

The port's model code calls no hint yet: no path of the port runs the
model on DTensors on several cards (``models/attention.py``,
``models/moe.py``).
"""
from __future__ import annotations

import contextlib
import os

DP = "dp"   # sentinel: all data-parallel axes present in the mesh

_ACTIVE: list = []     # the meshes ``use_mesh`` set, innermost last


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the active mesh inside the block."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh():
    """The innermost mesh ``use_mesh`` set, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def mesh_axis_sizes() -> dict | None:
    """{axis: size} of the active mesh, or None."""
    mesh = active_mesh()
    if mesh is None:
        return None
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_axes(shape: dict) -> tuple:
    return tuple(a for a in ("pod", "data") if a in shape and shape[a] > 1)


def fitted_spec(shape: dict, x_shape, dims) -> tuple:
    """The spec ``hint`` applies: each entry of ``dims`` where its axes are
    all in the mesh and divide the dim, else None; trailing dims None."""
    spec = []
    for i, d in enumerate(x_shape):
        ax = dims[i] if i < len(dims) else None
        if ax == DP:
            ax = dp_axes(shape) or None
            if ax is not None and len(ax) == 1:
                ax = ax[0]
        if ax is None:
            spec.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        ok = True
        for a in axes:
            if a not in shape:
                ok = False
                break
            size *= shape[a]
        spec.append(ax if ok and size > 1 and d % size == 0 else None)
    return tuple(spec)


def hint(x, *dims):
    """Redistribute ``x`` to the placements of ``dims`` where valid.

    Each entry of ``dims`` is None, an axis name, a tuple of axis names, or
    the sentinel ``DP`` (all data axes).  Axes missing from the mesh or not
    dividing the dimension fall back to ``Replicate`` on that dim.
    Trailing unspecified dims replicate.

    Set REPRO_NO_HINTS=1 to disable all hints (the unannotated baseline).
    """
    if os.environ.get("REPRO_NO_HINTS", "0") == "1":
        return x
    mesh = active_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    from .rules import to_placements
    if not isinstance(x, DTensor):
        return x
    spec = fitted_spec(mesh_axis_sizes(), x.shape, dims)
    return x.redistribute(mesh, to_placements(spec, mesh))
