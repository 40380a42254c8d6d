"""The few tree operations the training modules and the expert planner
need, over the port's trees: dicts (walked in sorted key order, as JAX walks them), lists and
tuples (in order; a NamedTuple by field) and tensor leaves.  A leaf's
path is its keys joined by ``/`` — ``params/blocks/0/attn/wq``,
``opt/mu/embed``, ``step`` — the names a checkpoint's manifest holds.
It imports nothing of the package, so any module may import it at its
top (``training.tree`` is its name there).
"""
from __future__ import annotations

from typing import Callable


def _children(node):
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten(tree, prefix: str = "") -> tuple[list[str], list]:
    """(paths, leaves) of ``tree`` in walk order."""
    paths, leaves = [], []

    def walk(node, path):
        children = _children(node)
        if children is None:
            paths.append(path)
            leaves.append(node)
            return
        for key, child in children:
            walk(child, f"{path}/{key}" if path else key)

    walk(tree, prefix)
    return paths, leaves


def unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves are ``leaves`` (walk
    order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}      # keep ``like``'s order
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_tree(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of its shape."""
    others = [flatten(t)[1] for t in rest]
    _, leaves = flatten(tree)
    return unflatten(tree, [fn(*args) for args in zip(leaves, *others)])


def map_with_path(fn: Callable, tree):
    """``fn(path, leaf)`` applied to every leaf."""
    paths, leaves = flatten(tree)
    return unflatten(tree, [fn(p, x) for p, x in zip(paths, leaves)])
