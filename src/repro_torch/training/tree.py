"""The tree operations of :mod:`repro_torch.tree`, under the name the
training modules and their callers import them by."""
from ..tree import (  # noqa: F401
    flatten,
    map_tree,
    map_with_path,
    unflatten,
)
