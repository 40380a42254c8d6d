"""Production mesh builders for the dry run (port of
``repro.launch.mesh``).

The 256-rank (16 x 16) and 512-rank (2 x 16 x 16) meshes are the
reference's pod shapes: a model of a deployment, not a machine the port
has run on.  They are ``DeviceMesh``es over a ``fake`` process group
(``torch.testing._internal.distributed.fake_pg``): every rank is this
process, collectives do nothing, and DTensors on the ``meta`` device hold
shapes and placements alone.  A FUNCTION, not a module-level constant:
importing this module starts no process group, and a process holds one
default group at a time (``make_mesh`` replaces a group of another size).
"""
from __future__ import annotations

# NVIDIA H100 80GB HBM3 (SXM) at 700 W, datasheet figures (not
# measurements), used by the dry run's roofline terms (per card).
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor cores
HBM_BANDWIDTH = 3.35e12         # B/s, HBM3
NVLINK_BANDWIDTH = 450e9        # B/s, NVLink 4, one direction


def make_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake process
    group of ``prod(shape)`` ranks, this process rank 0."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    size = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a non-fake default process group is active; "
                               "the dry run's meshes need their own")
        if dist.get_world_size() != size:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=size)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks per pod; 2x16x16 = 512 ranks across two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def release_mesh() -> None:
    """Destroy the fake default process group, if one is active."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()
