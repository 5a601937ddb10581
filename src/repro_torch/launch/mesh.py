"""Mesh construction: the counterpart of ``repro.launch.mesh``.

Functions, not module-level constants, so importing this module touches no
process group.  A mesh of more than one device is a ``DeviceMesh`` built by
``init_device_mesh`` over the default process group, which the caller
starts: one real group (gloo or nccl) for a run, or the fake group of
``fake_process_group`` for the dry run, whose 256 or 512 ranks stand in for
the placeholder host devices that JAX's dry run gets from
``--xla_force_host_platform_device_count``.  A one-device mesh needs no
process group: ``make_mesh`` returns a ``sharding.plan.AbstractMesh`` for it, and
the model then holds plain tensors on that device.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

from repro_torch.sharding.plan import make_abstract_mesh


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A mesh of ``shape`` named ``axes``: a ``DeviceMesh`` over the
    default process group (which must have ``prod(shape)`` ranks), or an
    ``AbstractMesh`` on ``device_type`` when ``shape`` holds one
    device."""
    shape, axes = tuple(shape), tuple(axes)
    if math.prod(shape) == 1:
        return make_abstract_mesh(shape, axes, device_type)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def production_mesh_shape(multi_pod: bool = False):
    """(shape, axes) of the production mesh: 16x16 = 256 devices per pod,
    2 pods = 512."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    return make_mesh(*production_mesh_shape(multi_pod), device_type)


@contextmanager
def fake_process_group(world_size: int):
    """The default process group as ``world_size`` fake ranks (this process
    is rank 0): collectives return at once with outputs of the right
    shape, and no data moves.  Only the dry run and its tests start it, in
    a process of their own; the group is destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running in this process")
    dist.init_process_group("fake", rank=0, world_size=world_size, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()
