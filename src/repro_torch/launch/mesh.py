"""Device meshes over the ranks of an initialised process group.

Counterpart of ``repro/launch/mesh.py``.  Where the JAX package lays out
devices, a mesh here lays out the ranks of ``torch.distributed``'s default
group (one rank a card): ``make_mesh`` wraps them into a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions, which
also makes each dimension's sub-group.  ``make_production_mesh`` is a
FUNCTION, so importing this module touches no device or group state.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def mesh_from_ranks(ranks, axes, *, device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` over the array ``ranks`` (one global rank an entry,
    each rank once) with dimension names ``axes``.  Every rank of the
    group must call it, in the same order as its other meshes: a mesh
    makes one sub-group a dimension."""
    ranks = np.asarray(ranks, dtype=np.int64)
    if ranks.ndim != len(axes):
        raise ValueError(f"a mesh of shape {ranks.shape} takes "
                         f"{ranks.ndim} axis names, got {tuple(axes)}")
    return DeviceMesh(device_type, torch.from_numpy(ranks),
                      mesh_dim_names=tuple(axes))


def make_mesh(shape, axes, *, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over ranks 0..prod(shape)-1 of
    the initialised group, in row-major order.  Raises ``RuntimeError``
    with the world size the shape needs when the group is smaller (or
    larger) than that, or when no group is initialised."""
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of shape {tuple(shape)} needs an "
                           f"initialised process group of {need} ranks")
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(f"a mesh of shape {tuple(shape)} needs a world "
                           f"size of {need}; the group has {world}")
    return mesh_from_ranks(np.arange(need).reshape(tuple(shape)), axes,
                           device_type=device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The production mesh: (16, 16) over (data, model), or (2, 16, 16)
    over (pod, data, model); needs a group of 256 ranks (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of a dict already."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return {a: int(n) for a, n in zip(mesh.mesh_dim_names, mesh.mesh.shape)}
