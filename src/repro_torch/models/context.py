"""Parallel execution context threaded through model code.

The JAX package's ``repro/models/context.py`` over ``torch.distributed``.
A :class:`ParallelCtx` tells the layers how the current mesh is laid out,
so the manually parallel blocks (the tensor-parallel projections, the
expert-parallel MoE, flash-decoding over a sequence-sharded KV cache) can
name their axes and reach their process groups. ``None`` means one device without a mesh: every layer
also works without a context.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dims are
named ``("data", "model")`` or ``("pod", "data", "model")``
(:func:`repro_torch.runtime.elastic.make_mesh`). The port runs SPMD, one
process a rank: each rank holds its local shard of every tensor, and the
collectives that the JAX package writes inside ``shard_map`` run over the
process group of the axes named (:func:`axes_group`). A group over
several axes (``("pod", "data")``) is made once per mesh, by every rank
in the same order, as ``torch.distributed.new_group`` asks, with the
explicit timeout :data:`GROUP_TIMEOUT` (``new_group`` would give it the
backend's default of 30 minutes), so a rank that leaves the order of
collectives fails there instead of waiting.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import weakref

import torch.distributed as dist

from repro_torch.runtime.sharding import mesh_shape

MOE_IMPLS = ("ep", "dense")
# The collective timeout of the process groups the port starts: a rank that
# leaves the order of collectives fails within it instead of waiting for ever.
GROUP_TIMEOUT = datetime.timedelta(minutes=10)

# DeviceMesh -> {axes: (process group, its ranks)}, for groups over several axes
_GROUPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _dim(mesh, axis: str) -> int:
    return tuple(mesh.mesh_dim_names).index(axis)


def axes_size(mesh, axes: tuple[str, ...]) -> int:
    """Ranks along ``axes`` (1 for no axes)."""
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in axes)


def axes_index(mesh, axes: tuple[str, ...]) -> int:
    """This rank's index along ``axes``, the first axis major (a spec entry's order)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    shape = mesh_shape(mesh)
    idx = 0
    for a in axes:
        idx = idx * shape[a] + coord[_dim(mesh, a)]
    return idx


def axes_group(mesh, axes: tuple[str, ...]):
    """The process group of this rank's ranks along ``axes`` (group rank = index
    along ``axes``, as :func:`axes_index`). Every rank must call this for a new
    pair of a mesh and several axes, in the same order."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = _GROUPS.setdefault(mesh, {})
    if axes not in groups:
        if list(axes) != sorted(axes, key=lambda a: _dim(mesh, a)):
            raise ValueError(f"axes {axes} are not in the mesh's order {mesh.mesh_dim_names}")
        grid = mesh.mesh
        rest = [d for d in range(grid.ndim) if d not in {_dim(mesh, a) for a in axes}]
        rows = grid.permute(*rest, *(_dim(mesh, a) for a in axes)).reshape(
            -1, axes_size(mesh, axes))
        mine = None
        for row in rows.tolist():
            g = dist.new_group(row, timeout=GROUP_TIMEOUT)
            if dist.get_rank() in row:
                mine = g
        groups[axes] = mine
    return groups[axes]


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """How the mesh carries the model: the batch over ``batch_axes``, tensor and
    expert parallelism over ``model_axis``. ``moe_impl`` is ``"ep"`` (the
    expert-parallel exchange) or ``"dense"``; ``flash_decode`` attends a decode
    step over the sequence-sharded cache; ``seq_parallel`` keeps the residual
    stream between the tensor-parallel products split along the sequence over
    the model axis (the reference's sequence-parallel layout)."""

    mesh: object
    batch_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    moe_impl: str = "ep"
    flash_decode: bool = False
    seq_parallel: bool = False

    def __post_init__(self):
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl is one of {MOE_IMPLS}, got {self.moe_impl!r}")

    @property
    def all_axes(self) -> tuple[str, ...]:
        return tuple(self.batch_axes) + (self.model_axis,)

    @property
    def model_size(self) -> int:
        return mesh_shape(self.mesh)[self.model_axis]

    @property
    def batch_size(self) -> int:
        """Ranks along the batch axes."""
        return axes_size(self.mesh, tuple(self.batch_axes))

    @property
    def model_group(self):
        return axes_group(self.mesh, (self.model_axis,))

    @property
    def batch_group(self):
        return axes_group(self.mesh, tuple(self.batch_axes))

    @property
    def model_rank(self) -> int:
        return axes_index(self.mesh, (self.model_axis,))

    @property
    def batch_rank(self) -> int:
        return axes_index(self.mesh, tuple(self.batch_axes))
