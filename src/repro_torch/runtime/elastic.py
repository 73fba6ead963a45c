"""Elastic scaling: pick a mesh for the ranks that are alive, and (re)lay trees out on it.

The JAX package's ``repro/runtime/elastic.py`` over ``torch.distributed``.
Checkpoints hold whole logical tensors (:func:`gather` before a save), so
surviving a node failure or a resize is: pick a mesh for the ranks that
are alive, rebuild the sharding rules for THAT mesh (they are
divisibility-aware, so they adapt), and :func:`reshard` the restored tree.
Nothing in the model or step code changes.

:func:`choose_mesh_shape` is the policy: keep the model axis as close to
the target tensor-parallel degree as the rank count allows (it must
divide the count), give the rest to data (and pod, when more than one
pod of ranks remains).

:func:`make_mesh` lays the mesh over the default process group. The
device decides the backend: ``nccl`` for the card, ``gloo`` for the CPU.
With no group yet it starts a one-rank group on a ``FileStore`` in a
fresh temporary file (no port, no environment, so processes that do
this side by side cannot collide; the store removes the file when the
group is destroyed), with an explicit timeout (:data:`GROUP_TIMEOUT`). A
group whose backend is not the device's raises, except a ``gloo`` group
for the card: its caller chose to carry CUDA tensors over the host (two
ranks that share one card, which NCCL refuses); nothing switches backend. The
dry-run's one-process ``fake`` group (:mod:`repro_torch.launch.dryrun`) serves
any device: nothing is issued over it.

:func:`reshard` gives each packed weight its local logical ``shape``.
Codes are nibble-packed along K, so a block of a row-parallel weight's
packed rows is twice as many logical rows, except in the last rank's
block of an odd K, which holds the pad row and one logical row less.
"""
from __future__ import annotations

import dataclasses
import tempfile

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import PackedWeight
from repro_torch.models.context import GROUP_TIMEOUT, axes_group, axes_index, axes_size
from repro_torch.runtime import collectives
from repro_torch.runtime.sharding import spec_axes

POD_SIZE = 256
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def choose_mesh_shape(n_devices: int, target_model: int = 16) -> tuple[tuple[int, ...],
                                                                        tuple[str, ...]]:
    """The largest mesh for ``n_devices`` ranks honoring the tensor-parallel target."""
    model = target_model
    while model > 1 and n_devices % model != 0:
        model //= 2
    rest = n_devices // model
    if rest > POD_SIZE // model and rest % 2 == 0:
        # split a pod axis off the data dimension for deployments of more than one pod
        pods = rest * model // POD_SIZE
        data = rest // pods
        if pods * data * model == n_devices and data >= 1 and pods > 1:
            return (pods, data, model), ("pod", "data", "model")
    return (rest, model), ("data", "model")


def backend_for(device: torch.device) -> str:
    """The collective backend of ``device``'s type."""
    if device.type not in BACKENDS:
        raise ValueError(f"no collective backend for device type {device.type!r}")
    return BACKENDS[device.type]


def ensure_group(device=None) -> None:
    """The default process group, started as a one-rank group on a ``FileStore``
    when there is none; raises if it exists with another backend than ``device``'s
    (a ``gloo`` group serves the card too)."""
    device = resolve_device(device)
    backend = backend_for(device)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend and have != "fake" and not (have == "gloo"
                                                       and device.type == "cuda"):
            raise ValueError(f"the process group runs {have!r}, but {device} needs {backend!r}")
        return
    if device.type == "cuda":  # NCCL binds the group to the current card
        torch.cuda.set_device(device if device.index is not None else torch.cuda.current_device())
    with tempfile.NamedTemporaryFile(prefix="repro_torch_pg_", delete=False) as f:
        path = f.name
    store = dist.FileStore(path, 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1, timeout=GROUP_TIMEOUT)


def make_mesh(devices=None, target_model: int = 16, *, device=None):
    """A ``DeviceMesh`` over ``devices`` (global ranks in layout order; default
    every rank of the default group), shaped by :func:`choose_mesh_shape`, on
    ``device``'s type (default: the card). Every rank of the group calls it;
    a rank outside ``devices`` gets a mesh it is not in (no coordinate)."""
    from torch.distributed.device_mesh import DeviceMesh

    device = resolve_device(device)
    ensure_group(device)
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    shape, axes = choose_mesh_shape(len(ranks), target_model)
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(shape)
    return DeviceMesh(device.type, grid, mesh_dim_names=axes)


def local_block(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec``."""
    out = x
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        n = axes_size(mesh, axes)
        if n == 1:
            continue
        if out.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide over {axes}")
        out = out.chunk(n, dim=d)[axes_index(mesh, axes)]
    return x if out is x else out.clone()


def _whole(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The whole tensor from this rank's block ``x``: gathered over each sharded dim."""
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes_size(mesh, axes) > 1:
            x = collectives.all_gather(x, d, axes_group(mesh, axes))
    return x


def _k_axes(pw: PackedWeight, spec) -> tuple[str, ...]:
    """The axes that shard a packed weight's K (its codes' dim -2)."""
    entries = list(spec) + [None] * (pw.codes.ndim - len(spec))
    return spec_axes(entries[-2])


def local_shape(pw: PackedWeight, mesh, spec) -> tuple[int, int]:
    """The logical ``(K, N)`` of this rank's block of the whole packed weight
    ``pw`` under its codes' ``spec``."""
    k, n = pw.shape
    entries = list(spec) + [None] * (pw.codes.ndim - len(spec))
    n_axes = spec_axes(entries[-1])
    if n_axes:
        n //= axes_size(mesh, n_axes)
    k_axes = _k_axes(pw, spec)
    if k_axes:
        parts = axes_size(mesh, k_axes)
        rows = pw.codes.shape[-2] // parts
        step = 2 * rows if pw.nibble else rows
        start = axes_index(mesh, k_axes) * step
        k = min(k, start + step) - start
        if k < 1:
            raise ValueError(f"K = {pw.shape[0]} over {parts} ranks leaves this rank no row")
    return k, n


def reshard(tree, mesh, spec_tree):
    """Each leaf of a whole (logical) tree replaced by this rank's block under its
    spec: a view-free copy where the spec shards, the leaf itself where it does not;
    a packed weight's ``shape`` becomes its block's logical one."""
    def leaf(x, spec):
        if isinstance(x, PackedWeight):
            return dataclasses.replace(x, codes=local_block(x.codes, mesh, spec.codes),
                                       sf=local_block(x.sf, mesh, spec.sf),
                                       shape=local_shape(x, mesh, spec.codes))
        return local_block(x, mesh, spec)

    return _walk(leaf, tree, spec_tree)


def gather(tree, mesh, spec_tree):
    """:func:`reshard`'s inverse: each leaf whole, gathered from every rank's block
    (a collective: every rank of the mesh calls it)."""
    def leaf(x, spec):
        if not isinstance(x, PackedWeight):
            return _whole(x, mesh, spec)
        k, n = x.shape
        entries = list(spec.codes) + [None] * (x.codes.ndim - len(spec.codes))
        n *= axes_size(mesh, spec_axes(entries[-1]))
        k_axes = _k_axes(x, spec.codes)
        if k_axes:  # the blocks' logical rows, the last one's short of an odd K's pad
            k = int(collectives.all_gather(
                torch.tensor([k], device=x.codes.device), 0, axes_group(mesh, k_axes)).sum())
        return dataclasses.replace(x, codes=_whole(x.codes, mesh, spec.codes),
                                   sf=_whole(x.sf, mesh, spec.sf), shape=(k, n))

    return _walk(leaf, tree, spec_tree)


def _walk(fn, tree, spec_tree):
    """``fn(leaf, spec)`` over a tree whose packed weights are leaves (their spec a
    packed weight holding the codes' and scales' specs)."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(fn, v, s) for v, s in zip(tree, spec_tree))
    return fn(tree, spec_tree)
