"""Production mesh construction.

The JAX package's ``repro/launch/mesh.py``: one pod is a 16 x 16
``("data", "model")`` mesh of 256 ranks; the multi-pod mesh adds a
leading ``"pod"`` axis (2 x 16 x 16 = 512 ranks) that composes with
``"data"`` for batch sharding, so the slowest links carry only the
per-step gradient mean (optionally compressed, :mod:`repro_torch.optim.compress`).
A function, not a module constant: importing this module starts no
process group.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.runtime.elastic import GROUP_TIMEOUT, backend_for, ensure_group, make_mesh


def world_mesh(target_model: int = 16, device=None) -> tuple:
    """``(mesh, device)`` of a launcher's process: under ``torchrun`` (``WORLD_SIZE``
    above 1) the default group from its environment, this rank on its
    ``LOCAL_RANK`` card (or the CPU), and an elastic mesh over every rank;
    otherwise no mesh, as the JAX launchers do with one device."""
    device = resolve_device(device)
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None, device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device), timeout=GROUP_TIMEOUT)
    return make_mesh(target_model=target_model, device=device), device


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The ``(16, 16)`` (or ``(2, 16, 16)``) mesh over the first 256 (512) ranks of
    the default group, on ``device``'s type (default: the card). Raises when the
    group has fewer ranks, as ``jax.make_mesh`` does with too few devices."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    device = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} needs {n} ranks; the "
                         f"process group has {world}")
    ensure_group(device)
    return DeviceMesh(device.type, torch.arange(n).reshape(shape), mesh_dim_names=axes)
