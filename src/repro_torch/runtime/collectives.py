"""The mesh layer's explicit collectives, each counted by kind.

Where the JAX package writes a collective inside ``shard_map``
(``lax.psum``, ``lax.pmax``, ``lax.all_to_all``) or leaves one to GSPMD
(the gathers of a sharded tree, the gradient mean of a data-parallel
step), the port calls one of these over a mesh dim's process group
(:mod:`repro_torch.models.context`). Each adds one to :data:`ISSUED`
under its kind when it issues its collective, and nowhere else: the
counterpart of the kernel wrappers' launch counters, which shows that a
run over a one-rank mesh went through the collectives rather than the
meshless path.

A tensor that requires grad goes through ``torch.distributed.nn``'s
differentiable forms (the expert exchange and the data-parallel loss in
a training step); everything else through ``torch.distributed`` itself.
A failed collective raises: nothing here retries or falls back.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

KINDS = ("all_reduce", "all_to_all", "all_gather")

# Collectives issued so far in this process, by kind (reset with reset()).
ISSUED: collections.Counter = collections.Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset() -> None:
    """Set every count of :data:`ISSUED` to 0."""
    ISSUED.clear()
    ISSUED.update({k: 0 for k in KINDS})


def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum" or "max") of ``t`` over ``group``: the reduced tensor (``t``
    itself, reduced in place, unless ``t`` requires grad)."""
    ISSUED["all_reduce"] += 1
    if _needs_grad(t):
        from torch.distributed import nn as dist_nn

        return dist_nn.functional.all_reduce(t, op=_OPS[op], group=group)
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t[n, ...]`` split on dim 0 into one block a rank of ``group`` (``n`` its
    size), block ``i`` sent to rank ``i``; returns the blocks received, in rank
    order (``lax.all_to_all(..., split_axis=0, concat_axis=0, tiled=True)``)."""
    ISSUED["all_to_all"] += 1
    t = t.contiguous()
    out = torch.empty_like(t)
    if _needs_grad(t):
        from torch.distributed import nn as dist_nn

        return dist_nn.functional.all_to_all_single(out, t, group=group)
    dist.all_to_all_single(out, t, group=group)
    return out


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim`` in rank order."""
    ISSUED["all_gather"] += 1
    t = t.contiguous()
    n = dist.get_world_size(group)
    if _needs_grad(t):
        from torch.distributed import nn as dist_nn

        return torch.cat(dist_nn.functional.all_gather(t, group=group), dim=dim)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


reset()
