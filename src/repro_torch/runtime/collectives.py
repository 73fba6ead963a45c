"""The mesh layer's explicit collectives, each counted by kind.

Where the JAX package writes a collective inside ``shard_map``
(``lax.psum``, ``lax.pmax``, ``lax.all_to_all``) or leaves one to GSPMD
(the gathers of a sharded tree, the gradient mean of a data-parallel
step, the partial sums of a tensor-parallel product), the port calls one
of these over a mesh dim's process group
(:mod:`repro_torch.models.context`). Each adds one to :data:`ISSUED`
under its kind when it issues its collective, and nowhere else: the
counterpart of the kernel wrappers' launch counters, which shows that a
run over a mesh went through the collectives rather than the meshless
path. A collective that a backward pass issues counts too. :func:`agree`,
the serving engine's check that its ranks took the same decisions, counts
under its own kind, ``"agree"``.

A tensor that requires grad goes through ``torch.distributed.nn``'s
differentiable forms (the expert exchange and the data-parallel loss in
a training step); everything else through ``torch.distributed`` itself.
The tensor-parallel layers use the conjugate pairs below, each a
``torch.autograd.Function`` whose backward is the other half of the pair:

* :func:`copy_to_model` (identity, then ``all_reduce`` of the gradient) at
  the input of a column-parallel product, and :func:`reduce_from_model`
  (``all_reduce``, then the identity) at the output of a row-parallel one;
* :func:`gather_seq` (``all_gather`` along the sequence, then
  ``reduce_scatter``) and :func:`scatter_seq` (``reduce_scatter``, then
  ``all_gather``), their sequence-parallel forms;
* :func:`gather_from_model` (``all_gather`` of rank blocks, then this
  rank's block of the gradient) and :func:`split_to_model` (this rank's
  block, then ``all_gather`` of the gradient), the layout changes between
  a whole tensor and its rank blocks.

Gathered blocks may differ in size along their dim (``sizes``, one a
rank): they travel padded to the largest. A ``gloo`` group carries CUDA tensors
for every kind here (PyTorch 2.11 on the H100: ``all_reduce``,
``all_gather``, ``reduce_scatter`` and ``all_to_all``), so nothing is
staged through the host. A failed collective raises: nothing here retries
or falls back.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist
import torch.nn.functional as F

KINDS = ("all_reduce", "all_to_all", "all_gather", "reduce_scatter", "agree")

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


def all_gather(t: torch.Tensor, dim: int, group, sizes=None) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim`` in rank order;
    ``sizes`` (each rank's extent along ``dim``) where they differ."""
    ISSUED["all_gather"] += 1
    n = dist.get_world_size(group)
    if sizes is not None and len(set(sizes)) > 1:
        t = _pad_to(t, dim, max(sizes))
    t = t.contiguous()
    if _needs_grad(t):
        from torch.distributed import nn as dist_nn

        parts = list(dist_nn.functional.all_gather(t, group=group))
    else:
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
    if sizes is not None and len(set(sizes)) > 1:
        parts = [p.narrow(dim, 0, s) for p, s in zip(parts, sizes)]
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group`` of ``t``, of which this rank keeps its equal block
    along ``dim``."""
    ISSUED["reduce_scatter"] += 1
    n = dist.get_world_size(group)
    blocks = [b.contiguous() for b in t.split(blocks_of(t.shape[dim], n)[0][1], dim=dim)]
    out = torch.empty_like(blocks[0])
    dist.reduce_scatter(out, blocks, group=group)
    return out


def agree(vec: torch.Tensor, group) -> bool:
    """Whether the small integer vector ``vec`` is equal on every rank of ``group``:
    one ``all_reduce(MAX)`` of ``[vec, -vec]``, whose halves are the vector's
    maximum and minus its minimum over the group (the values stay within
    ``+-(2**63 - 1)``). Returns a host bool, so it waits for the collective."""
    ISSUED["agree"] += 1
    v = vec.to(torch.int64).reshape(-1)
    both = torch.cat([v, -v])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    n = v.numel()
    return bool(torch.equal(both[:n], -both[n:]))


def _pad_to(t: torch.Tensor, dim: int, width: int) -> torch.Tensor:
    extra = width - t.shape[dim]
    if extra == 0:
        return t
    pad = [0, 0] * (t.ndim - dim % t.ndim - 1) + [0, extra]
    return F.pad(t, pad)


def blocks_of(total: int, n: int, sizes=None) -> list[tuple[int, int]]:
    """``[start, stop)`` of each rank's block of ``total`` (equal blocks, or
    ``sizes``)."""
    if sizes is None:
        if total % n:
            raise ValueError(f"{total} does not split into {n} equal blocks")
        sizes = [total // n] * n
    if sum(sizes) != total:
        raise ValueError(f"blocks {list(sizes)} do not cover {total}")
    out, start = [], 0
    for s in sizes:
        out.append((start, start + s))
        start += s
    return out


def _block(t: torch.Tensor, dim: int, group, sizes) -> torch.Tensor:
    start, stop = blocks_of(t.shape[dim], dist.get_world_size(group), sizes)[
        dist.get_rank(group)]
    return t.narrow(dim, start, stop - start)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, sizes):
        ctx.dim, ctx.group, ctx.sizes = dim, group, sizes
        return all_gather(x, dim, group, sizes)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.group, ctx.sizes).contiguous(), None, None, None


class _SplitToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(x, dim, group, None).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group`` (each rank's gradient
    is the part that its column block of a product contributes)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (the partial products of a row-parallel
    product); the gradient passes as it is."""
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int, group, sizes=None) -> torch.Tensor:
    """Every rank's block ``x`` concatenated along ``dim``; the gradient's block
    of this rank passes back."""
    return _GatherFromModel.apply(x, dim, group, None if sizes is None else tuple(sizes))


def split_to_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal block of the whole ``x`` along ``dim``; the gradient's
    blocks are gathered back whole."""
    return _SplitToModel.apply(x, dim, group)


def gather_seq(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's rows ``x`` concatenated along the sequence ``dim``; the
    gradient is summed over ``group`` and this rank keeps its rows."""
    return _GatherSeq.apply(x, dim, group)


def scatter_seq(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, this rank's rows along the sequence
    ``dim``; the gradient's rows are gathered back whole."""
    return _ScatterSeq.apply(x, dim, group)


reset()
