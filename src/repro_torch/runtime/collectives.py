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

Every collective issues through ``torch.distributed`` itself. A tensor
that requires grad goes through a ``torch.autograd.Function`` whose
backward issues its collective through this module too, so what a
backward pass issues is counted as a forward's is: :func:`all_reduce`'s
gradient is reduced the same way and :func:`all_to_all`'s exchanged back
(``torch.distributed.nn``'s rules; the expert exchange and the norm's sum
of squares in a training step), :func:`all_gather`'s is
:func:`gather_seq`'s. The tensor-parallel layers use the conjugate pairs
below, each a ``torch.autograd.Function`` whose backward is the other half
of the pair:

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

Each also adds the bytes it puts on this rank's wire to :data:`WIRE_BYTES`
under its kind, by the JAX package's convention for its compiled steps
(``repro/launch/hlo_stats.py``), with ``g`` the group's size and ``b`` the
bytes of the result:

* ``all_reduce`` and ``agree``: ``2·b·(g-1)/g`` (a ring's send and receive);
* ``all_gather``: ``b·(g-1)/g``;
* ``reduce_scatter``: ``b·(g-1)`` (the operand is ``g`` results);
* ``all_to_all``: ``b·(g-1)/g``.

:data:`ISSUED` and :data:`WIRE_BYTES` count what was issued. Under an active
cost counter (:mod:`repro_torch.runtime.cost`) every call also reports its
kind and wire bytes there. A ``meta`` tensor is counted, never computed: the
call reads ``g`` from the group, reports, and returns an empty ``meta``
result of the real shape, whose gradient is counted the same way; it
issues nothing and adds nothing to :data:`ISSUED` or :data:`WIRE_BYTES`
(the dry-run's abstract evaluation, :mod:`repro_torch.launch.hlo_stats`).

Gathered blocks may differ in size along their dim (``sizes``, one a
rank): they travel padded to the largest, and are counted padded. A ``gloo`` group carries CUDA tensors
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

from repro_torch.runtime import cost

KINDS = ("all_reduce", "all_to_all", "all_gather", "reduce_scatter", "agree")

# Collectives issued so far in this process, by kind (reset with reset()).
ISSUED: collections.Counter = collections.Counter()
# Their bytes on this rank's wire, by kind (reset with reset()).
WIRE_BYTES: collections.Counter = collections.Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset() -> None:
    """Set every count of :data:`ISSUED` and :data:`WIRE_BYTES` to 0."""
    for counter, zero in ((ISSUED, 0), (WIRE_BYTES, 0.0)):
        counter.clear()
        counter.update({k: zero for k in KINDS})


def wire_bytes(kind: str, result_bytes: int, g: int) -> float:
    """The bytes one collective of ``kind`` puts on a rank's wire, for a result of
    ``result_bytes`` over a group of ``g`` ranks (the module docstring's rule)."""
    if kind in ("all_reduce", "agree"):
        return 2.0 * result_bytes * (g - 1) / g
    if kind in ("all_gather", "all_to_all"):
        return result_bytes * (g - 1) / g
    if kind == "reduce_scatter":
        return float(result_bytes * (g - 1))
    raise ValueError(f"unknown collective kind {kind!r} (known: {KINDS})")


def _issue(kind: str, result_bytes: int, group, outs=(), *, meta: bool = False) -> None:
    """Count one collective of ``kind`` with a result of ``result_bytes``: in
    :data:`ISSUED` and :data:`WIRE_BYTES` unless it runs on ``meta`` (nothing is
    issued then), and in the active cost counter (``outs``, its new results,
    tracked there)."""
    wire = wire_bytes(kind, result_bytes, dist.get_world_size(group))
    if not meta:
        ISSUED[kind] += 1
        WIRE_BYTES[kind] += wire
    cost.collective(kind, wire, outs)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


# The collectives themselves, on tensors that carry no gradient: each issues
# (nothing on ``meta``), then counts. The public functions below route a tensor
# that requires grad through an autograd Function whose backward is one of
# these too, so a backward's collectives are counted as a forward's are.


def _reduced(t: torch.Tensor, group, op: str, fresh: bool) -> torch.Tensor:
    """``op`` of ``t`` over ``group``, in place, or into a new tensor if ``fresh``."""
    with cost.paused():
        out = t.clone(memory_format=torch.contiguous_format) if fresh else t
        if not t.is_meta:
            dist.all_reduce(out, op=_OPS[op], group=group)
    _issue("all_reduce", _nbytes(t), group, (out,) if fresh else (), meta=t.is_meta)
    return out


def _exchanged(t: torch.Tensor, group) -> torch.Tensor:
    """The blocks of the contiguous ``t`` exchanged over ``group`` (:func:`all_to_all`)."""
    with cost.paused():
        out = torch.empty_like(t)
        if not t.is_meta:
            dist.all_to_all_single(out, t, group=group)
    _issue("all_to_all", _nbytes(t), group, (out,), meta=t.is_meta)
    return out


def _gathered(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's contiguous ``t`` of ``group``, in rank order."""
    n = dist.get_world_size(group)
    with cost.paused():
        parts = [torch.empty_like(t) for _ in range(n)]
        if not t.is_meta:
            dist.all_gather(parts, t, group=group)
    _issue("all_gather", n * _nbytes(t), group, parts, meta=t.is_meta)
    return parts


def _scattered(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, this rank's equal block along ``dim``."""
    n = dist.get_world_size(group)
    blocks = [b.contiguous() for b in t.split(blocks_of(t.shape[dim], n)[0][1], dim=dim)]
    with cost.paused():
        out = torch.empty_like(blocks[0])
        if not t.is_meta:
            dist.reduce_scatter(out, blocks, group=group)
    _issue("reduce_scatter", _nbytes(out), group, (out,), meta=t.is_meta)
    return out


class _AllReduce(torch.autograd.Function):
    """``all_reduce``; the gradient reduced the same way (``torch.distributed.nn``'s
    rule)."""

    @staticmethod
    def forward(ctx, x, group, op):
        ctx.group, ctx.op = group, op
        return _reduced(x, group, op, fresh=True)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group, ctx.op, fresh=True), None, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` of equal blocks; the gradient's blocks sent back the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchanged(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchanged(g.contiguous(), ctx.group), None


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum" or "max") of ``t`` over ``group``: the reduced tensor (``t``
    itself, reduced in place, unless ``t`` requires grad; its gradient is then
    reduced the same way)."""
    if _needs_grad(t):
        return _AllReduce.apply(t, group, op)
    return _reduced(t, group, op, fresh=False)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t[n, ...]`` split on dim 0 into one block a rank of ``group`` (``n`` its
    size), block ``i`` sent to rank ``i``; returns the blocks received, in rank
    order (``lax.all_to_all(..., split_axis=0, concat_axis=0, tiled=True)``).
    The gradient travels back by the same exchange."""
    t = t.contiguous()
    return _AllToAll.apply(t, group) if _needs_grad(t) else _exchanged(t, group)


def all_gather(t: torch.Tensor, dim: int, group, sizes=None) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim`` in rank order;
    ``sizes`` (each rank's extent along ``dim``) where they differ. The gradient
    is summed over ``group`` and this rank keeps its block (:func:`gather_seq`)."""
    n = dist.get_world_size(group)
    ragged = sizes is not None and len(set(sizes)) > 1
    if ragged:
        t = _pad_to(t, dim, max(sizes))
    t = t.contiguous()
    if _needs_grad(t):
        whole = gather_seq(t, dim, group)
        if not ragged:
            return whole
        parts = whole.chunk(n, dim=dim)
    else:
        parts = _gathered(t, group)
    if ragged:
        parts = [p.narrow(dim, 0, s) for p, s in zip(parts, sizes)]
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group`` of ``t``, of which this rank keeps its equal block
    along ``dim``; the gradient's blocks are gathered back whole
    (:func:`scatter_seq`)."""
    if _needs_grad(t):
        return scatter_seq(t, dim, group)
    return _scattered(t, dim, group)


def agree(vec: torch.Tensor, group) -> bool:
    """Whether the small integer vector ``vec`` is equal on every rank of ``group``:
    one ``all_reduce(MAX)`` of ``[vec, -vec]``, whose halves are the vector's
    maximum and minus its minimum over the group (the values stay within
    ``+-(2**63 - 1)``). Returns a host bool, so it waits for the collective."""
    v = vec.to(torch.int64).reshape(-1)
    both = torch.cat([v, -v])
    with cost.paused():
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    _issue("agree", _nbytes(both), group)
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
