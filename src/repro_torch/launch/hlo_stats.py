"""Step cost of the port's eager steps: FLOPs, bytes, collective wire bytes, the roofline.

The JAX package's ``repro/launch/hlo_stats.py`` reads a compiled step:
``cost_analysis()`` for FLOPs and bytes, the optimized HLO's text for the
collectives' wire bytes. The port compiles nothing and has no HLO. It counts
an eager step as the step runs, once, under :func:`count_cost`:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (2 per multiply-add of
  every product: ``mm``, ``bmm``, convolutions, attention), plus what each
  kernel wrapper reports for its one call (:mod:`repro_torch.runtime.cost`);
* bytes: a ``TorchDispatchMode`` that sums the bytes each aten op reads and
  writes, plus each kernel wrapper's operands and output. In an eager
  program every op reads its inputs from device memory and writes its
  outputs back: nothing is fused, so the sum over the ops is the step's
  eager traffic (XLA, which fuses, counts a fusion's operands once instead).
  It is this implementation's, not the least the step needs: a copy that a
  later change removes lowers it. :func:`step_cost` also gives the least,
  ``min_bytes`` (arguments read once, outputs written once). View
  and alias ops move nothing. An indexed read (``index``, ``gather``,
  ``embedding``, ``index_select``) reads the rows it returns, not the whole
  table; an indexed write in place (``index_put_``, ``scatter_``,
  ``index_copy_``) reads and writes the values it stores, not the whole
  destination; ``copy_`` reads its source and writes its destination;
* collective wire bytes: what each collective reports, by kind, by the
  reference's byte convention (:mod:`repro_torch.runtime.collectives`);
* storage: the same dispatch mode follows every fresh result's storage until
  it is freed, so the peak of live intermediate storage comes out too.

The step runs for real on real tensors, or on ``meta`` tensors, which the
port's counterpart of ``jax.jit(...).lower(abstract args)`` is:
:func:`step_cost` runs ``fn`` once on ``meta`` copies of its arguments. A
``meta`` tensor is counted, never computed. The same call counts the same on
the CPU, the card and ``meta``.

The reference's ``cpu_convert_artifact_bytes`` has no counterpart: it finds
the float32 copies that XLA's CPU backend hoists out of a compiled loop, an
artifact of one compiler. An eager step holds only what its ops allocate,
and the storage count sees all of it.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.runtime import cost

aten = torch.ops.aten

# Indexed reads: the rows read are the output's; the indices are read too.
_INDEXED_READS = {aten.index.Tensor, aten.index_select.default, aten.gather.default,
                  aten.embedding.default}
# Indexed writes in place: the values stored are read and written; the indices read.
_INDEXED_WRITES = {aten.index_put_.default, aten._index_put_impl_.default,
                   aten.scatter_.src, aten.scatter_.value, aten.scatter_add_.default,
                   aten.index_copy_.default, aten.index_add_.default}
# Writes of the destination alone.
_FILLS = {aten.fill_.Scalar, aten.fill_.Tensor, aten.zero_.default}
# Allocations that write nothing, and ``_unsafe_view``, a view whose schema does
# not say so (a product's reshape of its fresh result).
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
               aten.new_empty.default, aten.new_empty_strided.default,
               aten._unsafe_view.default}


def _tensors(tree) -> list[torch.Tensor]:
    seen, out = set(), []
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _is_view(func) -> bool:
    """Whether ``func`` returns aliases of its inputs without writing them."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _fresh(func) -> bool:
    """Whether ``func``'s results are new storage (no result aliases an input)."""
    return all(r.alias_info is None for r in func._schema.returns)


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes one aten op reads and writes (the module docstring's rules)."""
    if func in _NO_TRAFFIC or _is_view(func):
        return 0
    nb = cost.tensor_bytes
    if func in _INDEXED_READS:
        idx = [t for t in _tensors((args[1:], kwargs)) if not t.is_floating_point()]
        return sum(map(nb, idx)) + 2 * sum(map(nb, _tensors(out)))
    if func in _INDEXED_WRITES:
        if func in (aten.index_put_.default, aten._index_put_impl_.default):
            idx, vals = _tensors(args[1]), [args[2]]
        else:  # (self, dim, index, src or value, ...)
            idx, vals = [args[2]], _tensors(args[3:4])
        written = (sum(map(nb, vals)) if vals
                   else args[2].numel() * args[0].element_size())
        return sum(map(nb, idx)) + 2 * written
    if func is aten.copy_.default:
        return nb(args[0]) + nb(args[1])
    if func in _FILLS:
        return nb(args[0])
    return sum(map(nb, _tensors((args, kwargs)))) + sum(map(nb, _tensors(out)))


class _ByteMode(TorchDispatchMode):
    """Sums :func:`op_bytes` over every aten op and tracks each fresh result's storage."""

    def __init__(self, counter: cost.CostCounter):
        super().__init__()
        self.counter = counter
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.bytes += op_bytes(func, args, kwargs, out)
        if _fresh(func):
            for t in _tensors(out):
                self.counter.track(t)
        return out


@dataclasses.dataclass
class StepCost:
    """What :func:`count_cost` counted (filled in when its block ends).

    ``flops``, ``bytes_accessed`` and ``collective_bytes`` (this rank's wire
    bytes) are the keys of the reference's ``compiled_cost``; ``by_op`` holds the
    wire bytes by collective kind, ``collective_calls`` the calls by kind,
    ``kernels`` the kernel-wrapper calls by ``"<kernel>/<route>"``;
    ``peak_bytes`` is the peak of live storage allocated inside the block and
    ``live_bytes`` what of it is still referenced at its end.
    """

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    by_op: dict = dataclasses.field(default_factory=dict)
    collective_calls: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    live_bytes: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def kernel_calls(self) -> dict:
        """The kernel-wrapper calls by kernel, over every route."""
        out: dict = {}
        for key, n in self.kernels.items():
            name = key.split("/")[0]
            out[name] = out.get(name, 0) + n
        return out


@contextlib.contextmanager
def count_cost():
    """Count the FLOPs, bytes, wire bytes and storage of everything run inside the
    block; yields a :class:`StepCost` that holds the sums once the block ends."""
    from torch.utils.flop_counter import FlopCounterMode

    result = StepCost()
    counter = cost.CostCounter()
    mode = _ByteMode(counter)
    with cost.counting(counter):
        flop_mode = FlopCounterMode(display=False)
        with flop_mode, mode:
            yield result
    result.flops = float(flop_mode.get_total_flops()) + counter.flops
    result.bytes_accessed = float(mode.bytes) + counter.bytes_accessed
    result.by_op = {k: float(v) for k, v in counter.wire.items() if v}
    result.collective_bytes = float(sum(result.by_op.values()))
    result.collective_calls = {k: int(v) for k, v in counter.calls.items() if v}
    result.kernels = {k: int(v) for k, v in counter.kernels.items() if v}
    result.peak_bytes = int(counter.peak)
    result.live_bytes = int(counter.live)


def to_meta(tree):
    """A ``meta`` copy of ``tree`` (dicts, lists, tuples, packed weights, tensors):
    each tensor an empty ``meta`` tensor of its shape, dtype and strides; anything
    else as it is."""
    from repro_torch.kernels.ops import PackedWeight

    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tree.shape, tree.stride(), dtype=tree.dtype, device="meta")
    if isinstance(tree, PackedWeight):
        return dataclasses.replace(tree, codes=to_meta(tree.codes), sf=to_meta(tree.sf))
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v) for v in tree)
    return tree


def tree_bytes(tree) -> int:
    """The bytes of the tensors in ``tree`` (packed weights' codes and scales
    included), each tensor's elements once: the arguments' bytes of a step."""
    return sum(t.numel() * t.element_size()
               for t in {id(t): t for t in _tensor_leaves(tree)}.values())


def _fresh_bytes(out, before: set[int]) -> int:
    """The bytes of the storages in ``out`` that the step made (not in ``before``)."""
    seen: dict[int, int] = {}
    for t in _tensors(out):
        st = t.untyped_storage()
        if id(st) not in before:
            seen.setdefault(id(st), st.nbytes())
    return sum(seen.values())


def step_cost(fn, *args, **kwargs) -> dict:
    """The counterpart of the reference's ``compiled_cost``: ``fn`` run once on
    ``meta`` copies of its tensor arguments (packed weights included) under
    :func:`count_cost`. Returns ``flops``, ``bytes_accessed`` and
    ``collective_bytes`` (this rank's), ``by_op``, ``collective_calls`` and
    ``kernels``; ``memory``: the arguments' bytes, the fresh outputs' bytes and
    the peak of the other live storage (``temp_bytes``); and ``min_bytes``, the
    arguments read once and the fresh outputs written once, the least traffic
    of the step whatever implements it (:func:`roofline_terms`)."""
    margs, mkwargs = to_meta(args), to_meta(kwargs)
    arg_storages = {id(t.untyped_storage()) for t in _tensor_leaves((margs, mkwargs))}
    with count_cost() as c:
        out = fn(*margs, **mkwargs)
    rec = c.as_dict()
    rec["memory"] = _memory_record(tree_bytes((margs, mkwargs)),
                                   _fresh_bytes(out, arg_storages), c.peak_bytes)
    rec["min_bytes"] = rec["memory"]["argument_bytes"] + rec["memory"]["output_bytes"]
    return rec


def _tensor_leaves(tree) -> list[torch.Tensor]:
    """The tensors of ``tree`` (packed weights' codes and scales included)."""
    from repro_torch.kernels.ops import PackedWeight

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, PackedWeight):
        return [tree.codes, tree.sf]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return []


def _memory_record(argument_bytes: int, output_bytes: int, peak_bytes: int) -> dict:
    """The dry-run's memory keys: arguments, fresh outputs, and temp, the rest of the
    peak of storage allocated in the step, so that the three sum to the predicted
    peak of the step (``total_per_device_gib``)."""
    temp = max(int(peak_bytes) - int(output_bytes), 0)
    rec = {"argument_bytes": int(argument_bytes), "output_bytes": int(output_bytes),
           "temp_bytes": temp}
    rec["total_per_device_gib"] = (rec["argument_bytes"] + rec["output_bytes"] + temp) / 2**30
    return rec


# ---------------------------------------------------------------------------
# NVIDIA H100 80GB HBM3 constants (datasheet, one card at its 700 W limit)
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s (datasheet, NVIDIA H100 80GB HBM3, 700 W)
HBM_BW = 3.35e12  # bytes/s (datasheet, NVIDIA H100 80GB HBM3, 700 W)
NVLINK_BW = 450e9  # bytes/s a direction, within a node (datasheet, NVIDIA H100 80GB HBM3, 700 W)
IB_BW = 50e9  # bytes/s a GPU, across nodes (datasheet, NVIDIA H100 80GB HBM3, 700 W)
NODE_SIZE = 8  # cards a node: ranks 8i .. 8i+7 share NVLink


def link_bandwidth(mesh) -> float:
    """The bandwidth of the slowest link that a group of ``mesh`` (this rank's ranks
    along one of its axes) crosses: NVLink within a node of :data:`NODE_SIZE`
    consecutive ranks, InfiniBand across nodes. NVLink for no mesh."""
    if mesh is None:
        return NVLINK_BW
    grid = mesh.mesh
    coord = mesh.get_coordinate()
    for d in range(grid.ndim):
        if grid.shape[d] < 2:
            continue
        index = list(coord)
        index[d] = slice(None)
        ranks = grid[tuple(index)].reshape(-1).tolist()
        if len({r // NODE_SIZE for r in ranks}) > 1:
            return IB_BW
    return NVLINK_BW


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float, link_bw: float = IB_BW,
                   min_bytes_per_device: float | None = None) -> dict:
    """The three roofline terms in seconds, per device (the global quantities are the
    per-device ones times the device count, which cancels): compute at
    :data:`PEAK_FLOPS`, memory at :data:`HBM_BW`, collectives at ``link_bw`` (the
    slowest link the step's groups cross, :func:`link_bandwidth`).

    ``memory_s`` is the eager traffic's: every op's reads and writes, which an
    implementation that fuses or drops copies lowers. ``min_memory_s``, given
    ``min_bytes_per_device`` (a step's arguments read once and its outputs written
    once, ``min_bytes`` of :func:`step_cost`), is the traffic any
    implementation of the same step must make: the term that reads the same work
    whatever implements it."""
    compute_s = flops_per_device / PEAK_FLOPS
    memory_s = bytes_per_device / HBM_BW
    collective_s = coll_bytes_per_device / link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]).replace("_s", "")
    terms["total_s"] = max(compute_s, memory_s, collective_s)
    if min_bytes_per_device is not None:
        terms["min_memory_s"] = min_bytes_per_device / HBM_BW
    return terms
