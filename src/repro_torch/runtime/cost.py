"""The active step-cost counter, which the kernel wrappers and the collectives report to.

:func:`repro_torch.launch.hlo_stats.count_cost` pushes a :class:`CostCounter`
and counts every aten op of the step under it. Two kinds of call do not go
through aten as what they are, and report themselves here instead:

* a kernel wrapper (:mod:`repro_torch.kernels`) counts as one operation,
  :func:`kernel`: its FLOPs and the bytes of its operands and output, each
  once, under ``"<kernel>/<route>"``. Whatever it runs inside (the plain
  version on the CPU, the launch on the card, nothing on ``meta``) runs
  under :func:`paused` and adds nothing, so one call counts the same on
  every device;
* a collective (:mod:`repro_torch.runtime.collectives`) counts its wire
  bytes by kind, :func:`collective`; the ``torch.distributed`` call itself
  runs under :func:`paused`.

A ``meta`` tensor is counted, never computed: a wrapper or a collective
given one returns an empty ``meta`` result of the real shape and dtype,
reports its cost here, and launches and issues nothing. The counter also
follows the storage that the step allocates (:meth:`CostCounter.track`), so
the peak of live intermediate storage is known without a device.

Nothing is counted while no counter is active, and nothing here imports
the launch tooling: the kernels and the collectives import this module.
"""
from __future__ import annotations

import collections
import contextlib
import weakref

import torch
from torch.utils.weak import WeakIdKeyDictionary

_ACTIVE: list["CostCounter"] = []


class CostCounter:
    """Sums of one counted step.

    ``flops`` and ``bytes_accessed`` hold what the kernel wrappers reported
    (the aten ops' own are added by ``count_cost``), ``wire`` the collectives'
    wire bytes by kind, ``calls`` the collectives by kind, ``kernels`` the
    wrapper calls by ``"<kernel>/<route>"``. ``live`` and ``peak`` are the
    bytes of the storage allocated since the counter started that is still
    referenced, now and at most.
    """

    def __init__(self) -> None:
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.wire: collections.Counter = collections.Counter()
        self.calls: collections.Counter = collections.Counter()
        self.kernels: collections.Counter = collections.Counter()
        self.live = 0
        self.peak = 0
        self.paused = 0
        self._known: WeakIdKeyDictionary = WeakIdKeyDictionary()

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live from now until it is freed, once per storage
        (``t`` is a fresh result: a storage that existed before the step is never
        passed here)."""
        st = t.untyped_storage()
        if st in self._known:
            return
        n = st.nbytes()
        self._known[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n


def active() -> CostCounter | None:
    """The counter of the innermost ``count_cost``, None outside one or while paused."""
    if _ACTIVE and not _ACTIVE[-1].paused:
        return _ACTIVE[-1]
    return None


@contextlib.contextmanager
def counting(counter: CostCounter):
    """``counter`` active for the block (``count_cost`` enters its dispatch modes
    inside this)."""
    _ACTIVE.append(counter)
    try:
        yield counter
    finally:
        _ACTIVE.remove(counter)


_NOTHING_TO_PAUSE = contextlib.nullcontext()


def paused():
    """Nothing inside counts: the active counter's reports and the dispatch modes
    of ``count_cost`` (FLOPs, bytes, storage) are off for the block. Without an
    active counter, a shared empty context (one global read a call)."""
    c = active()
    return _NOTHING_TO_PAUSE if c is None else _paused(c)


@contextlib.contextmanager
def _paused(c: CostCounter):
    from torch.utils._python_dispatch import _disable_current_modes

    c.paused += 1
    try:
        with _disable_current_modes():
            yield
    finally:
        c.paused -= 1


def kernel(name: str, route: str, flops: float, nbytes: float, out: torch.Tensor) -> None:
    """One kernel-wrapper call: ``flops`` and ``nbytes`` (operands and output, each
    once), its output's storage tracked."""
    c = active()
    if c is None:
        return
    c.flops += flops
    c.bytes_accessed += nbytes
    c.kernels[f"{name}/{route}"] += 1
    c.track(out)


def collective(kind: str, wire: float, outs=()) -> None:
    """One collective of ``kind`` with ``wire`` bytes on this rank's wire; ``outs``,
    its new results, are tracked."""
    c = active()
    if c is None:
        return
    c.wire[kind] += wire
    c.calls[kind] += 1
    for t in outs:
        c.track(t)


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes ``t`` addresses: its elements, a broadcast (stride-0) dim counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def matmul_bytes(x: torch.Tensor, codes: torch.Tensor, m: int, n: int) -> int:
    """A packed matmul's bytes: x, the codes, one float32 scale factor and the
    kernel's float32 ``[M, N]`` output, each once."""
    return tensor_bytes(x) + codes.numel() + 4 + m * n * 4
