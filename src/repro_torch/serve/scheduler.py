"""Slot scheduler for the continuous-batching engine.

The port's copy of the JAX package's ``repro/serve/scheduler.py``: pure
host-side bookkeeping (numpy only). The engine owns the device state
(params, cache, steps) and asks the scheduler two questions per step —
"which queued requests go into which free slots now?" and "which slots
are live?".

Invariants the engine relies on:
  * a slot is in exactly one of {free, live} at any time;
  * ``finish(slot)`` makes the slot reusable IMMEDIATELY — the next
    ``ready()`` may hand it out again in the same engine step (cache
    hygiene is the engine's mask-past-pos contract, not the
    scheduler's);
  * admission order is deterministic: FIFO over requests, lowest free
    slot first, so two runs of the same trace produce the same
    (slot, request) assignments.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import deque
from typing import Any, Iterator

import numpy as np


def fingerprint(*arrays) -> int:
    """A deterministic 62-bit digest of integer arrays (their int64 values and
    shapes, in order): equal on every process for equal inputs."""
    h = hashlib.blake2b(digest_size=8)
    for a in arrays:
        a = np.ascontiguousarray(a, dtype=np.int64)
        h.update(np.asarray(a.shape, np.int64).tobytes())
        h.update(a.tobytes())
    return int.from_bytes(h.digest(), "little") >> 2


@dataclasses.dataclass
class Request:
    """One generation request and its accumulated output.

    ``out`` entries are ints (sampled path) or lazy ``(array, flat_idx)``
    pairs — a device token array from one greedy decode/prefill/verify
    step plus this request's flat index into it (row for a ``[B]``
    vector; ``row * width + col`` for a ``[B, width]`` verify matrix).
    Laziness is what keeps the greedy decode loop device-resident (no
    per-step host sync); entries are resolved to ints on the first
    :meth:`tokens` call.

    Under speculative serving (DESIGN.md §10) a request advances a
    VARIABLE number of tokens per engine step; ``drafted`` counts the
    draft-tier tokens submitted for verification on its behalf and
    ``accepted`` the ones the verify tier confirmed matched its own
    greedy stream, so per-request acceptance is observable
    (``accepted / drafted`` — a model-agreement metric, deliberately
    not clamped by the request's remaining token budget).
    """

    rid: int
    prompt: np.ndarray  # [S] int32 prompt tokens
    max_new_tokens: int
    key: Any = None  # a torch.Generator: sampled decoding (None = greedy)
    out: list = dataclasses.field(default_factory=list)
    slot: int | None = None
    done: bool = False
    truncated: bool = False
    drafted: int = 0
    accepted: int = 0
    # span timestamps (time.perf_counter, dispatch-clocked at the
    # engine's existing sync points; DESIGN.md §11): set by the engine
    # at submit / admission / first emitted token / finish.
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_finish: float = 0.0

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.out)

    def advance(self, arr: Any, row: int, width: int, n: int) -> int:
        """Append up to ``n`` lazily-resolved tokens from row ``row`` of
        the ``[B, width]`` token matrix ``arr``.

        Returns how many were actually taken: the advance is clamped to
        ``remaining``, so a drafted run crossing ``max_new_tokens``
        truncates instead of overshooting the request's budget.
        """
        take = min(int(n), self.remaining)
        base = row * width
        for i in range(take):
            self.out.append((arr, base + i))
        return take

    def tokens(self) -> np.ndarray:
        host: dict[int, np.ndarray] = {}  # one host copy per device array
        resolved = []
        for e in self.out:
            if isinstance(e, tuple):
                arr, i = e
                a = host.get(id(arr))
                if a is None:
                    a = host[id(arr)] = _host(arr)
                resolved.append(int(a[i]))
            else:
                resolved.append(int(e))
        self.out = resolved
        return np.asarray(resolved, np.int32)


def _host(arr) -> np.ndarray:
    """A flat numpy copy of a device tensor (anything with ``.cpu()``) or an array."""
    if hasattr(arr, "cpu"):
        arr = arr.cpu().numpy()
    return np.asarray(arr).reshape(-1)


class SlotScheduler:
    """FIFO admission over a fixed pool of cache slots."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.n_slots = n_slots
        self._free: list[int] = sorted(range(n_slots), reverse=True)  # pop() -> lowest
        self._queue: deque[Request] = deque()
        self.live: dict[int, Request] = {}

    @property
    def busy(self) -> bool:
        """Anything queued or in flight?"""
        return bool(self._queue) or bool(self.live)

    @property
    def queued(self) -> int:
        return len(self._queue)

    def submit(self, req: Request) -> None:
        self._queue.append(req)

    def ready(self) -> Iterator[tuple[int, Request]]:
        """Admit queued requests into free slots (lowest slot first)."""
        while self._queue and self._free:
            slot = self._free.pop()
            req = self._queue.popleft()
            req.slot = slot
            self.live[slot] = req
            yield slot, req

    def finish(self, slot: int) -> Request:
        """Retire the slot's request; the slot is immediately reusable."""
        req = self.live.pop(slot)
        req.done = True
        req.slot = None
        self._free.append(slot)
        self._free.sort(reverse=True)
        return req

    def digest(self) -> np.ndarray:
        """``[queued, free, queue, admitted]`` int64: the queue's and the free list's
        lengths, a :func:`fingerprint` of the queued requests (ids, budgets and
        prompts, in order) and one of the admitted (slot, request id, tokens
        emitted) triples. Ranks that took the same decisions hold equal digests."""
        queue = [np.asarray([r.rid, r.max_new_tokens, r.prompt.size], np.int64)
                 for r in self._queue]
        queue += [r.prompt for r in self._queue]
        live = np.asarray([(s, r.rid, len(r.out)) for s, r in sorted(self.live.items())],
                          np.int64).reshape(-1, 3)
        return np.asarray([len(self._queue), len(self._free), fingerprint(*queue),
                           fingerprint(live, np.asarray(self._free, np.int64))], np.int64)

    def cancel(self, req: Request) -> None:
        """Drop a still-queued (never admitted) request."""
        self._queue.remove(req)
        req.done = True
