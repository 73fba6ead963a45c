"""Host-side page allocator for the paged KV cache.

The port's copy of the JAX package's ``repro/serve/paging.py``. The
physical cache is a pool of ``n_pages`` fixed-size pages per layer
(:func:`repro_torch.models.transformer.init_paged_cache`); this module owns
the *logical* side: a per-slot page table mapping each slot's logical
token positions to physical pages, page refcounts, and the
copy-on-write prefix index that lets admissions sharing a prompt prefix
reference the same physical pages instead of re-prefilling them.

Sharing contract (why copy-on-write never needs an actual copy):

  * Only FULL prompt pages are shareable: prefix page ``p`` of a prompt
    of length ``S`` is indexed only when ``(p + 1) * page_size <= S``,
    and at most ``(S - 1) // page_size`` pages are shared on admission,
    so every admission prefills at least one suffix token privately.
  * Decode writes for a slot admitted with prompt length ``S`` land at
    positions ``>= S``, i.e. in pages ``>= S // page_size`` — all
    private. Shared pages hold only immutable prefix positions, so a
    refcount > 1 page is never written and nothing ever needs copying.
  * Every released slot's table row is pointed at the slot's reserved
    *scratch page* (the last ``n_slots`` pages of the pool), so the
    engine's ride-along dispatches for free slots scatter into a page no
    live slot reads.

All state is host numpy; torch appears only where the ``[n_slots, Pmax]``
int32 table goes to the device (:meth:`PageTable.to_device`, a copy).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import host_to_device


class PageTable:
    """Refcounted page table with exact-match prefix sharing.

    ``admit`` / ``register`` / ``release`` bracket a slot's lifetime:

    1. ``admit(slot, prompt)`` walks the prefix index over the prompt's
       full pages, acquires every contiguously-matching shared page
       chain, allocates the remaining pages privately, and returns the
       number of prompt tokens already covered by shared pages (the
       engine prefills only the suffix).
    2. ``register(slot, prompt)`` (after the suffix prefill) indexes the
       slot's full prompt pages so later admissions can share them.
    3. ``release(slot)`` (finish or evict) derefs the row's pages,
       frees and de-indexes those whose refcount hits zero, and parks
       the row on the slot's scratch page.

    Prefix matching is exact (dict keyed by the prefix token bytes), so
    a "hash match" can never alias two different prefixes.
    """

    def __init__(self, n_slots: int, max_len: int, page_size: int, n_pages: int,
                 device=None):
        self.device = torch.device(device if device is not None else "cpu")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_slots = int(n_slots)
        self.page_size = int(page_size)
        self.pmax = -(-int(max_len) // self.page_size)
        self.n_pages = int(n_pages)
        min_pages = self.n_slots  # one scratch page per slot
        if self.n_pages < min_pages + self.pmax:
            raise ValueError(
                f"n_pages={n_pages} cannot hold even one slot: need "
                f">= n_slots + Pmax = {min_pages + self.pmax}"
            )
        # Scratch pages are the last n_slots page ids; they are never in
        # the free list and never refcounted.
        self.scratch = np.arange(
            self.n_pages - self.n_slots, self.n_pages, dtype=np.int32
        )
        self.table = np.tile(self.scratch[:, None], (1, self.pmax))
        self.refs = np.zeros((self.n_pages,), dtype=np.int32)
        # Reverse-sorted so pop() hands out the lowest id (deterministic).
        self._free = list(range(self.n_pages - self.n_slots - 1, -1, -1))
        self._index: dict[bytes, int] = {}  # prefix bytes -> page id
        self._key_of: dict[int, bytes] = {}  # page id -> prefix bytes
        # Stats (monotonic counters, exported via engine.stats()).
        self.admissions = 0
        self.prefix_hits = 0  # shared pages acquired across admissions
        self.pages_allocated = 0  # private pages handed out

    # -- queries ----------------------------------------------------------
    @property
    def pages_total(self) -> int:
        """Allocatable (non-scratch) pages in the pool."""
        return self.n_pages - self.n_slots

    @property
    def pages_used(self) -> int:
        return int(np.count_nonzero(self.refs))

    @property
    def pages_shared(self) -> int:
        return int(np.count_nonzero(self.refs > 1))

    def to_device(self, slot: int | None = None, *, rows: tuple[int, int] | None = None
                  ) -> torch.Tensor:
        """Device copy of the page table (the whole ``[n_slots, Pmax]``
        table, one slot's row as ``[1, Pmax]`` when ``slot`` is given, or the
        rows ``[start, stop)`` of ``rows``), int64 on :attr:`device`.

        ``admit``/``release`` change ``table`` in place while earlier
        dispatches may still be queued, so the device always receives a
        snapshot copy, never a view of the live buffer.
        """
        if slot is not None:
            rows = (slot, slot + 1)
        table = self.table if rows is None else self.table[rows[0]:rows[1]]
        return host_to_device(table.astype(np.int64), self.device)

    def digest(self, slots) -> np.ndarray:
        """``[free, used, prefix hits, pages]`` int64: the free list's length, the
        pages in use, the shared pages acquired so far and a fingerprint of the
        admitted ``slots``' page rows and the free list (equal on ranks that took
        the same decisions)."""
        from repro_torch.serve.scheduler import fingerprint

        slots = np.asarray(sorted(slots), np.int64)
        return np.asarray([len(self._free), self.pages_used, self.prefix_hits,
                           fingerprint(slots, self.table[slots],
                                       np.asarray(self._free, np.int64))], np.int64)

    def _prefix_key(self, prompt: np.ndarray, n_pages: int) -> bytes:
        return np.ascontiguousarray(
            prompt[: n_pages * self.page_size], dtype=np.int32
        ).tobytes()

    # -- lifecycle --------------------------------------------------------
    def admit(self, slot: int, prompt: np.ndarray) -> int:
        """Build slot ``slot``'s page row for ``prompt``; return the
        number of leading prompt tokens covered by shared pages."""
        s = int(prompt.size)
        self.admissions += 1
        max_share = (s - 1) // self.page_size  # always leave a suffix
        shared: list[int] = []
        for p in range(max_share):
            pid = self._index.get(self._prefix_key(prompt, p + 1))
            if pid is None:
                break
            shared.append(pid)
        n_private = self.pmax - len(shared)
        if n_private > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: slot {slot} needs {n_private} private "
                f"pages, {len(self._free)} free (pool {self.pages_total})"
            )
        for pid in shared:
            self.refs[pid] += 1
        self.prefix_hits += len(shared)
        private = [self._free.pop() for _ in range(n_private)]
        self.refs[private] += 1
        self.pages_allocated += n_private
        self.table[slot, : len(shared)] = shared
        self.table[slot, len(shared):] = private
        return len(shared) * self.page_size

    def register(self, slot: int, prompt: np.ndarray) -> None:
        """Index slot ``slot``'s full prompt pages for future sharing."""
        s = int(prompt.size)
        for p in range(s // self.page_size):
            key = self._prefix_key(prompt, p + 1)
            pid = int(self.table[slot, p])
            if key not in self._index and pid not in self._key_of:
                self._index[key] = pid
                self._key_of[pid] = key

    def release(self, slot: int) -> None:
        """Deref the row's pages; park the row on its scratch page."""
        row = self.table[slot]
        scratch = self.scratch[slot]
        for pid in np.unique(row[row != scratch]):
            pid = int(pid)
            self.refs[pid] -= 1
            if self.refs[pid] == 0:
                key = self._key_of.pop(pid, None)
                if key is not None:
                    self._index.pop(key, None)
                self._free.append(pid)
        self._free.sort(reverse=True)
        self.table[slot] = scratch
