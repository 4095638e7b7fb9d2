"""Host-side page allocator for the paged KV cache (a copy of
repro/serve/paging.py without the release-rate EWMA and
`estimated_wait_s`, which only the reference's slo-aware page-exhaustion
shed reads; that shed is not ported).

The device half lives in ``models.attention.PagedKVCache`` (the pool
tensors + the page table the device reads). This module owns every allocation
decision, and it rides the engine's existing one-host-sync-per-chunk
boundary: reserve/map/release all happen in plain Python at the chunk
sync, and the refreshed page table reaches the device as an ordinary
async host->device transfer. Nothing
here reads a device value, so paging adds **zero** host syncs.

Reservation discipline: a request is admitted only if its *worst-case*
page count can be reserved up front — the prompt plus the clamped decode
budget plus one decode chunk of slack (a lane that dies mid-chunk keeps
appending inertly until the sync, so its final chunk can run up to one
chunk past its budget; those writes must land in pages the lane owns,
never drop into another lane's). Because every admitted lane's worst case
is reserved before its prefill, the per-chunk incremental mapping
(``map_to`` covering ``[0, pos + chunk)``) can never fail mid-flight:
page exhaustion is an admission-time event, not a decode-time one.
"""

from __future__ import annotations

import numpy as np


class PageLeak(RuntimeError):
    """A page-pool invariant was violated (double-free, overlap, or pages
    still owned/reserved at a point the caller asserts is drained)."""


class PagePool:
    """Fixed pool of `n_pages` KV pages shared by `slots` serving lanes.

    Page ids are ints in [0, n_pages); the sentinel id ``n_pages`` marks
    an unmapped page-table entry (see PagedKVCache: writes routed through
    it land in the pool's scratch page, which nothing reads).
    """

    def __init__(self, n_pages: int, page_size: int, slots: int,
                 max_len: int, chunk_slack: int = 0):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be >= 1")
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"page_size {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.chunk_slack = int(chunk_slack)
        self.pages_per_lane = max_len // page_size      # P_max
        self._free: list[int] = list(range(self.n_pages - 1, -1, -1))
        self._owned: list[list[int]] = [[] for _ in range(self.slots)]
        self._reserved: list[int] = [0] * self.slots
        self._dirty = True          # device table needs a (re)push
        self.allocated_total = 0
        self.freed_total = 0

    # -- introspection -----------------------------------------------------
    @property
    def sentinel(self) -> int:
        return self.n_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def reserved_pages(self) -> int:
        return sum(self._reserved)

    @property
    def occupancy(self) -> float:
        return self.pages_in_use / self.n_pages

    @property
    def dirty(self) -> bool:
        return self._dirty

    def owned(self, slot: int) -> tuple[int, ...]:
        return tuple(self._owned[slot])

    # -- admission ---------------------------------------------------------
    def worst_pages(self, prompt_len: int, budget: int) -> int:
        """Worst-case pages one request can touch: prompt + decode budget
        + one chunk of inert post-death writes, clamped to max_len."""
        tokens = min(self.max_len,
                     int(prompt_len) + int(budget) + self.chunk_slack)
        return -(-max(1, tokens) // self.page_size)

    def can_reserve(self, pages: int) -> bool:
        return self.reserved_pages + pages <= self.n_pages

    def reserve(self, slot: int, pages: int) -> None:
        if self._reserved[slot] or self._owned[slot]:
            raise PageLeak(f"slot {slot} re-reserved while holding "
                           f"{len(self._owned[slot])} pages "
                           f"(reserved={self._reserved[slot]})")
        if not self.can_reserve(pages):
            raise PageLeak(f"reservation overflow: {self.reserved_pages} "
                           f"reserved + {pages} > {self.n_pages}")
        self._reserved[slot] = int(pages)

    # -- mapping -----------------------------------------------------------
    def map_to(self, slot: int, n_tokens: int) -> bool:
        """Map enough pages for `slot` to cover [0, n_tokens). Returns
        True if the device table became stale. Never exceeds the slot's
        reservation — writes past it resolve to the sentinel and drop
        (only inert dead-lane writes can ever reach there)."""
        need = min(-(-int(n_tokens) // self.page_size), self._reserved[slot])
        grew = False
        own = self._owned[slot]
        while len(own) < need:
            if not self._free:      # unreachable under the reserve proof
                raise PageLeak(f"page pool exhausted mapping slot {slot}: "
                               f"reservation discipline violated")
            own.append(self._free.pop())
            self.allocated_total += 1
            grew = True
        if grew:
            self._dirty = True
        return grew

    def release(self, slot: int) -> None:
        """Return all of `slot`'s pages to the free list and drop its
        reservation. Safe to call on an empty slot (no-op)."""
        own = self._owned[slot]
        if own:
            self._free.extend(reversed(own))
            self.freed_total += len(own)
            own.clear()
            self._dirty = True
        self._reserved[slot] = 0

    # -- device table ------------------------------------------------------
    def table(self) -> np.ndarray:
        """Slot-indexed page table [slots, P_max] int32, sentinel-padded.
        Marks the pool clean: the caller is pushing this to the device."""
        t = np.full((self.slots, self.pages_per_lane), self.sentinel,
                    np.int32)
        for s, own in enumerate(self._owned):
            if own:
                t[s, :len(own)] = own
        self._dirty = False
        return t

    # -- invariants --------------------------------------------------------
    def check(self) -> None:
        """Raise PageLeak unless {free} + {owned} exactly partition the
        pool and no reservation is overdrawn."""
        seen: set[int] = set(self._free)
        if len(seen) != len(self._free):
            raise PageLeak("duplicate page id on the free list")
        for s, own in enumerate(self._owned):
            if len(own) > self._reserved[s]:
                raise PageLeak(f"slot {s} owns {len(own)} pages over its "
                               f"reservation {self._reserved[s]}")
            for p in own:
                if p in seen:
                    raise PageLeak(f"page {p} owned by slot {s} is also "
                                   f"free or owned elsewhere")
                seen.add(p)
        if seen != set(range(self.n_pages)):
            raise PageLeak(f"page partition broken: {len(seen)} of "
                           f"{self.n_pages} pages accounted for")

    def assert_drained(self) -> None:
        self.check()
        if self.pages_in_use or self.reserved_pages:
            raise PageLeak(f"pool not drained: {self.pages_in_use} pages "
                           f"in use, {self.reserved_pages} reserved")
        if self.allocated_total != self.freed_total:
            raise PageLeak(f"alloc/free imbalance: {self.allocated_total} "
                           f"allocated vs {self.freed_total} freed")
