"""Block/paged KV-cache manager over the sequence-sharded cache layout.

The port's own copy of the JAX package's ``serve/kv_cache.py``, which
does no framework work.  The physical decode cache is one dense tensor
per layer stack (``[layers, slots, max_len, kv, hd]``); the page table
does not address it.  What pages buy is everything *around* the tensor:

  * **admission control** — a request is admitted only if its worst-case
    page need (padded prompt + ``max_new_tokens``) fits the slot's frame
    budget, instead of silently truncating at ``max_len``;
  * **occupancy accounting** — the old engine zero-filled ``max_len``
    rows per slot and reported nothing; the page table knows exactly how
    many 16-token pages are live, the high-water mark, and the internal
    fragmentation of the current residency (live tokens / paged tokens);
  * **alloc/free invariants** — every allocated frame is owned by
    exactly one slot, frees return the slot's frames in full, and the
    pool-wide free list stays in **address order**, which ``check()``
    verifies and the churn tests exercise.

Pages are ``page_size`` tokens (default 16 — the sequence-sharding
divisibility unit, so a page never straddles a model-axis shard
boundary for tp <= 16).  Frames are drawn from a pool-wide free list
(``slots * max_len // page_size`` frames): prefill reserves the frames
covering the padded prompt and decode allocates one more frame each
time the write position crosses a page boundary.

Freed frames re-enter the free list **in address order**
(``bisect.insort``), not append order.  Under long bursty replays the
append-order free list of the original implementation became a shuffle
of the address space, so the reported external fragmentation (share of
free frames not in the longest contiguous run) drifted upward across
bursts even when occupancy returned to zero; ordered reinsertion makes
the metric a true residency property — an empty table always reports
``external_fragmentation() == 0`` (pinned by the churn test in
``tests/test_serve_runtime.py``).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import List


@dataclass
class PageAllocation:
    """One slot's live page-table row."""
    slot: int
    pages: int = 0          # frames currently allocated to the slot
    live_tokens: int = 0    # cache rows actually written (pos + 1)
    frames: List[int] = field(default_factory=list)   # pool frame ids


class CacheOverflow(RuntimeError):
    """A (prompt, max_new_tokens) request cannot fit a slot's frames."""


class PagedKVCache:
    """Page table for a ``slots x max_len`` sequence-sharded cache."""

    def __init__(self, slots: int, max_len: int, page_size: int = 16):
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"page_size {page_size}")
        self.slots = slots
        self.max_len = max_len
        self.page_size = page_size
        self.frames_per_slot = max_len // page_size
        self.total_pages = slots * self.frames_per_slot
        self._table: dict[int, PageAllocation] = {}
        # pool-wide free list of frame addresses, ALWAYS ascending —
        # alloc pops from the head (lowest address first), free
        # re-inserts in address order
        self._free: List[int] = list(range(self.total_pages))
        # counters for the stats/ledger report
        self.page_allocs = 0
        self.page_frees = 0
        self.requests_admitted = 0
        self.requests_freed = 0
        self.high_water_pages = 0

    # --- sizing ----------------------------------------------------------

    def pages_for(self, n_tokens: int) -> int:
        """Frames needed to hold ``n_tokens`` cache rows."""
        return max(0, -(-int(n_tokens) // self.page_size))

    def can_admit(self, prompt_len: int, max_new_tokens: int,
                  padded_len: int = 0) -> bool:
        """Worst-case fit: padded prompt + every new token + the final
        write position (decode writes at ``pos`` before the finish
        check, so the last generated token still needs a row)."""
        need = max(padded_len, prompt_len) + max(max_new_tokens, 1)
        return need <= self.max_len and \
            self.pages_for(need) <= self.frames_per_slot

    # --- frame pool ------------------------------------------------------

    def _take_frames(self, n: int) -> List[int]:
        taken, self._free = self._free[:n], self._free[n:]
        return taken

    def _return_frames(self, frames: List[int]):
        """Freed frames re-enter the free list in ADDRESS order — the
        append-order alternative shuffles the list under bursty churn
        and makes external fragmentation drift upward permanently."""
        for f in frames:
            bisect.insort(self._free, f)

    # --- alloc / advance / free ------------------------------------------

    def alloc(self, slot: int, n_tokens: int) -> PageAllocation:
        """Admit a request into ``slot``, reserving pages for its first
        ``n_tokens`` cache rows (the padded prefill length)."""
        if slot in self._table:
            raise RuntimeError(f"slot {slot} already allocated "
                               f"({self._table[slot]})")
        pages = self.pages_for(n_tokens)
        if pages > self.frames_per_slot:
            raise CacheOverflow(
                f"{n_tokens} tokens need {pages} pages > "
                f"{self.frames_per_slot} frames/slot "
                f"(max_len={self.max_len}, page={self.page_size})")
        rec = PageAllocation(slot=slot, pages=pages, live_tokens=n_tokens,
                             frames=self._take_frames(pages))
        self._table[slot] = rec
        self.page_allocs += pages
        self.requests_admitted += 1
        self.high_water_pages = max(self.high_water_pages,
                                    self.allocated_pages)
        return rec

    def advance(self, slot: int, pos: int) -> int:
        """Decode wrote a cache row at ``pos``; allocate any new page
        that write crossed into.  Returns pages newly allocated."""
        rec = self._table[slot]
        rec.live_tokens = max(rec.live_tokens, pos + 1)
        need = self.pages_for(rec.live_tokens)
        grew = 0
        if need > rec.pages:
            if need > self.frames_per_slot:
                raise CacheOverflow(
                    f"slot {slot}: position {pos} is past the last frame "
                    f"({self.frames_per_slot} x {self.page_size})")
            grew = need - rec.pages
            rec.frames += self._take_frames(grew)
            rec.pages = need
            self.page_allocs += grew
            self.high_water_pages = max(self.high_water_pages,
                                        self.allocated_pages)
        return grew

    def free(self, slot: int) -> int:
        """Request finished: return every page the slot held."""
        rec = self._table.pop(slot)
        self._return_frames(rec.frames)
        self.page_frees += rec.pages
        self.requests_freed += 1
        return rec.pages

    # --- stats / invariants ----------------------------------------------

    @property
    def allocated_pages(self) -> int:
        return sum(r.pages for r in self._table.values())

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_tokens(self) -> int:
        return sum(r.live_tokens for r in self._table.values())

    def occupancy(self) -> float:
        """Fraction of the page pool currently allocated."""
        return self.allocated_pages / self.total_pages

    def fragmentation(self) -> float:
        """1 - live/paged tokens: the share of allocated cache rows not
        holding a live token (page-rounding waste; the zero-filled
        monolith this replaces sat at 1 - live/(slots*max_len))."""
        paged = self.allocated_pages * self.page_size
        return 1.0 - (self.live_tokens / paged) if paged else 0.0

    def external_fragmentation(self) -> float:
        """Share of FREE frames outside the longest contiguous free run
        (1 - longest_run / free).  Because frees re-enter the list in
        address order this is a pure residency property: it returns to
        exactly 0.0 whenever occupancy does, no matter how bursty the
        preceding churn was."""
        if not self._free:
            return 0.0
        best = run = 1
        for prev, cur in zip(self._free, self._free[1:]):
            run = run + 1 if cur == prev + 1 else 1
            best = max(best, run)
        return 1.0 - best / len(self._free)

    def stats(self) -> dict:
        return {
            "page_size": self.page_size,
            "total_pages": self.total_pages,
            "allocated_pages": self.allocated_pages,
            "free_pages": self.free_pages,
            "occupancy": self.occupancy(),
            "high_water_pages": self.high_water_pages,
            "live_tokens": self.live_tokens,
            "fragmentation": self.fragmentation(),
            "external_fragmentation": self.external_fragmentation(),
            "page_allocs": self.page_allocs,
            "page_frees": self.page_frees,
            "requests_admitted": self.requests_admitted,
            "requests_freed": self.requests_freed,
        }

    def check(self):
        """Raise if any page-table invariant is violated."""
        seen: set[int] = set()
        for slot, rec in self._table.items():
            assert 0 <= slot < self.slots, f"slot {slot} out of range"
            assert 0 < rec.pages <= self.frames_per_slot, rec
            assert len(rec.frames) == rec.pages, rec
            assert rec.live_tokens <= rec.pages * self.page_size, rec
            assert self.pages_for(rec.live_tokens) == rec.pages, \
                f"slot {slot}: {rec.pages} pages but " \
                f"{rec.live_tokens} live tokens"
            dup = seen & set(rec.frames)
            assert not dup, f"frames {dup} owned by two slots"
            seen |= set(rec.frames)
        assert all(b > a for a, b in zip(self._free, self._free[1:])), \
            "free list out of address order"
        assert not (seen & set(self._free)), "allocated frame in free list"
        assert len(seen) + len(self._free) == self.total_pages, \
            (len(seen), len(self._free), self.total_pages)
        assert self.allocated_pages <= self.total_pages
        assert self.page_allocs - self.page_frees == self.allocated_pages, \
            (self.page_allocs, self.page_frees, self.allocated_pages)
        assert self.requests_admitted - self.requests_freed \
            == len(self._table)

    def __repr__(self):
        return (f"PagedKVCache(slots={self.slots}, "
                f"pages={self.allocated_pages}/{self.total_pages}, "
                f"page={self.page_size})")
