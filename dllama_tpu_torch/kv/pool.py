"""Host-side accounting for a fixed-size-page KV pool.

The port's own copy of dllama_tpu/kv/pool.py (it imports nothing of the
JAX package); the code is unchanged.

The pool tracks *page ids* into a device buffer owned by the engine
(``[n_layers, n_pages, n_kv_heads, page_size, head_dim]``); no device state
lives here.  Every page has a refcount:

- ``alloc()`` hands out pages at refcount 1 (the caller — in practice the
  radix tree — owns them),
- ``retain()``/``release()`` add/remove users (a lane adopting a shared
  prefix retains its pages for the life of the stream),
- a page whose refcount drops to 0 returns to the free list.

Page 0 is reserved as a scratch page: bucketed device copy programs pad
their page-id vectors with it, so it must never be handed to a caller.

``fork()`` is the copy-on-write bookkeeping step: when a stored prefix
diverges mid-page, the divergent stream gets a freshly allocated page (the
device copy happens in the engine) and the fork is counted for telemetry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

SCRATCH_PAGE = 0


@dataclass
class PoolStats:
    total: int          # usable pages (excludes the scratch page)
    free: int
    used: int
    shared: int         # pages with refcount >= 2 (tree + at least one lane)
    cow_forks: int


class PagePool:
    """Refcounted free-list allocator over ``n_pages`` fixed-size pages."""

    def __init__(
        self,
        n_pages: int,
        page_size: int,
        on_event: Optional[Callable[[str, dict], None]] = None,
    ) -> None:
        if n_pages < 2:
            raise ValueError(f"PagePool needs >= 2 pages (1 is scratch), got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        self._refs: Dict[int, int] = {}
        # LIFO free list keeps recently-freed (still-warm) pages hot.
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._cow_forks = 0
        self._on_event = on_event

    # -- events ------------------------------------------------------------
    def _emit(self, kind: str, **payload) -> None:
        if self._on_event is not None:
            self._on_event(kind, payload)

    # -- allocation --------------------------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages at refcount 1. Raises MemoryError when short."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise MemoryError(f"pool exhausted: want {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        if n:
            self._emit("kv_page_alloc", n=n, free=len(self._free))
        return pages

    def fork(self, src: int) -> int:
        """COW-fork accounting: allocate a private copy slot for ``src``."""
        if src == SCRATCH_PAGE:
            raise KeyError(f"fork of reserved scratch page {src}")
        if src not in self._refs:
            raise KeyError(f"fork of unallocated page {src}")
        page = self.alloc(1)[0]
        self._cow_forks += 1
        self._emit("kv_cow_fork", src=src, dst=page)
        return page

    def retain(self, pages: List[int]) -> None:
        for p in pages:
            if p not in self._refs:
                raise KeyError(f"retain of unallocated page {p}")
            self._refs[p] += 1

    def release(self, pages: List[int]) -> int:
        """Drop one ref per page; returns how many pages were freed."""
        freed = 0
        for p in pages:
            refs = self._refs.get(p)
            if refs is None:
                raise KeyError(f"release of unallocated page {p}")
            if refs == 1:
                del self._refs[p]
                self._free.append(p)
                freed += 1
            else:
                self._refs[p] = refs - 1
        if freed:
            self._emit("kv_page_free", n=freed, free=len(self._free))
        return freed

    # -- introspection -----------------------------------------------------
    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def stats(self) -> PoolStats:
        shared = sum(1 for r in self._refs.values() if r >= 2)
        return PoolStats(
            total=self.n_pages - 1,
            free=len(self._free),
            used=len(self._refs),
            shared=shared,
            cow_forks=self._cow_forks,
        )

    def check(self) -> None:
        """Invariant sweep — every page is exactly one of {scratch, free, allocated}."""
        seen = set(self._free)
        if len(seen) != len(self._free):
            raise AssertionError("free list contains duplicates")
        if SCRATCH_PAGE in seen or SCRATCH_PAGE in self._refs:
            raise AssertionError("scratch page leaked into free list / allocations")
        for p, r in self._refs.items():
            if p in seen:
                raise AssertionError(f"page {p} both free and allocated")
            if r < 1:
                raise AssertionError(f"page {p} has refcount {r}")
        n_accounted = 1 + len(self._free) + len(self._refs)
        if n_accounted != self.n_pages:
            raise AssertionError(
                f"page leak: scratch + {len(self._free)} free + "
                f"{len(self._refs)} allocated != {self.n_pages} total"
            )

    def reset(self) -> None:
        self._refs.clear()
        self._free = list(range(self.n_pages - 1, 0, -1))
