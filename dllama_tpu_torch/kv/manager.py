"""PagedKVManager: glue between the page pool / radix tree and the engine.

The port's copy of dllama_tpu/kv/manager.py, in its two modes
(``native``). In slab mode (the default, as in the JAX package) each lane's
KV lives in the engine's lanes' slab and the pool stores shared prefixes by
copies; in native mode the pool is the lanes' only KV home:

- ``match``   — at admission, find the longest stored token prefix of the
  request's (fully retokenized) conversation and the pages covering it,
  retaining them for the lane on the spot (the scheduler adopts a tick
  later; unpinned pages could be evicted and reallocated in that gap);
- ``adopt``   — slab: copy the matched pages into the lane's slab rows
  (`InferenceEngine.kv_adopt`). Native: build the lane's page list, the
  shared prefix pages as they are, a copy-on-write fork of a mid-page
  boundary (the only device copy), fresh private pages for everything the
  lane will write; then point the engine's page table at it. A full-page
  prefix moves zero device bytes;
- ``publish`` — at finish, store the whole pages of the lane's fed tokens,
  deduplicated against the tree so a prefix two streams share is stored
  once. Slab: fresh pages (a copy-on-write fork where the stored prefix
  diverged mid-page), the matched prefix pinned across the eviction that
  makes room, then the lane's rows copied in (`InferenceEngine.kv_publish`);
  a publish that poisoned the pool (its epoch moved) resets the
  accounting, a transient failure releases only that publish's pages.
  Native: an ownership transfer, the lane already wrote them;
- ``release_lane`` / ``release_all_lanes`` — refcount hygiene and the
  error path (a slab lane has no page-table row to clear); ``reset`` —
  the recovery path's big hammer: every page and stored prefix dropped
  (after a failed dispatch the pool's bytes are not trusted);
- ``anchor_for`` — the radix anchor of a lane's last match, the key the
  shared n-gram drafter groups sibling streams by (runtime/spec.py).

The chaos plane's draws are the JAX manager's (runtime/faults.py):
``kv_alloc`` (``op=adopt``) before an adopt allocates, raised to the
scheduler, which retries it (native mode); ``dispatch`` (``op=kv_publish``)
on entry to a native publish (the engine draws it in ``kv_publish`` for a
slab one) and ``kv_alloc`` (``op=publish``) where a slab publish allocates
its pages (a native publish allocates none and draws no ``kv_alloc``), each
absorbed: the stream already finished, only future reuse is lost.

Observability is the JAX manager's (obs/): the ``dllama_kv_pages_*``
gauges, the ``dllama_radix_*``, ``dllama_kv_cow_forks_total`` and
``dllama_shared_prefix_tokens_total`` counters (radix evictions also feed
the server's ``dllama_cache_evictions_total``, handed in as
``evict_counter``), the pool's and the manager's flight-recorder events
(``kv_cow_fork``, ``kv_evict``, ``kv_publish_skipped``, ``kv_pool_reset``)
and ``component="kv"`` spans over ``match``, ``adopt`` and ``publish``.
The manager's own counts stay plain attributes too (``hits``,
``shared_tokens``, ``evictions``, ``publish_skips`` and the pool's
``cow_forks``): ``debug()`` and ``/v1/health`` read them, one server at a
time, where the registry counts for the whole process. All engine calls
come from the scheduler thread; ``lock`` protects the host accounting
against concurrent readers (``debug``, ``/metrics``).
"""

from __future__ import annotations

import logging
import threading
from typing import Any

from ..obs.metrics import get_registry
from ..obs.recorder import get_recorder
from ..obs.spans import get_span_tracker
from ..runtime.faults import InjectedFault, get_fault_plane
from .pool import PagePool
from .radix import RadixTree

logger = logging.getLogger(__name__)

DEFAULT_PAGE_SIZE = 16


class PagedKVManager:
    def __init__(self, engine: Any, page_size: int = 0, n_pages: int = 0,
                 evict_counter: Any = None, native: bool = False) -> None:
        self.engine = engine
        self.page_size = page_size or DEFAULT_PAGE_SIZE
        self.native = bool(native)
        n = engine.init_kv_pool(self.page_size, n_pages, native=self.native)
        self.recorder = get_recorder()
        # component="kv" spans over the host-side accounting (the engine's
        # COW page copy records its own span)
        self.spans = get_span_tracker()
        self.pool = PagePool(n, self.page_size, on_event=self._pool_event)
        self.tree = RadixTree(self.page_size)
        self.lock = threading.Lock()
        self._lane_pages: dict[int, list[int]] = {}
        self._lane_match_tokens: dict[int, int] = {}
        # radix anchor of each lane's last match (runtime/spec.py's shared
        # n-gram store): (node_id, matched token count), absent when the
        # match found nothing
        self._lane_anchor: dict[int, tuple[int, int]] = {}
        self.hits = 0  # admissions that adopted a stored prefix
        self.shared_tokens = 0  # prompt tokens served from shared pages
        self.evictions = 0  # pages LRU-evicted from radix leaves
        self.publish_skips = 0  # publishes an injected fault dropped
        # dashboards keep their dllama_cache_evictions_total series: the
        # ApiState hands us its handle and radix evictions feed it
        self._evict_counter = evict_counter
        obs = get_registry()
        self.g_total = obs.gauge(
            "dllama_kv_pages_total",
            "Usable pages in the shared KV pool (excludes the scratch page).",
        )
        self.g_free = obs.gauge(
            "dllama_kv_pages_free", "KV pool pages on the free list."
        )
        self.g_shared = obs.gauge(
            "dllama_kv_pages_shared",
            "KV pool pages referenced by the radix tree AND at least one "
            "live lane (refcount >= 2) — the physically-shared prefix "
            "storage.",
        )
        self.c_hits = obs.counter(
            "dllama_radix_hits_total",
            "Admissions whose conversation matched a stored radix prefix "
            "and adopted shared pages.",
        )
        self.c_evictions = obs.counter(
            "dllama_radix_evictions_total",
            "Pages LRU-evicted from radix-tree leaves to make room for a "
            "lane's pages (native) or a publish (slab).",
        )
        self.c_shared_tokens = obs.counter(
            "dllama_shared_prefix_tokens_total",
            "Prompt tokens served from shared pool pages instead of being "
            "re-prefilled (sum of adopted prefix lengths).",
        )
        self.c_cow = obs.counter(
            "dllama_kv_cow_forks_total",
            "Copy-on-write page forks: an adoption (native) or a publish "
            "(slab) diverged mid-page from a stored prefix and took a "
            "private copy of that page slot.",
        )
        self.g_total.set(n - 1)
        self._update_gauges_locked()

    # -- internals ---------------------------------------------------------
    def _pool_event(self, kind: str, payload: dict) -> None:
        self.recorder.record(kind, **payload)
        if kind == "kv_cow_fork":
            self.c_cow.inc()

    def _update_gauges_locked(self) -> None:
        st = self.pool.stats()
        self.g_free.set(st.free)
        self.g_shared.set(st.shared)

    # -- admission ---------------------------------------------------------
    def match(self, lane: int, tokens: list[int]) -> tuple[int, list[int]]:
        """Longest reusable stored prefix of ``tokens``: returns
        ``(n_reused_tokens, pages)``. Reuse is capped one short of the
        prompt (the engine must be fed at least one token) and to the
        rows the collected pages cover; a partial final page is fine (its
        stale tail rows are overwritten by suffix prefill before any query
        can attend to them). The pages are retained for ``lane`` here,
        inside the lock (see the module docstring); every admission-failure
        path releases them through `release_lane`."""
        ps = self.page_size
        with self.spans.span(
            "kv_match", component="kv", lane=lane, n_tokens=len(tokens)
        ), self.lock:
            # a lane admitted twice without release would leak a retain
            stale = self._lane_pages.pop(lane, None)
            if stale:
                self.pool.release(stale)
            mr = self.tree.match(tokens)
            # the anchor follows the raw token match, not the page cap:
            # grouping siblings needs prefix identity, not adoptable KV
            if mr.anchor is not None:
                self._lane_anchor[lane] = (mr.anchor, mr.n_tokens)
            else:
                self._lane_anchor.pop(lane, None)
            m = min(mr.n_tokens, len(mr.pages) * ps, len(tokens) - 1)
            if m <= 0:
                self._lane_match_tokens[lane] = 0
                self._update_gauges_locked()
                return 0, []
            pages = mr.pages[: -(-m // ps)]
            self.pool.retain(pages)
            self._lane_pages[lane] = list(pages)
            self._lane_match_tokens[lane] = m
            self._update_gauges_locked()
            return m, pages

    def adopt(self, lane: int, pages: list[int]) -> None:
        """Slab mode: copy ``pages`` (already retained by `match`) into
        ``lane``'s slab rows (nothing for an empty match). Native mode:
        build the lane's full page list from them and install it in the
        engine's page table: a mid-page boundary page is forked (one device
        page copy), the rest of the lane's rows get fresh private pages."""
        if not self.native:
            if pages:
                self.engine.kv_adopt(lane, pages)
            return
        self._adopt_native(lane, pages)

    def _adopt_native(self, lane: int, pages: list[int]) -> None:
        ps = self.page_size
        n_blocks = self.engine._kv_n_blocks
        with self.spans.span(
            "kv_adopt_native", component="kv", lane=lane, n_pages=len(pages)
        ), self.lock:
            fault = get_fault_plane().draw("kv_alloc", op="adopt")
            if fault is not None:
                raise fault
            m = self._lane_match_tokens.get(lane, 0)
            lane_list = list(pages)
            if m % ps and lane_list:
                # the lane will write rows >= m into this slot: it needs a
                # private copy of the shared page
                orig = lane_list[-1]
                fork = self._alloc_lane_pages(1, lane, fork_src=orig)[0]
                try:
                    self.engine.kv_page_copy([orig], [fork])
                except BaseException:
                    self.pool.release([fork])
                    raise
                # swap the lane's retain from the shared original to its fork
                # (the tree keeps its own ref on the original)
                self.pool.release([orig])
                lane_list[-1] = fork
            need = n_blocks - len(lane_list)
            if need > 0:
                lane_list += self._alloc_lane_pages(need, lane)
            self._lane_pages[lane] = lane_list
            self.engine.adopt_pages(lane, lane_list)
            self._update_gauges_locked()

    def _alloc_lane_pages(self, n: int, lane: int, fork_src: int | None = None) -> list[int]:
        """``n`` private pages for a native lane (or the fork of
        ``fork_src``), LRU-evicting refcount-1 tree leaves under pressure;
        raises MemoryError when the pool cannot hold them (admission cannot
        go on without somewhere to write). Called under ``lock``."""
        self._evict_for_locked(n, lane)
        if fork_src is not None:
            return [self.pool.fork(fork_src)]
        return self.pool.alloc(n)

    def _evict_for_locked(self, n: int, lane: int) -> None:
        """LRU-evict refcount-1 tree leaves until ``n`` pages are free (or
        none is left to evict). Called under ``lock``."""
        short = n - self.pool.free_pages
        if short > 0:
            freed = self.tree.evict(short, self.pool)
            self.evictions += freed
            self.c_evictions.inc(freed)
            if self._evict_counter is not None:
                self._evict_counter.inc(freed)
            if freed:
                self.recorder.record("kv_evict", n_pages=freed, lane=lane)

    def anchor_for(self, lane: int) -> tuple[int, int] | None:
        """(radix node_id, matched token count) of ``lane``'s last `match`,
        or None when nothing matched: the grouping key the scheduler hands
        the shared n-gram drafter."""
        with self.lock:
            return self._lane_anchor.get(lane)

    def release_lane(self, lane: int) -> None:
        with self.lock:
            pages = self._lane_pages.pop(lane, None)
            self._lane_match_tokens.pop(lane, None)
            self._lane_anchor.pop(lane, None)
            if pages:
                self.pool.release(pages)
            if self.native:
                self.engine.clear_lane_pages(lane)
            self._update_gauges_locked()

    # -- finish ------------------------------------------------------------
    def publish(self, lane: int, tokens: list[int]) -> int:
        """Store ``lane``'s fed ``tokens`` (KV rows [0, len(tokens)) live in
        its slab rows or its pages) as whole pages, for the slots the tree
        does not hold yet: copied into fresh pages (slab), or the lane's
        own pages with a reference for the tree (native); then the token
        path goes into the tree. Returns the number of pages newly stored
        (0: full dedup, no whole page to store, a full pool, or a failure:
        the publish narrows itself, releasing its new pages or references,
        and nothing fails)."""
        with self.spans.span(
            "kv_publish_host", component="kv", lane=lane,
            n_tokens=len(tokens),
        ):
            return self._publish(lane, tokens)

    def _publish(self, lane: int, tokens: list[int]) -> int:
        if not self.native:
            return self._publish_slab(lane, tokens)
        ps = self.page_size
        n_full = len(tokens) // ps
        if n_full == 0:
            return 0
        full = list(tokens[: n_full * ps])
        fault = get_fault_plane().draw("dispatch", op="kv_publish")
        if fault is not None:
            with self.lock:
                self.publish_skips += 1
            self.recorder.record(
                "kv_publish_skipped", lane=lane, want=n_full, error=str(fault)
            )
            return 0
        with self.lock:
            lane_list = self._lane_pages.get(lane) or []
            if len(lane_list) < n_full:
                return 0
            mr = self.tree.match(full)
            k_shared = min(mr.n_tokens // ps, n_full)
            n_new = n_full - k_shared
            if n_new == 0:
                return 0
            pages = lane_list[k_shared:n_full]
            # the tree owns its reference BEFORE insert: the lane's retain
            # dies with release_lane, and a tree pointing at freed pages
            # would hand later admissions recycled KV
            self.pool.retain(pages)
            try:
                self.tree.insert(full, pages, first_slot=k_shared)
            except ValueError:
                # insert validates that dedup'd slots still exist on the
                # stored path; a rejection drops the store (only future
                # reuse is lost)
                logger.exception("kv radix insert rejected; publish dropped")
                self.pool.release(pages)
                self._update_gauges_locked()
                return 0
            self._update_gauges_locked()
        return n_new

    def _publish_slab(self, lane: int, tokens: list[int]) -> int:
        """The JAX manager's slab publish: pin the matched prefix across the
        eviction that makes room (under pressure its own leaf may be the
        refcount-1 victim), allocate the new slots (a fork where the stored
        prefix diverged mid-page), copy the lane's rows in, insert."""
        ps = self.page_size
        n_full = len(tokens) // ps
        if n_full == 0:
            return 0
        full = list(tokens[: n_full * ps])
        with self.lock:
            mr = self.tree.match(full)
            k_shared = min(mr.n_tokens // ps, n_full)
            n_new = n_full - k_shared
            if n_new == 0:
                return 0
            self.pool.retain(mr.pages)
            try:
                self._evict_for_locked(n_new, lane)
                if n_new > self.pool.free_pages:
                    # the pool is full of retained and live pages: skip (the
                    # stream already served; only future reuse is lost)
                    self.publish_skips += 1
                    self.recorder.record("kv_publish_skipped", lane=lane, want=n_new,
                                         free=self.pool.free_pages)
                    return 0
                diverged = mr.n_tokens > k_shared * ps and len(mr.pages) > k_shared
                pages = self._alloc_publish_pages_locked(mr.pages[k_shared] if diverged else None,
                                                  n_new, lane)
            finally:
                self.pool.release(mr.pages)
            if pages is None:
                return 0
        pool_epoch0 = self.engine.kv_pool_epoch
        try:
            self.engine.kv_publish(lane, pages, start_page=k_shared)
        except Exception as e:
            poisoned = self.engine.kv_pool_epoch != pool_epoch0
            self.recorder.record("kv_publish_failed", lane=lane, poisoned=poisoned,
                                 error=str(e))
            if poisoned:
                # the copy failed inside the pool's guard, which zeroed the
                # pool: every stored page is gone with it
                logger.exception("kv_publish poisoned the pool; resetting")
                self.reset(reset_device=False)
            else:
                # failed before the pool was touched: only this publish's
                # fresh pages are suspect
                logger.exception("kv_publish failed; dropping this publish's pages")
                with self.lock:
                    self.pool.release(pages)
                    self._update_gauges_locked()
            with self.lock:
                self.publish_skips += 1
            return 0
        with self.lock:
            try:
                self.tree.insert(full, pages, first_slot=k_shared)
            except ValueError:
                logger.exception("kv radix insert rejected; publish dropped")
                self.pool.release(pages)
                self._update_gauges_locked()
                return 0
            self._update_gauges_locked()
        return n_new

    def _alloc_publish_pages_locked(self, fork_page: int | None, n_new: int,
                             lane: int) -> list[int] | None:
        """``n_new`` pages for a slab publish, the first a copy-on-write
        fork of ``fork_page`` when the stored prefix diverged mid-page; None
        on a full pool or an injected ``kv_alloc`` fault (only future reuse
        is lost). Called under ``lock``."""
        try:
            fault = get_fault_plane().draw("kv_alloc", op="publish")
            if fault is not None:
                raise fault
            if fork_page is None:
                return self.pool.alloc(n_new)
            rest = self.pool.alloc(n_new - 1)
            try:
                return [self.pool.fork(fork_page)] + rest
            except MemoryError:
                self.pool.release(rest)
                raise
        except (MemoryError, InjectedFault) as e:
            self.publish_skips += 1
            self.recorder.record("kv_alloc_failed", lane=lane, want=n_new, error=str(e))
            return None

    def note_hit(self, n_tokens: int) -> None:
        with self.lock:
            self.hits += 1
            self.shared_tokens += n_tokens
        self.c_hits.inc()
        self.c_shared_tokens.inc(n_tokens)

    # -- error path / introspection ----------------------------------------
    def reset(self, reset_device: bool = True) -> None:
        """Drop every page and stored prefix: the host accounting and, by
        default, the device pool (`InferenceEngine.reset_kv_pool`). The
        recovery path passes ``reset_device=False``: the engine's dispatch
        guard already reset the pool in place."""
        with self.lock:
            self.tree.clear()
            self.pool.reset()
            self._lane_pages.clear()
            self._lane_match_tokens.clear()
            self._lane_anchor.clear()
            if self.native:
                self.engine.clear_all_lane_pages()
            self._update_gauges_locked()
        if reset_device:
            self.engine.reset_kv_pool()
        self.recorder.record("kv_pool_reset")

    def release_all_lanes(self) -> None:
        """Scheduler-error path: every lane was dropped, release their
        retains. The tree's stored prefixes stay valid (no dispatch writes
        into a page the tree holds)."""
        with self.lock:
            for pages in self._lane_pages.values():
                self.pool.release(pages)
            self._lane_pages.clear()
            self._lane_match_tokens.clear()
            self._lane_anchor.clear()
            if self.native:
                self.engine.clear_all_lane_pages()
            self._update_gauges_locked()

    def check(self) -> None:
        with self.lock:
            self.pool.check()

    def debug(self) -> dict:
        """Pool, radix and lane accounting in one snapshot."""
        with self.lock:
            st = self.pool.stats()
            return {
                "page_size": self.page_size,
                "pool": {
                    "total": st.total,
                    "free": st.free,
                    "used": st.used,
                    "shared": st.shared,
                    "cow_forks": st.cow_forks,
                },
                "radix": {
                    "nodes": self.tree.node_count(),
                    "tokens": self.tree.token_count(),
                    "pages": self.tree.n_pages,
                    "hits": self.hits,
                    "shared_tokens": self.shared_tokens,
                    "evictions": self.evictions,
                },
                "lanes": {str(lane): len(pages) for lane, pages in self._lane_pages.items()},
            }
