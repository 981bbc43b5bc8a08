"""lockwatch: runtime lock-order tracking and deterministic interleaving.

The port's copy of dllama_tpu/analysis/lockwatch.py (stdlib only).

Static rules (``guarded-attrs``) catch *missing* locks; this module
catches *wrong lock orders* and makes thread races reproducible:

* :class:`LockWatch` + :class:`TrackedLock` — a drop-in
  ``threading.Lock`` that records the cross-thread acquisition-order
  graph (edge ``A -> B`` whenever ``B`` is taken while ``A`` is held)
  and raises :class:`LockOrderViolation` the moment an acquisition
  would close a cycle — turning a once-a-week deadlock hang into an
  immediate, stack-traced test failure.

* :func:`make_lock` / :func:`make_condition` — the factory production
  code calls at its lock sites. Plain ``threading`` primitives unless
  ``DLLAMA_LOCKWATCH=1`` (test mode), so the hot path pays nothing.

* :class:`Interleaver` — a seeded cooperative scheduler: spawned
  threads run ONE at a time and hand control back at explicit
  :meth:`Interleaver.step` points; which parked thread runs next is
  chosen by a seeded ``random.Random``. The same seed replays the same
  interleaving exactly, which is what lets the match->adopt race
  live on as a deterministic regression test instead of a war story.

Threads under an Interleaver must never block outside a step point —
take locks with :meth:`Interleaver.acquire` (a non-blocking acquire
loop that yields to the scheduler between attempts) so a schedule that
*would* deadlock parks instead of hanging the test run.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple


class LockOrderViolation(RuntimeError):
    """An acquisition would close a cycle in the lock-order graph."""


# -- acquisition-order graph -------------------------------------------------


class LockWatch:
    """Records which locks are taken while which others are held, across
    all threads, and refuses the edge that would create a cycle."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._held: Dict[int, List[str]] = {}  # thread ident -> lock stack
        self._edges: Dict[str, Set[str]] = {}  # A -> {B taken under A}
        self._edge_owner: Dict[Tuple[str, str], str] = {}  # edge -> thread

    def _find_path_locked(self, src: str, dst: str) -> Optional[List[str]]:
        """A path src -> ... -> dst in the edge graph (DFS); caller holds
        ``self._mu``."""
        stack: List[Tuple[str, List[str]]] = [(src, [src])]
        seen: Set[str] = set()
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in sorted(self._edges.get(node, ())):
                stack.append((nxt, path + [nxt]))
        return None

    def record_attempt(self, name: str) -> Optional[str]:
        """Record edges held -> ``name``; returns a human-readable cycle
        description if one of them would close a cycle (caller raises)."""
        ident = threading.get_ident()
        tname = threading.current_thread().name
        with self._mu:
            for h in self._held.get(ident, []):
                if h == name or name in self._edges.get(h, ()):
                    continue
                path = self._find_path_locked(name, h)
                if path is not None:
                    owner = self._edge_owner.get((path[0], path[1]), "?")
                    cyc = " -> ".join([h] + path)
                    return (
                        f"acquiring {name!r} while holding {h!r} "
                        f"(thread {tname!r}) closes the cycle {cyc}; the "
                        f"reverse order was first taken by thread {owner!r}"
                    )
                self._edges.setdefault(h, set()).add(name)
                self._edge_owner.setdefault((h, name), tname)
        return None

    def push(self, name: str) -> None:
        ident = threading.get_ident()
        with self._mu:
            self._held.setdefault(ident, []).append(name)

    def pop(self, name: str) -> None:
        ident = threading.get_ident()
        with self._mu:
            held = self._held.get(ident, [])
            for i in range(len(held) - 1, -1, -1):
                if held[i] == name:
                    del held[i]
                    break

    def edges(self) -> Dict[str, Set[str]]:
        with self._mu:
            return {a: set(bs) for a, bs in self._edges.items()}

    def held_by_current(self) -> List[str]:
        with self._mu:
            return list(self._held.get(threading.get_ident(), []))

    def reset(self) -> None:
        with self._mu:
            self._held.clear()
            self._edges.clear()
            self._edge_owner.clear()


class TrackedLock:
    """``threading.Lock`` plus lock-order bookkeeping via a LockWatch.

    Duck-types the Lock API (``acquire``/``release``/``locked``/context
    manager), so it also serves as the inner lock of a
    ``threading.Condition``.
    """

    def __init__(self, name: str, watch: LockWatch) -> None:
        self.name = name
        self._watch = watch
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            # check BEFORE blocking: the schedule that would deadlock
            # raises here instead of hanging
            cyc = self._watch.record_attempt(self.name)
            if cyc is not None:
                raise LockOrderViolation(cyc)
            ok = self._inner.acquire(True, timeout)
        else:
            ok = self._inner.acquire(False)
            if ok:
                cyc = self._watch.record_attempt(self.name)
                if cyc is not None:
                    self._inner.release()
                    raise LockOrderViolation(cyc)
        if ok:
            self._watch.push(self.name)
        return ok

    def release(self) -> None:
        self._watch.pop(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"TrackedLock({self.name!r}, locked={self.locked()})"


# -- env-gated factory (production lock sites call these) --------------------

_watch_init_mu = threading.Lock()
_global_watch: Optional[LockWatch] = None


def enabled() -> bool:
    return os.environ.get("DLLAMA_LOCKWATCH", "0") not in ("", "0")


def global_watch() -> LockWatch:
    global _global_watch
    with _watch_init_mu:
        if _global_watch is None:
            _global_watch = LockWatch()
        return _global_watch


def make_lock(name: str) -> "threading.Lock | TrackedLock":
    """A lock for a named production site: plain ``threading.Lock``
    normally, a :class:`TrackedLock` under ``DLLAMA_LOCKWATCH=1``."""
    if not enabled():
        return threading.Lock()
    return TrackedLock(name, global_watch())


def make_condition(name: str) -> threading.Condition:
    """Same gate for ``threading.Condition`` sites: in watch mode the
    condition's inner lock is tracked, so waiter re-acquisition shows up
    in the order graph too."""
    if not enabled():
        return threading.Condition()
    return threading.Condition(TrackedLock(name, global_watch()))


# -- deterministic interleaving harness --------------------------------------


class _Abort(BaseException):
    """Internal: unwinds a controlled thread when the harness gives up."""


class Interleaver:
    """Seeded cooperative scheduler for race regression tests.

    ``spawn()`` registers named thread bodies; ``run()`` starts them and
    grants execution to exactly one at a time. A controlled thread runs
    until its next :meth:`step` call, where it parks and the scheduler
    picks the next runnable thread with a seeded RNG. The (name, label)
    sequence is recorded in ``trace`` — identical for identical seeds.
    """

    def __init__(self, seed: int = 0, timeout_s: float = 10.0) -> None:
        self.rng = random.Random(seed)
        self.timeout_s = timeout_s
        self.cv = threading.Condition()
        self._threads: Dict[str, threading.Thread] = {}
        self._names: Dict[int, str] = {}  # thread ident -> spawn name
        self.parked: Set[str] = set()
        self.finished: Set[str] = set()
        self.granted: Optional[str] = None
        self.trace: List[Tuple[str, str]] = []
        self.errors: List[Tuple[str, BaseException]] = []
        self._aborted = False

    # -- called from the harness (main) thread ---------------------------

    def spawn(self, name: str, fn: Callable[[], None]) -> None:
        if name in self._threads:
            raise ValueError(f"duplicate interleaver thread {name!r}")
        t = threading.Thread(  # dlint: disable=thread-hygiene — joined in run() below via self._threads
            target=self._body, args=(name, fn), daemon=True,
            name=f"dllama-itl-{name}",
        )
        self._threads[name] = t

    def run(self) -> List[Tuple[str, str]]:
        """Drive every spawned thread to completion; returns the trace.
        Re-raises the first exception a controlled thread died with
        (e.g. a LockOrderViolation)."""
        for t in self._threads.values():
            t.start()
        deadline = time.monotonic() + self.timeout_s
        with self.cv:
            while len(self.finished) < len(self._threads):
                if self.granted is None and self.parked:
                    pick = self.rng.choice(sorted(self.parked))
                    self.parked.discard(pick)
                    self.granted = pick
                    self.cv.notify_all()
                    continue
                if not self.cv.wait(timeout=0.2):
                    if time.monotonic() > deadline:
                        self._aborted = True
                        self.cv.notify_all()
                        raise RuntimeError(
                            f"interleaver stalled (a controlled thread is "
                            f"blocking outside a step point?): "
                            f"granted={self.granted!r} "
                            f"parked={sorted(self.parked)} "
                            f"finished={sorted(self.finished)}"
                        )
        for t in self._threads.values():
            t.join(timeout=2.0)
        with self.cv:
            if self.errors:
                raise self.errors[0][1]
            return list(self.trace)

    # -- called from controlled threads -----------------------------------

    def step(self, label: str = "") -> None:
        """Park here until the scheduler grants this thread the next run
        slice. No-op when the calling thread isn't harness-controlled, so
        shared code paths can be instrumented unconditionally."""
        name = self._names.get(threading.get_ident())
        if name is None:
            return
        with self.cv:
            self.trace.append((name, label))
            self.parked.add(name)
            if self.granted == name:
                self.granted = None
            self.cv.notify_all()
            while self.granted != name:
                if self._aborted:
                    raise _Abort()
                self.cv.wait(timeout=0.2)

    def acquire(self, lock: "threading.Lock | TrackedLock", label: str = "") -> "_Held":
        """Cooperatively take ``lock``: never blocks while holding the
        run slice, so a would-deadlock schedule parks (and times out
        with a diagnostic) instead of wedging the whole test run."""
        while not lock.acquire(blocking=False):
            self.step(f"acquire-wait:{label}")
        return _Held(lock)

    # -- internals ---------------------------------------------------------

    def _body(self, name: str, fn: Callable[[], None]) -> None:
        self._names[threading.get_ident()] = name
        try:
            self.step("start")
            fn()
        except _Abort:
            pass
        except BaseException as e:
            with self.cv:
                self.errors.append((name, e))
        finally:
            with self.cv:
                self.finished.add(name)
                self.parked.discard(name)
                if self.granted == name:
                    self.granted = None
                self.cv.notify_all()


class _Held:
    """Context manager returned by :meth:`Interleaver.acquire`."""

    def __init__(self, lock: "threading.Lock | TrackedLock") -> None:
        self._lock = lock

    def __enter__(self) -> "_Held":
        return self

    def __exit__(self, *exc) -> None:
        self._lock.release()
