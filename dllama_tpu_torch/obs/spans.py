"""Span timeline tracing: where inside the engine each millisecond went.

The request tracer (trace.py) answers "how did this request do" with ONE flat
record; this layer answers "where did its time GO" with a timeline of
sub-request spans — queue wait, admission chunks, ``kv_adopt``/
``kv_publish`` copies, decode-block dispatch vs. device completion, SSE
flushes — each tagged with the owning request and lane so the full
serving path of one request reconstructs from a single export.

Design constraints mirror the metrics registry:

* **Low overhead.** A span is two ``perf_counter`` reads and one dict
  append under a short lock; with the tracker disabled ``begin`` returns
  ``None`` after one attribute read and ``end(None)`` is a no-op, so the
  bench's obs on/off comparison toggles this layer together with the
  registry and the recorder.
* **Bounded memory.** Completed spans land in a ring; old spans fall
  off. Drops are themselves observable: the first drop (and then every
  ``capacity`` further drops) records an ``obs_overflow`` flight-recorder
  event.
* **Two exports.** :meth:`SpanTracker.chrome_trace` renders the ring (or
  one request's spans) as Chrome-trace / Perfetto JSON — ``pid`` is the
  component (scheduler / engine / kv / http), ``tid`` is the lane — and
  :meth:`SpanTracker.request_summary` folds one request's spans into a
  millisecond accounting ("TTFT = 480ms: 210 queue + 190 prefill-chunks
  + 45 adopt + 35 first block") plus a wall-time coverage fraction.
  ``GET /v1/debug/timeline`` and ``--timeline-out`` serve both.

Threading: ``begin``/``end`` may run on different threads (the queue
span begins on the HTTP handler thread and ends on the scheduler
thread); a handle is mutated only by its ender and ``end`` is idempotent
(the first ender wins), so cross-thread handoff needs no lock beyond the
ring append.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Iterator

from .recorder import get_recorder

DEFAULT_CAPACITY = 4096

# stable Chrome-trace pid per component (new components get the next id)
_COMPONENT_PIDS = {"scheduler": 1, "engine": 2, "kv": 3, "http": 4, "cli": 5}

# Replica attribution: the in-process fleet shares ONE global
# tracker across N replicas, so span records carry the replica that
# produced them. The tag is registered per-thread (scheduler loop + HTTP
# handler threads are replica-owned; engine compile/prefetch helpers stay
# untagged) and stamped at ``begin`` — a span that begins on a replica
# thread and ends elsewhere keeps its origin.
_thread_ctx = threading.local()


def set_thread_replica(tag: str | None) -> None:
    """Tag every span subsequently begun on THIS thread with a replica
    name (``None`` clears). Single-replica servers never call this and
    their span records are unchanged."""
    _thread_ctx.replica = tag


def get_thread_replica() -> str | None:
    return getattr(_thread_ctx, "replica", None)


class _SpanHandle:
    """In-flight span state between ``begin`` and ``end``."""

    __slots__ = ("name", "component", "request_id", "lane", "t0", "attrs",
                 "replica", "done")

    def __init__(self, name, component, request_id, lane, t0, attrs,
                 replica=None):
        self.name = name
        self.component = component
        self.request_id = request_id
        self.lane = lane
        self.t0 = t0
        self.attrs = attrs
        self.replica = replica
        self.done = False


class SpanTracker:
    """Thread-safe bounded ring of completed spans; see module docstring."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        enabled: bool | None = None,
        clock: Callable[[], float] = time.perf_counter,
        wall_clock: Callable[[], float] = time.time,
        recorder: object | None = None,
    ) -> None:
        self.enabled = (
            enabled
            if enabled is not None
            else os.environ.get("DLLAMA_OBS", "1") != "0"
        )
        self.capacity = capacity
        self._clock = clock
        self._epoch = clock()  # all span t0s are seconds since this anchor
        self.epoch_unix = wall_clock()
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._recorder = recorder
        self._total = 0
        self._dropped = 0
        # optional throttled file sink (--timeline-out on the server)
        self._sink_path: str | None = None
        self._sink_min_interval = 5.0
        self._sink_last = 0.0

    @property
    def recorder(self):
        if self._recorder is None:
            self._recorder = get_recorder()
        return self._recorder

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    # -- span lifecycle ----------------------------------------------------

    def begin(self, name: str, component: str = "engine",
              request_id: str | None = None, lane: int | None = None,
              **attrs) -> _SpanHandle | None:
        """Open a span; returns an opaque handle (or None when disabled —
        ``end(None)`` no-ops, so call sites never branch)."""
        if not self.enabled:
            return None
        return _SpanHandle(
            name, component, request_id, lane, self._clock(), attrs or None,
            replica=get_thread_replica(),
        )

    def end(self, handle: _SpanHandle | None, **attrs) -> None:
        """Close a span and commit it to the ring; idempotent (a second
        end — e.g. an error path racing the normal one — no-ops)."""
        if handle is None or handle.done:
            return
        handle.done = True
        t1 = self._clock()
        if attrs:
            handle.attrs = {**(handle.attrs or {}), **attrs}
        rec = {
            "name": handle.name,
            "component": handle.component,
            "request_id": handle.request_id,
            "lane": handle.lane,
            "t0": handle.t0 - self._epoch,
            "dur_s": max(t1 - handle.t0, 0.0),
        }
        if handle.replica is not None:
            rec["replica"] = handle.replica
        if handle.attrs:
            rec["attrs"] = handle.attrs
        overflowed = False
        with self._lock:
            self._total += 1
            if len(self._ring) == self.capacity:
                self._dropped += 1
                # rate-limit the meta-event: first drop, then every
                # `capacity` further drops (a busy server overflows on
                # every span once the ring is full)
                overflowed = self._dropped % self.capacity == 1
            self._ring.append(rec)
            dropped = self._dropped
        if overflowed:
            self.recorder.record(
                "obs_overflow", what="span_ring", capacity=self.capacity,
                dropped=dropped,
            )

    @contextmanager
    def span(self, name: str, component: str = "engine",
             request_id: str | None = None, lane: int | None = None,
             **attrs) -> Iterator[_SpanHandle]:
        """``with tracker.span("admission_chunk", ...):`` — the body is
        timed even when it raises (the error still took the time)."""
        handle = self.begin(name, component, request_id, lane, **attrs)
        try:
            yield handle
        finally:
            self.end(handle)

    # -- views -------------------------------------------------------------

    def completed(self, request_id: str | None = None,
                  replica: str | None = None) -> list[dict]:
        with self._lock:
            spans = list(self._ring)
        if request_id is not None:
            spans = [s for s in spans if s["request_id"] == request_id]
        if replica is not None:
            spans = [s for s in spans if s.get("replica") == replica]
        return spans

    @property
    def total_recorded(self) -> int:
        with self._lock:
            return self._total

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # -- Chrome-trace / Perfetto export ------------------------------------

    def chrome_trace(self, request_id: str | None = None,
                     replica: str | None = None,
                     pid_prefix: str | None = None,
                     pid_base: int = 0) -> dict:
        """Chrome-trace JSON-object format (loadable by Perfetto and
        chrome://tracing): one complete ("X") event per span, pid =
        component, tid = lane (-1 = no lane), ts/dur in microseconds
        since the tracker epoch. Extra top-level keys (the per-request
        summary under "dllama") are legal metadata both viewers ignore.

        ``replica`` keeps only spans stamped with that replica tag (the
        in-process fleet shares one tracker). ``pid_prefix`` prefixes
        every process name and ``pid_base`` offsets every pid, so a fleet
        stitcher can merge N fragments without two replicas' identical
        component names/pids colliding in the viewer."""
        spans = self.completed(request_id, replica)
        events: list[dict] = []
        seen_pids: dict[str, int] = {}
        seen_tids: set[tuple[int, int]] = set()
        for s in spans:
            comp = s["component"]
            pid = _COMPONENT_PIDS.get(comp)
            if pid is None:
                pid = _COMPONENT_PIDS.setdefault(
                    comp, max(_COMPONENT_PIDS.values()) + 1
                )
            pid += pid_base
            tid = s["lane"] if s["lane"] is not None else -1
            if comp not in seen_pids:
                seen_pids[comp] = pid
                events.append({
                    "ph": "M", "pid": pid, "tid": 0,
                    "name": "process_name",
                    "args": {
                        "name": f"{pid_prefix}/{comp}" if pid_prefix
                        else comp
                    },
                })
            if (pid, tid) not in seen_tids:
                seen_tids.add((pid, tid))
                events.append({
                    "ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name",
                    "args": {
                        "name": f"lane {tid}" if tid >= 0 else "no lane"
                    },
                })
            args = {
                "request_id": s["request_id"],
                **(s.get("attrs") or {}),
            }
            if s.get("replica") is not None:
                args["replica"] = s["replica"]
            ev = {
                "ph": "X",
                "pid": pid,
                "tid": tid,
                "ts": round(s["t0"] * 1e6, 3),
                "dur": round(s["dur_s"] * 1e6, 3),
                "name": s["name"],
                "args": args,
            }
            events.append(ev)
        out = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "dllama": {
                "epoch_unix": self.epoch_unix,
                "n_spans": len(spans),
                "dropped": self.dropped,
            },
        }
        if replica is not None:
            out["dllama"]["replica"] = replica
        if request_id is not None:
            out["dllama"]["request_id"] = request_id
            out["dllama"]["summary"] = self.request_summary(request_id)
        return out

    def export_file(self, path: str, request_id: str | None = None) -> int:
        """Write the Chrome-trace JSON to ``path`` (``--timeline-out``);
        returns the span count. Serialization failures fall back to
        ``repr`` per value (same policy as the tracer sink)."""
        trace = self.chrome_trace(request_id)
        with open(path, "w") as f:
            f.write(json.dumps(trace, default=repr))
        return trace["dllama"]["n_spans"]

    def set_sink(self, path: str | None,
                 min_interval_s: float = 5.0) -> None:
        """Throttled auto-export: ``maybe_flush`` rewrites ``path`` at
        most every ``min_interval_s`` (the server calls it per finished
        request); ``flush`` writes unconditionally (server shutdown)."""
        self._sink_path = path
        self._sink_min_interval = min_interval_s
        self._sink_last = 0.0

    def maybe_flush(self) -> None:
        if self._sink_path is None:
            return
        now = self._clock()
        if now - self._sink_last < self._sink_min_interval:
            return
        self._sink_last = now
        self.flush()

    def flush(self) -> None:
        if self._sink_path is None:
            return
        try:
            self.export_file(self._sink_path)
        except OSError:
            self.recorder.record(
                "obs_sink_error", what="timeline", path=self._sink_path
            )

    # -- per-request millisecond accounting --------------------------------

    def request_summary(self, request_id: str) -> dict:
        """Fold one request's spans into per-phase totals and shares plus
        a wall-time coverage fraction (union of span intervals / first
        span start -> last span end). The ≥95%-coverage acceptance bar
        lives on this number: every serving phase is spanned, so the only
        uncovered time is scheduler-tick bookkeeping between spans."""
        spans = self.completed(request_id)
        if not spans:
            return {"request_id": request_id, "n_spans": 0, "phases": {},
                    "wall_ms": 0.0, "coverage": None}
        intervals = sorted(
            (s["t0"], s["t0"] + s["dur_s"]) for s in spans
        )
        wall_t0 = intervals[0][0]
        wall_t1 = max(t1 for _, t1 in intervals)
        wall = max(wall_t1 - wall_t0, 0.0)
        covered = 0.0
        cur0, cur1 = intervals[0]
        for t0, t1 in intervals[1:]:
            if t0 > cur1:
                covered += cur1 - cur0
                cur0, cur1 = t0, t1
            else:
                cur1 = max(cur1, t1)
        covered += cur1 - cur0
        phases: dict[str, dict] = {}
        for s in spans:
            ph = phases.setdefault(
                s["name"], {"n": 0, "total_ms": 0.0, "share": 0.0}
            )
            ph["n"] += 1
            ph["total_ms"] += s["dur_s"] * 1000.0
        for ph in phases.values():
            ph["total_ms"] = round(ph["total_ms"], 3)
            ph["share"] = (
                round(ph["total_ms"] / (wall * 1000.0), 4) if wall else None
            )
        return {
            "request_id": request_id,
            "n_spans": len(spans),
            "wall_ms": round(wall * 1000.0, 3),
            "covered_ms": round(covered * 1000.0, 3),
            "coverage": round(covered / wall, 4) if wall else None,
            "phases": dict(sorted(phases.items())),
        }


_DEFAULT = SpanTracker(
    capacity=int(os.environ.get("DLLAMA_SPAN_CAPACITY",
                                str(DEFAULT_CAPACITY))),
)


def get_span_tracker() -> SpanTracker:
    """The process-wide default span tracker (shared by the engine, the
    lane scheduler, the KV manager and ``/v1/debug/timeline``)."""
    return _DEFAULT
