"""Engine flight recorder: a bounded ring of structured engine events.

The request traces (trace.py) explain the SERVING layer (who waited, who got a
lane); when decode stalls or a compile storms the prefetch thread the
question is what the ENGINE did — the last N dispatches, their windows
and wall times, which programs compiled on which origin, when the KV
cache epoch moved. The recorder answers that: every engine-level event is
one small dict appended to a lock-guarded ring (old events fall off, a
long-lived server never grows), timestamped on the monotonic clock so
intervals survive wall-clock jumps.

Event kinds recorded today (see runtime/engine.py + runtime/api_server.py):

  * ``step_dispatch`` / ``step_complete`` — one compiled-program call
    (kind, attention window, block width / prefill bucket, position; the
    complete event carries ``ms``);
  * ``compile_start`` / ``compile_end`` — program builds with their
    origin (``dispatch`` / ``prefetch``) and compile seconds; lazily
    jitted programs record a single deferred ``compile`` event;
  * ``cache_epoch`` — KV-cache rebuilds (init / reset / crash recovery);
  * ``admit`` / ``evict`` / ``finish`` — lane-scheduler decisions;
  * ``error`` / ``scheduler_error`` — failed dispatches and scheduler-
    loop exceptions;
  * ``watchdog_stall`` / ``watchdog_recovered`` — stall episodes the
    engine watchdog (obs/watchdog.py) detected and cleared;
  * ``obs_overflow`` / ``obs_sink_error`` — observability failing at its
    own job: the span ring dropping completed spans, or a trace/timeline
    sink write failing (the layer degrades, and says so here).

**Postmortem dump**: when a ``postmortem_dir`` is configured
(``--postmortem-dir`` or ``DLLAMA_POSTMORTEM_DIR``), a crashed step or
scheduler loop writes the whole ring plus the failure reason as one JSON
file before the error propagates — the black box you read after the
crash, not the log you hoped you had enabled.

Recording is a dict build + deque append under a short lock; with the
recorder disabled (``DLLAMA_OBS=0`` disables it together with the
metrics registry) every ``record`` call returns after one attribute read.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque

logger = logging.getLogger(__name__)

DEFAULT_CAPACITY = 2048


class FlightRecorder:
    """Bounded, thread-safe ring of engine events; see module docstring."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        enabled: bool = True,
        postmortem_dir: str | None = None,
    ) -> None:
        self.capacity = capacity
        self.enabled = enabled
        self.postmortem_dir = postmortem_dir
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0  # total events ever recorded (ring drops the oldest)
        self._n_postmortems = 0
        # named callables whose outputs embed into every postmortem dump
        # (the API server registers a /v1/health snapshot and the last
        # 60 s of the anomaly-signal series): a ring dump then carries
        # the server-level evidence, diagnosable without a live server
        self._context_providers: dict[str, object] = {}

    def add_context_provider(self, key: str, fn) -> None:
        """Register (or replace) a zero-arg callable whose return value
        is embedded under ``context[key]`` in postmortem dumps. Keyed so
        test churn rebuilding server state replaces, never stacks."""
        self._context_providers[key] = fn

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def record(self, kind: str, **fields) -> None:
        """Append one event. ``t`` is monotonic seconds; ``seq`` is the
        lifetime event index (gaps at the ring head reveal how much
        history fell off)."""
        if not self.enabled:
            return
        ev = {"t": time.monotonic(), "kind": kind}
        ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)

    def events(self, kind: str | None = None) -> list[dict]:
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    @property
    def total_recorded(self) -> int:
        with self._lock:
            return self._seq

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def dump(self) -> dict:
        """JSON-ready snapshot: ring contents + bookkeeping (what
        ``/v1/debug/recorder`` serves and the postmortem writes)."""
        with self._lock:
            evs = list(self._ring)
            total = self._seq
        return {
            "captured_unix": time.time(),
            "captured_monotonic": time.monotonic(),
            "capacity": self.capacity,
            "n_events": len(evs),
            "total_recorded": total,
            "dropped": max(total - len(evs), 0),
            "events": evs,
        }

    def dump_json(self) -> str:
        return json.dumps(self.dump())

    def postmortem(self, reason: str, error: BaseException | str | None = None
                   ) -> str | None:
        """Write the ring + failure context as a JSON file into
        ``postmortem_dir``; returns the path, or None when no dir is
        configured. Never raises — a broken postmortem path must not mask
        the original failure."""
        self.record(
            "postmortem", reason=reason,
            error=None if error is None else str(error),
        )
        d = self.postmortem_dir
        if not d:
            return None
        try:
            os.makedirs(d, exist_ok=True)
            with self._lock:
                self._n_postmortems += 1
                n = self._n_postmortems
            path = os.path.join(
                d, f"postmortem-{int(time.time() * 1000)}-{os.getpid()}-{n}.json"
            )
            payload = self.dump()
            payload["reason"] = reason
            payload["error"] = None if error is None else str(error)
            payload["error_type"] = (
                type(error).__name__
                if isinstance(error, BaseException)
                else None
            )
            # providers run OUTSIDE the ring lock (dump/record take it)
            # and individually fail-safe: bad context must never mask
            # the original failure or the rest of the dump
            context = {}
            for key, fn in list(self._context_providers.items()):
                try:
                    context[key] = fn()
                except Exception as e:
                    context[key] = {"context_error": str(e)}
            if context:
                payload["context"] = context
            with open(path, "w") as f:
                json.dump(payload, f)
            logger.error("postmortem written to %s (reason: %s)", path, reason)
            return path
        except Exception:
            logger.exception("failed to write postmortem for %r", reason)
            return None


_DEFAULT = FlightRecorder(
    capacity=int(os.environ.get("DLLAMA_RECORDER_CAPACITY",
                                str(DEFAULT_CAPACITY))),
    enabled=os.environ.get("DLLAMA_OBS", "1") != "0",
    postmortem_dir=os.environ.get("DLLAMA_POSTMORTEM_DIR") or None,
)


def get_recorder() -> FlightRecorder:
    """The process-wide default recorder (what the engine, the lane
    scheduler and ``/v1/debug/recorder`` share)."""
    return _DEFAULT
