"""Engine watchdog: turn silent hangs into diagnosable artifacts.

A hung ``kv_adopt`` copy or a wedged scheduler loop today stops the
world with no alarm: lanes stay "active", clients block on their SSE
queues, and nothing in ``/metrics`` moves. The watchdog is a daemon
thread that audits liveness signals the scheduler feeds it:

* **beat** — one call per scheduler-loop tick, carrying how many lanes
  are active / admitting;
* **dispatch begin/end** — brackets around every engine call the
  scheduler makes (decode block, admission chunk, adopt), so the oldest
  in-flight dispatch's age is known;
* **decode / admission progress** — timestamps of the last decode-block
  dispatch and the last admission chunk/adopt that completed;
* **pause begin/end** — a stretch on the scheduler thread declared not
  to be a stall (the profiler's start and stop, which hold the
  interpreter): while one is open only the dispatch-hung rule audits it,
  and its end moves the gap rules' clocks past it.

Every ``interval_s`` it evaluates three stall rules (all against an
injectable clock, so tests drive them deterministically):

1. ``dispatch-hung`` — a dispatch has been in flight longer than
   ``dispatch_timeout_s``;
2. ``scheduler-stalled`` — lanes are active or admitting but the loop
   has not beaten for ``dispatch_timeout_s`` (a deadlock outside any
   dispatch);
3. ``decode-stalled`` — lanes are active but no decode block was
   dispatched for more than ``stall_factor`` × the p99 block time
   (from ``dllama_engine_step_seconds{kind="decode_lanes"}`` via
   ``_Histogram.percentile``), floored at ``min_stall_s``;
4. ``admission-stalled`` — a request is mid-admission but no chunk or
   adopt completed for ``dispatch_timeout_s``.

On the first detection of an episode it increments
``dllama_watchdog_stalls_total{reason=}``, flips the
``dllama_watchdog_degraded`` gauge (``/v1/health`` reports
``status: degraded`` with the reason), records a ``watchdog_stall``
flight-recorder event, and writes the existing postmortem ring dump
(reason ``watchdog``) — the black box for a hang instead of a crash.
When the signals recover it clears the degraded state and records
``watchdog_recovered``; a later episode triggers a fresh postmortem.

Knobs ride the environment (no CLI surface yet):
``DLLAMA_WATCHDOG_INTERVAL_S``, ``DLLAMA_WATCHDOG_DISPATCH_TIMEOUT_S``,
``DLLAMA_WATCHDOG_STALL_FACTOR``, ``DLLAMA_WATCHDOG_MIN_STALL_S``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable

from ..analysis.lockwatch import make_lock
from .metrics import get_registry
from .recorder import get_recorder


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name, "")
    return float(v) if v else default


def resolve_watchdog_knobs() -> dict:
    return {
        "interval_s": _env_float("DLLAMA_WATCHDOG_INTERVAL_S", 1.0),
        "dispatch_timeout_s": _env_float(
            "DLLAMA_WATCHDOG_DISPATCH_TIMEOUT_S", 30.0
        ),
        "stall_factor": _env_float("DLLAMA_WATCHDOG_STALL_FACTOR", 20.0),
        "min_stall_s": _env_float("DLLAMA_WATCHDOG_MIN_STALL_S", 5.0),
    }


class EngineWatchdog:
    """Scheduler-liveness monitor; see module docstring."""

    def __init__(
        self,
        interval_s: float = 1.0,
        dispatch_timeout_s: float = 30.0,
        stall_factor: float = 20.0,
        min_stall_s: float = 5.0,
        block_p99: Callable[[], float | None] | None = None,
        clock: Callable[[], float] = time.monotonic,
        registry: object | None = None,
        recorder: object | None = None,
    ) -> None:
        self.interval_s = interval_s
        self.dispatch_timeout_s = dispatch_timeout_s
        self.stall_factor = stall_factor
        self.min_stall_s = min_stall_s
        # callable returning the p99 decode-block seconds (None = no data)
        self.block_p99 = block_p99 or (lambda: None)
        self._clock = clock
        self.recorder = recorder if recorder is not None else get_recorder()
        obs = registry if registry is not None else get_registry()
        self.m_stalls = obs.counter(
            "dllama_watchdog_stalls_total",
            "Stall episodes the watchdog detected, by rule "
            "(dispatch-hung / scheduler-stalled / decode-stalled / "
            "admission-stalled). Each episode also wrote a postmortem.",
            labelnames=("reason",),
        )
        self.g_degraded = obs.gauge(
            "dllama_watchdog_degraded",
            "1 while the watchdog considers the engine stalled "
            "(/v1/health reports status=degraded), else 0.",
        )
        self.g_beat_age = obs.gauge(
            "dllama_watchdog_heartbeat_age_seconds",
            "Seconds since the scheduler loop last beat the watchdog "
            "(refreshed on every watchdog check).",
        )
        self._lock = make_lock("obs.watchdog")
        # liveness signals (mutated by the scheduler thread)
        self._last_beat: float | None = None
        self._n_active = 0
        self._n_admitting = 0
        self._dispatch_t0: float | None = None
        self._dispatch_kind: str | None = None
        self._paused = False
        self._last_decode: float | None = None
        self._last_admission: float | None = None
        self._admitting_since: float | None = None
        # detection state
        self.stalled_reason: str | None = None
        self.stalled_detail: str | None = None
        self._stalled_since: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- scheduler-side hooks (cheap: one clock read + a few stores) -------

    def beat(self, n_active: int = 0, n_admitting: int = 0) -> None:
        now = self._clock()
        with self._lock:
            self._last_beat = now
            self._n_active = n_active
            self._n_admitting = n_admitting
            if n_admitting > 0:
                if self._admitting_since is None:
                    self._admitting_since = now
            else:
                self._admitting_since = None
            if n_active > 0 and self._last_decode is None:
                # lanes just went active: arm the decode-gap rule from now,
                # not from a decode that never happened
                self._last_decode = now
            elif n_active == 0:
                self._last_decode = None

    def dispatch_begin(self, kind: str) -> None:
        now = self._clock()
        with self._lock:
            self._dispatch_t0 = now
            self._dispatch_kind = kind
            if kind == "decode_lanes":
                self._last_decode = now

    def dispatch_end(self) -> None:
        with self._lock:
            if self._dispatch_kind in ("prefill_lane_chunk", "kv_adopt"):
                self._last_admission = self._clock()
            self._dispatch_t0 = None
            self._dispatch_kind = None

    def pause_begin(self, what: str) -> None:
        """Declare that the scheduler thread starts ``what``, a stretch
        that is no stall (as a dispatch is declared): until `pause_end`
        it is audited as a dispatch in flight (dispatch-hung only)."""
        with self._lock:
            self._dispatch_t0 = self._clock()
            self._dispatch_kind = what
            self._paused = True

    def pause_end(self) -> None:
        """End the declared pause: the beat, decode and admission clocks
        move forward by its length, so the gap rules see no gap."""
        now = self._clock()
        with self._lock:
            if self._paused and self._dispatch_t0 is not None:
                dt = max(0.0, now - self._dispatch_t0)
                for name in ("_last_beat", "_last_decode", "_last_admission",
                             "_admitting_since"):
                    t = getattr(self, name)
                    if t is not None:
                        setattr(self, name, t + dt)
            self._paused = False
            self._dispatch_t0 = None
            self._dispatch_kind = None

    # -- detection ---------------------------------------------------------

    def _evaluate(self, now: float) -> tuple[str, str] | None:
        """(reason, detail) if any stall rule fires; caller holds no lock
        (reads are snapshotted under it here)."""
        with self._lock:
            last_beat = self._last_beat
            n_active = self._n_active
            n_admitting = self._n_admitting
            dispatch_t0 = self._dispatch_t0
            dispatch_kind = self._dispatch_kind
            last_decode = self._last_decode
            last_admission = self._last_admission
            admitting_since = self._admitting_since
            paused = self._paused
        if last_beat is None:
            return None  # scheduler never ran; nothing to audit
        self.g_beat_age.set(max(now - last_beat, 0.0))
        busy = n_active > 0 or n_admitting > 0
        if dispatch_t0 is not None:
            age = now - dispatch_t0
            if age > self.dispatch_timeout_s:
                return (
                    "dispatch-hung",
                    f"{dispatch_kind} in flight for {age:.1f}s "
                    f"(timeout {self.dispatch_timeout_s:.1f}s)",
                )
        if paused:
            return None  # a declared pause is no gap
        if busy and now - last_beat > self.dispatch_timeout_s:
            return (
                "scheduler-stalled",
                f"no scheduler tick for {now - last_beat:.1f}s with "
                f"{n_active} active / {n_admitting} admitting lanes",
            )
        if n_active > 0 and last_decode is not None:
            p99 = self.block_p99()
            threshold = max(
                self.min_stall_s,
                self.stall_factor * p99 if p99 else 0.0,
            )
            gap = now - last_decode
            if gap > threshold:
                return (
                    "decode-stalled",
                    f"no decode-block dispatch for {gap:.1f}s with "
                    f"{n_active} active lanes "
                    f"(threshold {threshold:.1f}s)",
                )
        if n_admitting > 0 and admitting_since is not None:
            ref = max(
                admitting_since,
                last_admission if last_admission is not None else 0.0,
            )
            gap = now - ref
            if gap > self.dispatch_timeout_s:
                return (
                    "admission-stalled",
                    f"{n_admitting} admitting lanes made no chunk/adopt "
                    f"progress for {gap:.1f}s",
                )
        return None

    def check_once(self, now: float | None = None) -> str | None:
        """One audit pass; returns the stall reason when degraded. Edge-
        triggered: only the healthy -> stalled transition pays the
        postmortem + counter, re-checks while stalled just refresh."""
        if now is None:
            now = self._clock()
        hit = self._evaluate(now)
        if hit is None:
            with self._lock:
                reason, self.stalled_reason = self.stalled_reason, None
                self.stalled_detail = None
                self._stalled_since = None
            if reason is not None:
                self.g_degraded.set(0)
                self.recorder.record("watchdog_recovered", reason=reason)
            return None
        reason, detail = hit
        with self._lock:
            first = self.stalled_reason is None
            if first:
                self.stalled_reason = reason
                self.stalled_detail = detail
                self._stalled_since = now
        if first:
            self.m_stalls.labels(reason=reason).inc()
            self.g_degraded.set(1)
            self.recorder.record(
                "watchdog_stall", reason=reason, detail=detail
            )
            # the black box for a hang instead of a crash: dump the ring
            # (dispatches that led here) while the process is still alive
            self.recorder.postmortem("watchdog", f"{reason}: {detail}")
        return reason

    # -- status / thread ---------------------------------------------------

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self.stalled_reason is not None

    def status(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "degraded": self.stalled_reason is not None,
                "reason": self.stalled_reason,
                "detail": self.stalled_detail,
                "stalled_since_s": (
                    None if self._stalled_since is None
                    else round(self._clock() - self._stalled_since, 3)
                ),
                "in_flight_dispatch": self._dispatch_kind,
                "n_active": self._n_active,
                "n_admitting": self._n_admitting,
            }

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="dllama-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check_once()
            except Exception:  # the auditor must never take down serving
                import logging

                logging.getLogger(__name__).exception("watchdog check failed")
