"""In-process metrics time-series: bounded ring history for every metric.

Everything the registry exports today is a point-in-time snapshot: a
``/metrics`` scrape tells you where the counters stand NOW, and nothing
retains what they looked like ten seconds ago. The ROADMAP's
replica-router and SLO-aware-scheduling items both need the *time
dimension* — "is goodput dropping", "is the KV free list draining" —
and so does a human watching a live engine. This module keeps it, in
process, with zero dependencies:

* :class:`SeriesStore` — one bounded two-tier ring per series. Tier 1
  holds full-resolution samples (~1 s, ``interval_s``) for the recent
  past (``tier1_retention_s``, default 10 min); tier 2 holds a
  downsampled point per ``DOWNSAMPLE_EVERY`` tier-1 samples (~10 s) out
  to ``retention_s`` (default 1 h). Counter-kind series downsample by
  LAST value (the cumulative count at the bucket edge stays exact);
  gauge-kind series downsample by MEAN (a 10 s bucket of a noisy gauge
  keeps its level, not a lucky instant).
* :class:`MetricsSampler` — a named, joinable daemon thread
  (``dllama-series-sampler``) that every ``interval_s`` runs the
  registry's refresh hooks (so on-demand gauges — SLO windows, device
  memory, step cost — are current *independent of Prometheus scrapes*),
  snapshots ``registry.flat_values()`` into the store, and invokes any
  ``on_sample`` callbacks (the anomaly monitor rides here). The clock is
  injectable; ``sample_once()`` is the thread body's unit-testable core.

Surfaced by ``GET /v1/debug/series?name=&window=`` and the live
``GET /dashboard`` sparklines (obs/dashboard.py). Knobs:
``--series-retention`` / ``DLLAMA_SERIES_RETENTION_S``,
``DLLAMA_SERIES_INTERVAL_S``, ``DLLAMA_SERIES_MAX``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable

from ..analysis.lockwatch import make_lock
from .metrics import MetricsRegistry, get_registry
from .recorder import FlightRecorder, get_recorder

# tier-2 keeps one point per this many tier-1 samples (~10 s at the
# default 1 s interval)
DOWNSAMPLE_EVERY = 10


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name, "")
    return float(v) if v else default


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    return int(v) if v else default


def resolve_series_knobs(
    retention_s: float | None = None, interval_s: float | None = None
) -> tuple[float, float]:
    """Time-series knob resolution, same precedence as the lane knobs:
    explicit (CLI ``--series-retention``) beats env
    (DLLAMA_SERIES_RETENTION_S / DLLAMA_SERIES_INTERVAL_S) beats the
    defaults (1 h retention, 1 s sampling)."""
    if retention_s is None:
        retention_s = _env_float("DLLAMA_SERIES_RETENTION_S", 3600.0)
    if interval_s is None:
        interval_s = _env_float("DLLAMA_SERIES_INTERVAL_S", 1.0)
    return float(retention_s), float(interval_s)


class _Series:
    """One metric's two-tier ring; appends are O(1), bounds are deques."""

    __slots__ = (
        "kind", "tier1", "tier2", "_bucket_n", "_bucket_sum", "_bucket_last"
    )

    def __init__(self, kind: str, tier1_cap: int, tier2_cap: int) -> None:
        self.kind = kind
        self.tier1: deque[tuple[float, float]] = deque(maxlen=tier1_cap)
        self.tier2: deque[tuple[float, float]] = deque(maxlen=tier2_cap)
        self._bucket_n = 0
        self._bucket_sum = 0.0
        self._bucket_last = 0.0

    def append(self, t: float, value: float) -> None:
        self.tier1.append((t, value))
        self._bucket_n += 1
        self._bucket_sum += value
        self._bucket_last = value
        if self._bucket_n >= DOWNSAMPLE_EVERY:
            down = (
                self._bucket_last
                if self.kind == "counter"
                else self._bucket_sum / self._bucket_n
            )
            self.tier2.append((t, down))
            self._bucket_n = 0
            self._bucket_sum = 0.0


class SeriesStore:
    """Bounded ring time-series over registry samples; see module doc.

    Thread-safety: the sampler thread appends while HTTP handler threads
    query; one short lock guards the series map and the rings. The store
    is bounded three ways — tier-1/tier-2 deque capacities and a cap on
    the number of distinct series (``max_series``): past the cap, new
    names are dropped and counted in ``dllama_series_dropped_total``
    (recorded once as an ``obs_overflow`` event, not once per sample).
    """

    def __init__(
        self,
        interval_s: float = 1.0,
        retention_s: float = 3600.0,
        tier1_retention_s: float = 600.0,
        max_series: int = 2048,
        registry: MetricsRegistry | None = None,
        recorder: FlightRecorder | None = None,
    ) -> None:
        self.interval_s = max(float(interval_s), 0.001)
        self.retention_s = max(float(retention_s), self.interval_s)
        self.tier1_retention_s = min(
            max(float(tier1_retention_s), self.interval_s), self.retention_s
        )
        self.max_series = int(max_series)
        self._tier1_cap = max(
            int(round(self.tier1_retention_s / self.interval_s)), 1
        )
        self._tier2_cap = max(
            int(round(
                self.retention_s / (self.interval_s * DOWNSAMPLE_EVERY)
            )),
            1,
        )
        self._lock = make_lock("obs.series")
        self._series: dict[str, _Series] = {}
        self._overflowed = False
        self.recorder = recorder if recorder is not None else get_recorder()
        obs = registry if registry is not None else get_registry()
        self.m_samples = obs.counter(
            "dllama_series_samples_total",
            "Sampler ticks folded into the in-process time-series store.",
        )
        self.g_tracked = obs.gauge(
            "dllama_series_tracked",
            "Distinct series the time-series store currently retains.",
        )
        self.m_dropped = obs.counter(
            "dllama_series_dropped_total",
            "New series names dropped because the store hit its "
            "max-series bound (existing series keep sampling).",
        )

    # -- writes (sampler thread) ------------------------------------------

    def record(
        self, now: float, values: dict[str, tuple[str, float]]
    ) -> None:
        """Fold one sampler tick — ``flat_values()`` output — into the
        rings."""
        dropped = 0
        with self._lock:
            for name, (kind, value) in values.items():
                s = self._series.get(name)
                if s is None:
                    if len(self._series) >= self.max_series:
                        dropped += 1
                        continue
                    s = _Series(kind, self._tier1_cap, self._tier2_cap)
                    self._series[name] = s
                s.append(now, value)
            n_tracked = len(self._series)
        self.m_samples.inc()
        self.g_tracked.set(n_tracked)
        if dropped:
            self.m_dropped.inc(dropped)
            if not self._overflowed:
                self._overflowed = True
                self.recorder.record(
                    "obs_overflow", what="series_store",
                    max_series=self.max_series,
                )

    # -- reads (HTTP handler threads) -------------------------------------

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def query(
        self, name: str, window_s: float, now: float | None = None
    ) -> dict[str, object] | None:
        """Points for ``name`` covering the trailing ``window_s`` seconds
        before ``now`` (default: the series' newest sample, so readers
        need no clock of their own and fake-clock tests stay
        deterministic); tier 1 serves windows it fully retains, tier 2
        serves the rest. None when the series does not exist."""
        window_s = max(float(window_s), self.interval_s)
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return None
            use_tier1 = window_s <= self.tier1_retention_s
            ring = s.tier1 if use_tier1 else s.tier2
            if now is None:
                now = s.tier1[-1][0] if s.tier1 else 0.0
            cutoff = now - window_s
            points = [[t, v] for t, v in ring if t >= cutoff]
            kind = s.kind
        return {
            "name": name,
            "kind": kind,
            "tier": "1s" if use_tier1 else "10s",
            "interval_s": (
                self.interval_s if use_tier1
                else self.interval_s * DOWNSAMPLE_EVERY
            ),
            "window_s": window_s,
            "now": now,
            "points": points,
        }

    def latest(self, name: str) -> float | None:
        """Most recent tier-1 value of ``name`` (anomaly rules read
        signals through this)."""
        with self._lock:
            s = self._series.get(name)
            if s is None or not s.tier1:
                return None
            return s.tier1[-1][1]


class MetricsSampler:
    """Named, joinable sampler thread over a :class:`SeriesStore`.

    Every ``interval_s`` (injectable via the store) it runs the
    registry's refresh hooks, folds ``flat_values()`` into the store and
    calls each ``on_sample(now)`` callback. ``sample_once()`` is the
    whole tick, callable directly under a fake clock — the thread adds
    only the wait loop, and ``stop()`` joins it so engine teardown (and
    test churn) never leaks a sampler mutating the shared registry."""

    def __init__(
        self,
        store: SeriesStore,
        registry: MetricsRegistry | None = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.store = store
        self.registry = registry if registry is not None else get_registry()
        self._clock = clock
        self.on_sample: list[Callable[[float], None]] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def sample_once(self, now: float | None = None) -> float:
        """One tick: refresh hooks -> snapshot -> callbacks. Returns the
        tick timestamp."""
        if now is None:
            now = self._clock()
        self.registry.run_refresh_hooks()
        self.store.record(now, self.registry.flat_values())
        for cb in list(self.on_sample):
            try:
                cb(now)
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "series on_sample callback failed"
                )
        return now

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="dllama-series-sampler", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        """Idempotent stop-and-join (server close and test churn both
        call it; a joined sampler cannot race the next ApiState's
        registry writes)."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.store.interval_s):
            try:
                self.sample_once()
            except Exception:  # the sampler must never take down serving
                import logging

                logging.getLogger(__name__).exception(
                    "series sampler tick failed"
                )
