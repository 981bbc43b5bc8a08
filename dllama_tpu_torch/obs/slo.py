"""Windowed SLO attainment and goodput accounting.

The cumulative-since-boot counters behind ``/metrics`` answer "how has
this process done"; an admission controller or replica router needs "is
the service meeting its latency objectives RIGHT NOW". This module keeps
ring-buffered sliding windows (10s / 1m / 5m) over per-request TTFT /
TPOT / queue-wait samples and per-token completion timestamps, and folds
them into:

* **attainment** — the fraction of requests finishing inside the window
  that met their TTFT / TPOT targets (``--slo-ttft-ms`` /
  ``--slo-tpot-ms``; an unset target is vacuously met, so with no
  targets configured attainment is 1.0 and goodput equals throughput);
* **goodput** — tokens/s counted ONLY from SLO-met requests: the number
  a capacity planner actually cares about (a replica serving 1k tok/s
  at 40% attainment is not a 1k tok/s replica);
* **throughput** — tokens/s over ALL generated tokens in the window,
  from per-token timestamps (so it tracks in-flight streams, not just
  finished ones).

Surfaced three ways: ``dllama_slo_*`` gauges (refreshed at scrape /
snapshot time, one child per window), ``GET /v1/debug/slo``, and a
``slo`` section in the bench's BENCH_SERVING.json.

Thread-safety: requests finish on the scheduler thread while snapshots
run on HTTP handler threads; both sides take one short lock. Sample
rings are bounded deques — a window is additionally truncated by
capacity under extreme rates, which errs toward recency.
"""

from __future__ import annotations

import os
import threading
import time

from collections import deque
from typing import Callable

from .metrics import get_registry

WINDOWS: tuple[tuple[float, str], ...] = (
    (10.0, "10s"), (60.0, "1m"), (300.0, "5m"),
)

# the goodput gauge family name, exported so fleet-level consumers
# (fleet/obs.py scrapes it per replica and sums the 1m window) don't
# hardcode a string that must match the registration below
GOODPUT_METRIC = "dllama_slo_goodput_tokens_per_s"


def _env_float(name: str) -> float | None:
    v = os.environ.get(name, "")
    return float(v) if v else None


def resolve_slo_knobs(
    ttft_ms: float | None = None, tpot_ms: float | None = None
) -> tuple[float | None, float | None]:
    """SLO target resolution, same precedence as the lane knobs: explicit
    (CLI flag) beats env (DLLAMA_SLO_TTFT_MS / DLLAMA_SLO_TPOT_MS) beats
    the default (no target; attainment is then vacuously 1.0)."""
    if ttft_ms is None:
        ttft_ms = _env_float("DLLAMA_SLO_TTFT_MS")
    if tpot_ms is None:
        tpot_ms = _env_float("DLLAMA_SLO_TPOT_MS")
    return ttft_ms, tpot_ms


class SloTracker:
    """Sliding-window SLO/goodput accounting; see module docstring."""

    def __init__(
        self,
        ttft_target_ms: float | None = None,
        tpot_target_ms: float | None = None,
        registry: object | None = None,
        clock: Callable[[], float] = time.monotonic,
        max_requests: int = 4096,
        max_token_events: int = 16384,
    ) -> None:
        self.ttft_target_ms = ttft_target_ms
        self.tpot_target_ms = tpot_target_ms
        self._clock = clock
        self._lock = threading.Lock()
        # (t_finish, ttft_s|None, tpot_s|None, queue_wait_s|None,
        #  n_tokens, slo_met)
        self._requests: deque = deque(maxlen=max_requests)
        self._tokens: deque = deque(maxlen=max_token_events)  # (t, n)
        obs = registry if registry is not None else get_registry()
        self.g_ttft_att = obs.gauge(
            "dllama_slo_ttft_attainment",
            "Fraction of requests finishing inside the window whose TTFT "
            "met the --slo-ttft-ms target (1.0 when no target is set).",
            labelnames=("window",),
        )
        self.g_tpot_att = obs.gauge(
            "dllama_slo_tpot_attainment",
            "Fraction of requests finishing inside the window whose mean "
            "TPOT met the --slo-tpot-ms target (1.0 when no target is "
            "set).",
            labelnames=("window",),
        )
        self.g_att = obs.gauge(
            "dllama_slo_attainment",
            "Fraction of requests finishing inside the window that met "
            "ALL configured SLO targets.",
            labelnames=("window",),
        )
        # NOTE: literal name (not GOODPUT_METRIC) so the metrics-docs
        # lint sees the registration; the constant mirrors it for readers
        self.g_goodput = obs.gauge(
            "dllama_slo_goodput_tokens_per_s",
            "Completion tokens/s inside the window counting ONLY requests "
            "that met their SLO targets.",
            labelnames=("window",),
        )
        self.g_throughput = obs.gauge(
            "dllama_slo_throughput_tokens_per_s",
            "Completion tokens/s inside the window over ALL streams "
            "(per-token timestamps, so in-flight streams count).",
            labelnames=("window",),
        )
        self.g_requests = obs.gauge(
            "dllama_slo_window_requests",
            "Requests that finished inside the window.",
            labelnames=("window",),
        )

    # -- recording ---------------------------------------------------------

    def observe_request(
        self,
        ttft_s: float | None,
        tpot_s: float | None,
        queue_wait_s: float | None = None,
        n_tokens: int = 0,
        deadline_ms: float | None = None,
        total_s: float | None = None,
    ) -> bool:
        """One finished request; returns whether it met its targets. A
        missing sample (e.g. TTFT on a zero-token stream) only violates a
        target that is actually configured. A per-request ``deadline_ms``
        hint (predictive admission) is an additional target for
        THIS request only: blowing it makes the request SLO-unmet (its
        tokens drop out of goodput) even when the global targets pass."""
        met = True
        if self.ttft_target_ms is not None:
            met = ttft_s is not None and ttft_s * 1000.0 <= self.ttft_target_ms
        if met and self.tpot_target_ms is not None and tpot_s is not None:
            met = tpot_s * 1000.0 <= self.tpot_target_ms
        if met and deadline_ms is not None and total_s is not None:
            met = total_s * 1000.0 <= deadline_ms
        with self._lock:
            self._requests.append(
                (self._clock(), ttft_s, tpot_s, queue_wait_s,
                 int(n_tokens), met)
            )
        return met

    def observe_span(
        self, span: object, deadline_ms: float | None = None
    ) -> bool | None:
        """Record a finished :class:`~dllama_tpu_torch.obs.trace.RequestSpan`.
        Only clean finishes (stop/length) count toward attainment —
        a cancelled stream says nothing about the service's latency."""
        if span.finish_reason not in ("stop", "length"):
            return None
        n = span.n_completion or 0
        tpot_s = None
        if (span.total_s is not None and span.ttft_s is not None and n > 1):
            tpot_s = (span.total_s - span.ttft_s) / (n - 1)
        return self.observe_request(
            span.ttft_s, tpot_s, span.queue_wait_s, n_tokens=n,
            deadline_ms=deadline_ms, total_s=span.total_s,
        )

    def note_tokens(self, n: int = 1) -> None:
        """Timestamp ``n`` freshly generated tokens (throughput rides on
        these, so mid-stream tokens count before the request finishes)."""
        if n <= 0:
            return
        with self._lock:
            self._tokens.append((self._clock(), n))

    # -- windows -----------------------------------------------------------

    def snapshot(self) -> dict:
        """Per-window attainment/goodput/throughput; also refreshes every
        ``dllama_slo_*`` gauge (called at scrape time and by the debug
        endpoint)."""
        now = self._clock()
        with self._lock:
            requests = list(self._requests)
            tokens = list(self._tokens)
        windows: dict[str, dict] = {}
        for win_s, label in WINDOWS:
            cutoff = now - win_s
            reqs = [r for r in requests if r[0] >= cutoff]
            n = len(reqs)
            n_ttft_met = n_tpot_met = n_met = 0
            good_tokens = 0
            ttfts: list[float] = []
            for _, ttft_s, tpot_s, _qw, n_tok, met in reqs:
                ttft_ok = (
                    self.ttft_target_ms is None
                    or (ttft_s is not None
                        and ttft_s * 1000.0 <= self.ttft_target_ms)
                )
                tpot_ok = (
                    self.tpot_target_ms is None
                    or tpot_s is None
                    or tpot_s * 1000.0 <= self.tpot_target_ms
                )
                n_ttft_met += ttft_ok
                n_tpot_met += tpot_ok
                if met:
                    n_met += 1
                    good_tokens += n_tok
                if ttft_s is not None:
                    ttfts.append(ttft_s)
            n_window_tokens = sum(
                tn for tt, tn in tokens if tt >= cutoff
            )
            # attainment over zero requests is vacuous: report 1.0 so the
            # gauges stay finite for dashboards and the bench asserts
            ttft_att = n_ttft_met / n if n else 1.0
            tpot_att = n_tpot_met / n if n else 1.0
            att = n_met / n if n else 1.0
            goodput = good_tokens / win_s
            throughput = n_window_tokens / win_s
            ttfts.sort()
            windows[label] = {
                "window_s": win_s,
                "n_requests": n,
                "n_met": n_met,
                "ttft_attainment": round(ttft_att, 4),
                "tpot_attainment": round(tpot_att, 4),
                "attainment": round(att, 4),
                "goodput_tokens_per_s": round(goodput, 3),
                "throughput_tokens_per_s": round(throughput, 3),
                "ttft_p50_ms": (
                    round(ttfts[len(ttfts) // 2] * 1000.0, 3)
                    if ttfts else None
                ),
            }
            self.g_ttft_att.labels(window=label).set(ttft_att)
            self.g_tpot_att.labels(window=label).set(tpot_att)
            self.g_att.labels(window=label).set(att)
            self.g_goodput.labels(window=label).set(goodput)
            self.g_throughput.labels(window=label).set(throughput)
            self.g_requests.labels(window=label).set(n)
        return {
            "targets": {
                "ttft_ms": self.ttft_target_ms,
                "tpot_ms": self.tpot_target_ms,
            },
            "windows": windows,
        }
