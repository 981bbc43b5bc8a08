"""Rolling-baseline anomaly detection over the in-process time-series.

Sarathi-SERVE and Orca both motivate continuous stall/goodput signals as
*scheduler inputs*, not just operator dashboards: a replica that is
quietly degrading (decode stalls creeping up, KV free pages draining,
goodput sagging) should say so before a hard watchdog timeout fires.
This module is that early-warning layer:

* :class:`EwmaBaseline` — exponentially weighted mean + variance of a
  signal; cheap, O(1), no sample storage.
* :class:`AnomalyRule` — one signal: a ``value_fn`` sampled every
  sampler tick, a direction (``high`` = spikes are bad, ``low`` = drops
  are bad), a z-score threshold against the EWMA baseline, absolute /
  relative deviation guards (so a near-constant baseline's tiny variance
  cannot turn noise into alarms), a warmup sample count, and a recovery
  hysteresis (``recover_ticks`` consecutive calm ticks to clear).
* :class:`AnomalyMonitor` — evaluates every rule once per sampler tick
  (wired as a ``MetricsSampler.on_sample`` callback). Edge-triggered
  like the watchdog: the calm -> anomalous transition increments
  ``dllama_anomaly_total{signal=}``, sets ``dllama_anomaly_degraded``,
  and records an ``anomaly`` flight-recorder event; recovery records
  ``anomaly_recovered``. While a rule is firing its baseline is FROZEN —
  an anomaly must not teach the baseline that anomalous is normal.

:func:`build_default_rules` wires the four production signals — decode
stall per dispatch, TTFT and TPOT per-request rates, KV free-page slope,
and 1-minute goodput — against a :class:`~.timeseries.SeriesStore`.
``/v1/health`` reports ``status: degraded`` while EITHER the watchdog or
this monitor is degraded, listing both sources' reasons.
"""

from __future__ import annotations

import math
import time
from typing import Callable

from ..analysis.lockwatch import make_lock
from .metrics import MetricsRegistry, get_registry
from .recorder import FlightRecorder, get_recorder
from .timeseries import SeriesStore


class EwmaBaseline:
    """EWMA mean/variance of a scalar signal (West-style update)."""

    __slots__ = ("alpha", "mean", "var", "n")

    def __init__(self, alpha: float = 0.05) -> None:
        self.alpha = float(alpha)
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def update(self, value: float) -> None:
        if self.n == 0:
            self.mean = value
            self.var = 0.0
        else:
            delta = value - self.mean
            incr = self.alpha * delta
            self.mean += incr
            self.var = (1.0 - self.alpha) * (self.var + delta * incr)
        self.n += 1

    @property
    def std(self) -> float:
        return math.sqrt(self.var) if self.var > 0.0 else 0.0


class AnomalyRule:
    """One monitored signal; see module docstring for the semantics."""

    def __init__(
        self,
        signal: str,
        value_fn: Callable[[], float | None],
        direction: str = "high",
        z_threshold: float = 4.0,
        min_samples: int = 30,
        min_abs: float = 0.0,
        rel_frac: float = 0.0,
        min_mean: float | None = None,
        std_floor: float = 1e-6,
        recover_ticks: int = 5,
        alpha: float = 0.05,
    ) -> None:
        if direction not in ("high", "low"):
            raise ValueError(f"direction {direction!r} not in ('high','low')")
        self.signal = signal
        self.value_fn = value_fn
        self.direction = direction
        self.z_threshold = float(z_threshold)
        self.min_samples = int(min_samples)
        self.min_abs = float(min_abs)
        self.rel_frac = float(rel_frac)
        # None = no baseline-level guard: slope-style "low" signals have
        # legitimately zero/negative baseline means (steady drain)
        self.min_mean = None if min_mean is None else float(min_mean)
        self.std_floor = float(std_floor)
        self.recover_ticks = int(recover_ticks)
        self.alpha = float(alpha)

    def abnormal(self, baseline: EwmaBaseline, value: float) -> float | None:
        """The signal's z-score when ``value`` trips this rule against
        ``baseline``, else None. Guards: warmup, absolute and relative
        deviation floors, and (for ``low``) a minimum baseline level so
        an idle signal sitting at zero can never "drop"."""
        if baseline.n < self.min_samples:
            return None
        mean = baseline.mean
        std = max(baseline.std, self.std_floor)
        dev = value - mean if self.direction == "high" else mean - value
        if (
            self.direction == "low"
            and self.min_mean is not None
            and mean < self.min_mean
        ):
            return None
        if dev < self.min_abs or dev < self.rel_frac * abs(mean):
            return None
        z = dev / std
        return z if z >= self.z_threshold else None


class _RuleState:
    __slots__ = ("baseline", "active", "calm", "since", "detail")

    def __init__(self, alpha: float) -> None:
        self.baseline = EwmaBaseline(alpha)
        self.active = False
        self.calm = 0
        self.since: float | None = None
        self.detail: dict[str, object] | None = None


class AnomalyMonitor:
    """Edge-triggered rolling-baseline anomaly detection over a rule
    set; evaluated once per sampler tick (see module docstring)."""

    def __init__(
        self,
        rules: list[AnomalyRule],
        registry: MetricsRegistry | None = None,
        recorder: FlightRecorder | None = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.rules = list(rules)
        self._clock = clock
        self.recorder = recorder if recorder is not None else get_recorder()
        obs = registry if registry is not None else get_registry()
        self.m_anomalies = obs.counter(
            "dllama_anomaly_total",
            "Anomaly episodes by signal (decode_stall / ttft / tpot / "
            "kv_free_slope / goodput): the signal left its rolling EWMA "
            "baseline past the rule's z-score threshold.",
            labelnames=("signal",),
        )
        self.g_degraded = obs.gauge(
            "dllama_anomaly_degraded",
            "1 while any anomaly rule is firing (/v1/health reports "
            "status=degraded with the active signals), else 0.",
        )
        self._lock = make_lock("obs.anomaly")
        self._state: dict[str, _RuleState] = {
            r.signal: _RuleState(r.alpha) for r in self.rules
        }

    # -- evaluation (sampler tick) ----------------------------------------

    def evaluate(self, now: float | None = None) -> list[str]:
        """One pass over every rule; returns the signals that FIRED on
        this tick (edge, not level)."""
        if now is None:
            now = self._clock()
        fired: list[str] = []
        recovered: list[str] = []
        for rule in self.rules:
            try:
                value = rule.value_fn()
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "anomaly value_fn for %r failed", rule.signal
                )
                continue
            with self._lock:
                st = self._state[rule.signal]
                if st.active:
                    # a missing sample (no traffic this tick) is a calm
                    # tick: the abnormal signal is gone
                    z = (
                        rule.abnormal(st.baseline, value)
                        if value is not None
                        else None
                    )
                    if z is not None:
                        st.calm = 0
                    else:
                        st.calm += 1
                        if st.calm >= rule.recover_ticks:
                            st.active = False
                            st.since = None
                            st.detail = None
                            st.calm = 0
                            recovered.append(rule.signal)
                    continue
                if value is None:
                    continue
                z = rule.abnormal(st.baseline, value)
                if z is not None:
                    st.active = True
                    st.calm = 0
                    st.since = now
                    st.detail = {
                        "signal": rule.signal,
                        "value": round(value, 6),
                        "baseline_mean": round(st.baseline.mean, 6),
                        "z": round(z, 2),
                    }
                    fired.append(rule.signal)
                else:
                    # calm ticks teach the baseline; anomalous (and
                    # frozen-while-active) ones never do
                    st.baseline.update(value)
        for signal in fired:
            self.m_anomalies.labels(signal=signal).inc()
            with self._lock:
                detail = self._state[signal].detail
            self.recorder.record("anomaly", **(detail or {"signal": signal}))
        for signal in recovered:
            self.recorder.record("anomaly_recovered", signal=signal)
        if fired or recovered:
            self.g_degraded.set(1.0 if self.degraded else 0.0)
        return fired

    # -- status ------------------------------------------------------------

    @property
    def degraded(self) -> bool:
        with self._lock:
            return any(st.active for st in self._state.values())

    def active_signals(self) -> list[str]:
        with self._lock:
            return sorted(
                s for s, st in self._state.items() if st.active
            )

    def status(self) -> dict[str, object]:
        now = self._clock()
        with self._lock:
            active = {}
            for signal, st in self._state.items():
                if not st.active:
                    continue
                detail = dict(st.detail or {})
                if st.since is not None:
                    detail["active_s"] = round(now - st.since, 3)
                active[signal] = detail
            return {
                "enabled": True,
                "degraded": bool(active),
                "active": active,
                "n_rules": len(self.rules),
                "baselines": {
                    s: {
                        "n": st.baseline.n,
                        "mean": round(st.baseline.mean, 6),
                        "std": round(st.baseline.std, 6),
                    }
                    for s, st in self._state.items()
                },
            }


# -- default production rule set ------------------------------------------


def _per_event_rate(
    store: SeriesStore, sum_name: str, count_name: str
) -> Callable[[], float | None]:
    """Per-tick mean of a histogram signal: delta(sum)/delta(count) since
    the previous tick, None on ticks with no new observations (the rule
    then neither fires nor learns)."""
    prev: dict[str, float | None] = {"sum": None, "count": None}

    def fn() -> float | None:
        s = store.latest(sum_name)
        c = store.latest(count_name)
        if s is None or c is None:
            return None
        ps, pc = prev["sum"], prev["count"]
        prev["sum"], prev["count"] = s, c
        if ps is None or pc is None or c <= pc:
            return None
        return (s - ps) / (c - pc)

    return fn


def _slope(store: SeriesStore, name: str) -> Callable[[], float | None]:
    """Per-tick delta of a gauge (its discrete slope)."""
    prev: dict[str, float | None] = {"v": None}

    def fn() -> float | None:
        v = store.latest(name)
        if v is None:
            return None
        pv = prev["v"]
        prev["v"] = v
        if pv is None:
            return None
        return v - pv

    return fn


def _level(store: SeriesStore, name: str) -> Callable[[], float | None]:
    def fn() -> float | None:
        return store.latest(name)

    return fn


# public value-fn builders: external rule sets (fleet/obs.py builds its
# fleet-level rules over the router's series store) compose the same
# primitives the default rules use
level = _level
slope = _slope
per_event_rate = _per_event_rate


# the series behind the default rules, in one place: postmortem dumps
# embed the trailing window of exactly these signals (obs/recorder.py
# context providers), so a ring dump carries the same evidence the live
# anomaly monitor would have been looking at
DEFAULT_SIGNAL_SERIES = (
    "dllama_decode_stall_seconds_sum",
    "dllama_decode_stall_seconds_count",
    "dllama_ttft_seconds_sum",
    "dllama_ttft_seconds_count",
    "dllama_tpot_seconds_sum",
    "dllama_tpot_seconds_count",
    "dllama_kv_pages_free",
    'dllama_slo_goodput_tokens_per_s{window="1m"}',
    'dllama_admission_predict_error_ms_sum{signal="ttft"}',
    'dllama_admission_predict_error_ms_count{signal="ttft"}',
)


def build_default_rules(store: SeriesStore) -> list[AnomalyRule]:
    """The production signal set, reading the series the sampler just
    recorded (the monitor runs as an ``on_sample`` callback, after the
    tick's values land in the store):

    * ``decode_stall`` — mean inter-dispatch stall per decode block this
      tick spiking over its baseline (an admission storm or host hiccup
      a streaming client feels);
    * ``ttft`` / ``tpot`` — per-request first-token and per-token
      latency rates creeping up;
    * ``kv_free_slope`` — the paged-KV free list draining persistently
      faster than its baseline churn (a retain leak or runaway fanout
      exhausts the pool long before allocation actually fails);
    * ``goodput`` — the 1-minute SLO-met tokens/s dropping far below its
      baseline while the engine is supposed to be under load;
    * ``predict_error`` — the predictive admission controller's mean
      TTFT forecast error blowing up over its baseline: the EWMA
      self-calibration (runtime/admission.py) should keep this bounded,
      so a sustained spike means the predictor is steering admission /
      EDF ordering / preemption with a broken model of the machine. The
      lane server scores a forecast at every clean finish, with predictive
      mode on or off (``dllama_admission_predict_error_ms``), so the
      series this rule reads exist once a request has finished.
    """
    return [
        AnomalyRule(
            "decode_stall",
            _per_event_rate(
                store,
                "dllama_decode_stall_seconds_sum",
                "dllama_decode_stall_seconds_count",
            ),
            direction="high",
            z_threshold=4.0,
            min_abs=0.05,
            rel_frac=1.0,
            min_samples=30,
        ),
        AnomalyRule(
            "ttft",
            _per_event_rate(
                store, "dllama_ttft_seconds_sum", "dllama_ttft_seconds_count"
            ),
            direction="high",
            z_threshold=4.0,
            min_abs=0.25,
            rel_frac=1.0,
            min_samples=30,
        ),
        AnomalyRule(
            "tpot",
            _per_event_rate(
                store, "dllama_tpot_seconds_sum", "dllama_tpot_seconds_count"
            ),
            direction="high",
            z_threshold=4.0,
            min_abs=0.02,
            rel_frac=1.0,
            min_samples=30,
        ),
        AnomalyRule(
            "kv_free_slope",
            _slope(store, "dllama_kv_pages_free"),
            direction="low",
            z_threshold=4.0,
            min_abs=1.0,
            min_samples=30,
        ),
        AnomalyRule(
            "goodput",
            _level(store, 'dllama_slo_goodput_tokens_per_s{window="1m"}'),
            direction="low",
            z_threshold=4.0,
            min_mean=1.0,
            rel_frac=0.5,
            min_samples=60,
        ),
        AnomalyRule(
            "predict_error",
            _per_event_rate(
                store,
                'dllama_admission_predict_error_ms_sum{signal="ttft"}',
                'dllama_admission_predict_error_ms_count{signal="ttft"}',
            ),
            direction="high",
            z_threshold=4.0,
            min_abs=50.0,
            rel_frac=2.0,
            min_samples=30,
        ),
    ]
