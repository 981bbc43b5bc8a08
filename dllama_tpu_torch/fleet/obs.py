"""Fleet observability plane: the router-side half of the fleet's
measurement substrate (the port's copy of dllama_tpu/fleet/obs.py, on the
port's obs/ and analysis/lockwatch.py).

Three pieces, all engine-free (the router builds no engine and touches no
card):

* **Metrics re-export + aggregation.** :class:`FleetObs` scrapes every
  replica's ``/metrics`` text, re-exports it with a ``replica`` label
  injected into each series (:func:`relabel_prom_text`), and folds fleet
  aggregates into gauges on the router registry: aggregate goodput
  (sum of per-replica 1-minute SLO goodput), per-replica TPOT p50
  (computed from the scraped histogram buckets,
  :func:`histogram_quantile`), the TPOT skew across replicas, the
  router's affinity hit rate, and replica counts by state. A
  router-side ``obs.timeseries.SeriesStore`` +
  ``MetricsSampler`` samples those aggregates; an
  ``obs.anomaly.AnomalyMonitor`` over
  :func:`build_fleet_rules` (TPOT skew, failover-rate spike,
  fleet-goodput drop) feeds the router's ``/v1/health``
  ``degraded_reasons``.
* **Timeline stitching.** :func:`stitch_timelines` merges the router's
  own Chrome-trace fragment with per-replica ``/v1/debug/timeline``
  fragments into ONE Perfetto-loadable trace: each fragment arrives
  pre-namespaced (``pid_prefix``/``pid_base``, obs/spans.py) and is
  rebased onto the router's epoch via each fragment's
  ``dllama.epoch_unix``, so a mid-stream failover renders as a single
  continuous request across processes with the router's ``failover``
  span attributing the gap.
* **Request ledger.** :class:`RequestLedger` remembers, per router-
  minted request id, the trace id, which replicas served it and every
  failover hop — ``GET /v1/fleet/timeline?request_id=`` uses it to know
  which replicas to ask for fragments.

Scrape re-entrancy: the scrape runs as a keyed registry refresh hook, so
BOTH the router's ``/metrics`` handler and the fleet sampler trigger it.
In the in-process fleet the registry is process-global — a replica
scrape would recurse into the hook — so the hook takes a non-blocking
lock (inner triggers no-op) and throttles to the sampling interval.

Knobs (env, ``DLLAMA_FLEET_OBS_*`` family): ``DLLAMA_FLEET_OBS_INTERVAL_S``
(scrape/sample cadence, default 1 s), ``DLLAMA_FLEET_OBS_RETENTION_S``
(fleet series retention, default 1 h), ``DLLAMA_FLEET_OBS_LEDGER``
(request-ledger capacity, default 512).
"""

from __future__ import annotations

import math
import os
import re
import threading
import time
import urllib.request
from collections import OrderedDict
from typing import Callable

from ..analysis.lockwatch import make_lock
from ..obs.anomaly import AnomalyMonitor, AnomalyRule, level, slope
from ..obs.metrics import MetricsRegistry, get_registry
from ..obs.recorder import FlightRecorder, get_recorder
from ..obs.slo import GOODPUT_METRIC
from ..obs.timeseries import MetricsSampler, SeriesStore
from .replicas import ReplicaRegistry

DEFAULT_OBS_INTERVAL_S = 1.0
DEFAULT_OBS_RETENTION_S = 3600.0
DEFAULT_LEDGER_CAP = 512

# pid namespace stride per stitched fragment: the router keeps pid_base
# 0, replica i gets 100*(i+1) — far above the component pid table
PID_STRIDE = 100


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name, "")
    return float(v) if v else default


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    return int(v) if v else default


def resolve_fleet_obs_knobs(
    interval_s: float | None = None,
    retention_s: float | None = None,
    ledger_cap: int | None = None,
) -> tuple[float, float, int]:
    """Fleet-obs knob resolution, explicit beats ``DLLAMA_FLEET_OBS_*``
    env beats default (the same ladder as the router's fleet knobs)."""
    if interval_s is None:
        interval_s = _env_float(
            "DLLAMA_FLEET_OBS_INTERVAL_S", DEFAULT_OBS_INTERVAL_S
        )
    if retention_s is None:
        retention_s = _env_float(
            "DLLAMA_FLEET_OBS_RETENTION_S", DEFAULT_OBS_RETENTION_S
        )
    if ledger_cap is None:
        ledger_cap = _env_int("DLLAMA_FLEET_OBS_LEDGER", DEFAULT_LEDGER_CAP)
    if interval_s <= 0:
        raise ValueError(f"fleet obs interval must be positive: {interval_s}")
    if ledger_cap < 1:
        raise ValueError(f"fleet obs ledger cap must be >= 1: {ledger_cap}")
    return float(interval_s), float(retention_s), int(ledger_cap)


# ---------------------------------------------------------------------------
# Prometheus text parsing / relabeling
# ---------------------------------------------------------------------------

_SERIES_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)\s*$"
)
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prom_text(text: str) -> list[tuple[str, dict[str, str], float]]:
    """Parse Prometheus exposition text into ``(name, labels, value)``
    triples; comment lines and malformed values are skipped (a replica
    mid-restart must degrade the scrape, never raise)."""
    out: list[tuple[str, dict[str, str], float]] = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SERIES_LINE.match(line)
        if m is None:
            continue
        name, labels_raw, value_raw = m.groups()
        try:
            value = float(value_raw)
        except ValueError:
            continue
        labels = (
            {k: v for k, v in _LABEL.findall(labels_raw)}
            if labels_raw
            else {}
        )
        out.append((name, labels, value))
    return out


def relabel_prom_text(
    text: str, replica: str, skip_prefixes: tuple[str, ...] = ()
) -> str:
    """Re-emit one replica's scrape with ``replica="<name>"`` injected as
    the first label of every series. Comment lines (HELP/TYPE) are
    dropped — N re-exported sections would otherwise repeat them per
    replica, which Prometheus rejects as duplicate metadata."""
    out: list[str] = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SERIES_LINE.match(line)
        if m is None:
            continue
        name, labels_raw, value_raw = m.groups()
        if name.startswith(skip_prefixes):
            continue
        inner = labels_raw[1:-1] if labels_raw else ""
        merged = f'replica="{replica}"' + ("," + inner if inner else "")
        out.append(f"{name}{{{merged}}} {value_raw}")
    return "\n".join(out)


def histogram_quantile(
    series: list[tuple[str, dict[str, str], float]],
    name: str,
    q: float,
) -> float | None:
    """PromQL-style ``histogram_quantile`` over parsed ``_bucket`` lines
    of one (unlabelled beyond ``le``) histogram: linear interpolation
    inside the target cumulative bucket. None when the histogram is
    absent or empty."""
    buckets: list[tuple[float, float]] = []
    for sname, labels, value in series:
        if sname != f"{name}_bucket" or "le" not in labels:
            continue
        le = labels["le"]
        bound = math.inf if le in ("+Inf", "inf") else float(le)
        buckets.append((bound, value))
    if not buckets:
        return None
    buckets.sort(key=lambda b: b[0])
    total = buckets[-1][1]
    if total <= 0:
        return None
    target = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in buckets:
        if cum >= target:
            if math.isinf(bound):
                # everything above the last finite bound: report it
                return prev_bound
            if cum == prev_cum:
                return bound
            frac = (target - prev_cum) / (cum - prev_cum)
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_cum = bound, cum
    return buckets[-1][0] if math.isfinite(buckets[-1][0]) else prev_bound


# ---------------------------------------------------------------------------
# timeline stitching
# ---------------------------------------------------------------------------


def stitch_timelines(
    router_trace: dict, fragments: list[tuple[str, dict]]
) -> dict:
    """Merge the router's Chrome-trace fragment with per-replica
    fragments into one trace. Each fragment must already be namespaced
    (fetched with ``pid_prefix``/``pid_base``); this function only
    rebases timestamps — every fragment's ``ts`` values are seconds
    since ITS tracker's epoch, so the per-fragment ``dllama.epoch_unix``
    anchors translate them all onto the router's timebase."""
    router_meta = router_trace.get("dllama") or {}
    router_epoch = float(router_meta.get("epoch_unix") or 0.0)
    events: list[dict] = list(router_trace.get("traceEvents") or [])
    sources = {
        "router": sum(1 for e in events if e.get("ph") == "X"),
    }
    for name, frag in fragments:
        frag_meta = frag.get("dllama") or {}
        frag_epoch = float(frag_meta.get("epoch_unix") or router_epoch)
        shift_us = (frag_epoch - router_epoch) * 1e6
        n_x = 0
        for ev in frag.get("traceEvents") or []:
            ev = dict(ev)
            if ev.get("ph") == "X":
                n_x += 1
                ev["ts"] = round(float(ev.get("ts") or 0.0) + shift_us, 3)
            events.append(ev)
        sources[name] = n_x
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "dllama": {
            "epoch_unix": router_epoch,
            "n_spans": sum(sources.values()),
            "sources": sources,
        },
    }


# ---------------------------------------------------------------------------
# request ledger
# ---------------------------------------------------------------------------


class RequestLedger:
    """Bounded map of router-minted request id -> fleet routing history
    (trace id, replicas touched in order, failover hops). The stitcher
    reads it to know which replicas hold timeline fragments; old entries
    fall off FIFO so a long-lived router never grows."""

    def __init__(self, capacity: int = DEFAULT_LEDGER_CAP) -> None:
        self.capacity = int(capacity)
        self._lock = make_lock("fleet.ledger")
        self._entries: OrderedDict[str, dict] = OrderedDict()

    def open(self, request_id: str, trace_id: str) -> None:
        with self._lock:
            self._entries[request_id] = {
                "trace_id": trace_id,
                "replicas": [],
                "failovers": [],
            }
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def touch(self, request_id: str, replica: str) -> None:
        """Record that ``replica`` is now serving the request (appended
        only on change, so a retry loop doesn't spam the list)."""
        with self._lock:
            e = self._entries.get(request_id)
            if e is None:
                return
            if not e["replicas"] or e["replicas"][-1] != replica:
                e["replicas"].append(replica)

    def failover(
        self,
        request_id: str,
        from_replica: str,
        reason: str,
        emitted_tokens: int,
        gap_s: float | None = None,
        to_replica: str | None = None,
    ) -> None:
        with self._lock:
            e = self._entries.get(request_id)
            if e is None:
                return
            e["failovers"].append({
                "from": from_replica,
                "to": to_replica,
                "reason": reason,
                "emitted_tokens": emitted_tokens,
                "gap_s": gap_s,
            })

    def close_failover(
        self, request_id: str, to_replica: str, gap_s: float
    ) -> None:
        """Attribute the open (last) failover hop once the sibling
        stream is live: where it landed and how long the gap was."""
        with self._lock:
            e = self._entries.get(request_id)
            if e is None or not e["failovers"]:
                return
            last = e["failovers"][-1]
            if last["to"] is None:
                last["to"] = to_replica
                last["gap_s"] = round(gap_s, 6)

    def get(self, request_id: str) -> dict | None:
        with self._lock:
            e = self._entries.get(request_id)
            if e is None:
                return None
            return {
                "trace_id": e["trace_id"],
                "replicas": list(e["replicas"]),
                "failovers": [dict(f) for f in e["failovers"]],
            }

    def recent(self, n: int = 50) -> list[dict]:
        with self._lock:
            items = list(self._entries.items())[-n:]
        return [
            {
                "request_id": rid,
                "trace_id": e["trace_id"],
                "replicas": list(e["replicas"]),
                "n_failovers": len(e["failovers"]),
            }
            for rid, e in reversed(items)
        ]


# ---------------------------------------------------------------------------
# fleet anomaly rules
# ---------------------------------------------------------------------------

# the fleet aggregate series the default fleet rules watch (the router's
# postmortem evidence window, mirroring obs/anomaly.DEFAULT_SIGNAL_SERIES)
FLEET_SIGNAL_SERIES = (
    "dllama_fleet_goodput_tokens_per_s",
    "dllama_fleet_tpot_skew_ms",
    "dllama_router_failovers_total",
)


def build_fleet_rules(store: SeriesStore) -> list[AnomalyRule]:
    """The fleet-level rule set over the aggregates the scrape just
    folded into the router's series store:

    * ``fleet_tpot_skew`` — one replica's TPOT p50 pulling away from its
      siblings (ms of spread), the canonical sick-replica signature a
      per-replica monitor can't see;
    * ``fleet_failover_rate`` — the failover counter's per-tick slope
      spiking (replica deaths are rare; a burst is an incident);
    * ``fleet_goodput`` — the fleet's aggregate SLO-met tokens/s
      dropping far below baseline while under load.

    Guards are deliberately conservative so seeded chaos (one or two
    injected failovers, bursty test traffic) reads as weather, not an
    incident: the failover rule needs a ≥3-failover burst inside one
    sampling tick, and the goodput rule needs minutes of baseline plus
    a near-total (80%) collapse before firing.
    """
    return [
        AnomalyRule(
            "fleet_tpot_skew",
            level(store, "dllama_fleet_tpot_skew_ms"),
            direction="high",
            z_threshold=4.0,
            min_abs=5.0,
            rel_frac=1.0,
            min_samples=30,
        ),
        AnomalyRule(
            "fleet_failover_rate",
            slope(store, "dllama_router_failovers_total"),
            direction="high",
            z_threshold=4.0,
            min_abs=3.0,
            min_samples=60,
        ),
        AnomalyRule(
            "fleet_goodput",
            level(store, "dllama_fleet_goodput_tokens_per_s"),
            direction="low",
            z_threshold=4.0,
            rel_frac=0.8,
            min_mean=1.0,
            min_samples=120,
        ),
    ]


# ---------------------------------------------------------------------------
# the scraper/aggregator
# ---------------------------------------------------------------------------

_REPLICA_STATES = ("healthy", "degraded", "draining", "dead")


def _default_fetch(url: str) -> str:
    with urllib.request.urlopen(url, timeout=5.0) as r:
        data: bytes = r.read()
    return data.decode("utf-8", "replace")


class FleetObs:
    """Scrape -> relabel -> aggregate -> monitor; see module docstring.

    ``fetch`` and ``clock`` are injectable so the fleet anomaly path is
    coverable by a deterministic fake-clock test (no live replicas, no
    real time): a fake fetch hands back crafted per-replica scrape text
    and ``sample_once(now)`` drives the monitor tick by tick.
    """

    def __init__(
        self,
        replicas: ReplicaRegistry,
        registry: MetricsRegistry | None = None,
        recorder: FlightRecorder | None = None,
        fetch: Callable[[str], str] | None = None,
        clock: Callable[[], float] = time.monotonic,
        interval_s: float | None = None,
        retention_s: float | None = None,
        affinity_rate_fn: Callable[[], float | None] | None = None,
    ) -> None:
        interval, retention, _ = resolve_fleet_obs_knobs(
            interval_s, retention_s
        )
        self.interval_s = interval
        self.replicas = replicas
        self.obs = registry if registry is not None else get_registry()
        self.recorder = recorder if recorder is not None else get_recorder()
        self._fetch = fetch if fetch is not None else _default_fetch
        self._clock = clock
        self._affinity_rate_fn = affinity_rate_fn
        self.store = SeriesStore(
            interval_s=interval,
            retention_s=retention,
            registry=self.obs,
            recorder=self.recorder,
        )
        self.sampler = MetricsSampler(
            self.store, registry=self.obs, clock=clock
        )
        self.monitor = AnomalyMonitor(
            build_fleet_rules(self.store),
            registry=self.obs,
            recorder=self.recorder,
            clock=clock,
        )
        # monitor AFTER the tick's values land in the store (the sampler
        # calls run_refresh_hooks -> the scrape -> flat_values -> record
        # -> on_sample), so every rule reads this tick's aggregates
        self.sampler.on_sample.append(self.monitor.evaluate)
        self.g_goodput = self.obs.gauge(
            "dllama_fleet_goodput_tokens_per_s",
            "Aggregate fleet goodput: sum of every scraped replica's "
            "1-minute SLO-met tokens/s.",
        )
        self.g_replica_goodput = self.obs.gauge(
            "dllama_fleet_replica_goodput_tokens_per_s",
            "Per-replica 1-minute SLO goodput as scraped by the router "
            "(the fleet dashboard's per-replica overlay).",
            labelnames=("replica",),
        )
        self.g_replica_tpot = self.obs.gauge(
            "dllama_fleet_replica_tpot_p50_ms",
            "Per-replica TPOT p50 in ms, computed by the router from "
            "the scraped dllama_tpot_seconds histogram buckets.",
            labelnames=("replica",),
        )
        self.g_tpot_skew = self.obs.gauge(
            "dllama_fleet_tpot_skew_ms",
            "Max minus min per-replica TPOT p50 across the fleet (ms): "
            "the sick-replica spread the fleet_tpot_skew anomaly rule "
            "watches.",
        )
        self.g_affinity_rate = self.obs.gauge(
            "dllama_fleet_affinity_hit_rate",
            "Fraction of routed requests served by their prefix-affinity "
            "target replica (cumulative, from the router's counters).",
        )
        self.g_replicas = self.obs.gauge(
            "dllama_fleet_replicas",
            "Replica count by registry state (healthy / degraded / "
            "draining / dead).",
            labelnames=("state",),
        )
        self.m_scrapes = self.obs.counter(
            "dllama_fleet_scrapes_total",
            "Router scrapes of replica /metrics endpoints by outcome "
            "(ok, error).",
            labelnames=("outcome",),
        )
        # relabeled per-replica sections for the /metrics re-export
        self._sections_lock = make_lock("fleet.obs.sections")
        self._sections: dict[str, str] = {}
        # scrape guard: non-blocking (in-process recursion) + throttled
        self._scrape_lock = threading.Lock()
        self._scrape_last: float | None = None
        self._hook_registered = False

    # -- wiring ------------------------------------------------------------

    def register(self) -> None:
        """Install the scrape as a keyed refresh hook: the router's
        ``/metrics`` handler and the fleet sampler both call
        ``run_refresh_hooks()``, so either keeps the aggregates warm."""
        self.obs.add_refresh_hook("fleet_obs", self._refresh)
        self._hook_registered = True

    def start(self) -> None:
        self.register()
        self.sampler.start()

    def close(self) -> None:
        """Stop the sampler and unhook the scrape (test churn must
        not leak a hook that scrapes dead ports forever)."""
        self.sampler.stop()
        if self._hook_registered:
            self.obs.remove_refresh_hook("fleet_obs")
            self._hook_registered = False

    # -- the scrape --------------------------------------------------------

    def _refresh(self) -> None:
        """Refresh-hook entry: re-entrancy-guarded + throttled. The
        in-process fleet shares ONE registry, so a replica handling our
        scrape GET runs this very hook again — the non-blocking acquire
        turns that inner call into a no-op instead of a recursion."""
        if not self._scrape_lock.acquire(blocking=False):
            return
        try:
            now = self._clock()
            if (
                self._scrape_last is not None
                and now - self._scrape_last < self.interval_s
            ):
                return
            self._scrape_last = now
            self.scrape_once()
        finally:
            self._scrape_lock.release()

    def scrape_once(self) -> dict[str, bool]:
        """Scrape every replica once, rebuild the re-export sections and
        set the fleet aggregate gauges. Returns per-replica success."""
        views = self.replicas.views()
        counts = dict.fromkeys(_REPLICA_STATES, 0)
        for v in views.values():
            counts[v.state] = counts.get(v.state, 0) + 1
        for st, n in counts.items():
            self.g_replicas.labels(state=st).set(float(n))
        per_goodput: dict[str, float] = {}
        per_tpot_ms: dict[str, float] = {}
        ok: dict[str, bool] = {}
        sections: dict[str, str] = {}
        for name in sorted(views):
            url = views[name].base_url
            try:
                text = self._fetch(f"{url}/metrics")
            except (OSError, ValueError) as e:
                ok[name] = False
                self.m_scrapes.labels(outcome="error").inc()
                self.recorder.record(
                    "fleet_scrape_error", replica=name,
                    error=f"{type(e).__name__}: {e}",
                )
                continue
            ok[name] = True
            self.m_scrapes.labels(outcome="ok").inc()
            sections[name] = relabel_prom_text(
                text, name,
                # the in-process fleet's shared registry puts the
                # router's and the fleet's OWN families into every
                # replica scrape; re-exporting those replica-labelled
                # would be recursion in data form
                skip_prefixes=("dllama_router_", "dllama_fleet_"),
            )
            series = parse_prom_text(text)
            for sname, labels, value in series:
                if (
                    sname == GOODPUT_METRIC
                    and labels.get("window") == "1m"
                ):
                    per_goodput[name] = value
            tpot = histogram_quantile(series, "dllama_tpot_seconds", 0.5)
            if tpot is not None:
                per_tpot_ms[name] = tpot * 1000.0
        with self._sections_lock:
            self._sections = sections
        if per_goodput:
            self.g_goodput.set(sum(per_goodput.values()))
        for name, v in per_goodput.items():
            self.g_replica_goodput.labels(replica=name).set(v)
        for name, v in per_tpot_ms.items():
            self.g_replica_tpot.labels(replica=name).set(v)
        if len(per_tpot_ms) >= 2:
            self.g_tpot_skew.set(
                max(per_tpot_ms.values()) - min(per_tpot_ms.values())
            )
        elif per_tpot_ms:
            self.g_tpot_skew.set(0.0)
        if self._affinity_rate_fn is not None:
            rate = self._affinity_rate_fn()
            if rate is not None:
                self.g_affinity_rate.set(rate)
        return ok

    # -- the re-export -----------------------------------------------------

    def render_fleet(self) -> str:
        """The replica-labelled re-export block appended to the router's
        own ``/metrics`` render (values-only lines; HELP/TYPE metadata
        lives on the replicas)."""
        with self._sections_lock:
            sections = dict(self._sections)
        parts = [sections[name] for name in sorted(sections) if sections[name]]
        return "\n".join(parts)
