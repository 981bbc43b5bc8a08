"""Thread-safe metrics registry with Prometheus text-format rendering.

Counters, gauges, and fixed-bucket histograms — the stdlib-only subset of
a Prometheus client that the serving path needs. Design constraints:

* **Negligible overhead.** A histogram observation is one ``bisect`` into
  a fixed bucket list plus an increment, under a lock held only for that
  observation; when the registry is disabled every mutate call returns
  before taking the lock, so instrumentation hooks cost one attribute
  read on the cold path.
* **Idempotent registration.** ``registry.counter(name)`` returns the
  existing family when `name` was already registered (the API server and
  engine are built many times per test process against the shared default
  registry); re-registering under a different metric type raises.
* **Valid scrape output.** ``render()`` emits Prometheus text format
  0.0.4 (``# HELP``/``# TYPE`` per family, cumulative ``_bucket{le=}``
  rows + ``_sum``/``_count`` for histograms) so a stock Prometheus server
  can scrape ``GET /metrics`` unmodified.
* **One refresh path.** Gauges that are computed on demand (the windowed
  ``dllama_slo_*`` values, per-chip device memory, compiled-step cost)
  register a named *refresh hook* on the registry; every reader that
  wants current values — the ``/metrics`` scrape handler AND the
  time-series sampler (``timeseries.py``) — calls
  ``run_refresh_hooks()`` first. Before this existed the refresh lived
  inside the scrape handler only, so any non-scrape reader saw whatever
  the last scrape left behind (a stale-gauge bug).
"""

from __future__ import annotations

import logging
import os
import threading
from bisect import bisect_left
from typing import Callable, Sequence

# serving latencies (TTFT, queue wait, prefill, dispatch): 1 ms .. 60 s
DEFAULT_LATENCY_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
# per-token decode latency (TPOT): 0.5 ms .. 1 s
DEFAULT_TOKEN_BUCKETS_S = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
)


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats as repr."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Counter:
    __slots__ = ("_family", "_value")

    def __init__(self, family: "_Family") -> None:
        self._family = family
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        reg = self._family.registry
        if not reg.enabled:
            return
        with reg._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class _Gauge:
    __slots__ = ("_family", "_value")

    def __init__(self, family: "_Family") -> None:
        self._family = family
        self._value = 0.0

    def set(self, value: float) -> None:
        reg = self._family.registry
        if not reg.enabled:
            return
        with reg._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        reg = self._family.registry
        if not reg.enabled:
            return
        with reg._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class _Histogram:
    __slots__ = ("_family", "_counts", "_sum", "_count")

    def __init__(self, family: "_Family") -> None:
        self._family = family
        # one slot per bucket + the +Inf overflow slot
        self._counts = [0] * (len(family.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        reg = self._family.registry
        if not reg.enabled:
            return
        idx = bisect_left(self._family.buckets, value)  # le is inclusive
        with reg._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> float | None:
        """Estimate the ``q``-quantile (q in [0, 1]) by linear
        interpolation inside the bucket holding the target rank — the
        single shared implementation the watchdog and the SLO windows
        read p99 block time from. Returns None with no observations.
        Samples beyond the last finite bucket clamp to its edge (the
        +Inf bucket has no upper edge to interpolate toward)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        reg = self._family.registry
        with reg._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return None
        buckets = self._family.buckets
        target = q * total
        cum = 0.0
        for i, n in enumerate(counts[:-1]):
            prev = cum
            cum += n
            if cum >= target:
                lo = buckets[i - 1] if i > 0 else 0.0
                hi = buckets[i]
                if n == 0:
                    return hi
                return lo + (hi - lo) * (target - prev) / n
        return buckets[-1] if buckets else None


_CHILD_TYPES = {"counter": _Counter, "gauge": _Gauge, "histogram": _Histogram}


class _Family:
    """One named metric family; children are keyed by label-value tuples.
    A family declared without labelnames has a single default child and
    proxies ``inc``/``set``/``dec``/``observe`` straight to it."""

    def __init__(self, registry, name, help_, mtype, labelnames, buckets):
        self.registry = registry
        self.name = name
        self.help = help_
        self.type = mtype
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets) if buckets else ()
        self._children: dict[tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = _CHILD_TYPES[mtype](self)

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(kv)}"
            )
        key = tuple(str(kv[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self.registry._lock:
                child = self._children.setdefault(
                    key, _CHILD_TYPES[self.type](self)
                )
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use .labels()"
            )
        return self._children[()]

    # no-label conveniences
    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def set(self, value: float) -> None:
        self._default().set(value)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    @property
    def value(self):
        return self._default().value

    @property
    def count(self):
        return self._default().count

    @property
    def sum(self):
        return self._default().sum

    def percentile(self, q: float) -> float | None:
        return self._default().percentile(q)

    def child_values(self) -> dict[tuple[str, ...], float]:
        return {k: c.value for k, c in sorted(self._children.items())
                if not isinstance(c, _Histogram)}

    def _label_str(self, key: tuple[str, ...], extra: str = "") -> str:
        parts = [
            f'{n}="{_escape_label(v)}"' for n, v in zip(self.labelnames, key)
        ]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self, out: list[str]) -> None:
        out.append(f"# HELP {self.name} {_escape_help(self.help)}")
        out.append(f"# TYPE {self.name} {self.type}")
        for key in sorted(self._children):
            child = self._children[key]
            if self.type == "histogram":
                cum = 0
                for le, n in zip(self.buckets, child._counts):
                    cum += n
                    le_lbl = 'le="' + _fmt(le) + '"'
                    out.append(
                        f"{self.name}_bucket"
                        f"{self._label_str(key, le_lbl)} {cum}"
                    )
                cum += child._counts[-1]
                inf_lbl = 'le="+Inf"'
                out.append(
                    f"{self.name}_bucket"
                    f"{self._label_str(key, inf_lbl)} {cum}"
                )
                out.append(
                    f"{self.name}_sum{self._label_str(key)} "
                    f"{_fmt(child._sum)}"
                )
                out.append(
                    f"{self.name}_count{self._label_str(key)} {child._count}"
                )
            else:
                out.append(
                    f"{self.name}{self._label_str(key)} {_fmt(child.value)}"
                )


# histogram quantiles the sampler snapshots per family child (series
# names: <name>_p50{...} / <name>_p99{...}, gauge-kind)
SAMPLE_QUANTILES: tuple[tuple[float, str], ...] = ((0.5, "p50"), (0.99, "p99"))


class MetricsRegistry:
    """Thread-safe registry of metric families; see module docstring."""

    CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._lock = threading.RLock()
        self._families: dict[str, _Family] = {}
        # name -> callable; insertion-ordered, keyed so rebuilding an
        # ApiState/engine against the shared default registry REPLACES
        # its hook instead of stacking a dead closure per rebuild
        self._refresh_hooks: dict[str, Callable[[], object]] = {}

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def _get(
        self,
        name: str,
        help_: str,
        mtype: str,
        labelnames: Sequence[str],
        buckets: Sequence[float] | None = None,
    ) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != mtype:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.type}, "
                        f"cannot re-register as {mtype}"
                    )
                return fam
            fam = _Family(self, name, help_, mtype, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> _Family:
        return self._get(name, help, "counter", labelnames)

    def gauge(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> _Family:
        return self._get(name, help, "gauge", labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
    ) -> _Family:
        return self._get(name, help, "histogram", labelnames, buckets)

    # -- refresh hooks -----------------------------------------------------

    def add_refresh_hook(self, name: str, fn: Callable[[], object]) -> None:
        """Register (or replace) the named on-demand gauge refresher.
        Hooks run in registration order from ``run_refresh_hooks()``."""
        with self._lock:
            self._refresh_hooks[name] = fn

    def remove_refresh_hook(self, name: str) -> None:
        with self._lock:
            self._refresh_hooks.pop(name, None)

    def run_refresh_hooks(self) -> None:
        """Bring every on-demand gauge current. Called by BOTH readers —
        the ``/metrics`` scrape handler and the time-series sampler — so
        they see the same values. Hooks run outside the registry lock
        (they set gauges, which retakes it) and a failing hook logs and
        is skipped: one broken refresher must not take down the scrape
        or the sampler thread."""
        if not self.enabled:
            return
        with self._lock:
            hooks = list(self._refresh_hooks.items())
        for name, fn in hooks:
            try:
                fn()
            except Exception:
                logging.getLogger(__name__).exception(
                    "metrics refresh hook %r failed", name
                )

    def render(self) -> str:
        out: list[str] = []
        with self._lock:
            for fam in self._families.values():
                fam.render(out)
        return "\n".join(out) + "\n" if out else ""

    def flat_values(self) -> dict[str, tuple[str, float]]:
        """Every current sample as ``series name -> (kind, value)`` — the
        time-series sampler's view of the registry. Counters and gauges
        contribute one entry per labelled child
        (``name{label="v"}``); a histogram child contributes its
        cumulative ``_count``/``_sum`` (counter-kind, rate-able) plus the
        :data:`SAMPLE_QUANTILES` estimates (``_p50``/``_p99``,
        gauge-kind). Does NOT run the refresh hooks — callers that want
        current on-demand gauges call :meth:`run_refresh_hooks` first."""
        out: dict[str, tuple[str, float]] = {}
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            with self._lock:
                children = sorted(fam._children.items())
            for key, child in children:
                labels = fam._label_str(key)
                if isinstance(child, _Histogram):
                    out[f"{fam.name}_count{labels}"] = (
                        "counter", float(child.count),
                    )
                    out[f"{fam.name}_sum{labels}"] = (
                        "counter", float(child.sum),
                    )
                    for q, suffix in SAMPLE_QUANTILES:
                        v = child.percentile(q)
                        if v is not None:
                            out[f"{fam.name}_{suffix}{labels}"] = (
                                "gauge", float(v),
                            )
                else:
                    out[f"{fam.name}{labels}"] = (fam.type, float(child.value))
        return out

    def reset(self) -> None:
        """Drop all families and refresh hooks (tests/bench only — live
        scrapers rely on counters being monotonic for the process
        lifetime)."""
        with self._lock:
            self._families.clear()
            self._refresh_hooks.clear()


_DEFAULT = MetricsRegistry(enabled=os.environ.get("DLLAMA_OBS", "1") != "0")


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (what `/metrics` serves)."""
    return _DEFAULT
