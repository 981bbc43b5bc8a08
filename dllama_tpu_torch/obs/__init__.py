"""Serving observability of the port: metrics, traces, spans, SLOs, the
watchdog, the anomaly monitor, step cost and device memory.

The port's copy of dllama_tpu/obs/ (its ``__all__`` too). The stdlib-only
modules are copies (``metrics``, ``recorder``, ``trace``, ``spans``,
``slo``, ``timeseries``, ``anomaly``, ``watchdog``, ``dashboard``), each
with its own process-wide singletons, apart from the JAX package's.
``cost`` and ``device`` are rewrites: the step costs come from the port's
own layouts and the card's name, the memory from
``torch.cuda.memory_stats`` (see each module). Importing the package
needs neither a card nor triton nor nvcc.

All hooks are no-ops when the registry is disabled (``DLLAMA_OBS=0`` or
``get_registry().disable()``); an enabled histogram observation is an O(1)
bucket increment under a short lock.
"""

from .anomaly import (
    AnomalyMonitor,
    AnomalyRule,
    EwmaBaseline,
    build_default_rules,
)
from .cost import (
    extract_cost,
    hbm_peak_bytes_per_s,
    print_roofline_report,
    roofline_fraction,
    roofline_report,
    weight_bytes_per_token,
)
from .dashboard import DASHBOARD_HTML, render_dashboard
from .device import (
    compare_with_analytic,
    device_memory_stats,
    sample_device_memory,
)
from .metrics import (
    DEFAULT_LATENCY_BUCKETS_S,
    DEFAULT_TOKEN_BUCKETS_S,
    MetricsRegistry,
    get_registry,
)
from .recorder import FlightRecorder, get_recorder
from .slo import SloTracker, resolve_slo_knobs
from .spans import SpanTracker, get_span_tracker
from .timeseries import MetricsSampler, SeriesStore, resolve_series_knobs
from .trace import NULL_SPAN, RequestSpan, Tracer
from .watchdog import EngineWatchdog, resolve_watchdog_knobs

__all__ = [
    "DEFAULT_LATENCY_BUCKETS_S",
    "DEFAULT_TOKEN_BUCKETS_S",
    "MetricsRegistry",
    "get_registry",
    "FlightRecorder",
    "get_recorder",
    "device_memory_stats",
    "sample_device_memory",
    "compare_with_analytic",
    "extract_cost",
    "hbm_peak_bytes_per_s",
    "roofline_fraction",
    "roofline_report",
    "print_roofline_report",
    "weight_bytes_per_token",
    "NULL_SPAN",
    "RequestSpan",
    "Tracer",
    "SpanTracker",
    "get_span_tracker",
    "SloTracker",
    "resolve_slo_knobs",
    "EngineWatchdog",
    "resolve_watchdog_knobs",
    "SeriesStore",
    "MetricsSampler",
    "resolve_series_knobs",
    "AnomalyMonitor",
    "AnomalyRule",
    "EwmaBaseline",
    "build_default_rules",
    "DASHBOARD_HTML",
    "render_dashboard",
]
