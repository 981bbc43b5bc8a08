"""Device memory telemetry: what the card actually holds.

`memory_report` is the ANALYTIC accounting: the bytes the engine allocates
on purpose (its parameters, the slab caches (the single stream's and the
slab lanes'), the lanes' page pool with an
int8 pool's scales, the graphs' static buffers and private pool). This
module reads the caching allocator's own ledger through
``torch.cuda.memory_stats`` so creeping allocations (a leaked buffer, a
graph pool that keeps growing) show up as a divergence instead of an OOM
three hours into a serving run.

The three fields per card: ``bytes_in_use`` is
``allocated_bytes.all.current``, ``peak_bytes_in_use``
``allocated_bytes.all.peak`` and ``bytes_limit`` the card's
``total_memory``. These are the allocator's host-side counters: reading
them neither synchronises nor allocates on the card, so the ``/metrics``
refresh hooks may call them from any thread. The CPU has no such ledger
and degrades to an explicit ``available: false`` marker, never an
exception, so the same code path serves the CPU tests and the card.
"""

from __future__ import annotations

import dataclasses
import logging

from .metrics import get_registry

logger = logging.getLogger(__name__)

# analytic-vs-measured divergence beyond this fraction logs a warning
DIVERGENCE_WARN_FRACTION = 0.10


def device_memory_stats(device=None) -> list[dict]:
    """Memory snapshot of ``device`` (a torch device or name; None: the
    current CUDA device, or the CPU without one), one entry. The CPU
    entry carries ``available: False``."""
    import torch

    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    entry = {"device": str(dev), "platform": dev.type, "available": False}
    if dev.type != "cuda":
        return [entry]
    try:
        stats = torch.cuda.memory_stats(dev)
        limit = torch.cuda.get_device_properties(dev).total_memory
    except Exception:
        return [entry]
    entry.update(
        available=True,
        bytes_in_use=int(stats.get("allocated_bytes.all.current", 0)),
        peak_bytes_in_use=int(stats.get("allocated_bytes.all.peak", 0)),
        bytes_limit=int(limit),
    )
    return [entry]


def sample_device_memory(registry: object | None = None, device=None) -> list[dict]:
    """Snapshot ``device_memory_stats()`` into registry gauges
    (``dllama_device_bytes_in_use`` / ``_peak_bytes_in_use`` /
    ``_bytes_limit``, labeled by device) and return the snapshot. On the
    CPU the gauges are simply never set."""
    reg = registry if registry is not None else get_registry()
    g_use = reg.gauge(
        "dllama_device_bytes_in_use",
        "Device bytes currently allocated, per card "
        "(torch.cuda.memory_stats; absent on the CPU).",
        labelnames=("device",),
    )
    g_peak = reg.gauge(
        "dllama_device_peak_bytes_in_use",
        "High-water-mark of device bytes allocated, per card.",
        labelnames=("device",),
    )
    g_limit = reg.gauge(
        "dllama_device_bytes_limit",
        "Device memory capacity (total_memory), per card.",
        labelnames=("device",),
    )
    stats = device_memory_stats(device)
    for s in stats:
        if not s["available"]:
            continue
        g_use.labels(device=s["device"]).set(s["bytes_in_use"])
        g_peak.labels(device=s["device"]).set(s["peak_bytes_in_use"])
        g_limit.labels(device=s["device"]).set(s["bytes_limit"])
    return stats


def compare_with_analytic(
    analytic_per_chip_bytes: int,
    stats: list[dict] | None = None,
    warn_fraction: float = DIVERGENCE_WARN_FRACTION,
) -> dict:
    """Measured bytes-in-use per chip vs the analytic per-chip figure
    from ``memory_report``. Logs a warning past ``warn_fraction`` (runtime
    holding meaningfully more than the model accounts for = a leak or an
    unplanned allocation; meaningfully less = the analytic model itself
    drifted). Returns a JSON-ready comparison (``/v1/debug/memory`` embeds
    it)."""
    if stats is None:
        stats = device_memory_stats()
    measured = [s for s in stats if s["available"]]
    if not measured or analytic_per_chip_bytes <= 0:
        return {
            "available": False,
            "analytic_per_chip_bytes": int(analytic_per_chip_bytes),
            "max_divergence_fraction": None,
            "per_chip": [],
        }
    per_chip = []
    worst = 0.0
    for s in measured:
        div = (
            s["bytes_in_use"] - analytic_per_chip_bytes
        ) / analytic_per_chip_bytes
        per_chip.append(
            {
                "device": s["device"],
                "bytes_in_use": s["bytes_in_use"],
                "divergence_fraction": round(div, 4),
            }
        )
        if abs(div) > abs(worst):
            worst = div
    if abs(worst) > warn_fraction:
        logger.warning(
            "device memory diverges from the analytic report by %+.1f%% "
            "(measured %d B vs analytic %d B per chip): a positive gap "
            "suggests leaked/duplicated buffers or compile scratch, a "
            "negative one a stale analytic model",
            worst * 100.0,
            max(s["bytes_in_use"] for s in measured),
            analytic_per_chip_bytes,
        )
    return {
        "available": True,
        "analytic_per_chip_bytes": int(analytic_per_chip_bytes),
        "max_divergence_fraction": round(worst, 4),
        "per_chip": per_chip,
    }


@dataclasses.dataclass
class MemoryReport:
    """The engine's deliberate allocations on its device, in bytes (the
    JAX package's ``utils.telemetry.memory_report``, one card)."""

    params_bytes: int
    cache_bytes: int
    pool_bytes: int
    graph_bytes: int

    @property
    def total_bytes(self) -> int:
        return self.params_bytes + self.cache_bytes + self.pool_bytes + self.graph_bytes

    @property
    def per_device_bytes(self) -> int:
        return self.total_bytes

    def as_dict(self) -> dict:
        return dict(dataclasses.asdict(self), total_bytes=self.total_bytes,
                    per_device_bytes=self.per_device_bytes)

    def print(self) -> None:
        gb = 1024**3
        print(f"📀 Memory: params {self.params_bytes / gb:.3f} GiB, kv cache "
              f"{self.cache_bytes / gb:.3f} GiB, kv pool {self.pool_bytes / gb:.3f} GiB, "
              f"graphs {self.graph_bytes / gb:.3f} GiB, total {self.total_bytes / gb:.3f} GiB")


def memory_report(engine) -> MemoryReport:
    """The analytic side of ``compare_with_analytic`` for ``engine``: its
    params (a resident draft model's too), its slab caches (the single
    stream's, the slab lanes' and the draft's), its lanes' pool (an int8
    cache's scales included) and its graphs (the static input/output
    buffers and the private pool the captured graphs hold,
    `StepGraphs.pool_bytes`)."""
    from .cost import nbytes

    g = engine.graphs
    draft = getattr(engine, "_draft_params", None)
    return MemoryReport(
        params_bytes=nbytes(engine.params) + (nbytes(draft) if draft is not None else 0),
        cache_bytes=sum(nbytes(c) for c in (engine.cache, engine.lane_cache,
                                            getattr(engine, "draft_cache", None))
                        if c is not None),
        pool_bytes=nbytes(engine.kv_pool) if engine.kv_pool is not None else 0,
        graph_bytes=g.buffer_bytes() + g.pool_bytes(),
    )
