"""Deterministic fault-injection plane for chaos testing the serving path.

The port's copy of dllama_tpu/runtime/faults.py (stdlib only). A seeded,
schedule-driven ``FaultPlane`` whose named injection sites are threaded
through the engine's lane entries (``prefill_lane_chunk``,
``decode_lanes``, ``verify_lanes``, ``kv_page_copy``), the KV manager's
adopt and publish paths, and the SSE flush. A chaos run is then an input
(``--faults`` / ``DLLAMA_FAULTS``), not an accident: the same spec replays
the same faults at the same draw counts, so a recovery bug reproduces on
the first try instead of the thousandth soak.

Spec grammar (comma-separated schedules)::

    site[:key=value]*[,site[:key=value]*]...

    dispatch:p=0.05:seed=7          5% of dispatch draws fail (seeded)
    kv_alloc:nth=12                 exactly the 12th kv_alloc draw fails
    dispatch:every=40:kind=poison   every 40th draw poisons the cache
    dispatch:op=decode_lanes:nth=3  3rd decode_lanes dispatch only
    sse_flush:p=0.01:seed=3:n=5     at most 5 injected flush failures

Keys: ``p`` (per-draw probability, seeded), ``nth`` (1-based draw index,
fires once), ``every`` (periodic), ``n`` (cap on total injections),
``seed`` (per-schedule RNG seed), ``kind`` (``transient`` — raised
BEFORE the engine's pool guard, no device work done, KV state intact,
retryable; ``poison`` — raised INSIDE the guard, the pool is reset and
the cache epoch moves, so the scheduler must recover lanes), ``op``
(restrict a ``dispatch`` schedule to one engine entry point). Exactly one
of ``p``/``nth``/``every`` per schedule.

Sites: ``dispatch`` (the four lane entries and the manager's publish,
``op=kv_publish``; filter with ``op=``), ``kv_alloc`` (page allocation on
the adopt and publish paths), ``sse_flush`` (client socket death
mid-stream). ``KNOWN_SITES`` and ``KINDS`` are the JAX module's, so a spec
parses alike in both packages; ``prefetch`` (the JAX engine's AOT compile
thread) has no draw site in the port, which compiles nothing ahead.

Every injection increments ``dllama_faults_injected_total{site}`` and
records a ``fault_injected`` event in the flight recorder (obs/), so a chaos
run's postmortems show which failures were injected and which were
organic; ``counts()`` gives the plane's own totals by site.
"""

from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass, field

from ..obs.metrics import get_registry
from ..obs.recorder import get_recorder

KNOWN_SITES = ("dispatch", "kv_alloc", "sse_flush", "prefetch")
KINDS = ("transient", "poison")


class FaultSpecError(ValueError):
    """A ``--faults`` / ``DLLAMA_FAULTS`` spec that cannot be parsed."""


class InjectedFault(RuntimeError):
    """The exception an armed schedule raises at its site. ``poison``
    tells the raiser WHERE to raise it (inside or outside the
    pool guard), which is what makes the two failure classes
    distinguishable to the scheduler's epoch check."""

    def __init__(self, site: str, op: str | None, kind: str, seq: int):
        self.site = site
        self.op = op
        self.kind = kind
        self.seq = seq  # per-schedule injection index (1-based)
        where = f"{site}:{op}" if op else site
        super().__init__(
            f"injected {kind} fault #{seq} at {where} (chaos schedule)"
        )

    @property
    def poison(self) -> bool:
        return self.kind == "poison"


@dataclass
class _Schedule:
    site: str
    op: str | None = None
    p: float = 0.0
    nth: int = 0
    every: int = 0
    n: int = 0  # max injections (0 = nth fires once, p/every unbounded)
    seed: int = 0
    kind: str = "transient"
    draws: int = 0
    injected: int = 0
    rng: random.Random = field(default_factory=random.Random)

    def should_fire(self) -> bool:
        """Called with the plane lock held; advances this schedule's draw
        counter and decides deterministically."""
        self.draws += 1
        cap = self.n if self.n > 0 else (1 if self.nth > 0 else 0)
        if cap and self.injected >= cap:
            return False
        if self.nth > 0:
            fire = self.draws == self.nth
        elif self.every > 0:
            fire = self.draws % self.every == 0
        else:
            fire = self.rng.random() < self.p
        if fire:
            self.injected += 1
        return fire


def parse_fault_spec(spec: str) -> list[_Schedule]:
    """Parse the ``--faults`` grammar into schedules (see module
    docstring); raises :class:`FaultSpecError` on malformed input so a
    typo'd chaos run dies at startup, not silently fault-free."""
    schedules: list[_Schedule] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        site = fields[0].strip()
        if site not in KNOWN_SITES:
            raise FaultSpecError(
                f"unknown fault site {site!r} (known: {', '.join(KNOWN_SITES)})"
            )
        sched = _Schedule(site=site)
        for f in fields[1:]:
            key, sep, value = f.partition("=")
            key = key.strip()
            if not sep:
                raise FaultSpecError(f"expected key=value, got {f!r}")
            try:
                if key == "p":
                    sched.p = float(value)
                    if not 0.0 <= sched.p <= 1.0:
                        raise FaultSpecError(f"p={value} outside [0, 1]")
                elif key == "nth":
                    sched.nth = int(value)
                    if sched.nth < 1:
                        raise FaultSpecError("nth must be >= 1")
                elif key == "every":
                    sched.every = int(value)
                    if sched.every < 1:
                        raise FaultSpecError("every must be >= 1")
                elif key == "n":
                    sched.n = int(value)
                elif key == "seed":
                    sched.seed = int(value)
                elif key == "kind":
                    if value not in KINDS:
                        raise FaultSpecError(
                            f"unknown fault kind {value!r} "
                            f"(known: {', '.join(KINDS)})"
                        )
                    sched.kind = value
                elif key == "op":
                    sched.op = value
                else:
                    raise FaultSpecError(f"unknown fault key {key!r}")
            except ValueError as e:
                if isinstance(e, FaultSpecError):
                    raise
                raise FaultSpecError(f"bad value in {f!r}: {e}") from e
        n_triggers = sum(
            1 for v in (sched.p > 0, sched.nth > 0, sched.every > 0) if v
        )
        if n_triggers != 1:
            raise FaultSpecError(
                f"schedule {part!r} needs exactly one of p=/nth=/every="
            )
        sched.rng = random.Random(sched.seed)
        schedules.append(sched)
    return schedules


class FaultPlane:
    """Holds the armed schedules and serves ``draw()`` calls from the
    injection sites. With no schedules (the production default) a draw
    is one attribute read and an early return — the plane costs nothing
    when chaos is off."""

    def __init__(self, spec: str = "") -> None:
        self.spec = spec
        self.schedules = parse_fault_spec(spec) if spec else []
        self._lock = threading.Lock()
        self._m_injected = None
        if self.schedules:
            self._m_injected = get_registry().counter(
                "dllama_faults_injected_total",
                "Faults injected by the chaos plane, by site "
                "(runtime/faults.py; 0 series when no schedule is armed).",
                labelnames=("site",),
            )

    @property
    def armed(self) -> bool:
        return bool(self.schedules)

    def draw(self, site: str, op: str | None = None) -> InjectedFault | None:
        """One potential injection point was reached: every schedule for
        ``site`` (whose ``op`` filter matches) advances its draw counter;
        the first that fires wins. Returns the fault to raise, or None."""
        if not self.schedules:
            return None
        fault = None
        with self._lock:
            for s in self.schedules:
                if s.site != site or (s.op is not None and s.op != op):
                    continue
                if s.should_fire() and fault is None:
                    fault = InjectedFault(site, op, s.kind, s.injected)
        if fault is not None:
            if self._m_injected is not None:
                self._m_injected.labels(site=site).inc()
            get_recorder().record(
                "fault_injected", site=site, op=op, fault_kind=fault.kind,
                seq=fault.seq,
            )
        return fault

    def counts(self) -> dict[str, int]:
        """Injected-fault totals by site (test/bench introspection)."""
        out: dict[str, int] = {}
        with self._lock:
            for s in self.schedules:
                out[s.site] = out.get(s.site, 0) + s.injected
        return out


_PLANE = FaultPlane(os.environ.get("DLLAMA_FAULTS", ""))


def get_fault_plane() -> FaultPlane:
    """The process-wide plane every injection site consults."""
    return _PLANE


def set_fault_plane(spec: str) -> FaultPlane:
    """Arm (or with ``""`` disarm) the process-wide plane; returns it.
    Tests and the bench install per-run schedules through this, the CLI
    through ``--faults``."""
    global _PLANE
    _PLANE = FaultPlane(spec)
    return _PLANE
