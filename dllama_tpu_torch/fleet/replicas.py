"""Replica registry: health polling + a per-replica state machine.

Each replica runs an ordinary ``api_server`` whose ``GET /v1/health``
already reports ``ok`` / ``degraded`` (+ ``degraded_reasons``) /
``draining`` and — new with the fleet — a ``capacity`` block
(``max_streams``, ``kv_native``, ``lanes``, ``parked``, ``in_flight``)
so the router can make admission-aware spill decisions instead of
hashing blindly. The registry polls every replica, maps the payload
onto a four-state machine::

    healthy <-> degraded <-> draining        (what the replica reports)
         \\________ dead ________/            (poll failures / router veto)

A replica becomes ``dead`` after ``fail_threshold`` consecutive poll
failures (or immediately via :meth:`ReplicaRegistry.mark_dead` when the
router's connection attempt is refused) and is revived by the next
successful poll — death is an observation, not a sentence.

The poller takes an injectable ``fetch`` callable and ``clock`` so unit
tests drive the state machine synchronously with canned payloads; the
background thread is only started by :meth:`start` (the router does
this, tests usually call :meth:`poll_once` directly).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping

from ..obs.recorder import get_recorder

HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"
DEAD = "dead"

_STATUS_TO_STATE = {
    "ok": HEALTHY,
    "degraded": DEGRADED,
    "draining": DRAINING,
}

DEFAULT_POLL_S = 2.0
DEFAULT_FAIL_THRESHOLD = 3
_FETCH_TIMEOUT_S = 5.0


def _default_fetch(base_url: str) -> dict:
    with urllib.request.urlopen(
        f"{base_url}/v1/health", timeout=_FETCH_TIMEOUT_S
    ) as r:
        return json.loads(r.read())


@dataclass
class Replica:
    """One replica's registry entry (mutable, guarded by the registry
    lock)."""

    name: str
    base_url: str
    state: str = HEALTHY
    consecutive_failures: int = 0
    last_health: dict = field(default_factory=dict)
    last_error: str = ""
    last_change_ts: float = 0.0


@dataclass(frozen=True)
class ReplicaView:
    """Immutable per-replica snapshot handed to routing (affinity's
    ``plan_route``) — no locks needed downstream."""

    name: str
    base_url: str
    state: str
    max_streams: int = 0          # 0 = unknown capacity: never saturated
    in_flight: int = 0
    lanes: int = 0
    parked: int = 0
    kv_native: bool = False
    degraded_reasons: tuple[str, ...] = ()

    @property
    def saturated(self) -> bool:
        return self.max_streams > 0 and self.in_flight >= self.max_streams


class ReplicaRegistry:
    """Thread-safe registry over a fixed replica set.

    ``fetch(base_url) -> dict`` must return the replica's ``/v1/health``
    payload or raise; ``clock()`` stamps state transitions (monotonic by
    default, injectable for tests).
    """

    def __init__(
        self,
        replicas: Mapping[str, str] | Iterable[tuple[str, str]],
        fetch: Callable[[str], dict] | None = None,
        clock: Callable[[], float] = time.monotonic,
        poll_interval_s: float = DEFAULT_POLL_S,
        fail_threshold: int = DEFAULT_FAIL_THRESHOLD,
    ):
        pairs = (
            replicas.items() if isinstance(replicas, Mapping) else replicas
        )
        self._replicas: dict[str, Replica] = {
            name: Replica(name=name, base_url=url) for name, url in pairs
        }
        if not self._replicas:
            raise ValueError("registry needs at least one replica")
        self._fetch = fetch if fetch is not None else _default_fetch
        self._clock = clock
        self.poll_interval_s = float(poll_interval_s)
        self.fail_threshold = int(fail_threshold)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.recorder = get_recorder()

    # ------------------------------------------------------------- state

    @property
    def names(self) -> list[str]:
        return list(self._replicas)

    def url_of(self, name: str) -> str:
        return self._replicas[name].base_url

    def urls(self) -> dict[str, str]:
        """Name -> base URL for every registered replica (the fleet
        scraper and recorder/timeline fan-outs iterate this)."""
        return {name: rep.base_url for name, rep in self._replicas.items()}

    def _transition(self, rep: Replica, state: str, reason: str) -> None:
        """Caller holds the lock."""
        if rep.state == state:
            return
        prev, rep.state = rep.state, state
        rep.last_change_ts = self._clock()
        self.recorder.record(
            "replica_state",
            replica=rep.name,
            prev=prev,
            state=state,
            reason=reason,
        )

    def poll_once(self) -> dict[str, str]:
        """Poll every replica once; returns ``{name: state}``."""
        for rep in self._replicas.values():
            try:
                payload = self._fetch(rep.base_url)
            except (OSError, ValueError) as e:
                with self._lock:
                    rep.consecutive_failures += 1
                    rep.last_error = f"{type(e).__name__}: {e}"
                    if rep.consecutive_failures >= self.fail_threshold:
                        self._transition(rep, DEAD, "poll_failures")
                continue
            state = _STATUS_TO_STATE.get(str(payload.get("status")), DEGRADED)
            with self._lock:
                rep.consecutive_failures = 0
                rep.last_error = ""
                rep.last_health = payload
                self._transition(rep, state, "health")
        return {name: rep.state for name, rep in self._replicas.items()}

    def mark_dead(self, name: str, reason: str = "router") -> None:
        """Router veto: a connection to this replica was refused; stop
        routing to it until a health poll revives it."""
        rep = self._replicas.get(name)
        if rep is None:
            return
        with self._lock:
            rep.consecutive_failures = max(
                rep.consecutive_failures, self.fail_threshold
            )
            self._transition(rep, DEAD, reason)

    def mark_draining(self, name: str) -> None:
        """Immediate local echo of a forwarded ``POST /v1/drain`` — the
        next poll would notice anyway, but routing should stop now."""
        rep = self._replicas.get(name)
        if rep is None:
            return
        with self._lock:
            self._transition(rep, DRAINING, "drain_forwarded")

    def views(self) -> dict[str, ReplicaView]:
        out: dict[str, ReplicaView] = {}
        with self._lock:
            for name, rep in self._replicas.items():
                cap = rep.last_health.get("capacity") or {}
                out[name] = ReplicaView(
                    name=name,
                    base_url=rep.base_url,
                    state=rep.state,
                    max_streams=int(cap.get("max_streams", 0) or 0),
                    in_flight=int(cap.get("in_flight", 0) or 0),
                    lanes=int(cap.get("lanes", 0) or 0),
                    parked=int(cap.get("parked", 0) or 0),
                    kv_native=bool(cap.get("kv_native", False)),
                    degraded_reasons=tuple(
                        rep.last_health.get("degraded_reasons") or ()
                    ),
                )
        return out

    def snapshot(self) -> dict[str, dict]:
        """Full per-replica detail for ``GET /v1/fleet``."""
        with self._lock:
            return {
                name: {
                    "url": rep.base_url,
                    "state": rep.state,
                    "consecutive_failures": rep.consecutive_failures,
                    "last_error": rep.last_error,
                    "health": rep.last_health,
                }
                for name, rep in self._replicas.items()
            }

    # ------------------------------------------------------------ poller

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._poll_loop, name="fleet-health-poller", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # pragma: no cover - belt and braces
                self.recorder.record(
                    "replica_poll_error", error=f"{type(e).__name__}: {e}"
                )
            self._stop.wait(self.poll_interval_s)
