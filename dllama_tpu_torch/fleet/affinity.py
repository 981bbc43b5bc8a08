"""Prefix-affinity routing: consistent hashing over the prompt's first K
token ids.

Pure functions + a small hash ring, no I/O, no clocks — everything here
is unit-testable with plain lists. The router tokenizes each request
ONCE (with the same chat template + encode flags as the replica's
admission path) and hashes the first ``k`` token ids; the ring maps that
key to a stable replica order. Repeated prompts — and prompts sharing a
long system prefix — land on the same replica, whose radix tree then
serves the prefix from cache. Hashing uses blake2b, not Python's
``hash()``, so the assignment is stable across processes and runs
(``PYTHONHASHSEED`` must not matter for routing determinism).

``plan_route`` layers health on top of the ring order: dead and
draining replicas are skipped, saturated replicas (admission-aware:
``in_flight >= max_streams`` from the health capacity block) are
skipped, and degraded replicas are deprioritized to last-resort rather
than skipped — a degraded replica still serves, it is just not the
first choice. Every diversion away from the affinity target is recorded
with a reason so the router can count spills per cause.
"""

from __future__ import annotations

import bisect
import hashlib
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Iterable, Mapping, Sequence

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (typing only)
    from .replicas import ReplicaView

DEFAULT_AFFINITY_K = 32
# virtual nodes per replica; enough that removing one replica moves only
# ~1/N of the keyspace instead of reshuffling everything.
VNODES = 64


def _h(data: bytes) -> int:
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "big"
    )


def prefix_affinity_key(tokens: Sequence[int], k: int = DEFAULT_AFFINITY_K) -> int:
    """Stable 64-bit key for the first ``k`` token ids of a prompt.

    Two prompts sharing their first ``k`` tokens (e.g. a common system
    prompt) hash to the same key and therefore the same replica — that
    is the whole point: the replica's radix tree already holds the
    shared prefix.
    """
    if k <= 0:
        raise ValueError(f"affinity k must be positive, got {k}")
    head = tokens[: int(k)]
    payload = b"".join(
        int(t).to_bytes(4, "big", signed=False) for t in head
    )
    return _h(b"prefix:" + payload)


class HashRing:
    """Consistent-hash ring over replica names with virtual nodes.

    ``order(key)`` walks the ring clockwise from the key's position and
    returns every distinct replica once, in ring order — the first entry
    is the affinity target, the rest are the deterministic spill /
    failover order for that key.
    """

    def __init__(self, names: Iterable[str] = (), vnodes: int = VNODES):
        if vnodes <= 0:
            raise ValueError(f"vnodes must be positive, got {vnodes}")
        self._vnodes = int(vnodes)
        self._points: list[int] = []          # sorted ring positions
        self._owner: dict[int, str] = {}      # position -> replica name
        self._names: set[str] = set()
        for name in names:
            self.add(name)

    @property
    def names(self) -> frozenset[str]:
        return frozenset(self._names)

    def add(self, name: str) -> None:
        if name in self._names:
            return
        self._names.add(name)
        for v in range(self._vnodes):
            point = _h(f"replica:{name}#{v}".encode())
            # blake2b collisions across <1k points are effectively
            # impossible; if one ever happens, first owner keeps it.
            if point in self._owner:
                continue
            self._owner[point] = name
            bisect.insort(self._points, point)

    def remove(self, name: str) -> None:
        if name not in self._names:
            return
        self._names.discard(name)
        keep = [p for p in self._points if self._owner[p] != name]
        for p in self._points:
            if self._owner[p] == name:
                del self._owner[p]
        self._points = keep

    def order(self, key: int) -> list[str]:
        """All replicas in clockwise ring order starting at ``key``."""
        if not self._points:
            return []
        out: list[str] = []
        seen: set[str] = set()
        start = bisect.bisect_left(self._points, int(key) % (1 << 64))
        n = len(self._points)
        for i in range(n):
            name = self._owner[self._points[(start + i) % n]]
            if name not in seen:
                seen.add(name)
                out.append(name)
            if len(seen) == len(self._names):
                break
        return out


@dataclass
class RoutePlan:
    """Ordered candidates for one request plus why anyone was skipped."""

    target: str | None            # affinity target (ring-first), pre-health
    candidates: list[str] = field(default_factory=list)
    skipped: list[tuple[str, str]] = field(default_factory=list)  # (name, reason)

    @property
    def spill_reason(self) -> str | None:
        """Why the affinity target was diverted, if it was.

        None when the first candidate IS the target (an affinity hit)
        or when there is no viable candidate at all.
        """
        if self.target is None or not self.candidates:
            return None
        if self.candidates[0] == self.target:
            return None
        for name, reason in self.skipped:
            if name == self.target:
                return reason
        return "degraded"  # target demoted to last-resort, not skipped


def plan_route(
    ring_order: Sequence[str],
    views: Mapping[str, "ReplicaView"],
) -> RoutePlan:
    """Filter a ring order through replica health into a RoutePlan.

    Dead / draining / saturated replicas are skipped with a reason;
    degraded replicas are demoted behind every healthy candidate but
    kept as last resort. Deterministic: same inputs, same plan.
    """
    plan = RoutePlan(target=ring_order[0] if ring_order else None)
    degraded: list[str] = []
    for name in ring_order:
        view = views.get(name)
        if view is None or view.state == "dead":
            plan.skipped.append((name, "dead"))
            continue
        if view.state == "draining":
            plan.skipped.append((name, "draining"))
            continue
        if view.saturated:
            plan.skipped.append((name, "saturated"))
            continue
        if view.state == "degraded":
            degraded.append(name)
            continue
        plan.candidates.append(name)
    plan.candidates.extend(degraded)
    return plan
