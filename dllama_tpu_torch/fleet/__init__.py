"""Replica fleet of the port: a prefix-affinity front door over N engine
replicas (the port's copy of dllama_tpu/fleet/, with its names, knobs,
metric families and JSON keys).

The single-replica serving story (drain, shedding, structured retryable
errors, degraded health, byte-identical recovery and park/resume) scales
out here: a lightweight stdlib HTTP router (:mod:`.router`) fronts N
independent ``api_server`` replicas of the port, routing each request by
prompt-prefix hash to the replica whose radix tree likely holds the
prefix (:mod:`.affinity`), spilling to siblings when the target is
degraded / draining / saturated (:mod:`.replicas`), and surviving
replica death mid-stream by resuming the stream on a sibling with the
already-emitted tokens as prompt prefix (``resume_tokens``, the lane
server's recovery admission one level up). :mod:`.obs` is the router's
observability plane. :mod:`.launch` brings up an N-replica fleet in
process (one engine a replica, on the card unless ``device="cpu"``) or as
one ``api_server`` process a replica. Importing the package needs neither
a card nor triton nor nvcc.
"""

from .affinity import HashRing, RoutePlan, plan_route, prefix_affinity_key
from .replicas import (
    DEAD,
    DEGRADED,
    DRAINING,
    HEALTHY,
    Replica,
    ReplicaRegistry,
    ReplicaView,
)
from .router import RouterState, resolve_fleet_knobs, serve_router

__all__ = [
    "HashRing",
    "RoutePlan",
    "plan_route",
    "prefix_affinity_key",
    "HEALTHY",
    "DEGRADED",
    "DRAINING",
    "DEAD",
    "Replica",
    "ReplicaRegistry",
    "ReplicaView",
    "RouterState",
    "resolve_fleet_knobs",
    "serve_router",
]
