"""The fleet front door: prefix-affinity routing + mid-stream failover.

A stdlib ``ThreadingHTTPServer`` (same style as ``runtime/api_server``,
deliberately engine-free: it builds no engine and touches no card; the
port's copy of dllama_tpu/fleet/router.py) that fronts N replicas:

    python -m dllama_tpu_torch.fleet.router --tokenizer t.t \\
        --replica r0=http://127.0.0.1:9990 --replica r1=http://127.0.0.1:9991


* **Affinity.** Each ``POST /v1/chat/completions`` is tokenized ONCE at
  the router with exactly the replica's admission recipe (chat template
  with ``append_generation_prompt=True``, then ``encode(is_start=True,
  add_special_tokens=True)``); the first K token ids hash onto a
  consistent ring (:mod:`.affinity`), so repeated and shared-prefix
  prompts land on the replica whose radix tree holds their prefix.
* **Spill.** The ring order is filtered through replica health
  (:mod:`.replicas`): dead/draining/saturated siblings are skipped,
  degraded ones demoted to last resort, and a 429/503 shed or refused
  connection at request time moves to the next candidate. Every
  diversion counts in ``dllama_router_spills_total{reason}``.
* **Mid-stream failover.** Replicas stream with ``include_tokens``, so
  every SSE chunk carries the exact generated token ids
  (``dllama_tokens``) and their raw decoded text (``dllama_piece``).
  When a replica dies mid-stream (EOF, stall past the watchdog read
  timeout, or an in-stream retryable error), the router first emits the
  catch-up delta — the exact text consumed but still held back by the
  dead replica's EOS detector — then re-issues the request to the next
  sibling as ``resume_tokens`` = prompt tokens + emitted tokens. The
  sibling's recovery-admission path (radix re-match + chunked
  re-prefill) continues the stream byte-identically under greedy
  decoding, on the SAME client connection. Two edge cases stay open, as
  in the JAX router: a stop string and an incomplete UTF-8 sequence that
  span the boundary.

* **Fleet observability.** The router mints a trace id +
  request id per client request and forwards them as
  ``x-dllama-trace``/``x-dllama-request`` headers on every relay
  INCLUDING failover re-issues, so every replica that touched a request
  records the same fleet-level identity. The router keeps its OWN
  ``obs.spans.SpanTracker`` (tokenize, route_plan,
  relay, stall_detect, failover, catch_up_synthesis spans);
  ``GET /v1/fleet/timeline?request_id=`` stitches the router fragment
  with per-replica ``/v1/debug/timeline`` fragments into one Perfetto
  trace where a mid-stream failover renders as a single continuous
  request with the gap attributed to an explicit ``failover`` span.
  ``GET /metrics`` re-exports replica metrics with a ``replica`` label
  and the fleet aggregates (:mod:`.obs`); the fleet anomaly rules feed
  ``/v1/health`` ``degraded_reasons``; ``/dashboard`` overlays
  per-replica sparklines.

Knobs resolve CLI-beats-env-beats-default via the ``DLLAMA_FLEET_*``
family: ``DLLAMA_FLEET_AFFINITY_K``, ``DLLAMA_FLEET_FAILOVER_MAX``,
``DLLAMA_FLEET_STALL_S``, ``DLLAMA_FLEET_POLL_S``; the observability
plane adds the ``DLLAMA_FLEET_OBS_*`` family (:mod:`.obs`).
"""

from __future__ import annotations

import http.client
import json
import os
import random
import threading
import time
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlencode, urlsplit

from ..obs.dashboard import DASHBOARD_CONTENT_TYPE, render_dashboard
from ..obs.metrics import get_registry
from ..obs.recorder import get_recorder
from ..obs.spans import SpanTracker
from ..tokenizer import (
    CHAT_TEMPLATE_NAMES,
    ChatItem,
    ChatTemplateGenerator,
    ChatTemplateType,
    Tokenizer,
)
from .affinity import (
    DEFAULT_AFFINITY_K,
    HashRing,
    RoutePlan,
    plan_route,
    prefix_affinity_key,
)
from .obs import (
    PID_STRIDE,
    FleetObs,
    RequestLedger,
    resolve_fleet_obs_knobs,
    stitch_timelines,
)
from .replicas import ReplicaRegistry

DEFAULT_FAILOVER_MAX = 3
DEFAULT_STALL_S = 120.0


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name, "")
    return float(v) if v else default


def resolve_fleet_knobs(
    affinity_k: int | None = None,
    failover_max: int | None = None,
    stall_timeout_s: float | None = None,
    poll_interval_s: float | None = None,
) -> tuple[int, int, float, float]:
    """Router knob resolution: explicit value (CLI flag / constructor)
    beats the ``DLLAMA_FLEET_*`` env knob beats the default — the same
    ladder as the engine's lane/stream knobs."""
    k = (
        int(affinity_k)
        if affinity_k is not None
        else int(_env_float("DLLAMA_FLEET_AFFINITY_K", DEFAULT_AFFINITY_K))
    )
    fmax = (
        int(failover_max)
        if failover_max is not None
        else int(_env_float("DLLAMA_FLEET_FAILOVER_MAX", DEFAULT_FAILOVER_MAX))
    )
    stall = (
        float(stall_timeout_s)
        if stall_timeout_s is not None
        else _env_float("DLLAMA_FLEET_STALL_S", DEFAULT_STALL_S)
    )
    poll = (
        float(poll_interval_s)
        if poll_interval_s is not None
        else _env_float("DLLAMA_FLEET_POLL_S", 2.0)
    )
    if k <= 0:
        raise ValueError(f"affinity k must be positive, got {k}")
    return k, max(0, fmax), stall, poll


def _sse_write(wfile, data: str) -> None:
    """One HTTP-chunked SSE frame (mirror of the replica server's)."""
    raw = data.encode("utf-8")
    wfile.write(f"{len(raw):x}\r\n".encode() + raw + b"\r\n")


class _StreamDeath(Exception):
    """An upstream replica's SSE stream died recoverably mid-flight:
    EOF / broken chunking, a read stall past the watchdog timeout, or an
    in-stream retryable error frame. The relay fails over."""


def _retry_after_s(value, default: int = 2) -> int:
    """Parse an upstream ``Retry-After`` header value (delta-seconds
    form) into a positive int; ``default`` on absent/malformed input.
    HTTP-date form is not produced by the replicas, so it falls through
    to the default rather than being parsed."""
    if value is None:
        return default
    try:
        s = int(float(value))
    except (TypeError, ValueError):
        return default
    return s if s > 0 else default


class RouterState:
    """Shared router state: registry + ring + tokenizer + metrics."""

    def __init__(
        self,
        registry: ReplicaRegistry,
        tokenizer: Tokenizer,
        chat_template_type: ChatTemplateType = ChatTemplateType.UNKNOWN,
        model_name: str = "dllama-fleet",
        affinity_k: int | None = None,
        failover_max: int | None = None,
        stall_timeout_s: float | None = None,
        routing: str = "affinity",
        seed: int = 0,
        fleet_obs: FleetObs | None = None,
    ):
        if routing not in ("affinity", "random"):
            raise ValueError(f"unknown routing mode {routing!r}")
        self.registry = registry
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.routing = routing
        self.start_unix = time.time()
        k, fmax, stall, _ = resolve_fleet_knobs(
            affinity_k, failover_max, stall_timeout_s
        )
        self.affinity_k = k
        self.failover_max = fmax
        self.stall_timeout_s = stall
        # the router's prompt rendering MUST mirror the replica's
        # admission path token-for-token — the affinity key hashes the
        # very ids the replica's radix tree stores (tests cross-check
        # against the replica's reported usage.prompt_tokens)
        stops = [
            tokenizer.vocab[t].decode("utf-8", "replace")
            for t in tokenizer.eos_token_ids
        ]
        self.template = ChatTemplateGenerator(
            chat_template_type,
            tokenizer.chat_template,
            stops[0] if stops else "",
        )
        self.ring = HashRing(registry.names)
        # predicted-wait bookkeeping: a replica that sheds
        # with Retry-After is predicting its own queue-drain time, so
        # the router remembers "busy until" per replica and demotes
        # still-backing-off siblings in the spill order instead of
        # hammering them with requests they already said they'd shed
        self._shed_until: dict[str, float] = {}
        self._shed_lock = threading.Lock()
        # deterministic per-request RNG stream for routing="random" (the
        # bench's affinity-off baseline): string seeding is stable across
        # processes, unlike hash()-seeded tuples
        self._seed = seed
        self._n_requests = 0
        self._count_lock = threading.Lock()
        self.obs = get_registry()
        self.recorder = get_recorder()
        self.m_requests = self.obs.counter(
            "dllama_router_requests_total",
            "Router requests by serving replica and outcome (ok, error, "
            "shed, refused, died, client_gone, unavailable, ...).",
            labelnames=("replica", "outcome"),
        )
        self.m_failovers = self.obs.counter(
            "dllama_router_failovers_total",
            "Mid-stream failovers: a replica's SSE stream died and the "
            "router resumed it on a sibling via resume_tokens.",
        )
        self.m_affinity_hits = self.obs.counter(
            "dllama_router_affinity_hits_total",
            "Requests served by their prefix-affinity target replica "
            "(first streamed-from replica == consistent-hash target).",
        )
        self.m_spills = self.obs.counter(
            "dllama_router_spills_total",
            "Requests diverted off their affinity target by reason "
            "(dead, draining, saturated, degraded, shed, refused).",
            labelnames=("reason",),
        )
        self.m_stalls = self.obs.counter(
            "dllama_router_stalls_total",
            "Mid-stream failovers triggered specifically by a read stall "
            "past the watchdog timeout (subset of failovers_total).",
        )
        self.m_gap = self.obs.histogram(
            "dllama_router_failover_gap_seconds",
            "Client-visible failover gap: replica stream death to the "
            "catch-up delta landing from the sibling (the recovery "
            "latency the fleet bench watches at p99).",
        )
        # the router's OWN span tracker — deliberately NOT the process
        # global: in the in-process fleet the global tracker belongs to
        # the replicas, and the stitcher must be able to fetch router
        # and replica fragments as disjoint span sets
        self.spans = SpanTracker()
        _, _, ledger_cap = resolve_fleet_obs_knobs()
        self.ledger = RequestLedger(ledger_cap)
        # scrape/aggregate/anomaly plane; injectable so the fake-clock
        # anomaly test drives a FleetObs with a fake fetch + fake clock
        self.fleet = (
            fleet_obs
            if fleet_obs is not None
            else FleetObs(
                registry,
                registry=self.obs,
                recorder=self.recorder,
                affinity_rate_fn=self.affinity_rate,
            )
        )
        self.fleet.register()

    # --------------------------------------------------------------- route

    def prompt_tokens(self, messages: list[dict]) -> list[int]:
        """Tokenize a chat exactly as replica admission will."""
        items = [
            ChatItem(str(m["role"]), str(m["content"])) for m in messages
        ]
        prompt = self.template.generate(items, append_generation_prompt=True)
        return self.tokenizer.encode(
            prompt.content, is_start=True, add_special_tokens=True
        )

    def route(self, tokens: list[int]) -> RoutePlan:
        """Plan the candidate order for one request. The affinity target
        is ALWAYS the ring's choice — in routing="random" mode only the
        try order is shuffled, so the affinity-hit metric measures the
        same thing in both modes and the bench comparison is honest."""
        key = prefix_affinity_key(tokens, self.affinity_k)
        plan = plan_route(self.ring.order(key), self.registry.views())
        if self.routing == "random" and len(plan.candidates) > 1:
            with self._count_lock:
                n = self._n_requests
                self._n_requests += 1
            rng = random.Random(f"{self._seed}:{n}")
            plan.candidates = rng.sample(
                plan.candidates, len(plan.candidates)
            )
        elif self.routing == "affinity":
            reason = plan.spill_reason
            if reason is not None:
                self.m_spills.labels(reason=reason).inc()
                self.recorder.record(
                    "router_spill",
                    reason=reason,
                    target=plan.target,
                    candidates=list(plan.candidates),
                )
        return plan

    # -------------------------------------------------- predicted wait

    def note_shed(self, name: str, retry_after) -> None:
        """A replica shed with the given ``Retry-After`` (header string,
        int, or None): remember its self-predicted busy-until time."""
        s = _retry_after_s(retry_after)
        with self._shed_lock:
            self._shed_until[name] = time.monotonic() + s

    def shed_wait_s(self, name: str) -> float:
        """Seconds this replica predicted it stays saturated (0 when it
        never shed or the backoff already expired)."""
        with self._shed_lock:
            until = self._shed_until.get(name)
        if until is None:
            return 0.0
        return max(0.0, until - time.monotonic())

    def order_by_backoff(self, candidates: list[str]) -> list[str]:
        """Predicted-wait-aware spill order: candidates whose shed
        backoff expired keep their (affinity) order and come first;
        replicas still inside a self-predicted busy window are demoted
        to the tail, soonest-free first. Nothing is dropped — when the
        whole fleet is backing off, the least-backed-off replica is
        still tried (it may have drained early)."""
        waits = [(self.shed_wait_s(n), i, n) for i, n in enumerate(candidates)]
        free = [n for w, _, n in waits if w <= 0.0]
        busy = [n for w, i, n in sorted(waits) if w > 0.0]
        return free + busy

    def min_shed_wait_s(self) -> int | None:
        """Smallest non-expired predicted wait across the fleet — the
        honest Retry-After for an all-replicas-shed 503 (None when no
        replica is inside a backoff window)."""
        waits = [
            w for w in (self.shed_wait_s(n) for n in self.registry.names)
            if w > 0.0
        ]
        if not waits:
            return None
        return max(1, int(-(-min(waits) // 1)))

    # ------------------------------------------------------------- fleet

    def affinity_rate(self) -> float | None:
        """Cumulative affinity hit rate over all routed requests (None
        before the first request); sampled into
        ``dllama_fleet_affinity_hit_rate`` each scrape."""
        total = sum(self.m_requests.child_values().values())
        if total <= 0:
            return None
        return self.m_affinity_hits.value / total

    def health_payload(self) -> dict:
        """The router's ``/v1/health`` body. Status composes replica
        registry states with the FLEET anomaly monitor: a fleet rule
        firing (TPOT skew, failover spike, goodput drop) degrades the
        router even while every replica individually reports healthy —
        exactly the fleet-level sickness a per-replica view can't see."""
        views = self.registry.views()
        states = [v.state for v in views.values()]
        if any(s == "healthy" for s in states):
            status = "ok"
        elif any(s != "dead" for s in states):
            status = "degraded"
        else:
            status = "unavailable"
        reasons = [
            f"fleet_anomaly:{sig}"
            for sig in self.fleet.monitor.active_signals()
        ]
        if reasons and status == "ok":
            status = "degraded"
        return {
            "status": status,
            "role": "router",
            "routing": self.routing,
            "uptime_s": round(time.time() - self.start_unix, 3),
            "replicas": {name: v.state for name, v in views.items()},
            "degraded_reasons": reasons,
        }


def make_router_handler(state: RouterState):
    class RouterHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet access log
            pass

        def _json(
            self, payload: dict, status: int = 200,
            retry_after: int | None = None,
        ) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(status)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header(
                "Content-Type", "application/json; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                self.send_header("Retry-After", str(retry_after))
            self.end_headers()
            self.wfile.write(body)

        # ------------------------------------------------------------ GET

        def do_GET(self):
            path, _, query = self.path.partition("?")
            params = parse_qs(query)
            if path == "/metrics":
                # run_refresh_hooks triggers the fleet scrape (a keyed
                # hook, obs.py), so the render below already holds fresh
                # aggregates; the replica-labelled re-export block is
                # appended after the router's own families
                state.obs.run_refresh_hooks()
                text = state.obs.render()
                fleet = state.fleet.render_fleet()
                if fleet:
                    text = text.rstrip("\n") + "\n" + fleet + "\n"
                body = text.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", state.obs.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/v1/health":
                self._json(state.health_payload())
            elif path == "/v1/fleet":
                self._json(self._fleet_payload())
            elif path == "/v1/fleet/timeline":
                self._fleet_timeline(params)
            elif path == "/v1/fleet/debug/recorder":
                self._fleet_recorder()
            elif path == "/v1/debug/series":
                self._fleet_series(params)
            elif path == "/dashboard":
                body = render_dashboard()
                self.send_response(200)
                self.send_header("Content-Type", DASHBOARD_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/v1/models":
                self._json(
                    {
                        "object": "list",
                        "data": [
                            {
                                "id": state.model_name,
                                "object": "model",
                                "created": 0,
                                "owned_by": "user",
                            }
                        ],
                    }
                )
            elif path in ("/health", "/healthz"):
                self._json({"status": "ok"})
            else:
                self.send_error(404, "Not Found")

        def _fetch_json(self, url: str) -> dict:
            """GET a replica debug endpoint as JSON (raises OSError /
            ValueError, handled per call site — a dead replica degrades
            the merged view, never the whole response)."""
            with urllib.request.urlopen(url, timeout=10.0) as r:
                return json.loads(r.read())

        def _fleet_timeline(self, params: dict) -> None:
            """GET /v1/fleet/timeline[?request_id=] — bare: the request
            ledger's recent entries (pick a request id to stitch); with
            an id: ONE merged Chrome/Perfetto trace of the router's own
            spans plus every touched replica's fragment, pid-namespaced
            per source and rebased onto the router's epoch, so a
            failover reads as one continuous request with the gap
            attributed to the router's ``failover`` span."""
            rid = (params.get("request_id") or [None])[0]
            if rid is None:
                self._json({"recent": state.ledger.recent()})
                return
            entry = state.ledger.get(rid)
            if entry is None:
                self._json(
                    {
                        "error": {
                            "message": f"unknown request_id {rid!r} "
                            "(the ledger keeps the most recent requests)",
                        }
                    },
                    404,
                )
                return
            router_frag = state.spans.chrome_trace(
                request_id=rid, pid_prefix="router"
            )
            names = sorted(state.registry.names)
            fragments: list[tuple[str, dict]] = []
            errors: dict[str, str] = {}
            for name in entry["replicas"]:
                # stable pid namespace per replica regardless of which
                # replicas THIS request touched
                idx = names.index(name) if name in names else len(names)
                q = urlencode(
                    {
                        "request_id": rid,
                        "replica": name,
                        "pid_prefix": name,
                        "pid_base": PID_STRIDE * (idx + 1),
                    }
                )
                url = state.registry.url_of(name)
                try:
                    frag = self._fetch_json(
                        f"{url}/v1/debug/timeline?{q}"
                    )
                except (OSError, ValueError) as e:
                    errors[name] = f"{type(e).__name__}: {e}"
                    state.recorder.record(
                        "fleet_timeline_error", replica=name,
                        error=errors[name],
                    )
                    continue
                fragments.append((name, frag))
            merged = stitch_timelines(router_frag, fragments)
            merged["dllama"]["request_id"] = rid
            merged["dllama"]["trace_id"] = entry["trace_id"]
            merged["dllama"]["replicas"] = entry["replicas"]
            merged["dllama"]["failovers"] = entry["failovers"]
            if errors:
                merged["dllama"]["fetch_errors"] = errors
            self._json(merged)

        def _fleet_recorder(self) -> None:
            """GET /v1/fleet/debug/recorder — the fleet postmortem in one
            fetch: the router's flight-recorder ring (router_failover /
            router_stall / router_spill / drain / scrape events) plus
            every replica's ring (or the fetch error in its place)."""
            out: dict = {"router": state.recorder.dump(), "replicas": {}}
            for name in sorted(state.registry.names):
                url = state.registry.url_of(name)
                try:
                    out["replicas"][name] = self._fetch_json(
                        f"{url}/v1/debug/recorder"
                    )
                except (OSError, ValueError) as e:
                    out["replicas"][name] = {
                        "error": f"{type(e).__name__}: {e}"
                    }
                    state.recorder.record(
                        "fleet_recorder_error", replica=name,
                        error=f"{type(e).__name__}: {e}",
                    )
            self._json(out)

        def _fleet_series(self, params: dict) -> None:
            """GET /v1/debug/series on the router — same shape as the
            replica endpoint (the shared /dashboard JS reads either) but
            backed by the FLEET store: aggregate goodput, per-replica
            TPOT p50, skew, failover counters."""
            store = state.fleet.store
            name = (params.get("name") or [None])[0]
            if name is None:
                self._json(
                    {
                        "names": store.names(),
                        "interval_s": store.interval_s,
                        "retention_s": store.retention_s,
                        "anomaly": state.fleet.monitor.status(),
                    }
                )
                return
            try:
                window = float((params.get("window") or ["300"])[0])
            except ValueError:
                self._json({"error": {"message": "bad window"}}, 400)
                return
            result = store.query(name, window)
            if result is None:
                self._json(
                    {"error": {"message": f"no series {name!r}"}}, 404
                )
                return
            self._json(result)

        def _fleet_payload(self) -> dict:
            views = state.registry.views()
            agg = {
                "lanes_total": sum(v.lanes for v in views.values()),
                "in_flight": sum(v.in_flight for v in views.values()),
                "parked": sum(v.parked for v in views.values()),
                "max_streams": sum(
                    v.max_streams for v in views.values()
                ),
                "states": {},
            }
            for v in views.values():
                agg["states"][v.state] = agg["states"].get(v.state, 0) + 1
            return {
                "router": {
                    "routing": state.routing,
                    "affinity_k": state.affinity_k,
                    "failover_max": state.failover_max,
                    "stall_timeout_s": state.stall_timeout_s,
                    "model": state.model_name,
                },
                "aggregate": agg,
                "replicas": state.registry.snapshot(),
            }

        # ----------------------------------------------------------- POST

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path == "/v1/drain":
                self._drain(parse_qs(query))
                return
            if path != "/v1/chat/completions":
                self.send_error(404, "Not Found")
                return
            # fleet identity: minted HERE, forwarded on every
            # relay and failover re-issue, echoed back to the client —
            # the one id that stitches router spans, replica spans,
            # recorder events and trace JSONL into a single story
            rid = f"req-{uuid.uuid4().hex[:12]}"
            trace = f"trace-{uuid.uuid4().hex[:12]}"
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                messages = body.get("messages")
                if not isinstance(messages, list) or not messages:
                    raise ValueError("messages required")
                with state.spans.span(
                    "tokenize", component="router", request_id=rid
                ):
                    tokens = state.prompt_tokens(messages)
            except (ValueError, KeyError, TypeError) as e:
                state.m_requests.labels(
                    replica="none", outcome="bad_request"
                ).inc()
                self._json({"error": {"message": f"bad request: {e}"}}, 400)
                return
            with state.spans.span(
                "route_plan", component="router", request_id=rid,
                n_prompt_tokens=len(tokens),
            ) as route_h:
                plan = state.route(tokens)
                state.spans.end(
                    route_h,
                    target=plan.target,
                    candidates=list(plan.candidates),
                )
            state.ledger.open(rid, trace)
            plan.candidates = state.order_by_backoff(plan.candidates)
            if not plan.candidates:
                state.m_requests.labels(
                    replica="none", outcome="unavailable"
                ).inc()
                ra = state.min_shed_wait_s() or 2
                self._json(
                    {
                        "error": {
                            "message": "no replica available",
                            "retryable": True,
                            "retry_after_s": ra,
                        }
                    },
                    503,
                    retry_after=ra,
                )
                return
            if body.get("stream"):
                self._relay_stream(body, tokens, plan, rid, trace)
            else:
                self._relay_unary(body, plan, rid, trace)

        def _drain(self, params: dict) -> None:
            """POST /v1/drain?replica=NAME — forward the drain and stop
            routing to the replica immediately."""
            name = (params.get("replica") or [None])[0]
            if name is None or name not in state.registry.names:
                self._json(
                    {
                        "error": {
                            "message": "replica query param required, one "
                            f"of {sorted(state.registry.names)}",
                        }
                    },
                    400,
                )
                return
            url = state.registry.url_of(name)
            try:
                req = urllib.request.Request(
                    f"{url}/v1/drain", data=b"", method="POST"
                )
                with urllib.request.urlopen(req, timeout=10.0) as r:
                    payload = json.loads(r.read())
            except (OSError, ValueError) as e:
                state.recorder.record(
                    "router_drain_error", replica=name,
                    error=f"{type(e).__name__}: {e}",
                )
                self._json(
                    {"error": {"message": f"drain forward failed: {e}"}},
                    502,
                )
                return
            state.registry.mark_draining(name)
            state.recorder.record("router_drain", replica=name)
            payload["replica"] = name
            self._json(payload)

        # --------------------------------------------------- unary relay

        def _relay_unary(
            self, body: dict, plan: RoutePlan, rid: str, trace: str
        ) -> None:
            """Non-stream requests: whole-request retry on the next
            candidate (greedy/seeded requests reproduce; an unseeded
            sampled request re-samples)."""
            headers = self._fleet_headers(rid, trace)
            shed_ra = None  # smallest upstream Retry-After seen
            for name in plan.candidates:
                relay_h = state.spans.begin(
                    "relay", component="router", request_id=rid,
                    replica=name,
                )
                res = self._open_upstream(
                    state.registry.url_of(name), body, headers
                )
                kind = res[0]
                if kind == "refused":
                    state.registry.mark_dead(name, "connect")
                    state.m_spills.labels(reason="refused").inc()
                    state.m_requests.labels(
                        replica=name, outcome="refused"
                    ).inc()
                    state.recorder.record(
                        "router_spill", reason="refused", replica=name,
                        request_id=rid,
                    )
                    state.spans.end(relay_h, outcome="refused")
                    continue
                if kind == "stream":  # impossible for stream=False
                    res[1].close()
                    state.m_requests.labels(
                        replica=name, outcome="protocol"
                    ).inc()
                    state.spans.end(relay_h, outcome="protocol")
                    continue
                _, status, data, retry_after = res
                if status in (429, 503):
                    state.note_shed(name, retry_after)
                    ra = _retry_after_s(retry_after)
                    shed_ra = ra if shed_ra is None else min(shed_ra, ra)
                    state.m_spills.labels(reason="shed").inc()
                    state.m_requests.labels(
                        replica=name, outcome="shed"
                    ).inc()
                    state.recorder.record(
                        "router_spill", reason="shed", replica=name,
                        request_id=rid, status=status,
                    )
                    state.spans.end(relay_h, outcome="shed")
                    continue
                state.m_requests.labels(
                    replica=name,
                    outcome="ok" if status == 200 else f"http_{status}",
                ).inc()
                if name == plan.target:
                    state.m_affinity_hits.inc()
                state.ledger.touch(rid, name)
                state.spans.end(relay_h, outcome=f"http_{status}")
                self.send_response(status)
                self.send_header(
                    "Content-Type", "application/json; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(data)))
                self.send_header("x-dllama-request", rid)
                self.send_header("x-dllama-trace", trace)
                self.end_headers()
                self.wfile.write(data)
                return
            state.m_requests.labels(
                replica="none", outcome="unavailable"
            ).inc()
            # propagate the fleet's own prediction: the smallest upstream
            # Retry-After seen this request (replicas derive it from
            # predicted queue-drain time), not a constant
            ra = shed_ra if shed_ra is not None else 2
            self._json(
                {
                    "error": {
                        "message": "all replicas refused or shed",
                        "retryable": True,
                        "retry_after_s": ra,
                    }
                },
                503,
                retry_after=ra,
            )

        # -------------------------------------------------- stream relay

        def _fleet_headers(self, rid: str, trace: str) -> dict:
            """Relay headers: the trace-propagation pair plus the
            client's deadline hint (``x-dllama-deadline-ms``), forwarded
            verbatim so replica-side predictive admission sees the same
            budget on the first issue AND on failover re-issues."""
            headers = {"x-dllama-trace": trace, "x-dllama-request": rid}
            ddl = self.headers.get("x-dllama-deadline-ms")
            if ddl:
                headers["x-dllama-deadline-ms"] = ddl
            return headers

        def _open_upstream(
            self, base_url: str, req_body: dict,
            headers: dict | None = None,
        ):
            """POST to a replica. Returns one of
            ``("stream", conn, resp)`` (SSE accepted),
            ``("response", status, body_bytes, retry_after)``, or
            ``("refused", reason)`` (connect/send failure). ``headers``
            carries the trace-propagation pair on every issue AND
            re-issue, so failed-over requests keep their identity."""
            u = urlsplit(base_url)
            conn = http.client.HTTPConnection(
                u.hostname, u.port, timeout=state.stall_timeout_s
            )
            try:
                conn.request(
                    "POST",
                    "/v1/chat/completions",
                    json.dumps(req_body),
                    {"Content-Type": "application/json", **(headers or {})},
                )
                resp = conn.getresponse()
            except OSError as e:
                conn.close()
                return ("refused", f"{type(e).__name__}: {e}")
            ctype = resp.getheader("Content-Type") or ""
            if resp.status == 200 and "text/event-stream" in ctype:
                return ("stream", conn, resp)
            try:
                data = resp.read()
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                return ("refused", f"{type(e).__name__}: {e}")
            retry_after = resp.getheader("Retry-After")
            conn.close()
            return ("response", resp.status, data, retry_after)

        def _client_chunk(self, obj: dict) -> None:
            _sse_write(self.wfile, f"data: {json.dumps(obj)}\r\n\r\n")

        def _client_done(self) -> None:
            _sse_write(self.wfile, "data: [DONE]\r\n\r\n")
            self.wfile.write(b"0\r\n\r\n")

        def _sse_headers(
            self, rid: str | None = None, trace: str | None = None
        ) -> None:
            self.send_response(200)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header(
                "Content-Type", "text/event-stream; charset=utf-8"
            )
            self.send_header("Transfer-Encoding", "chunked")
            if rid is not None:
                # echo the fleet identity so clients/tests can fetch the
                # stitched timeline for the stream they just consumed
                self.send_header("x-dllama-request", rid)
            if trace is not None:
                self.send_header("x-dllama-trace", trace)
            self.end_headers()

        def _synth_delta(self, text: str) -> dict:
            """A router-synthesized catch-up chunk: the exact text the
            dead replica had consumed but not yet flushed."""
            return {
                "id": "cmpl-1",
                "object": "chat.completion.chunk",
                "created": int(time.time()),
                "model": state.model_name,
                "choices": [
                    {
                        "index": 0,
                        "finish_reason": None,
                        "delta": {"role": "assistant", "content": text},
                    }
                ],
            }

        def _relay_frames(self, resp, book: dict) -> None:
            """Relay one upstream SSE stream until ``[DONE]``, keeping
            the failover books: ``emitted`` (generated token ids),
            ``exact`` (exact consumed text via dllama_piece) and
            ``relayed`` (delta text the client has) plus ``t_last`` (the
            clock at the last relayed frame — the stall-detect span's
            retroactive start). Raises _StreamDeath on EOF / stall /
            retryable error; raises OSError if OUR client's socket
            fails."""
            while True:
                book["t_last"] = time.perf_counter()
                try:
                    line = resp.readline()
                except (
                    http.client.HTTPException,
                    ConnectionError,
                    TimeoutError,
                    OSError,
                    ValueError,
                ) as e:
                    raise _StreamDeath(
                        f"read_{type(e).__name__}"
                    ) from e
                if not line:
                    raise _StreamDeath("eof")
                line = line.strip()
                if not line.startswith(b"data:"):
                    continue
                payload = line[5:].strip()
                if payload == b"[DONE]":
                    if book.get("finish") is None and "error" not in book:
                        # a stream must end with a finish chunk or an
                        # error frame; a bare [DONE] is a broken replica
                        raise _StreamDeath("no_finish")
                    return
                try:
                    obj = json.loads(payload)
                except ValueError as e:
                    raise _StreamDeath("bad_frame") from e
                if "error" in obj:
                    err = obj["error"]
                    if err.get("retryable"):
                        raise _StreamDeath(
                            f"retryable:{err.get('message', '')}"
                        )
                    # non-retryable (client-caused): forward verbatim,
                    # the stream is over
                    book["error"] = err
                    self._client_chunk({"error": err})
                    continue
                tokens = obj.pop("dllama_tokens", None)
                piece = obj.pop("dllama_piece", None)
                choice = (obj.get("choices") or [{}])[0]
                text = (choice.get("delta") or {}).get("content")
                # books BEFORE the client write: a dead client aborts
                # the whole request anyway (OSError propagates)
                if tokens:
                    book["emitted"].extend(int(t) for t in tokens)
                if piece:
                    book["exact"] += piece
                if choice.get("finish_reason"):
                    book["finish"] = choice["finish_reason"]
                self._client_chunk(obj)
                if text:
                    book["relayed"] += text

        def _relay_stream(
            self, body: dict, prompt_tokens: list[int], plan: RoutePlan,
            rid: str, trace: str,
        ) -> None:
            """Stream with mid-stream failover (the tentpole headline);
            see the module docstring for the resume contract. Every
            attempt is a router ``relay`` span; a death opens a
            ``failover`` span that stays open across the re-issue and
            ends when the catch-up delta lands from the sibling — THAT
            span is the client-visible gap, and its duration feeds
            ``dllama_router_failover_gap_seconds``."""
            book: dict = {"emitted": [], "exact": "", "relayed": ""}
            headers = self._fleet_headers(rid, trace)
            shed_ra = None  # smallest upstream Retry-After seen
            max_tokens = int(body.get("max_tokens", -1) or -1)
            started = False     # SSE headers sent to OUR client
            first_replica = None
            failovers = 0
            gap_h = None        # open failover span (death -> caught up)
            gap_t0 = None
            try:
                for name in plan.candidates:
                    resuming = bool(book["emitted"])
                    upstream = dict(body)
                    upstream["stream"] = True
                    upstream["include_tokens"] = True
                    upstream.pop("resume_tokens", None)
                    if resuming:
                        upstream["resume_tokens"] = (
                            prompt_tokens + book["emitted"]
                        )
                        upstream.pop("messages", None)
                        if max_tokens > 0:
                            upstream["max_tokens"] = max(
                                1, max_tokens - len(book["emitted"])
                            )
                    relay_h = state.spans.begin(
                        "relay", component="router", request_id=rid,
                        replica=name, resumed=resuming,
                    )
                    res = self._open_upstream(
                        state.registry.url_of(name), upstream, headers
                    )
                    kind = res[0]
                    if kind == "refused":
                        state.registry.mark_dead(name, "connect")
                        state.m_spills.labels(reason="refused").inc()
                        state.m_requests.labels(
                            replica=name, outcome="refused"
                        ).inc()
                        state.recorder.record(
                            "router_spill", reason="refused",
                            replica=name, request_id=rid,
                        )
                        state.spans.end(relay_h, outcome="refused")
                        continue
                    if kind == "response":
                        _, status, data, _ra = res
                        if status in (429, 503):
                            state.note_shed(name, _ra)
                            ra = _retry_after_s(_ra)
                            shed_ra = (
                                ra if shed_ra is None else min(shed_ra, ra)
                            )
                            state.m_spills.labels(reason="shed").inc()
                            state.m_requests.labels(
                                replica=name, outcome="shed"
                            ).inc()
                            state.recorder.record(
                                "router_spill", reason="shed",
                                replica=name, request_id=rid,
                                status=status,
                            )
                            state.spans.end(relay_h, outcome="shed")
                            continue
                        # non-retryable upstream answer (e.g. 400): if
                        # the client stream hasn't started, forward it;
                        # mid-failover it terminates the stream below
                        state.m_requests.labels(
                            replica=name, outcome=f"http_{status}"
                        ).inc()
                        state.spans.end(
                            relay_h, outcome=f"http_{status}"
                        )
                        if not started:
                            self.send_response(status)
                            self.send_header(
                                "Content-Type",
                                "application/json; charset=utf-8",
                            )
                            self.send_header(
                                "Content-Length", str(len(data))
                            )
                            self.end_headers()
                            self.wfile.write(data)
                            return
                        break
                    _, conn, resp = res
                    if first_replica is None:
                        first_replica = name
                    state.ledger.touch(rid, name)
                    if not started:
                        self._sse_headers(rid, trace)
                        started = True
                    if resuming:
                        # catch-up: exact consumed text the dead replica
                        # never flushed (its detector holdback). After
                        # this, relayed == exact and the sibling's fresh
                        # deltas append cleanly.
                        with state.spans.span(
                            "catch_up_synthesis", component="router",
                            request_id=rid, replica=name,
                        ) as catch_h:
                            gap = book["exact"][len(book["relayed"]):]
                            if gap:
                                self._client_chunk(self._synth_delta(gap))
                                book["relayed"] += gap
                            state.spans.end(
                                catch_h, catch_up_chars=len(gap)
                            )
                        # the client is whole again: close the gap span
                        # and book the recovery latency
                        state.spans.end(gap_h, to_replica=name)
                        gap_h = None
                        if gap_t0 is not None:
                            gap_s = time.perf_counter() - gap_t0
                            state.m_gap.observe(gap_s)
                            state.ledger.close_failover(rid, name, gap_s)
                            gap_t0 = None
                    try:
                        self._relay_frames(resp, book)
                    except _StreamDeath as death:
                        conn.close()
                        reason = str(death)
                        state.spans.end(
                            relay_h, outcome="died", reason=reason
                        )
                        if reason.startswith("read_Timeout"):
                            # a stall, not a crash: the socket was alive
                            # but silent past the watchdog timeout
                            state.m_stalls.inc()
                            state.recorder.record(
                                "router_stall", replica=name,
                                request_id=rid,
                                stall_timeout_s=state.stall_timeout_s,
                            )
                            # retroactive stall-detect span: it BEGAN at
                            # the last relayed frame, we only know now
                            stall_h = state.spans.begin(
                                "stall_detect", component="router",
                                request_id=rid, replica=name,
                            )
                            if (
                                stall_h is not None
                                and book.get("t_last") is not None
                            ):
                                stall_h.t0 = book["t_last"]
                            state.spans.end(stall_h)
                        state.m_failovers.inc()
                        state.m_requests.labels(
                            replica=name, outcome="died"
                        ).inc()
                        state.recorder.record(
                            "router_failover",
                            replica=name,
                            reason=reason,
                            emitted_tokens=len(book["emitted"]),
                            request_id=rid,
                            trace_id=trace,
                        )
                        state.ledger.failover(
                            rid, from_replica=name, reason=reason,
                            emitted_tokens=len(book["emitted"]),
                        )
                        gap_h = state.spans.begin(
                            "failover", component="router",
                            request_id=rid, from_replica=name,
                            reason=reason,
                            emitted_tokens=len(book["emitted"]),
                        )
                        gap_t0 = time.perf_counter()
                        failovers += 1
                        if failovers > state.failover_max:
                            break
                        continue
                    # clean end: upstream sent finish (or a
                    # non-retryable error frame) then [DONE]
                    conn.close()
                    state.spans.end(
                        relay_h,
                        outcome="error" if "error" in book else "ok",
                        relayed_tokens=len(book["emitted"]),
                    )
                    state.m_requests.labels(
                        replica=name,
                        outcome="error" if "error" in book else "ok",
                    ).inc()
                    if first_replica == plan.target:
                        state.m_affinity_hits.inc()
                    self._client_done()
                    return
                # candidates (or the failover budget) exhausted
                state.spans.end(gap_h, outcome="lost")
                gap_h = None
                state.m_requests.labels(
                    replica="none", outcome="unavailable"
                ).inc()
                if not started:
                    ra = shed_ra if shed_ra is not None else 2
                    self._json(
                        {
                            "error": {
                                "message": "all replicas refused or shed",
                                "retryable": True,
                                "retry_after_s": ra,
                            }
                        },
                        503,
                        retry_after=ra,
                    )
                    return
                self._client_chunk(
                    {
                        "error": {
                            "message": "stream lost: failover budget "
                            "exhausted",
                            "retryable": True,
                        }
                    }
                )
                self._client_done()
            except OSError:
                # OUR client went away mid-relay; the upstream replica's
                # lane notices its own socket close via cancellation
                state.m_requests.labels(
                    replica=first_replica or "none",
                    outcome="client_gone",
                ).inc()
                self.close_connection = True

    return RouterHandler


def serve_router(
    registry: ReplicaRegistry,
    tokenizer: Tokenizer,
    host: str = "127.0.0.1",
    port: int = 0,
    chat_template_type: ChatTemplateType = ChatTemplateType.UNKNOWN,
    model_name: str = "dllama-fleet",
    affinity_k: int | None = None,
    failover_max: int | None = None,
    stall_timeout_s: float | None = None,
    routing: str = "affinity",
    seed: int = 0,
    start_poller: bool = True,
) -> ThreadingHTTPServer:
    """Build the front door. The caller runs ``serve_forever()`` (tests
    drive it in a thread); ``server_close()`` stops the health poller."""
    state = RouterState(
        registry,
        tokenizer,
        chat_template_type=chat_template_type,
        model_name=model_name,
        affinity_k=affinity_k,
        failover_max=failover_max,
        stall_timeout_s=stall_timeout_s,
        routing=routing,
        seed=seed,
    )
    registry.poll_once()  # seed states before the first request
    if start_poller:
        registry.start()
        # the fleet sampler rides the poller decision: tests that drive
        # polls synchronously also drive scrapes/samples synchronously
        # (state.fleet.sampler / scrape_once), so no background thread
        # races their assertions
        state.fleet.start()
    server = ThreadingHTTPServer((host, port), make_router_handler(state))
    server.state = state
    inner_close = server.server_close

    def _close_and_stop():
        inner_close()
        registry.stop()
        state.fleet.close()

    server.server_close = _close_and_stop
    return server


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        prog="dllama-tpu-torch-router",
        description="Prefix-affinity fleet router",
    )
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=9980)
    parser.add_argument(
        "--replica", action="append", required=True, metavar="NAME=URL",
        help="replica endpoint, repeatable: r0=http://127.0.0.1:9990",
    )
    parser.add_argument("--tokenizer", required=True)
    parser.add_argument(
        "--chat-template", default=None,
        choices=sorted(CHAT_TEMPLATE_NAMES),
    )
    parser.add_argument("--model-name", default="dllama-fleet")
    parser.add_argument("--affinity-k", type=int, default=None)
    parser.add_argument("--failover-max", type=int, default=None)
    parser.add_argument("--stall-timeout-s", type=float, default=None)
    parser.add_argument(
        "--routing", default="affinity", choices=("affinity", "random")
    )
    args = parser.parse_args(argv)

    replicas = {}
    for spec in args.replica:
        name, sep, url = spec.partition("=")
        if not sep or not name or not url:
            raise SystemExit(f"--replica must be NAME=URL, got {spec!r}")
        replicas[name] = url.rstrip("/")
    _, _, _, poll_s = resolve_fleet_knobs()
    registry = ReplicaRegistry(replicas, poll_interval_s=poll_s)
    tok = Tokenizer(args.tokenizer)
    ttype = (
        CHAT_TEMPLATE_NAMES[args.chat_template]
        if args.chat_template
        else ChatTemplateType.UNKNOWN
    )
    server = serve_router(
        registry,
        tok,
        host=args.host,
        port=args.port,
        chat_template_type=ttype,
        model_name=args.model_name,
        affinity_k=args.affinity_k,
        failover_max=args.failover_max,
        stall_timeout_s=args.stall_timeout_s,
        routing=args.routing,
    )
    print(
        f"Router URL: http://localhost:{server.server_address[1]}/v1/ "
        f"({len(replicas)} replicas, routing={args.routing})"
    )
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
