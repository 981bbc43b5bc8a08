"""OpenAI-compatible HTTP API server: one request at a time, or lanes.

    python -m dllama_tpu_torch.runtime.api_server --model m.m --tokenizer t.t \\
        [--batch-size 4] [--kv-page-size 16] [--kv-native 0|1] [--weight-format q40] \\
        [--device cuda|cpu] \\
        [--faults SPEC] [--retry-max N] [--max-queue-depth N] [--max-streams N] \\
        [--trace-out PATH] [--timeline-out PATH] [--postmortem-dir DIR] \\
        [--slo-ttft-ms MS] [--slo-tpot-ms MS] [--series-retention S] \\
        [--admission-predict] [--admission-max-wait-ms MS] [--deadline-default-ms MS] \\
        [--deadline-priority-step-ms MS] [--replica-id NAME] [--tp N] [--sp N]

The port's core of dllama_tpu/runtime/api_server.py (reference:
src/dllama-api.cpp):

* ``POST /v1/chat/completions`` — chat completion, streamed (SSE) or not,
  with ``temperature``, ``top_p``, ``seed``, ``max_tokens`` and ``stop``
  (src/dllama-api.cpp:491-520), greedy or sampled per request;
* ``GET /v1/models`` — single-model listing (src/dllama-api.cpp:538-547);
* ``GET /v1/health`` — status (``ok``, ``degraded`` with its
  ``degraded_reasons`` from the watchdog and the anomaly monitor, or
  ``draining``), model name, lane occupancy, queue depth, uptime, the KV
  pool (pages, radix hits, COW forks, its dtype and the device bytes of a
  page), the speculation counters and the resilience counters;
* ``POST /v1/drain`` — graceful drain (SIGTERM too): admission stops,
  the streams in flight run to their end, then ``drained`` is set;
* ``GET /metrics`` — the registry in Prometheus text (obs/metrics.py),
  after the refresh hooks (device memory, SLO windows, step cost);
* ``GET /v1/debug/recorder``, ``/memory``, ``/kv``, ``/compile``,
  ``/timeline`` (``?request_id=``, ``replica``, ``pid_prefix``,
  ``pid_base``), ``/slo``, ``/series`` (``?name=&window=``),
  ``/admission`` — the flight recorder's ring, device memory against the
  engine's analytic ``memory_report``, the pool and radix tree, the graph
  keys with their capture seconds and analytic costs and the roofline by
  kind, the span timeline as Chrome-trace JSON, the SLO windows, the
  in-process series, the load predictor's calibration with the occupancy
  it forecasts against and its recent errors;
* ``GET /v1/debug/xlalint`` — the lint of every CUDA graph the engine
  captured (analysis/graphlint.py, `InferenceEngine.xlalint_report`): each
  graph's census, the findings new and baselined, the keys with no graph;
* ``POST /v1/debug/profile`` — a ``torch.profiler`` capture (CPU, and CUDA
  on the card) of ``seconds`` written as a Chrome trace into ``out_dir``;
  it starts and stops on the scheduler thread between dispatches, each
  declared to the watchdog as a pause (`profile_capture`); 409 while one
  runs, 500 when the capture fails;
* ``GET /dashboard`` — the live single-file dashboard; ``/health`` and
  ``/healthz`` — liveness.

With ``--batch-size 1`` (the default, as the JAX CLI's) the server is the
reference's serialized loop (src/dllama-api.cpp:367-487): each request
takes the engine lock (its queue wait is the lock wait) and runs
`ApiState.complete` on the engine's single-stream slab. A `NaiveCache`
remembers the conversation the slab holds: a request that extends it
prefills only the new messages from the cached end position (the
``dllama.reused_prefix_tokens`` of the response); anything else resets the
slab. A ``max_tokens`` cut runs one KV-only step so the next turn resumes
from a complete context; a conversation that reaches seq_len resets. A
dispatch that fails zeroes the slab and moves the engine's
``cache_epoch`` (its guard), and a moved epoch clears the NaiveCache: the
next request starts cold. Errors answer 400 (the client's: a prompt too
long) or 500 (the engine's) as JSON, in a stream as an error event before
``[DONE]``; ``resume_tokens`` is refused (400: it needs the lanes).
Shedding and drain work as on the lanes, with no queue to shed on and the
JAX floors as every ``Retry-After``; there is no watchdog or load
predictor on this path (as in the JAX server).

With ``--batch-size`` > 1 a `LaneScheduler` thread owns every engine
call. It admits queued requests FIFO into the least-recently-used free
lane, matches each conversation against the shared radix tree of served
prefixes (`kv.manager`), adopts the covering pool pages, prefills the rest
one bounded chunk a tick, and steps every active lane together in decode
blocks (on the card, CUDA graphs that `InferenceEngine.rehearse_admission`
captures before the scheduler starts: every lane-prefill bucket, the
greedy and the sampled block). A finished stream publishes its whole pages
to the tree. The lanes run in one of two modes (`resolve_kv_knobs`:
``--kv-native``, else ``DLLAMA_KV_NATIVE``, else 0, the JAX default):
slab lanes keep their KV in the engine's lanes' slab and adopt and publish
by copies (an adopt tick only when there are pages to copy); pool-native
lanes keep it in the pool, adopt with no device copy (a fork of a mid-page
boundary is the one copy) and publish by ownership. A page size < 0 runs
slab lanes with no pool at all (the sharing-off baseline).

Resilience (the JAX server's port of the reference's crash-retry loop,
src/dllama-api.cpp:616-628): every engine dispatch (prefill chunk, decode
block, verify pass, adopt) goes through `LaneScheduler._retry_dispatch`,
which retries a failure up to ``--retry-max`` times with a doubling
backoff while the engine's ``cache_epoch`` stands still (the pool is
intact: the dispatch did nothing). A failure that moved the epoch reset
the pool (the engine's dispatch guard): `_recover` resets the page
accounting and turns every surviving stream into a resume that re-prefills
its history from host-side truth and reinstalls its untouched lane state,
so the stream goes on where it was (in f32 byte for byte; in bf16 the
re-made rows carry the prefill kernels' roundings, not decode's); only the
lane whose own admission poisoned the pool fails, with a retryable error. In
slab mode a failed lane step zeroes the lanes' slab, not the pool: the
resumes re-adopt their published prefixes and re-prefill the rest; a
failed publish zeroes the pool, not the slab (the manager resets its
accounting, and the streams go on). Retries
exhausted on an intact pool fail the in-flight requests with a retryable
error (503 and ``Retry-After``), and the scheduler keeps serving. The
chaos plane (runtime/faults.py, ``--faults``) injects such failures on
purpose. ``--max-queue-depth`` sheds by ``priority`` (``low`` at half the
depth, ``high`` at twice it; 429 and ``Retry-After``); a drain answers 503
with ``Retry-After`` of at least 5. With ``--max-streams`` above the lane count, a
queued request parks the most-progressed stream (its whole pages published,
its lane freed, its job requeued); the resume adopts the pages with no
device copy and re-prefills only the page tail.

Speculation (``--speculation off|ngram|shared|draft``, ``--spec-k``;
runtime/spec.py): each greedy lane keeps an n-gram drafter over its own
history (``ngram``) and, with ``shared``, drafts from the continuations its
sibling streams under the same radix anchor published. Each tick every
lane with a draft goes through ONE batched verify pass
(`InferenceEngine.verify_lanes`: one forward of 1 + k rows a lane at its
own position through the page pool); the lane emits its longest draft
prefix that agrees with the pass's argmax plus one correction token, each
through the decode block's per-token path, so greedy streams are the same
bytes as with ``off``. Sampled lanes and greedy lanes without a draft take
the decode block in the same tick. ``draft`` (``--draft-model PATH``, else
``DLLAMA_DRAFT_MODEL``: a checkpoint with the target's vocab, loaded dense
beside it by `serve`) adds a resident draft model behind both n-gram
sources: the lanes they leave dry catch their draft rows up on their
verified history and take one batched greedy k-step proposal a tick
(`InferenceEngine.draft_prefill`, ``draft_propose``); the scheduler keeps a
draft cursor a lane, moved past the accepted rows by each verify and
dropped at release, park, recovery and a reset draft cache, and a failed
draft dispatch only skips model drafting for the tick. ``off`` (the
default) builds no drafters, no store and no verify graphs.

Observability (obs/, the JAX server's): every serving family of the JAX
``ApiState``, fed where the JAX scheduler feeds them; a request span (``--trace-out``) and timeline spans for the queue,
the admission steps, decode, parks and publishes around the engine's own;
the windowed SLOs (``--slo-ttft-ms``, ``--slo-tpot-ms``); a series sampler
(``--series-retention``) whose ticks drive the anomaly monitor; the
watchdog, beaten each scheduler tick and told of each dispatch. Either of
the last two puts ``/v1/health`` in ``degraded``, which sheds ``low``
requests (429, ``Retry-After`` of at least 2). The sampler and the watchdog start
after ``rehearse_admission``, so their threads never run beside a
rehearsal capture; the refresh hooks they run read host-side numbers only.
``resilience_stats`` and ``spec_stats`` read the registry's counters, less
their values when the scheduler started (one registry serves the process);
the counts without a family stay plain attributes.

Admission (runtime/admission.py, the JAX server's): a `LoadPredictor`
forecasts each request's TTFT and TPOT from the engine's measured step
seconds (the analytic bound and cold floors before enough dispatches),
the lanes' occupancy and the radix match; admission records its forecast
and a clean finish scores it (``dllama_admission_*``, the EWMA
corrections). Every ``Retry-After`` (sheds and retryable errors) is the
predicted queue drain, the JAX server's constants its floors. With
``--admission-predict`` the pending queue is picked by earliest effective
deadline (``deadline_ms`` / ``ttft_budget_ms`` body fields, the
``x-dllama-deadline-ms`` header; unhinted requests by priority offsets, so
with no hints the order is priority, then arrival), a hinted request whose
forecast misses its budget even if admitted now is refused as
``infeasible`` (429) before it queues, and `LaneScheduler._maybe_preempt`
parks a lower-priority or deadline-blown stream when that lets the EDF
head meet its budget (``dllama_preemptions_total``); the victim resumes
byte for byte. The EDF keys, the preemption's clock and the scored TTFTs
all read the scheduler's ``_clock``.

Under tensor, sequence, pipeline and data parallelism (``--tp``, ``--sp``,
``--pp``, ``--dp``) the server runs on rank 0 and the other ranks follow it (parallel/control.py): `main` makes
this process rank 0 and starts the others (parallel/launch.lead), or takes
torchrun's ranks; rank 0 sends each engine dispatch, with every value it
drew, to the followers before it runs it, so the scheduler, the KV
manager, speculation, the chaos plane and admission run on rank 0 alone.
All three modes run: slab lanes (every axis), pool-native lanes (tp and
dp; pp and sp refuse them, as the JAX engine does) and the serialized
path. A drain (``SIGTERM``, ``POST /v1/drain``) stops the
server once it has drained, then every rank; a lost rank stops it too.
``/v1/health`` gives ``parallel`` (tp, sp, the backend, the ranks, and pp
and dp past 1) and
``/v1/debug/memory`` rank 0's own bytes.

A fleet replica (fleet/, the JAX server's side of the router's contract):
``--replica-id`` names the server in ``/v1/health`` (``replica``), tags
every span its scheduler and handler threads begin, and scopes its
``sse_flush`` faults (``sse_flush:op=r1:...``). A request with
``include_tokens`` streams each delta with ``dllama_tokens`` (the generated
ids consumed since the last delta) and ``dllama_piece`` (their exact text,
which the EOS detector's holdback may keep ahead of the delta's), so a
router can resume a dead replica's stream on a sibling with
``resume_tokens``. The router's ``x-dllama-trace`` / ``x-dllama-request``
headers become the request's trace and request ids, and a
``trace_adopt`` recorder event names the replica before the shed gate.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import torch

from ..kv.manager import PagedKVManager
from ..obs.anomaly import DEFAULT_SIGNAL_SERIES, AnomalyMonitor, build_default_rules
from ..obs.dashboard import DASHBOARD_CONTENT_TYPE, render_dashboard
from ..obs.device import compare_with_analytic, memory_report, sample_device_memory
from ..obs.metrics import DEFAULT_TOKEN_BUCKETS_S, get_registry
from ..obs.recorder import get_recorder
from ..obs.slo import SloTracker, resolve_slo_knobs
from ..obs.spans import get_span_tracker, set_thread_replica
from ..obs.timeseries import MetricsSampler, SeriesStore, resolve_series_knobs
from ..obs.trace import Tracer
from ..obs.watchdog import EngineWatchdog, resolve_watchdog_knobs
from ..tokenizer import (
    CHAT_TEMPLATE_NAMES,
    ChatItem,
    ChatTemplateGenerator,
    ChatTemplateType,
    EosDetector,
    EosResult,
    Tokenizer,
)
from .admission import (
    LoadPredictor,
    OccupancySnapshot,
    effective_deadline_ms,
    resolve_admission_knobs,
    resolve_deadline_knobs,
)
from .engine import InferenceEngine
from .faults import get_fault_plane, set_fault_plane
from .spec import (
    DEFAULT_SPEC_K,
    SOURCE_DRAFT,
    NgramDrafter,
    SharedNgramStore,
    bucket_for,
    resolve_draft_model,
    resolve_spec_knobs,
    spec_buckets,
)

logger = logging.getLogger(__name__)

DEFAULT_LANE_BLOCK = 8
PRIORITIES = ("low", "normal", "high")
# shed when the queue holds this share of --max-queue-depth, by priority
SHED_FACTOR = {"low": 0.5, "normal": 1.0, "high": 2.0}
# the JAX server's Retry-After floors (seconds) under the predicted drain
RETRY_AFTER_DRAINING = 5
RETRY_AFTER_DEGRADED = 2
RETRY_AFTER = 1
# priority rank: a preemption victim ranks below the request it serves
PRIORITY_RANK = {"low": 0, "normal": 1, "high": 2}


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    return int(v) if v else default


def resolve_kv_knobs(kv_page_size: int | None = None, kv_pool_pages: int | None = None,
                     kv_native: bool | None = None) -> tuple[int, int, bool]:
    """The paged-KV knobs (the JAX server's): explicit (CLI flag) beats
    ``DLLAMA_KV_PAGE_SIZE`` / ``DLLAMA_KV_POOL_PAGES`` /
    ``DLLAMA_KV_NATIVE`` beats the defaults 0, 0 and 0. page_size 0: the
    manager's default (16); < 0: no pool (slab lanes with no prefix
    sharing, the sharing-off baseline). pool_pages 0: sized by the engine
    (2 * seq_len / page_size + 1 in slab mode; one sequence a lane plus two
    in native mode). kv_native 1: pool-native lanes (KV in the pool through
    a page table, adoption by page table, publish by ownership); 0: slab
    lanes (adopt and publish by copies)."""
    if kv_page_size is None:
        kv_page_size = _env_int("DLLAMA_KV_PAGE_SIZE", 0)
    if kv_pool_pages is None:
        kv_pool_pages = _env_int("DLLAMA_KV_POOL_PAGES", 0)
    if kv_native is None:
        kv_native = bool(_env_int("DLLAMA_KV_NATIVE", 0))
    return int(kv_page_size), int(kv_pool_pages), bool(kv_native)


def resolve_stream_knobs(max_streams: int | None = None) -> int:
    """Oversubscription knob: explicit (``--max-streams``) beats
    ``DLLAMA_MAX_STREAMS`` beats 0 (off: streams cap at the lane count).
    Above the lane count the scheduler parks a stream for a queued request
    and resumes it later (module docstring)."""
    if max_streams is None:
        max_streams = _env_int("DLLAMA_MAX_STREAMS", 0)
    return int(max_streams)


def resolve_resilience_knobs(retry_max: int | None = None, retry_backoff_ms: int | None = None,
                             max_queue_depth: int | None = None) -> tuple[int, int, int]:
    """Retry and shed knobs: explicit (CLI flag) beats the environment
    (``DLLAMA_RETRY_MAX``, ``DLLAMA_RETRY_BACKOFF_MS``,
    ``DLLAMA_MAX_QUEUE_DEPTH``) beats the defaults 3, 5 and 0. retry_max
    counts attempts after the first failure (0: no retries);
    max_queue_depth 0 sheds nothing."""
    if retry_max is None:
        retry_max = _env_int("DLLAMA_RETRY_MAX", 3)
    if retry_backoff_ms is None:
        retry_backoff_ms = _env_int("DLLAMA_RETRY_BACKOFF_MS", 5)
    if max_queue_depth is None:
        max_queue_depth = _env_int("DLLAMA_MAX_QUEUE_DEPTH", 0)
    return int(retry_max), int(retry_backoff_ms), int(max_queue_depth)


@dataclass
class ChatMessage:
    role: str
    content: str


@dataclass
class NaiveCacheItem:
    end_pos: int
    message: ChatMessage


class NaiveCache:
    """The serialized path's prompt-prefix KV reuse (the JAX server's;
    reference: src/dllama-api.cpp:298-343): the messages the engine's
    slab holds, each with the position its rows end at."""

    def __init__(self):
        self.items: list[NaiveCacheItem] = []

    def push(self, item: NaiveCacheItem) -> None:
        self.items.append(item)

    def clear(self) -> None:
        self.items = []

    def _matches_all(self, messages: list[ChatMessage]) -> bool:
        """True when ``messages`` strictly extends the cached conversation."""
        n = len(self.items)
        if n == 0 or len(messages) <= n:
            return False
        return all(self.items[i].message.role == messages[i].role
                   and self.items[i].message.content == messages[i].content for i in range(n))

    def probe(self, messages: list[ChatMessage]) -> int:
        """The start position a resolve would reuse, without changing the
        cache."""
        return self.items[-1].end_pos if self._matches_all(messages) else 0

    def resolve_delta_prompt(self, messages: list[ChatMessage]) -> tuple[list[ChatMessage], int]:
        """If ``messages`` extends the cached conversation, the new suffix
        and the cache's end position; else the cache is cleared and the
        whole conversation starts at 0."""
        if not self.items:
            return messages, 0
        if self._matches_all(messages):
            n = len(self.items)
            start_pos = self.items[-1].end_pos
            logger.info("naive cache hit: %d messages, pos %d", n, start_pos)
            return messages[n:], start_pos
        self.clear()
        return messages, 0


@dataclass
class InferenceParams:
    messages: list[ChatMessage] = field(default_factory=list)
    temperature: float = 0.8
    top_p: float = 0.9
    seed: int | None = None
    stream: bool = False
    max_tokens: int = -1
    stop: list[str] = field(default_factory=list)
    # load-shedding class (one of PRIORITIES; `ApiState.admission_decision`)
    priority: str = "normal"
    # latency budgets (runtime/admission.py): deadline_ms bounds the whole
    # completion, ttft_budget_ms the first token; either makes the request
    # hinted, which the predictive controller may refuse as infeasible and
    # EDF orders by its effective deadline
    deadline_ms: float | None = None
    ttft_budget_ms: float | None = None
    # a raw fed-token history that stands in for the chat template and the
    # tokenizer (the JAX server's fleet failover resume): the lanes admit it
    # like any prompt; the serialized path refuses it
    resume_tokens: list[int] | None = None
    # each SSE delta also carries the generated token ids and their exact
    # decoded text (``dllama_tokens`` / ``dllama_piece``), so a fleet router
    # can rebuild the stream's history at any flush (fleet/router.py)
    include_tokens: bool = False
    # the fleet's identity of the request (the router's x-dllama-trace /
    # x-dllama-request headers, forwarded on every relay and failover);
    # None outside a fleet
    trace_id: str | None = None
    request_id: str | None = None

    @property
    def deadline_hinted(self) -> bool:
        return self.deadline_ms is not None or self.ttft_budget_ms is not None


class LaneJob:
    """One request: the scheduler thread produces events, the HTTP handler
    thread consumes them. Events: ("delta", str) (with ``include_tokens`` a
    generated delta is a dict: ``text``, ``tokens``, ``piece``), ("done", finish_reason),
    ("error", {"message": ..., "retryable": ...}). The handler sets
    ``cancelled`` when the client goes away; the scheduler then frees the
    lane. The times (``perf_counter`` seconds) and ``lane`` /
    ``reused_prefix_tokens`` feed the response's ``dllama`` metadata.
    ``span`` is the request's lifecycle record (obs/trace.py; its id is the
    request id) and ``queue_span`` its open timeline span while it waits."""

    def __init__(self, params: InferenceParams, span, t_submit: float):
        self.params = params
        self.events: queue.Queue = queue.Queue()
        self.span = span
        self.queue_span = None
        self.request_id = span.request_id
        self.n_prompt_tokens = 0
        self.n_completion = 0
        self.buffer = ""
        self.cancelled = False
        self.lane: int | None = None
        self.reused_prefix_tokens = 0
        # submit, admission and first-token times on the scheduler's clock
        self.t_submit = t_submit
        self.t_admit: float | None = None
        self.t_first: float | None = None
        # a parked stream's preserved lane state, until its resume
        self._park_resume: _LaneState | None = None
        # predictive admission, on the scheduler's clock: the EDF key (set
        # at submit) and the forecast recorded at admission start, which
        # `_finish` scores
        self.edf_deadline_ms: float | None = None
        self.predicted_ttft_ms: float | None = None
        self.predicted_tpot_ms: float | None = None

    def metadata(self) -> dict:
        """Serving metadata for the client: request id, lane, TTFT, queue
        wait and reused prefix (the JAX server's ``dllama`` field)."""

        def ms(t0, t1):
            return None if t0 is None or t1 is None else round((t1 - t0) * 1000, 3)

        return {
            "request_id": self.request_id,
            "lane": self.lane,
            "ttft_ms": ms(self.t_submit, self.t_first),
            "queue_ms": ms(self.t_submit, self.t_admit),
            "reused_prefix_tokens": self.reused_prefix_tokens,
        }


@dataclass
class _LaneState:
    job: LaneJob
    pos: int
    token: int
    max_pos: int
    detector: EosDetector
    decoder: object  # tokenizer StreamDecoder
    temperature: float
    top_p: float
    seed: int | None = None
    # every token FED to the engine so far (prompt + generated). KV rows
    # [0, pos) hold history[:pos]; the last entry is the pending token whose
    # row the next decode step writes. _finish publishes history[:pos].
    history: list = field(default_factory=list)
    # the lane's drafter while a park or a recovery holds the state
    drafter: object = None
    # the request's open "decode" timeline span (obs/spans.py)
    decode_span: object = None
    # include_tokens: the (token id, piece) pairs consumed since the last
    # flushed delta; the detector's holdback makes a delta's text lag its
    # tokens, so each delta carries the exact ids and text behind it
    tape: list = field(default_factory=list)


@dataclass
class _AdmittingLane:
    """A request mid-admission: its adopt and its prompt's chunks run one
    per scheduler tick, interleaved with decode blocks for the active
    lanes, until the last fill token lands and the lane turns into a
    _LaneState."""

    job: LaneJob
    tokens: list[int]  # the full prompt, pending token included
    cursor: int  # fill tokens already in the lane's pages (adopted rows count)
    prompt_end: int
    max_pos: int
    public_prompt: str
    adopt_pages: list = field(default_factory=list)
    adopted: bool = False  # the adopt ran (it is its own tick)
    start_pos: int = 0  # the adopted prefix's length
    # a resume (recovery or park): ``tokens`` is the stream's whole fed
    # history and _finish_admission reinstalls this state untouched
    resume_state: _LaneState | None = None
    from_park: bool = False
    prefill_s: float = 0.0  # seconds of the adopt and the chunks so far
    n_chunks: int = 0


class _NoPool:
    """The scheduler's KV manager for lanes with no pool (a page size < 0,
    the JAX server's ``kv_manager`` None): slab lanes, nothing to match,
    adopt or publish."""

    native = False

    def match(self, lane: int, tokens: list[int]) -> tuple[int, list[int]]:
        return 0, []

    def adopt(self, lane: int, pages: list[int]) -> None:
        pass

    def publish(self, lane: int, tokens: list[int]) -> int:
        return 0

    def release_lane(self, lane: int) -> None:
        pass

    def release_all_lanes(self) -> None:
        pass

    def reset(self, reset_device: bool = True) -> None:
        pass

    def note_hit(self, n_tokens: int) -> None:
        pass

    def anchor_for(self, lane: int) -> None:
        return None


def _edf_key(job) -> float:
    """A queued entry's EDF key; an entry without one sorts last."""
    key = getattr(job, "edf_deadline_ms", None)
    return key if key is not None else float("inf")


class LaneScheduler:
    """Continuous batching over the engine's lanes (see the module
    docstring). One thread makes every engine call."""

    def __init__(self, state: "ApiState", block_size: int = DEFAULT_LANE_BLOCK,
                 admission_chunk: int | None = None, speculation: str = "off",
                 spec_k: int = DEFAULT_SPEC_K, max_streams: int = 0, retry_max: int = 3,
                 retry_backoff_ms: int = 5):
        self.state = state
        self.engine = state.engine
        self.kv = state.kv_manager if state.kv_manager is not None else _NoPool()
        self.block_size = max(1, int(block_size))
        # at most this many prompt tokens prefill a tick (0/None: the
        # largest bucket), so an active stream waits at most one chunk and
        # one block between tokens
        self.admission_chunk = int(admission_chunk) if admission_chunk else max(
            self.engine.prefill_buckets)
        b = self.engine.batch_size
        self.lanes: list[_LaneState | None] = [None] * b
        self.admitting: dict[int, _AdmittingLane] = {}
        # fresh admissions take the least-recently-used free lane
        self.lane_used = [0] * b
        self._admission_count = 0
        self._rr = -1  # round-robin cursor over admitting lanes
        self.pending: list[LaneJob] = []
        self.n_submitted = 0
        # park/resume above the lane count (module docstring; 0: off)
        self.max_streams = max(0, int(max_streams))
        # tokens a lane emitted since its last (re)admission: a park victim
        # needs a full block of them, so a deep queue rotates the lanes
        # instead of thrashing park and resume
        self._progress = [0] * b
        self._n_parked = 0
        # transient-dispatch retries: attempts after the first failure and
        # the backoff's base
        self.retry_max = max(0, int(retry_max))
        self.retry_backoff_s = max(0, int(retry_backoff_ms)) / 1000.0
        # the resilience counts without a registry family, as plain
        # counters: recoveries (poisoned pools), parks, and the tokens
        # resumes re-matched from the radix tree and re-prefilled (the
        # retries, lanes recovered and resumes are registry reads below)
        self.recoveries = 0
        self.parks = 0
        self.resume_reused_tokens = 0
        self.resume_prefill_tokens = 0
        # the stall and inter-dispatch accounting's clock (a test may
        # inject one)
        self._clock = time.perf_counter
        self._last_decode_end: float | None = None
        # speculation (module docstring); "off" is a pure bypass
        self.spec_mode = speculation
        self.spec_on = speculation != "off"
        self.spec_k = self.clamp_spec_k(self.engine, spec_k)
        self.spec_buckets = spec_buckets(self.spec_k)
        self.drafters: dict[int, NgramDrafter] = {}
        # the cross-lane store, keyed by radix anchors (modes "shared" and
        # "draft")
        self.spec_store = (SharedNgramStore() if speculation in ("shared", "draft")
                           else None)
        # the draft model's catch-up cursors: rows [0, _draft_pos[l]) of the
        # draft cache hold lane l's verified history; the epoch snapshot
        # tells a reset draft cache (the cursors restart at 0); _draft_fed
        # holds this tick's (position, k) of each lane's model draft, so the
        # verify outcome moves the cursor past the accepted rows
        self._draft_pos: dict[int, int] = {}
        self._draft_epoch = self.engine.draft_cache_epoch
        self._draft_fed: dict[int, tuple[int, int]] = {}
        # verify passes (no registry family; the drafted and accepted
        # tokens, the accept lengths and the sources are registry reads)
        self.spec_verify_dispatches = 0
        self.cv = threading.Condition()
        self._stop = False
        # calls to run on this thread between two ticks (`run_between_ticks`)
        self._between: list = []
        # the registry's values when this scheduler started: its reads
        # below are the deltas since (one registry serves the process)
        self._base = self._registry_counts()
        self.thread = threading.Thread(target=self._loop, daemon=True, name="dllama-scheduler")
        self.thread.start()

    @staticmethod
    def clamp_spec_k(engine: InferenceEngine, spec_k: int) -> int:
        """The draft length a verify pass takes: a verify row (1 + k
        tokens) runs as one chunk, so k is capped by the largest prefill
        bucket (the JAX scheduler caps it by its lane padding)."""
        return max(1, min(int(spec_k), max(engine.prefill_buckets) - 1))

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the scheduler thread (idempotent)."""
        with self.cv:
            self._stop = True
            self.cv.notify_all()
        if self.thread.is_alive():
            self.thread.join(timeout=timeout)

    def submit(self, params: InferenceParams) -> LaneJob:
        st = self.state
        # a router's identity wins: every timeline span of the request is
        # keyed on the fleet's request id, so a failover's two halves share it
        job = LaneJob(params, st.tracer.span(request_id=params.request_id, path="lanes",
                                             trace_id=params.trace_id), self._clock())
        # the EDF key: hints win; otherwise the priority ladder as deadline
        # offsets, so with no hints the pick order is (priority, arrival)
        job.edf_deadline_ms = effective_deadline_ms(
            job.t_submit * 1000.0, priority=params.priority, deadline_ms=params.deadline_ms,
            ttft_budget_ms=params.ttft_budget_ms, default_ms=st.deadline_default_ms,
            priority_step_ms=st.deadline_priority_step_ms)
        # the queue span begins here, on the handler thread, and ends on
        # the scheduler thread once the admission's tokenize and radix
        # match are done: "queue" covers the wait and the admission set-up
        job.queue_span = st.spans.begin("queue", component="scheduler",
                                        request_id=job.request_id)
        with self.cv:
            self.pending.append(job)
            self.n_submitted += 1
            st.m_queue_depth.set(len(self.pending))
            self.cv.notify()
        return job

    def occupancy(self) -> OccupancySnapshot:
        """The load snapshot the `LoadPredictor` forecasts against: lanes
        active and admitting, the chunks the admitting lanes still owe,
        parked streams and the queue depth, read together under the cv;
        callable from any thread (the scheduler calls it outside its cv
        block)."""
        chunk = max(1, self.admission_chunk)
        with self.cv:
            active = sum(1 for ls in self.lanes if ls is not None)
            admitting = list(self.admitting.values())
            queue_depth = len(self.pending)
            parked = self._n_parked
        chunks_left = sum(max(1, -(-max(0, adm.prompt_end - adm.cursor) // chunk))
                          for adm in admitting)
        return OccupancySnapshot(
            lanes_total=len(self.lanes), active_lanes=active, parked=parked,
            admitting=len(admitting), admitting_chunks=chunks_left, queue_depth=queue_depth,
            block_size=self.block_size, admission_chunk=chunk)

    def run_between_ticks(self, fn, timeout: float = 60.0):
        """Run ``fn()`` on the scheduler thread between two ticks (no
        dispatch in flight) and return its value or raise its error; a
        waiting scheduler wakes for it. The profile route starts and stops
        ``torch.profiler`` this way."""
        box: dict = {"done": threading.Event()}
        with self.cv:
            self._between.append((fn, box))
            self.cv.notify_all()
        if not box["done"].wait(timeout):
            raise TimeoutError(f"the scheduler ran no tick in {timeout} s")
        if "error" in box:
            raise box["error"]
        return box.get("value")

    def _run_between(self) -> None:
        with self.cv:
            calls, self._between = self._between, []
        for fn, box in calls:
            try:
                box["value"] = fn()
            except Exception as e:  # dlint: disable=silent-except — handed to the waiting caller, which re-raises it
                box["error"] = e
            box["done"].set()

    def _registry_counts(self) -> dict:
        """The registry values `resilience_stats` and `spec_stats` read."""
        st = self.state
        out = {
            "dispatch_retries": st.m_dispatch_retries.value,
            "lanes_recovered": st.m_lanes_recovered.value,
            "resumes": st.m_stream_resumes.value,
            "drafted": st.m_spec_drafted.value,
            "accepted": st.m_spec_accepted.value,
            "accept_len_sum": st.m_spec_accept_len.sum,
            "accept_len_count": st.m_spec_accept_len.count,
        }
        out.update({("shed", k[0]): v for k, v in st.m_shed.child_values().items()})
        if st.m_spec_source is not None:
            out.update({("source", k[0]): v
                        for k, v in st.m_spec_source.child_values().items()})
        return out

    def _delta(self, name) -> int:
        """A registry value less its value when this scheduler started."""
        now = self._registry_counts().get(name, 0)
        return int(now - self._base.get(name, 0))

    def _deltas(self, label: str) -> dict[str, int]:
        now = self._registry_counts()
        out = {k[1]: int(v - self._base.get(k, 0)) for k, v in now.items()
               if isinstance(k, tuple) and k[0] == label}
        return {k: v for k, v in sorted(out.items()) if v}

    @property
    def dispatch_retries(self) -> int:
        return self._delta("dispatch_retries")

    @property
    def lanes_recovered(self) -> int:
        return self._delta("lanes_recovered")

    @property
    def resumes(self) -> int:
        return self._delta("resumes")

    @property
    def spec_drafted(self) -> int:
        return self._delta("drafted")

    @property
    def spec_accepted(self) -> int:
        return self._delta("accepted")

    @property
    def spec_accept_len_sum(self) -> int:
        return self._delta("accept_len_sum")

    @property
    def spec_accept_len_count(self) -> int:
        return self._delta("accept_len_count")

    @property
    def spec_source(self) -> dict[str, int]:
        return self._deltas("source")

    def _set_lane_gauge(self) -> None:
        self.state.m_lanes_active.set(sum(1 for ls in self.lanes if ls is not None))

    def resilience_stats(self) -> dict:
        """The resilience counters in one snapshot (/v1/health's
        ``resilience``), the chaos plane's injected faults by site too.
        Retries, lanes recovered, resumes and the shed requests by reason
        are registry reads (`_delta`)."""
        return {
            "retry_max": self.retry_max,
            "dispatch_retries": self.dispatch_retries,
            "recoveries": self.recoveries,
            "lanes_recovered": self.lanes_recovered,
            "cache_epoch": self.engine.cache_epoch,
            "max_streams": max(self.max_streams, len(self.lanes)),
            "parked": self._n_parked,
            "parks": self.parks,
            "resumes": self.resumes,
            "resume_reused_tokens": self.resume_reused_tokens,
            "resume_prefill_tokens": self.resume_prefill_tokens,
            "shed": self._deltas("shed"),
            "faults": get_fault_plane().counts(),
        }

    # -- failure classification and recovery -------------------------------

    def _retry_dispatch(self, fn, what: str = "dispatch"):
        """Run one engine dispatch, retrying a failure up to ``retry_max``
        times with a doubling backoff while the engine's ``cache_epoch``
        stands still: the pool is as it was before the call, so the
        dispatch is safe to repeat. A failure that moved the epoch re-raises
        at once: the pool was reset, and the caller's recovery owns it.
        The watchdog sees the dispatch ``what`` in flight throughout."""
        wd = self.state.watchdog
        wd.dispatch_begin(what)
        try:
            attempt = 0
            while True:
                epoch = self.engine.cache_epoch
                try:
                    return fn()
                except Exception as e:
                    if self.engine.cache_epoch != epoch or attempt >= self.retry_max:
                        raise
                    attempt += 1
                    self.state.m_dispatch_retries.inc()
                    self.state.recorder.record(
                        "dispatch_retry", step=what, attempt=attempt, error=str(e),
                        error_type=type(e).__name__)
                    logger.warning("engine dispatch failed (%s: %s); retry %d of %d",
                                   type(e).__name__, e, attempt, self.retry_max)
                    time.sleep(self.retry_backoff_s * 2 ** (attempt - 1))
        finally:
            wd.dispatch_end()

    def _finish_span(self, job: LaneJob, reason: str, **counts) -> None:
        """Close the request's lifecycle span once and count its finish."""
        if job.span.finish(reason, **counts) is not None:
            self.state.m_finished.labels(reason=reason).inc()
            if reason == "cancelled":
                self.state.m_cancellations.inc()

    def _fail_active(self, lane: int, err: dict) -> None:
        """Error out one active lane's request and free the lane (nothing
        is published: its KV is not trusted on any path that gets here)."""
        ls = self.lanes[lane]
        self.state.spans.end(ls.decode_span, error=err["message"])
        ls.job.events.put(("error", err))
        self._finish_span(ls.job, "error", n_completion=ls.job.n_completion)
        self.lanes[lane] = None
        self.drafters.pop(lane, None)
        self._draft_pos.pop(lane, None)
        self.kv.release_lane(lane)

    def _fail_admitting(self, lane: int, err: dict) -> None:
        """Error out one request mid-admission and release its retains."""
        adm = self.admitting.pop(lane, None)
        if adm is None:
            return
        if adm.from_park:
            self._n_parked -= 1
            self.state.m_streams_parked.set(self._n_parked)
        if adm.resume_state is not None:
            # a resume that failed: the stream's decode span is still open
            self.state.spans.end(adm.resume_state.decode_span, error=err["message"])
        adm.job.events.put(("error", err))
        self._finish_span(adm.job, "error", n_completion=adm.job.n_completion)
        self.drafters.pop(lane, None)
        self._draft_pos.pop(lane, None)
        self.kv.release_lane(lane)

    def _drop_all(self, e: Exception) -> None:
        """Retries exhausted on an intact pool: fail every in-flight
        request with a retryable error and keep the scheduler alive."""
        err = {"message": str(e), "retryable": True}
        for lane in range(len(self.lanes)):
            if self.lanes[lane] is not None:
                self._fail_active(lane, err)
        for lane in list(self.admitting):
            self._fail_admitting(lane, err)
        self.kv.release_all_lanes()
        self.drafters.clear()
        self._draft_pos.clear()
        self._set_lane_gauge()

    def _recover(self, e: Exception, culprit: int | None) -> None:
        """A failed dispatch zeroed the lanes' KV (the epoch moved): the
        slab in slab mode, where the pool and the radix tree survive; the
        pool in native mode, where every page id of the lanes, the tree and
        the adopt lists names zeroed rows, so the page accounting resets
        too (the device pool is already zero). Each active lane becomes a
        resume: an admission of its whole fed history that re-matches it
        against the tree (slab: its published prefix adopts back; native:
        nothing is left), re-prefills the rest and reinstalls the untouched
        _LaneState, its drafter riding along, so the stream goes on where
        it was. Lanes mid-admission rewind to their adopted prefix, which
        they adopt again (native: to position 0). Only ``culprit``, the
        lane whose own admission dispatch failed, gets a retryable error."""
        err = {"message": str(e), "retryable": True}
        native = self.kv.native
        if native:
            self.kv.reset(reset_device=False)
        for lane in list(self.admitting):
            if lane == culprit:
                self._fail_admitting(lane, err)
                continue
            adm = self.admitting[lane]
            adm.cursor = adm.start_pos
            adm.adopted = False
            if native:
                adm.cursor = adm.start_pos = 0
                adm.adopt_pages = []
        for lane, ls in enumerate(self.lanes):
            if ls is None:
                continue
            if lane == culprit:
                self._fail_active(lane, err)
                continue
            if ls.job.cancelled:
                self._finish(lane, "cancelled")
                continue
            self.lanes[lane] = None
            ls.drafter = self.drafters.pop(lane, None)
            self._draft_pos.pop(lane, None)
            start_pos, pages = self.kv.match(lane, ls.history)
            self.admitting[lane] = _AdmittingLane(
                job=ls.job, tokens=list(ls.history), cursor=start_pos,
                prompt_end=len(ls.history) - 1, max_pos=ls.max_pos, public_prompt="",
                adopt_pages=pages, start_pos=start_pos, resume_state=ls,
            )
        self.recoveries += 1
        self.state.recorder.record(
            "lane_recovery", error=str(e), error_type=type(e).__name__, culprit=culprit,
            n_resumed=sum(1 for a in self.admitting.values() if a.resume_state is not None),
            n_admitting=len(self.admitting))
        self._set_lane_gauge()
        with self.cv:
            self.cv.notify_all()

    # -- scheduler thread --------------------------------------------------

    def _loop(self) -> None:
        # a fleet replica's scheduler thread tags every span it begins
        # (admission, decode, publish, park) with the replica's name
        if self.state.replica_id is not None:
            set_thread_replica(self.state.replica_id)
        # inference mode is per thread: the engine's tensors stay out of
        # autograd on this one too
        with torch.inference_mode():
            while self._tick():
                pass

    def _tick(self) -> bool:
        """One scheduler tick: admissions into free lanes, at most one
        admission step, one decode block. False once stopped."""
        st = self.state
        with self.cv:
            while (not self._stop and not self.pending and not any(self.lanes)
                   and not self.admitting and not self._between):
                self.cv.wait()
            if self._stop:
                return False
            admissions = []
            free = [i for i in range(len(self.lanes))
                    if self.lanes[i] is None and i not in self.admitting]
            while self.pending and free:
                # predictive mode picks the earliest effective deadline,
                # queue order breaking ties (an entry without a key sorts
                # last); otherwise FIFO
                idx = 0
                if st.admission_predict:
                    idx = min(range(len(self.pending)), key=lambda i: (
                        _edf_key(self.pending[i]), i))
                job = self.pending.pop(idx)
                lane = min(free, key=lambda i: self.lane_used[i])
                free.remove(lane)
                self._admission_count += 1
                self.lane_used[lane] = self._admission_count
                admissions.append((lane, job))
            n_pending = len(self.pending)
            st.m_queue_depth.set(n_pending)
        self._run_between()
        # the watchdog's scheduler-stalled rule audits the gap between beats
        st.watchdog.beat(n_active=sum(1 for ls in self.lanes if ls is not None),
                         n_admitting=len(self.admitting))
        tick_sp = st.spans.begin("sched_tick", component="scheduler", n_pending=n_pending,
                                 n_admitting=len(self.admitting))
        for lane, job in admissions:
            self._begin_admission(lane, job)
        self._maybe_park(n_pending)
        self._maybe_preempt(n_pending)
        self._admission_tick()
        if any(self.lanes):
            epoch0 = self.engine.cache_epoch
            try:
                self._step_block()
            except Exception as e:
                # transient failures were retried in _retry_dispatch; what
                # gets here moved the epoch (the pool was reset: the lanes
                # resume; no lane of a batched dispatch is the culprit) or
                # exhausted the retries on an intact pool
                poisoned = self.engine.cache_epoch != epoch0
                logger.exception("lane scheduler step failed (%s)",
                                 "pool reset; recovering lanes" if poisoned
                                 else "pool intact; dropping in-flight lanes")
                st.m_sched_errors.inc()
                st.recorder.record("scheduler_error", error=str(e), error_type=type(e).__name__,
                                   poisoned=poisoned,
                                   n_lanes=sum(1 for ls in self.lanes if ls is not None))
                st.recorder.postmortem("scheduler-loop", e)
                if poisoned:
                    self._recover(e, culprit=None)
                else:
                    self._drop_all(e)
        st.spans.end(tick_sp)
        if not any(self.lanes):
            # decode went idle: the next block starts a new stall window
            self._last_decode_end = None
        return True

    # -- oversubscription: park and resume ---------------------------------

    def _maybe_park(self, n_pending: int) -> None:
        """Park ONE active lane when requests wait, no lane is free or
        admitting, and ``max_streams`` exceeds the lanes. The victim is
        the lane that emitted the most tokens since its last (re)admission,
        at least one full block. ``n_pending`` is the tick's queue depth,
        read under the cv."""
        if self.max_streams <= len(self.lanes) or n_pending <= 0 or self.admitting:
            return
        if any(ls is None for ls in self.lanes):
            return
        victim, best = -1, self.block_size - 1
        for lane, ls in enumerate(self.lanes):
            if not ls.job.cancelled and self._progress[lane] > best:
                victim, best = lane, self._progress[lane]
        if victim >= 0:
            self._park_stream(victim)

    def _maybe_preempt(self, n_pending: int) -> None:
        """Deadline preemption (predictive mode only): when the EDF head is
        a HINTED request that blows its budget waiting for a lane to turn
        over but would meet it on a lane freed now, park ONE active stream
        of lower priority, or one past its own deadline, through
        `_park_stream`. The victim requeues with its later key, so EDF
        resumes it after the deadline traffic: paused, never restarted.
        Nothing fires when the head is infeasible either way."""
        st = self.state
        if (not st.admission_predict or n_pending <= 0 or self.admitting
                or any(ls is None for ls in self.lanes)):
            return
        with self.cv:
            if not self.pending:
                return
            head = min(self.pending, key=_edf_key)
        head_key = _edf_key(head)
        if head_key == float("inf") or not head.params.deadline_hinted:
            return
        now_ms = self._clock() * 1000.0
        remaining_ms = head_key - now_ms
        if remaining_ms <= 0:
            return
        n_tok = head.n_prompt_tokens or st.estimate_prompt_tokens(head.params)
        if st.predictor.predict(n_tok, self.occupancy()).ttft_ms <= remaining_ms:
            return  # feasible by waiting: no victim needed
        # the forecast on a lane freed now: no queue ahead, one lane fewer
        occ = self.occupancy()
        occ.queue_depth = 0
        occ.active_lanes = max(0, occ.active_lanes - 1)
        now_pred = st.predictor.predict(n_tok, occ)
        if now_pred.ttft_ms > remaining_ms:
            return  # infeasible either way
        head_rank = PRIORITY_RANK.get(head.params.priority, 1)
        victim, v_score, v_blown = -1, None, False
        for lane, ls in enumerate(self.lanes):
            # the park floor: at least one full block since (re)admission
            if ls.job.cancelled or self._progress[lane] <= self.block_size - 1:
                continue
            rank = PRIORITY_RANK.get(ls.job.params.priority, 1)
            vkey = _edf_key(ls.job)
            blown = vkey < now_ms
            if rank >= head_rank and not blown:
                continue  # only lower-priority or deadline-blown streams
            score = (rank, -vkey)
            if v_score is None or score < v_score:
                victim, v_score, v_blown = lane, score, blown
        if victim < 0:
            return
        reason = "deadline_blown" if v_blown else "priority"
        rid = self.lanes[victim].job.request_id
        self._park_stream(victim)
        st.m_preemptions.labels(reason=reason).inc()
        st.recorder.record("stream_preempt", lane=victim, reason=reason, victim_request=rid,
                           head_request=head.request_id, head_remaining_ms=round(remaining_ms, 3),
                           predicted_ttft_ms=round(now_pred.ttft_ms, 3))

    def _park_stream(self, lane: int) -> None:
        """Free ``lane`` for a queued request: publish the history's whole
        pages (no device work), release the lane and requeue the job with
        its preserved _LaneState and drafter (`_resume_parked`)."""
        ls = self.lanes[lane]
        st = self.state
        rid = ls.job.request_id
        with st.spans.span("park", component="scheduler", request_id=rid, lane=lane,
                           pos=ls.pos):
            self.kv.publish(lane, ls.history[: ls.pos])
            self.kv.release_lane(lane)
        self.lanes[lane] = None
        ls.drafter = self.drafters.pop(lane, None)
        self._draft_pos.pop(lane, None)
        self._progress[lane] = 0
        ls.job._park_resume = ls
        # parked is queued again: a fresh queue span covers the parked wait
        # (the decode span stays open: the stream pauses, never restarts)
        ls.job.queue_span = st.spans.begin("queue", component="scheduler", request_id=rid,
                                           parked=True)
        self._n_parked += 1
        self.parks += 1
        st.m_streams_parked.set(self._n_parked)
        self._set_lane_gauge()
        with self.cv:
            self.pending.append(ls.job)
            n_pending = len(self.pending)
            st.m_queue_depth.set(n_pending)
            self.cv.notify()
        st.recorder.record("stream_park", lane=lane, pos=ls.pos, n_pending=n_pending,
                           n_parked=self._n_parked)

    def _resume_parked(self, lane: int, job: LaneJob, ls: _LaneState) -> None:
        """Queue a parked stream's re-admission on ``lane``: the radix
        match adopts its published pages back (no device copy) and only the
        page tail re-prefills; _finish_admission reinstalls ``ls``."""
        st = self.state
        job._park_resume = None
        job.lane = lane
        try:
            start_pos, pages = self.kv.match(lane, ls.history)
            if start_pos > 0:
                st.m_prefix_hits.inc()
                st.m_reused_tokens.inc(start_pos)
                self.kv.note_hit(start_pos)
            st.spans.end(job.queue_span, lane=lane, resumed_from_park=True,
                         reused_prefix_tokens=start_pos)
            self.admitting[lane] = _AdmittingLane(
                job=job, tokens=list(ls.history), cursor=start_pos,
                prompt_end=len(ls.history) - 1, max_pos=ls.max_pos, public_prompt="",
                adopt_pages=pages, start_pos=start_pos, resume_state=ls, from_park=True,
            )
        except Exception as e:
            logger.exception("resume of a parked stream on lane %d failed", lane)
            st.recorder.record("resume_error", lane=lane, error=str(e),
                               error_type=type(e).__name__)
            st.spans.end(job.queue_span, error=str(e))
            st.spans.end(ls.decode_span, error=str(e))
            job.events.put(("error", {"message": str(e), "retryable": True}))
            self._finish_span(job, "error", n_completion=job.n_completion)
            self._n_parked -= 1
            st.m_streams_parked.set(self._n_parked)
            self.kv.release_lane(lane)

    def _begin_admission(self, lane: int, job: LaneJob) -> None:
        """Tokenize the whole conversation, match it against the radix
        tree (retaining the pages for this lane) and queue the lane's
        admission; no engine work yet. Validation failures (a bad template,
        a prompt too long) are the client's: retryable False."""
        state, tok = self.state, self.state.tokenizer
        p = job.params
        if job._park_resume is not None:
            self._resume_parked(lane, job, job._park_resume)
            return
        try:
            if p.resume_tokens is not None:
                # a raw fed history (prompt and emitted tokens) stands in
                # for the template: admitted like any prompt, it goes on
                # from its last token
                if len(p.resume_tokens) < 2:
                    raise ValueError("resume_tokens needs at least 2 token ids")
                tokens, public_prompt = [int(t) for t in p.resume_tokens], ""
            else:
                items = [ChatItem(m.role, m.content) for m in p.messages]
                prompt = state.template.generate(items, append_generation_prompt=True)
                tokens = tok.encode(prompt.content, is_start=True, add_special_tokens=True)
                public_prompt = prompt.public_prompt or ""
            start_pos, adopt_pages = self.kv.match(lane, tokens)
            if start_pos > 0:
                state.m_prefix_hits.inc()
                state.m_reused_tokens.inc(start_pos)
                self.kv.note_hit(start_pos)
            else:
                state.m_prefix_misses.inc()
            job.lane = lane
            job.reused_prefix_tokens = start_pos
            job.t_admit = self._clock()
            qw = job.span.mark_admitted(lane=lane, reused_prefix_tokens=start_pos)
            state.spans.end(job.queue_span, lane=lane, n_prompt=len(tokens),
                            reused_prefix_tokens=start_pos)
            if qw is not None:
                state.m_queue_wait.observe(qw)
            state.m_admissions.inc()
            # the forecast `_finish` scores: the queue wait is known now
            # (on the scheduler's clock) and the match says how much
            # prefill is skipped
            fc = state.predictor.predict(len(tokens), self.occupancy(), matched_tokens=start_pos)
            waited_ms = (job.t_admit - job.t_submit) * 1000.0
            job.predicted_ttft_ms = waited_ms + fc.ttft_ms - fc.queue_wait_ms
            job.predicted_tpot_ms = fc.tpot_ms
            state.m_predicted_ttft.observe(job.predicted_ttft_ms)
            seq_len = self.engine.header.seq_len
            prompt_end = len(tokens) - 1
            if prompt_end >= seq_len:
                raise ValueError(f"prompt of {len(tokens)} tokens exceeds seqLen {seq_len}")
            max_pos = min(prompt_end + p.max_tokens, seq_len) if p.max_tokens > 0 else seq_len
            job.n_prompt_tokens = len(tokens)
            self.admitting[lane] = _AdmittingLane(
                job=job, tokens=tokens, cursor=start_pos, prompt_end=prompt_end,
                max_pos=max_pos, public_prompt=public_prompt,
                adopt_pages=adopt_pages, start_pos=start_pos,
            )
        except Exception as e:
            state.recorder.record("admission_refused", lane=lane, error=str(e),
                                  error_type=type(e).__name__)
            state.spans.end(job.queue_span, error=str(e))
            job.events.put(("error", {"message": str(e), "retryable": False}))
            self._finish_span(job, "error")
            self.kv.release_lane(lane)

    def _admission_tick(self) -> None:
        """At most ONE admission step per tick, round-robin over the
        admitting lanes: the lane's adopt (native: it allocates the lane's
        pages and installs its page table, even on an empty match; slab:
        the copy of the matched pages, only when there are some), then one
        bounded prefill chunk a tick; the lane turns to decode once its
        last fill token lands."""
        if not self.admitting:
            return
        order = sorted(self.admitting)
        lane = min((i for i in order if i > self._rr), default=order[0])
        self._rr = lane
        adm = self.admitting[lane]
        if adm.job.cancelled:
            self._abort_admission(lane)
            return
        fills = adm.tokens[:-1]
        st, rid = self.state, adm.job.request_id
        epoch0 = self.engine.cache_epoch
        if not (adm.adopt_pages or self.kv.native):
            adm.adopted = True  # a slab lane with nothing to copy: no adopt tick
        try:
            if not adm.adopted:
                t0 = self._clock()
                with st.spans.span("adopt", component="scheduler", request_id=rid, lane=lane,
                                   n_pages=len(adm.adopt_pages)):
                    self._retry_dispatch(lambda: self.kv.adopt(lane, adm.adopt_pages),
                                         "kv_adopt")
                adm.prefill_s += self._clock() - t0
                adm.adopted = True
            elif adm.cursor < len(fills):
                t0 = self._clock()
                with st.spans.span("admission_chunk", component="scheduler", request_id=rid,
                                   lane=lane, pos=adm.cursor):
                    width = self._retry_dispatch(lambda: self.engine.prefill_lane_chunk(
                        lane, fills[adm.cursor:], adm.cursor, budget=self.admission_chunk),
                        "prefill_lane_chunk")
                adm.prefill_s += self._clock() - t0
                adm.cursor += width
                adm.n_chunks += 1
                st.m_admission_chunks.inc()
                st.recorder.record("admission_chunk", lane=lane, chunk=adm.n_chunks,
                                   pos=adm.cursor - width, n_tokens=width,
                                   done=adm.cursor >= len(fills))
            if adm.adopted and adm.cursor >= len(fills):
                self._finish_admission(lane, adm)
        except Exception as e:
            logger.exception("admission of lane %d failed", lane)
            st.recorder.record("admission_error", lane=lane, error=str(e),
                               error_type=type(e).__name__,
                               poisoned=self.engine.cache_epoch != epoch0)
            if self.engine.cache_epoch != epoch0:
                # the failed dispatch reset the pool under every lane: they
                # all resume, and this admission fails
                self._recover(e, culprit=lane)
            else:
                self._fail_admitting(lane, {"message": str(e), "retryable": True})

    def _finish_admission(self, lane: int, adm: _AdmittingLane) -> None:
        """The last fill token landed: install the decode-side _LaneState,
        or a resume's preserved one as it was (the stream decoder, the EOS
        detector and the counts go on; the client sees no restart)."""
        state, tok = self.state, self.state.tokenizer
        job, p = adm.job, adm.job.params
        self._progress[lane] = 0
        ls = adm.resume_state
        if ls is not None:
            self.lanes[lane] = ls
            del self.admitting[lane]
            dr, ls.drafter = ls.drafter, None
            if self.spec_on and ls.temperature <= 0.0:
                if isinstance(dr, NgramDrafter):
                    dr.rebind(*self._lane_anchor(lane))
                else:
                    dr = self._make_drafter(lane, job.request_id)
                self.drafters[lane] = dr
            self.resume_reused_tokens += adm.start_pos
            self.resume_prefill_tokens += adm.prompt_end - adm.start_pos
            self._set_lane_gauge()
            event = dict(lane=lane, pos=ls.pos, reused_prefix_tokens=adm.start_pos,
                         n_chunks=adm.n_chunks)
            if adm.from_park:
                self._n_parked -= 1
                state.m_streams_parked.set(self._n_parked)
                state.m_stream_resumes.inc()
                state.recorder.record("stream_resume", **event)
            else:
                state.m_lanes_recovered.inc()
                state.recorder.record("lane_recovered", **event)
            return
        job.span.set_prefill_seconds(adm.prefill_s)
        job.span.set_tokens(n_prompt=len(adm.tokens))
        state.m_prefill.observe(adm.prefill_s)
        if adm.public_prompt:
            job.buffer += adm.public_prompt
            job.events.put(("delta", adm.public_prompt))
        detector = EosDetector(
            tok.eos_token_ids, state.stops if not p.stop else p.stop,
            padding_left=state.max_stop_len, padding_right=state.max_stop_len,
        )
        self.lanes[lane] = _LaneState(
            job=job, pos=adm.prompt_end, token=adm.tokens[-1], max_pos=adm.max_pos,
            detector=detector, decoder=tok.stream_decoder(), temperature=p.temperature,
            top_p=p.top_p, seed=p.seed, history=list(adm.tokens),
            decode_span=state.spans.begin("decode", component="scheduler",
                                          request_id=job.request_id, lane=lane,
                                          n_prompt=len(adm.tokens)),
        )
        del self.admitting[lane]
        if self.spec_on and p.temperature <= 0.0:
            # greedy lanes only: a sampled lane's next token is not the
            # argmax the verify pass returns, so it stays on the decode block
            self.drafters[lane] = self._make_drafter(lane, job.request_id)
        self._set_lane_gauge()
        state.recorder.record("admit", lane=lane, reused_prefix_tokens=adm.start_pos,
                              n_prompt=len(adm.tokens), n_chunks=adm.n_chunks)

    def _abort_admission(self, lane: int) -> None:
        """Client went away mid-admission: stop prefilling for nobody."""
        adm = self.admitting.pop(lane)
        job = adm.job
        if adm.from_park:
            self._n_parked -= 1
            self.state.m_streams_parked.set(self._n_parked)
        if adm.resume_state is not None:
            self.state.spans.end(adm.resume_state.decode_span, reason="cancelled")
        self._finish_span(job, "cancelled", n_prompt=len(adm.tokens),
                          n_completion=job.n_completion)
        job.events.put(("done", "cancelled"))
        self.drafters.pop(lane, None)
        self._draft_pos.pop(lane, None)
        self.kv.release_lane(lane)
        self.state.recorder.record("finish", lane=lane, reason="cancelled", pos=adm.cursor,
                                   n_completion=job.n_completion)

    def _finish(self, lane: int, reason: str) -> None:
        ls = self.lanes[lane]
        st, job = self.state, ls.job
        st.spans.end(ls.decode_span, reason=reason, n_completion=job.n_completion)
        if reason in ("stop", "length"):
            # publish BEFORE signalling done, so a client's immediate
            # follow-up request matches this conversation
            with st.spans.span("publish", component="scheduler", request_id=job.request_id,
                               lane=lane, n_tokens=ls.pos):
                self.kv.publish(lane, ls.history[: ls.pos])
        self.drafters.pop(lane, None)
        self._draft_pos.pop(lane, None)
        self.kv.release_lane(lane)
        self._finish_span(job, reason, n_prompt=job.n_prompt_tokens,
                          n_completion=job.n_completion)
        st.slo.observe_span(job.span, deadline_ms=job.params.deadline_ms)
        self._score_prediction(job, reason)
        st.spans.maybe_flush()
        job.events.put(("done", reason))
        st.recorder.record("finish", lane=lane, reason=reason, pos=ls.pos,
                           n_completion=job.n_completion)
        self.lanes[lane] = None
        self._set_lane_gauge()
        with self.cv:
            self.cv.notify()

    def _score_prediction(self, job: LaneJob, reason: str) -> None:
        """Forecast against outcome for one finished request, on the
        scheduler's clock: the absolute errors feed the error histogram
        and the error ring, and the EWMA corrections fold the observed
        ratios back into the predictor. Only ``stop`` and ``length``
        finishes count: a cancelled stream says nothing of the model."""
        st = self.state
        pred = st.predictor
        if job.predicted_ttft_ms is None or job.t_first is None or reason not in ("stop", "length"):
            return
        ttft_ms = (job.t_first - job.t_submit) * 1000.0
        if ttft_ms > 0:
            err_ms = abs(ttft_ms - job.predicted_ttft_ms)
            st.m_predict_error.labels(signal="ttft").observe(err_ms)
            st.note_predict_error(err_ms)
            pred.observe_ttft(job.predicted_ttft_ms, ttft_ms)
        n = job.n_completion
        if n > 1:
            tpot_ms = (self._clock() - job.t_first) / (n - 1) * 1000.0
            st.m_predict_error.labels(signal="tpot").observe(abs(tpot_ms - job.predicted_tpot_ms))
            pred.observe_tpot(job.predicted_tpot_ms, tpot_ms)

    def _consume_token(self, lane: int, t: int) -> bool:
        """Advance one lane by one generated token: history, stream decode,
        EOS and stop-string detection, the length cap. False once the lane
        finished (its remaining block rows are dropped). The decode block
        and the verify pass both flush through it, so an accepted draft
        run gets exactly the per-token handling of plain decode."""
        ls = self.lanes[lane]
        if ls is None:
            return False
        self._progress[lane] += 1
        ls.pos += 1
        ls.token = t
        ls.history.append(t)
        ls.job.n_completion += 1
        if ls.job.n_completion == 1:
            ls.job.t_first = self._clock()
            ttft = ls.job.span.mark_first_token()
            if ttft is not None:
                self.state.m_ttft.observe(ttft)
        piece = ls.decoder.decode(t)
        tokens_on = ls.job.params.include_tokens
        if tokens_on:
            ls.tape.append((t, piece or ""))
        eos_type = ls.detector.append(t, piece)
        if eos_type in (EosResult.NOT_EOS, EosResult.EOS):
            delta = ls.detector.get_delta()
            if delta:
                ls.job.buffer += delta
                if tokens_on:
                    # cumulative tokens across deltas are the generated ids,
                    # cumulative pieces their exact text
                    ls.job.events.put(("delta", {"text": delta,
                                                 "tokens": [tid for tid, _ in ls.tape],
                                                 "piece": "".join(px for _, px in ls.tape)}))
                    ls.tape = []
                else:
                    ls.job.events.put(("delta", delta))
            ls.detector.reset()
        if eos_type == EosResult.EOS:
            self._finish(lane, "stop")
            return False
        if ls.pos >= ls.max_pos:
            self._finish(lane, "length")
            return False
        return True

    # -- speculation -------------------------------------------------------

    def spec_stats(self) -> dict:
        """The speculation counters in one snapshot (/v1/health's
        ``speculation``): drafted and accepted tokens, verify passes, the
        tokens a lane got from a verify pass on average (1 + accepted), the
        draft tokens by source, and the shared store's size and hits."""
        n = self.spec_accept_len_count
        return {
            "mode": self.spec_mode,
            "k": self.spec_k,
            "drafted": self.spec_drafted,
            "accepted": self.spec_accepted,
            "verify_passes": self.spec_verify_dispatches,
            "tokens_per_lane_pass": 1.0 + self.spec_accept_len_sum / n if n else 0.0,
            "sources": self.spec_source,
            "store": self.spec_store.stats() if self.spec_store is not None else None,
        }

    def _lane_anchor(self, lane: int) -> tuple[int | None, int]:
        """The lane's radix anchor (node_id, matched tokens) from its
        admission match, or (None, 0) when sharing is off or nothing
        matched."""
        if self.spec_store is not None:
            a = self.kv.anchor_for(lane)
            if a is not None:
                return a
        return (None, 0)

    def _make_drafter(self, lane: int, stream_id: str) -> NgramDrafter:
        anchor, aoff = self._lane_anchor(lane)
        return NgramDrafter(k_max=self.spec_k, shared_store=self.spec_store,
                            stream_id=stream_id, anchor=anchor, anchor_offset=aoff,
                            use_draft_model=(self.spec_mode == "draft"
                                             and self.engine.has_draft_model))

    def _spec_drafts(self) -> dict[int, list[int]]:
        """This tick's drafts: each greedy lane whose drafter proposes >= 1
        token within the lane's room (max_tokens and seq_len both cap the
        accepted run of len(draft) + 1 tokens). The drafter ranks its
        private n-gram match against the shared store's by matched length;
        in mode ``draft`` the lanes both n-gram sources left dry take one
        batched draft-model proposal (`_draft_with_model`)."""
        out: dict[int, list[int]] = {}
        st = self.state
        seq_len = self.engine.header.seq_len
        self._draft_fed.clear()
        model_lanes: dict[int, int] = {}  # lane -> its model-draft budget
        for lane, dr in self.drafters.items():
            ls = self.lanes[lane]
            if ls is None:
                continue
            dr.update(ls.history)
            room = min(ls.max_pos, seq_len) - ls.pos - 1
            if room < 1:
                continue
            budget = min(self.spec_k, room)
            d = dr.draft(budget=budget)
            if d:
                out[lane] = d
                if st.m_spec_source is not None and dr.last_source:
                    st.m_spec_source.labels(source=dr.last_source).inc(len(d))
                continue
            mb = dr.model_budget(budget)
            if mb > 0:
                model_lanes[lane] = mb
        if model_lanes:
            for lane, d in self._draft_with_model(model_lanes).items():
                self.drafters[lane].last_source = SOURCE_DRAFT
                out[lane] = d
                if st.m_spec_source is not None:
                    st.m_spec_source.labels(source=SOURCE_DRAFT).inc(len(d))
        if self.spec_store is not None and st.g_spec_store_groups is not None:
            stats = self.spec_store.stats()
            st.g_spec_store_groups.set(stats["groups"])
            st.g_spec_store_streams.set(stats["streams"])
            st.g_spec_store_tokens.set(stats["tokens"])
            st.g_spec_store_hits.set(stats["hits"])
            st.g_spec_store_misses.set(stats["misses"])
        return out

    def _draft_with_model(self, budgets: dict[int, int]) -> dict[int, list[int]]:
        """Draft-model proposals for the lanes whose n-gram sources ran dry
        (the JAX scheduler's ``_draft_with_model``): each lane's draft rows
        caught up on the verified history they have not seen
        (`InferenceEngine.draft_prefill`), then ONE batched k-step
        `draft_propose` for all of them, k the largest budget in its bucket.
        Advisory: a failure skips model drafting for the tick (the lanes
        decode in the block) and never touches the target's KV."""
        eng = self.engine
        b = len(self.lanes)
        dseq = eng.draft_seq_len
        if eng.draft_cache_epoch != self._draft_epoch:
            # the draft cache was reset by a failed draft dispatch: every
            # lane's draft rows are gone, the catch-up re-feeds them
            self._draft_pos.clear()
            self._draft_epoch = eng.draft_cache_epoch
        k = 0
        lanes: list[int] = []
        tokens, pos, act = [0] * b, [0] * b, [False] * b
        try:
            for lane, budget in budgets.items():
                ls = self.lanes[lane]
                if ls is None or ls.pos + budget > dseq:
                    continue
                dpos = self._draft_pos.get(lane, 0)
                if dpos < ls.pos:
                    # rows past a verify rewind are overwritten here before
                    # any draft query attends to them
                    eng.draft_prefill(lane, ls.history[dpos:ls.pos], dpos)
                    self._draft_pos[lane] = ls.pos
                lanes.append(lane)
                k = max(k, budget)
                tokens[lane], pos[lane], act[lane] = ls.token, ls.pos, True
            if not lanes:
                return {}
            props = eng.draft_propose(tokens, pos, act, bucket_for(k, self.spec_buckets))
        except Exception as e:
            self.state.recorder.record("draft_model_error", error=str(e),
                                       error_type=type(e).__name__, n_lanes=len(budgets))
            return {}
        out: dict[int, list[int]] = {}
        for lane in lanes if props else ():
            d = props[lane][: budgets[lane]]
            if d:
                out[lane] = d
                self._draft_fed[lane] = (pos[lane], len(d))
        return out

    def _spec_verify(self, drafts: dict[int, list[int]]) -> None:
        """One verify pass for every drafting lane: rows [pending, draft...,
        pads] of one bucketed width, each lane's longest draft prefix that
        agrees with the pass's argmax accepted plus one correction token,
        flushed through `_consume_token`. A lane too close to seq_len for
        the shared width leaves ``drafts`` and decodes in the block."""
        b = len(self.lanes)
        seq_len = self.engine.header.seq_len
        t = 1 + bucket_for(max(len(d) for d in drafts.values()), self.spec_buckets)
        for lane in list(drafts):
            if self.lanes[lane].pos + t > seq_len:
                del drafts[lane]
        if not drafts:
            return
        rows = [[0] * t for _ in range(b)]
        pos, act = [0] * b, [False] * b
        for lane, d in drafts.items():
            ls = self.lanes[lane]
            rows[lane] = [ls.token, *d] + [0] * (t - 1 - len(d))
            pos[lane], act[lane] = ls.pos, True
        st = self.state
        now = self._clock()
        if self._last_decode_end is not None:
            st.m_decode_stall.observe(now - self._last_decode_end)
        t0 = time.perf_counter()
        with st.spans.span("spec_verify", component="scheduler", n_lanes=len(drafts), t=t):
            grid = self._retry_dispatch(lambda: self.engine.verify_lanes(rows, pos, act),
                                        "verify_lanes")
        self._last_decode_end = self._clock()
        dt = time.perf_counter() - t0
        self.spec_verify_dispatches += 1
        n_emitted = 0
        for lane, d in drafts.items():
            out = grid[lane]
            # out[0] is the greedy token after the pending one, out[j] the
            # one after draft j-1: accept while they agree, then out[a]
            a = 0
            while a < len(d) and out[a] == d[a]:
                a += 1
            self.drafters[lane].feedback(len(d), a)
            fed = self._draft_fed.pop(lane, None)
            if fed is not None:
                # draft rows p + j hold history[p + j] for j <= a (row p is
                # the pending token, row p + i draft i - 1, right while the
                # drafts before it were accepted); later rows are stale and
                # the next catch-up re-feeds them
                self._draft_pos[lane] = fed[0] + min(a + 1, fed[1])
            st.m_spec_drafted.inc(len(d))
            st.m_spec_accepted.inc(a)
            st.m_spec_accept_len.observe(float(a))
            st.recorder.record("spec_verify", lane=lane, k=len(d), accepted=a, pos=pos[lane])
            emitted = d[:a] + [out[a]]
            n_emitted += len(emitted)
            st.m_tpot.observe(dt / len(emitted))
            for tok in emitted:
                if not self._consume_token(lane, tok):
                    break
        st.slo.note_tokens(n_emitted)
        if st.m_spec_drafted.value > 0:
            st.g_spec_rate.set(st.m_spec_accepted.value / st.m_spec_drafted.value)
        if st.g_spec_tokens_per_pass is not None and st.m_spec_accept_len.count > 0:
            st.g_spec_tokens_per_pass.set(
                1.0 + st.m_spec_accept_len.sum / st.m_spec_accept_len.count)

    def _step_block(self) -> None:
        b = len(self.lanes)
        for lane in range(b):  # free lanes whose client went away
            ls = self.lanes[lane]
            if ls is not None and ls.job.cancelled:
                self._finish(lane, "cancelled")
        # verify first: greedy lanes with a draft take one batched verify
        # pass; every other live lane decodes in the same tick's block
        verified: set[int] = set()
        if self.spec_on and self.drafters:
            drafts = self._spec_drafts()
            if drafts:
                self._spec_verify(drafts)
                verified = set(drafts)
        active = [ls is not None and lane not in verified for lane, ls in enumerate(self.lanes)]
        if not any(active):
            return
        tokens = [ls.token if ls else 0 for ls in self.lanes]
        pos = [ls.pos if ls else 0 for ls in self.lanes]
        temps = [ls.temperature if ls else 0.0 for ls in self.lanes]
        topps = [ls.top_p if ls else 1.0 for ls in self.lanes]
        seeds = [ls.seed if ls else None for ls in self.lanes]
        st = self.state
        now = self._clock()
        if self._last_decode_end is not None:
            st.m_decode_stall.observe(now - self._last_decode_end)
        t0 = time.perf_counter()
        rows = self._retry_dispatch(lambda: self.engine.decode_lanes(
            tokens, pos, self.block_size, active, temps, topps, seeds=seeds), "decode_lanes")
        self._last_decode_end = self._clock()
        if rows:
            st.m_tpot.observe((time.perf_counter() - t0) / len(rows))
            st.slo.note_tokens(len(rows) * sum(1 for a in active if a))
        if not rows:  # every lane in the block is out of sequence space
            for lane in range(b):
                if active[lane]:
                    self._finish(lane, "length")
            return
        for row in rows:
            for lane in range(b):
                if active[lane] and not self._consume_token(lane, row[lane]):
                    active[lane] = False


class ApiState:
    """Engine, tokenizer, chat template, KV manager and lane scheduler
    shared by the request handlers, the shedding and drain state, and the
    observability of the JAX ``ApiState``: the registry's serving families
    (`_register_families`), the tracer, the span tracker, the SLO windows,
    the series store and its sampler, the anomaly monitor and the
    watchdog. With a batch-1 engine there is no scheduler, KV manager, load
    predictor or watchdog (None, as in the JAX server): requests run one
    at a time under ``lock`` through `complete`, with the `NaiveCache`."""

    def __init__(self, engine: InferenceEngine, tokenizer: Tokenizer,
                 model_name: str = "dllama-tpu",
                 chat_template_type: ChatTemplateType = ChatTemplateType.UNKNOWN,
                 lane_block_size: int = DEFAULT_LANE_BLOCK, admission_chunk: int | None = None,
                 kv_page_size: int = 0, kv_pool_pages: int = 0, kv_native: bool = False,
                 speculation: str | None = None,
                 spec_k: int | None = None, max_streams: int | None = None,
                 retry_max: int | None = None, retry_backoff_ms: int | None = None,
                 max_queue_depth: int | None = None, tracer: Tracer | None = None,
                 slo_ttft_ms: float | None = None, slo_tpot_ms: float | None = None,
                 series_retention: float | None = None, admission_predict: bool | None = None,
                 admission_max_wait_ms: int | None = None,
                 deadline_default_ms: int | None = None,
                 deadline_priority_step_ms: int | None = None,
                 replica_id: str | None = None):
        # a fleet replica's name: /v1/health's ``replica``, the span tag of
        # its threads and the ``op`` its sse_flush faults draw under; set
        # before the scheduler thread starts
        self.replica_id = replica_id
        # explicit knobs beat the DLLAMA_* environment beats the defaults
        speculation, spec_k = resolve_spec_knobs(speculation, spec_k)
        retry_max, retry_backoff_ms, self.max_queue_depth = resolve_resilience_knobs(
            retry_max, retry_backoff_ms, max_queue_depth)
        # predictive admission (runtime/admission.py): the switch gates the
        # controller (infeasible refusals, EDF, deadline preemption); the
        # deadline knobs shape the synthetic deadlines of unhinted requests
        self.admission_predict, self.admission_max_wait_ms = resolve_admission_knobs(
            admission_predict, admission_max_wait_ms)
        self.deadline_default_ms, self.deadline_priority_step_ms = resolve_deadline_knobs(
            deadline_default_ms, deadline_priority_step_ms)
        # the recent |predicted - observed| TTFTs in ms (appended on the
        # scheduler thread; /v1/debug/admission reads their p50 and p95)
        self.predict_errors: deque = deque(maxlen=512)
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.start_unix = time.time()
        # graceful drain (the handler threads write it under _lock, never
        # the scheduler's cv)
        self._lock = threading.Lock()
        self.draining = False
        self.draining_since: float | None = None
        self.drained = threading.Event()
        # observability (obs/): every handle exists before the scheduler
        # thread starts using it, so the hot path never looks one up
        self.obs = get_registry()
        self.recorder = get_recorder()
        self.tracer = tracer if tracer is not None else Tracer()
        self.spans = get_span_tracker()
        ttft_ms, tpot_ms = resolve_slo_knobs(slo_ttft_ms, slo_tpot_ms)
        self.slo = SloTracker(ttft_target_ms=ttft_ms, tpot_target_ms=tpot_ms)
        self._register_families(speculation)
        # the shed counts at start: the serialized path's `shed` reads the
        # registry less them (the scheduler keeps its own base)
        self._shed_base = {k[0]: v for k, v in self.m_shed.child_values().items()}
        # one refresh path for every on-demand gauge: the /metrics scrape
        # and the series sampler both run the registry's hooks (keyed: a
        # rebuilt ApiState replaces its hooks). Host-side numbers only:
        # the allocator's counters and Python values
        self.obs.add_refresh_hook("device_memory",
                                  lambda: sample_device_memory(self.obs, engine.device))
        self.obs.add_refresh_hook("slo", self.slo.snapshot)
        retention_s, interval_s = resolve_series_knobs(series_retention)
        self.series = SeriesStore(interval_s=interval_s, retention_s=retention_s)
        self.sampler = MetricsSampler(self.series)
        self.anomaly = AnomalyMonitor(build_default_rules(self.series))
        self.sampler.on_sample.append(self.anomaly.evaluate)
        # POST /v1/debug/profile: one capture at a time
        self.profile_lock = threading.Lock()
        # request defaults captured once
        self.default_temperature = engine.temperature
        self.default_top_p = engine.sampler.topp
        stops = [tokenizer.vocab[t].decode("utf-8", "replace") for t in tokenizer.eos_token_ids]
        self.stops = stops
        self.max_stop_len = max((len(s) for s in stops), default=0)
        self.template = ChatTemplateGenerator(
            chat_template_type, tokenizer.chat_template, stops[0] if stops else "")
        # the serialized path: the conversation the single-stream slab
        # holds, and the engine lock a request holds for its whole run
        self.naive_cache = NaiveCache()
        self.lock = threading.Lock()
        lanes_on = engine.batch_size > 1
        # the lanes' pool and radix tree, slab or native (a page size < 0:
        # no pool, the sharing-off baseline)
        self.kv_manager = None
        if lanes_on and kv_page_size >= 0:
            self.kv_manager = PagedKVManager(engine, page_size=kv_page_size,
                                             n_pages=kv_pool_pages,
                                             evict_counter=self.m_evictions, native=kv_native)
        self.predictor = self.watchdog = self.scheduler = None
        if lanes_on:
            # the load predictor exists before the scheduler thread
            # (admission records forecasts through it); every Retry-After
            # reads it, with predictive mode on or off
            self.predictor = LoadPredictor(engine)
            # every admission-path graph before the first request, the
            # verify buckets too when speculation is on (dllama_tpu's
            # api_server rehearses its compiled programs the same way)
            engine.rehearse_admission(lane_block_size, spec_k=0 if speculation == "off"
                                      else LaneScheduler.clamp_spec_k(engine, spec_k))
            # the watchdog starts after the rehearsal (its thread never
            # runs beside a capture) and before the scheduler, which beats
            # it every tick; its decode-stalled threshold scales off the
            # engine's own p99 block seconds, so a slow model does not
            # false-alarm
            self.watchdog = EngineWatchdog(
                block_p99=lambda: engine._m_step.labels(kind="decode_lanes").percentile(0.99),
                recorder=self.recorder, **resolve_watchdog_knobs())
            self.watchdog.start()
            self.scheduler = LaneScheduler(
                self, block_size=lane_block_size, admission_chunk=admission_chunk,
                speculation=speculation, spec_k=spec_k,
                max_streams=resolve_stream_knobs(max_streams), retry_max=retry_max,
                retry_backoff_ms=retry_backoff_ms)
        self.m_lanes_total.set(engine.batch_size)
        self.g_draining.set(0)
        # every postmortem dump embeds a /v1/health snapshot and the last
        # 60 s of the anomaly rules' series
        self.recorder.add_context_provider("health", self.health_snapshot)
        self.recorder.add_context_provider("series_60s", self._series_context)
        # the sampler last: every gauge and hook it reads exists now
        self.sampler.start()

    def _register_families(self, speculation: str) -> None:
        """Every serving family of the JAX ``ApiState`` but predictive
        admission's (``dllama_admission_*``, ``dllama_preemptions_total``),
        with the JAX names, help and labels."""
        obs = self.obs
        self.m_http = obs.counter(
            "dllama_http_requests_total",
            "HTTP requests by path (unknown paths fold into 'other').", labelnames=("path",))
        self.m_queue_depth = obs.gauge(
            "dllama_queue_depth", "Requests waiting for a free lane (lane-scheduler path).")
        self.m_lanes_total = obs.gauge("dllama_lanes_total", "Serving lanes this engine exposes.")
        self.m_lanes_active = obs.gauge("dllama_lanes_active",
                                        "Lanes currently decoding a request.")
        self.m_queue_wait = obs.histogram("dllama_queue_wait_seconds",
                                          "Submit -> admission wait (lane assignment).")
        self.m_prefill = obs.histogram("dllama_prefill_seconds",
                                       "Prompt prefill wall time at admission.")
        self.m_ttft = obs.histogram("dllama_ttft_seconds",
                                    "Submit -> first generated token (time to first token).")
        self.m_tpot = obs.histogram(
            "dllama_tpot_seconds",
            "Per-token decode latency a streaming client observes "
            "(block wall time / tokens per lane in the block).",
            buckets=DEFAULT_TOKEN_BUCKETS_S)
        self.m_admissions = obs.counter("dllama_admissions_total",
                                        "Requests admitted into a lane.")
        self.m_prefix_hits = obs.counter(
            "dllama_prefix_cache_hits_total",
            "Admissions that reused a stored prompt prefix (radix-tree match).")
        self.m_prefix_misses = obs.counter("dllama_prefix_cache_misses_total",
                                           "Admissions that prefilled from position 0.")
        self.m_reused_tokens = obs.counter("dllama_reused_prefix_tokens_total",
                                           "KV positions skipped thanks to prompt-prefix reuse.")
        self.m_evictions = obs.counter(
            "dllama_cache_evictions_total",
            "Stored prompt prefixes dropped to make room: radix-tree LRU page evictions "
            "(see also dllama_radix_evictions_total).")
        self.m_cancellations = obs.counter(
            "dllama_sse_cancellations_total",
            "Streaming requests whose client disconnected mid-response.")
        self.m_finished = obs.counter(
            "dllama_requests_finished_total",
            "Completed requests by finish reason (stop/length/cancelled/error).",
            labelnames=("reason",))
        self.m_sched_errors = obs.counter(
            "dllama_scheduler_errors_total",
            "Engine errors that reached the lane-scheduler loop (each one recovered or "
            "dropped the in-flight lanes; see the traceback log).")
        self.m_dispatch_retries = obs.counter(
            "dllama_dispatch_retries_total",
            "Transient engine-dispatch failures re-issued by the scheduler's bounded-backoff "
            "retry (the cache epoch did not move, so lane KV survived the failure).")
        self.m_lanes_recovered = obs.counter(
            "dllama_lanes_recovered_total",
            "Lanes resumed after a poisoning dispatch failure: the pool was reset and the "
            "stream's history re-prefilled, and its stream continued.")
        self.m_shed = obs.counter(
            "dllama_requests_shed_total",
            "Requests refused at admission with 429/503 + Retry-After, by reason "
            "(draining / queue_full / degraded).", labelnames=("reason",))
        self.g_draining = obs.gauge(
            "dllama_draining",
            "1 while the server drains (admission stopped, in-flight streams finishing), "
            "else 0.")
        self.m_admission_chunks = obs.counter(
            "dllama_admission_chunks_total",
            "Bounded prefill chunks dispatched by the chunked admission state machine (one "
            "per scheduler tick per admitting lane).")
        self.m_decode_stall = obs.histogram(
            "dllama_decode_stall_seconds",
            "Gap between consecutive decode-block dispatches while >=1 lane is active — the "
            "inter-token stall streaming clients see; bounded by one admission chunk + one "
            "block.")
        self.m_spec_drafted = obs.counter(
            "dllama_spec_draft_tokens_total",
            "Draft tokens proposed by the n-gram speculator across verify dispatches.")
        self.m_spec_accepted = obs.counter(
            "dllama_spec_accepted_tokens_total",
            "Draft tokens accepted by batched verification (the greedy argmax agreed with "
            "the draft at that position).")
        self.m_spec_accept_len = obs.histogram(
            "dllama_spec_accept_length",
            "Accepted draft-prefix length per lane per verify dispatch (0 = the first draft "
            "token already diverged; each dispatch still emits one correction token).",
            buckets=(0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0))
        self.g_spec_rate = obs.gauge(
            "dllama_spec_acceptance_rate",
            "Cumulative accepted/drafted token ratio of the n-gram speculator (0 until the "
            "first verify dispatch).")
        # registered only with speculation on, so "off" adds no series
        self.m_spec_source = self.g_spec_tokens_per_pass = None
        self.g_spec_store_groups = self.g_spec_store_streams = None
        self.g_spec_store_tokens = self.g_spec_store_hits = self.g_spec_store_misses = None
        if speculation != "off":
            self.m_spec_source = obs.counter(
                "dllama_spec_source_total",
                "Draft tokens proposed, by source: the lane's private n-gram index, a "
                "sibling continuation from the shared store, or the resident draft model.",
                labelnames=("source",))
            self.g_spec_tokens_per_pass = obs.gauge(
                "dllama_spec_tokens_per_weight_pass",
                "Mean tokens emitted per verify dispatch (1 + mean accepted prefix length) "
                "— compare against the roofline ceiling printed at startup.")
        if speculation in ("shared", "draft"):
            self.g_spec_store_groups = obs.gauge(
                "dllama_spec_shared_store_groups",
                "Anchor groups (radix node identities) currently held by the cross-lane "
                "shared n-gram store.")
            self.g_spec_store_streams = obs.gauge(
                "dllama_spec_shared_store_streams",
                "Published stream continuations across all anchor groups in the shared "
                "n-gram store.")
            self.g_spec_store_tokens = obs.gauge(
                "dllama_spec_shared_store_tokens",
                "Accepted tokens retained across all shared-store stream continuations.")
            self.g_spec_store_hits = obs.gauge(
                "dllama_spec_shared_store_hits",
                "Cumulative shared-store lookups that returned a sibling continuation.")
            self.g_spec_store_misses = obs.gauge(
                "dllama_spec_shared_store_misses",
                "Cumulative shared-store lookups that found no usable sibling continuation.")
        self.m_streams_parked = obs.gauge(
            "dllama_streams_parked",
            "Admitted streams currently parked out of their lane (--max-streams "
            "oversubscription): KV published to the shared pool, page list dropped, waiting "
            "to resume.")
        self.m_stream_resumes = obs.counter(
            "dllama_stream_resumes_total",
            "Parked streams resumed into a lane via radix re-match through the "
            "recovery-admission path.")
        # predictive admission: the forecast and its error, in ms buckets
        # (a warm prefix on an idle engine forecasts ~1 ms, a deep queue
        # tens of seconds)
        ms_buckets = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0, 1000.0, 2000.0,
                      5000.0, 10000.0, 30000.0, 60000.0)
        self.m_predicted_ttft = obs.histogram(
            "dllama_admission_predicted_ttft_ms",
            "LoadPredictor TTFT forecast recorded at admission (known queue wait + "
            "cost-model/percentile prefill forecast over the radix-matched suffix), in "
            "milliseconds.", buckets=ms_buckets)
        self.m_predict_error = obs.histogram(
            "dllama_admission_predict_error_ms",
            "Absolute estimated-vs-observed error of the admission forecast on clean finishes, "
            "by signal (ttft / tpot), in milliseconds; the EWMA correction factor feeds on the "
            "same pairs.", labelnames=("signal",), buckets=ms_buckets)
        self.m_admission_rejected = obs.counter(
            "dllama_admission_rejected_total",
            "Requests rejected by the PREDICTIVE controller before touching the queue, by "
            "reason (infeasible = the forecast says the deadline/TTFT budget cannot be met "
            "even if admitted now).", labelnames=("reason",))
        self.m_preemptions = obs.counter(
            "dllama_preemptions_total",
            "Active streams parked by deadline preemption so a feasible hinted request could "
            "meet its SLO, by reason (priority = lower-priority victim; deadline_blown = the "
            "victim's own effective deadline had already passed).", labelnames=("reason",))

    @property
    def shed(self) -> dict[str, int]:
        """Requests refused at admission by reason, since this server
        started (the registry's ``dllama_requests_shed_total``)."""
        if self.scheduler is None:
            now = {k[0]: v for k, v in self.m_shed.child_values().items()}
            return {k: int(v - self._shed_base.get(k, 0)) for k, v in sorted(now.items())
                    if v - self._shed_base.get(k, 0)}
        return self.scheduler._deltas("shed")

    def degraded_reasons(self) -> list[str]:
        """Composed degradation: the watchdog (a hard stall) and the
        anomaly monitor (a soft baseline deviation) each add reasons.
        Shared by /v1/health and `admission_decision`."""
        reasons: list[str] = []
        wd = self.watchdog
        if wd is not None and wd.degraded:
            reasons.append(f"watchdog:{wd.status().get('reason')}")
        if self.anomaly.degraded:
            reasons.extend(f"anomaly:{s}" for s in self.anomaly.active_signals())
        return reasons

    def estimate_prompt_tokens(self, params: InferenceParams) -> int:
        """A coarse prompt length before tokenizing, for the pre-queue
        feasibility gate: ~4 characters a token plus a template overhead a
        message, no radix match assumed (the forecast recorded at
        admission has the real count and match; the EWMA correction takes
        up the bias); a resume's token count."""
        if params.resume_tokens is not None:
            return len(params.resume_tokens)
        n_chars = sum(len(m.content) for m in params.messages)
        return max(2, n_chars // 4 + 8 * max(1, len(params.messages)))

    def note_predict_error(self, err_ms: float) -> None:
        self.predict_errors.append(float(err_ms))

    def predict_error_stats(self) -> dict:
        """p50 and p95 of the recent TTFT forecast errors (ms)."""
        errs = sorted(self.predict_errors)
        n = len(errs)
        if not n:
            return {"n": 0, "p50_ms": None, "p95_ms": None}
        return {"n": n, "p50_ms": round(errs[n // 2], 3),
                "p95_ms": round(errs[min(n - 1, int(n * 0.95))], 3)}

    def predicted_retry_after(self, floor: int = RETRY_AFTER) -> int:
        """``Retry-After`` from the predicted queue drain (monotonic in
        queue depth, capped by ``--admission-max-wait-ms``), never below
        ``floor``: every shed and every retryable error quotes it. The
        serialized path has no queue to predict: ``floor``."""
        if self.scheduler is None:
            return floor
        return max(floor, self.predictor.retry_after_s(self.scheduler.occupancy(),
                                                       self.admission_max_wait_ms))

    def admission_snapshot(self) -> dict:
        """``GET /v1/debug/admission``: the knobs, the predictor's
        calibration, the occupancy it forecasts against, the Retry-After it
        quotes now and the recent forecast errors (the knobs and the errors
        alone on the serialized path)."""
        out = {
            "predictive": self.admission_predict,
            "max_wait_ms": self.admission_max_wait_ms,
            "deadline_default_ms": self.deadline_default_ms,
            "deadline_priority_step_ms": self.deadline_priority_step_ms,
            "prediction_error": self.predict_error_stats(),
        }
        if self.scheduler is not None:
            occ = self.scheduler.occupancy()
            out.update(occupancy=occ.as_dict(), predictor=self.predictor.snapshot(),
                       retry_after_s=self.predictor.retry_after_s(occ,
                                                                  self.admission_max_wait_ms))
        return out

    def admission_decision(self, priority: str,
                           params: InferenceParams | None = None) -> tuple[str, int] | None:
        """The shedding gate, before a request reaches the queue: None
        admits, else (reason, Retry-After seconds). A drain refuses all;
        ``--max-queue-depth`` refuses by priority once the queue holds
        `SHED_FACTOR` of it; a ``low`` request is refused while the server
        is degraded. In predictive mode a HINTED request whose forecast
        misses its budget even if admitted now is refused as
        ``infeasible``; an unhinted one never is. Every Retry-After is the
        predicted drain, the JAX server's constants its floors. The
        serialized path has no queue and no predictor: a drain and the
        degraded ``low`` refusal only."""
        if self.drain_state()[0]:
            return "draining", self.predicted_retry_after(RETRY_AFTER_DRAINING)
        sched, depth = self.scheduler, self.max_queue_depth
        if (sched is not None and depth > 0
                and len(sched.pending) >= depth * SHED_FACTOR.get(priority, 1.0)):
            return "queue_full", self.predicted_retry_after()
        if priority == "low" and self.degraded_reasons():
            return "degraded", self.predicted_retry_after(RETRY_AFTER_DEGRADED)
        if (self.admission_predict and sched is not None and params is not None
                and params.deadline_hinted):
            budget = min(h for h in (params.deadline_ms, params.ttft_budget_ms) if h is not None)
            pred = self.predictor.predict(self.estimate_prompt_tokens(params),
                                          self.scheduler.occupancy())
            if pred.ttft_ms > budget:
                self.m_admission_rejected.labels(reason="infeasible").inc()
                return "infeasible", self.predicted_retry_after()
        return None

    def note_shed(self, reason: str, priority: str = "normal", retry_after: int = 0) -> None:
        self.m_shed.labels(reason=reason).inc()
        self.recorder.record("request_shed", reason=reason, priority=priority,
                             retry_after_s=retry_after)

    def in_flight(self) -> int:
        sched = self.scheduler
        if sched is None:
            return int(self.lock.locked())
        return sum(ls is not None for ls in sched.lanes) + len(sched.admitting) + len(
            sched.pending)

    def begin_drain(self) -> dict:
        """Start a graceful drain (``POST /v1/drain``, SIGTERM): admission
        sheds every request, the streams in flight run to their end, the
        span sink flushes, then ``drained`` is set. Idempotent."""
        with self._lock:
            start = not self.draining
            if start:
                self.draining, self.draining_since = True, time.time()
            since = self.draining_since
        if start:
            in_flight = self.in_flight()
            self.g_draining.set(1)
            self.recorder.record("drain_begin", in_flight=in_flight)
            threading.Thread(  # dlint: disable=thread-hygiene — the drained event is the join surface; the process exits after it fires
                target=self._drain_watch, daemon=True, name="dllama-drain").start()
        return {"status": "draining", "in_flight": self.in_flight(),
                "drained": self.drained.is_set(), "since_unix": since}

    def drain_state(self) -> tuple[bool, float | None]:
        """(draining, its start in Unix seconds), read under ``_lock``."""
        with self._lock:
            return self.draining, self.draining_since

    def _drain_watch(self) -> None:
        """Poll until nothing is in flight, flush the span sink, then set
        ``drained`` (the SIGTERM handler waits on it before it shuts the
        server down)."""
        while self.in_flight():
            time.sleep(0.05)
        self.spans.flush()
        self.recorder.record("drain_complete")
        since = self.drain_state()[1]
        self.recorder.record("drained", in_flight=0,
                             drain_s=round(time.time() - since, 3) if since is not None else 0.0)
        self.drained.set()

    def _series_context(self) -> dict:
        out = {}
        for name in DEFAULT_SIGNAL_SERIES:
            q = self.series.query(name, 60.0)
            if q is not None:
                out[name] = q
        return out

    def memory_snapshot(self) -> dict:
        """``/v1/debug/memory``: the card's allocator counters against the
        engine's analytic `memory_report` (host-side reads only)."""
        stats = sample_device_memory(self.obs, self.engine.device)
        mr = memory_report(self.engine)
        out = {"devices": stats, "analytic": mr.as_dict(),
               "comparison": compare_with_analytic(mr.per_device_bytes, stats)}
        if self.engine.world > 1:
            out["rank"] = {"rank": 0, "ranks": self.engine.world,
                           "note": "rank 0's own bytes: its slices of the weights and its "
                                   "share of the KV; every other rank holds its own"}
        return out

    def health_snapshot(self) -> dict:
        """The /v1/health payload, also embedded into postmortem dumps (the
        recorder's context providers), so it never takes the scheduler's
        cv: the lane and queue reads are GIL-atomic snapshots."""
        sched, kv = self.scheduler, self.kv_manager
        total = self.engine.batch_size
        if sched is not None:
            active = sum(1 for ls in sched.lanes if ls is not None)
            admitting, queued, parked = len(sched.admitting), len(sched.pending), sched._n_parked
            max_streams = max(sched.max_streams, total)
        else:
            active, admitting, queued, parked, max_streams = int(self.lock.locked()), 0, 0, 0, 1
        kv_info = {"enabled": False}
        if kv is not None:
            kv_info = dict(kv.debug(), enabled=True, native=kv.native,
                           page_bytes=self.engine.kv_page_bytes())
        kv_info["dtype"] = str(self.engine.kv_dtype).removeprefix("torch.")
        payload = {
            "status": "ok",
            "model": self.model_name,
            "uptime_s": round(time.time() - self.start_unix, 3),
            "lanes": {"total": total, "active": active, "free": total - active},
            "admitting": admitting,
            "queue_depth": queued,
            "cache_epoch": self.engine.cache_epoch,
            # the JAX server's router-facing capacity: the stream ceiling,
            # what holds a slot toward it, and whether the lanes are
            # pool-native (parks and resumes copy nothing)
            "capacity": {"lanes": total, "max_streams": max_streams,
                         "in_flight": active + admitting + parked + queued, "parked": parked,
                         "kv_native": bool(kv is not None and kv.native)},
            "kv": kv_info,
        }
        if sched is not None:
            payload["speculation"] = sched.spec_stats()
            payload["resilience"] = sched.resilience_stats()
        reasons = self.degraded_reasons()
        if self.watchdog is not None and self.watchdog.degraded:
            payload["watchdog"] = self.watchdog.status()
        if self.anomaly.degraded:
            payload["anomaly"] = self.anomaly.status()
        if reasons:
            # a degraded server still accepts connections: health says so,
            # so a probe or a router can act on it
            payload["status"] = "degraded"
            payload["degraded_reasons"] = reasons
        if self.replica_id is not None:
            payload["replica"] = self.replica_id
        engine = self.engine
        if engine.world > 1:
            payload["parallel"] = {"tp": engine.tp, "sp": engine.sp,
                                   "backend": engine.mesh.backend, "ranks": engine.world}
            payload["parallel"].update({k: n for k, n in (("pp", engine.pp), ("dp", engine.dp))
                                        if n > 1})
        draining, since = self.drain_state()
        if draining:
            # draining wins: routers must stop sending traffic
            payload["status"] = "draining"
            payload["draining_since_unix"] = since
        return payload

    # -- the serialized path -------------------------------------------------

    def complete(self, params: InferenceParams, emit, span) -> dict:
        """One serialized completion (the JAX ``ApiState.complete``), crash
        consistent: a dispatch that failed zeroed the engine's slab and moved
        ``cache_epoch`` (its guard), so the positions the NaiveCache records no
        longer hold; a moved epoch clears it. A client's error raised before any
        dispatch moves no epoch and keeps the cache. An OSError comes from
        ``emit``, the client's socket: the request was cancelled."""
        epoch = self.engine.cache_epoch
        try:
            return self._complete(params, emit, span)
        except BaseException as e:
            if self.engine.cache_epoch != epoch:
                self.naive_cache.clear()
            reason = "cancelled" if isinstance(e, OSError) else "error"
            if span.finish(reason) is not None:
                self.m_finished.labels(reason=reason).inc()
                if reason == "cancelled":
                    self.m_cancellations.inc()
            raise

    def _complete(self, params: InferenceParams, emit, span) -> dict:
        """The serialized path's completion (the JAX ``ApiState._complete``;
        reference: ApiServer::complete, src/dllama-api.cpp:367-487), under the
        engine lock: resolve the delta prompt against the `NaiveCache` (a miss
        resets the slab), prefill it from the cached end position and decode
        with the engine's blocks, ``emit(delta)`` a text delta. A ``max_tokens``
        cut runs one KV-only step, so that a cached continuation resumes from a
        complete context; a conversation that reaches seq_len resets. The
        NaiveCache learns the conversation only once its rows exist."""
        engine, tok = self.engine, self.tokenizer
        engine.temperature = params.temperature
        engine.sampler.set_temp(params.temperature)
        engine.sampler.set_topp(params.top_p)
        if params.seed is not None:
            engine.set_seed(params.seed)
        delta_prompt, start_pos = self.naive_cache.resolve_delta_prompt(params.messages)
        if start_pos > 0:
            self.m_prefix_hits.inc()
            self.m_reused_tokens.inc(start_pos)
        else:
            self.m_prefix_misses.inc()
        span.set_reused_prefix(start_pos)
        if start_pos == 0:
            engine.reset()
        items = [ChatItem(m.role, m.content) for m in delta_prompt]
        prompt = self.template.generate(items, append_generation_prompt=True)
        tokens = tok.encode(prompt.content, is_start=start_pos == 0, add_special_tokens=True)
        n_prompt = len(tokens)
        seq_len = engine.header.seq_len
        prompt_end = min(start_pos + n_prompt - 1, seq_len)
        max_pos = min(prompt_end + params.max_tokens, seq_len) if params.max_tokens > 0 else seq_len
        buffer = ""
        if prompt.public_prompt:
            emit(prompt.public_prompt)
            buffer += prompt.public_prompt
        tok.reset_decoder()
        detector = EosDetector(tok.eos_token_ids, self.stops if not params.stop else params.stop,
                               padding_left=self.max_stop_len, padding_right=self.max_stop_len)
        out = {"hit_eos": False, "buffer": buffer}
        t_gen = time.perf_counter()

        def on_token(t: int):
            self.slo.note_tokens(1)
            ttft = span.mark_first_token()
            if ttft is not None:
                self.m_ttft.observe(ttft)
                # this path's prefill: generate's start to the first token's
                # readback (the prefill and the first decode block)
                pf = time.perf_counter() - t_gen
                span.set_prefill_seconds(pf)
                self.m_prefill.observe(pf)
            eos_type = detector.append(t, tok.decode(t))
            if eos_type in (EosResult.NOT_EOS, EosResult.EOS):
                delta = detector.get_delta()
                if delta:
                    emit(delta)
                    out["buffer"] += delta
                detector.reset()
            if eos_type == EosResult.EOS:
                out["hit_eos"] = True
                return False
            return True

        out_tokens, _, _ = engine.generate(tokens, max_steps=max_pos - start_pos, on_token=on_token,
                                           start_pos=start_pos)
        pos = prompt_end + len(out_tokens)
        token = out_tokens[-1] if out_tokens else tokens[-1]
        n_completion = pos - prompt_end
        if not out["hit_eos"] and pos < seq_len:
            # the cut's last token has no KV row yet (a block past the cut
            # wrote it already, and writing the same row again changes nothing)
            engine.decode_step(token, pos)
            pos += 1
        if pos >= seq_len:
            self.naive_cache.clear()
            engine.reset()
        else:
            for m in delta_prompt:
                self.naive_cache.push(NaiveCacheItem(prompt_end, m))
            self.naive_cache.push(NaiveCacheItem(pos, ChatMessage("assistant", out["buffer"])))
        reason = "stop" if out["hit_eos"] else "length"
        if span.finish(reason, n_prompt=n_prompt, n_completion=n_completion) is not None:
            self.m_finished.labels(reason=reason).inc()
            self.slo.observe_span(span)
            self.spans.maybe_flush()
        return _completion_response(self, out["buffer"], reason, n_prompt, n_completion,
                                    meta=_span_metadata(span))


def _span_metadata(span) -> dict:
    """The serialized path's ``dllama`` metadata (the lanes' `LaneJob.
    metadata`): request id, lane (None), TTFT, queue wait (the engine-lock
    wait) and the reused prefix."""
    def ms(v):
        return None if v is None else round(v, 3)

    return {"request_id": span.request_id, "lane": span.lane, "ttft_ms": ms(span.ttft_ms),
            "queue_ms": ms(span.queue_wait_ms),
            "reused_prefix_tokens": span.reused_prefix_tokens}


def _completion_response(state: ApiState, content: str, finish_reason: str, n_prompt: int,
                         n_completion: int, meta: dict | None = None) -> dict:
    """The chat.completion response body."""
    resp = {
        "id": f"chatcmpl-{uuid.uuid4().hex[:12]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": state.model_name,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": content},
            "finish_reason": finish_reason,
        }],
        "usage": {
            "prompt_tokens": n_prompt,
            "completion_tokens": n_completion,
            "total_tokens": n_prompt + n_completion,
        },
    }
    if meta is not None:
        resp["dllama"] = meta
    return resp


def _sse_write(wfile, data: str) -> None:
    """One HTTP-chunked SSE frame."""
    raw = data.encode("utf-8")
    wfile.write(f"{len(raw):x}\r\n".encode() + raw + b"\r\n")


def _chunk_payload(state: ApiState, delta: str | None, stop: bool, reason: str = "stop",
                   meta: dict | None = None) -> dict:
    choice: dict = {"index": 0, "finish_reason": reason if stop else None}
    if not stop:
        choice["delta"] = {"role": "assistant", "content": delta}
    payload = {
        "id": "cmpl-1",
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": state.model_name,
        "choices": [choice],
    }
    if stop and meta is not None:
        payload["dllama"] = meta
    return payload


_KNOWN_PATHS = frozenset({
    "/v1/chat/completions", "/v1/models", "/v1/health", "/v1/debug/recorder",
    "/v1/debug/memory", "/v1/debug/compile", "/v1/debug/kv", "/v1/debug/timeline",
    "/v1/debug/slo", "/v1/debug/series", "/v1/debug/profile", "/v1/debug/admission",
    "/v1/debug/xlalint", "/v1/drain", "/dashboard", "/metrics", "/health", "/healthz",
})


def write_chrome_trace(events, path: str) -> dict:
    """Write a profiler's events (``KinetoEvent``s) to ``path`` as a
    Chrome trace of complete events: host ops on process 0 by thread
    (``cpu_op``, and the CUDA API calls as ``cuda_runtime`` /
    ``cuda_driver``), device activity on process 1 + the device index by
    stream. Each event keeps its ids as ``args``: a host op its
    ``External id``; a CUDA API call and a device event their
    ``correlation`` and the ``External id`` of the op that issued them,
    a device event its device and stream (not its launch metadata: grid,
    block and registers would double the profiler's stop). A
    flow (``ph`` s/f, category ``ac2g``, the correlation id) ties each
    launch to its kernels, as torch's own export does. Written in Python
    one event at a time, so the interpreter switches to the scheduler
    thread between events, where the profiler's own export holds it for
    seconds. Returns the number of events, the sorted kernel names and
    the number of correlation ids that link a launch to device work."""
    from torch.autograd import DeviceType

    n, kernels, devices, launched, ran = 0, set(), set(), set(), set()
    with open(path, "w") as f:
        f.write('{"traceEvents": [\n')
        f.write(json.dumps({"ph": "M", "name": "process_name", "pid": 0,
                            "args": {"name": "host"}}))
        annotated = None
        for e in events:
            if annotated is None:
                annotated = hasattr(e, "is_user_annotation")
            name, ts = e.name(), e.start_ns() / 1e3
            corr, flow = e.correlation_id(), None
            if e.device_type() == DeviceType.CPU:
                pid, tid = 0, e.start_thread_id()
                # the CUDA API calls by name (``cudaLaunchKernel``,
                # ``cuLaunchKernel``): torch 2.11's events carry no
                # activity type
                cat = ("cuda_runtime" if name.startswith("cuda")
                       else "cuda_driver" if name[:2] == "cu" and name[2:3].isupper()
                       else "cpu_op")
                if cat == "cpu_op":
                    args = {"External id": corr}
                else:
                    args = {"correlation": corr, "External id": e.linked_correlation_id()}
                    if corr:
                        flow = "s"
                        launched.add(corr)
            else:
                pid, tid = 1 + e.device_index(), e.device_resource_id()
                devices.add(e.device_index())
                cat = ("gpu_user_annotation" if annotated and e.is_user_annotation()
                       else "gpu_memcpy" if name.startswith("Memcpy")
                       else "gpu_memset" if name.startswith("Memset") else "kernel")
                if cat == "kernel":
                    kernels.add(name)
                args = {"correlation": corr, "External id": e.linked_correlation_id(),
                        "device": e.device_index(), "stream": tid}
                if corr:
                    flow = "f"
                    ran.add(corr)
            f.write(",\n" + json.dumps({"ph": "X", "cat": cat, "name": name, "pid": pid,
                                          "tid": tid, "ts": ts, "dur": e.duration_ns() / 1e3,
                                          "args": args}))
            if flow is not None:
                f.write(",\n" + json.dumps(
                    {"ph": flow, "cat": "ac2g", "name": "ac2g", "id": corr, "pid": pid,
                     "tid": tid, "ts": ts, **({"bp": "e"} if flow == "f" else {})}))
            n += 1
        for d in sorted(devices):
            f.write(",\n" + json.dumps({"ph": "M", "name": "process_name", "pid": 1 + d,
                                          "args": {"name": f"device {d}"}}))
        f.write("\n]}\n")
    return {"n_events": n, "kernels": sorted(kernels), "n_flows": len(launched & ran)}


def profile_capture(state: ApiState, seconds: float, out_dir: str) -> dict:
    """A ``torch.profiler`` capture of ``seconds`` of serving, written as a
    Chrome trace into ``out_dir``: CPU activity, and CUDA on the card.

    The profiler starts and stops on the scheduler thread between two
    ticks (`LaneScheduler.run_between_ticks`; on the serialized path under
    the engine lock, between two requests): no dispatch, and so no graph
    replay, is in flight when it does, the scheduler thread's host ops are
    the ones recorded, and no other thread launches device work while the
    stop collects the device's records (a stop from another thread while
    the scheduler replays a graph has deadlocked inside CUDA). The
    start and the stop hold the interpreter for as long as they take
    (torch's ``_disable_profiler`` collects and converts every device
    record without releasing it: seconds for a second of graphed decode),
    so each is declared to the watchdog as a pause (`EngineWatchdog.
    pause_begin`), not counted as a stall. The trace is written on the
    calling thread by `write_chrome_trace`, which lets the scheduler run
    between events, where ``export_chrome_trace`` would hold the
    interpreter throughout. A ``dllama.profile_window`` range marks the
    window. Raises when the capture fails or the trace holds no event.
    ``timings_s``: the start, the window, the stop and the export as the
    caller saw them, and the seconds the start and the stop held the
    scheduler thread (``scheduler_start``, ``scheduler_stop``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if state.engine.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    window = record_function("dllama.profile_window")
    sched, wd = state.scheduler, state.watchdog
    held: dict[str, float] = {}

    def declared(what, fn):
        def run():
            if wd is not None:
                wd.pause_begin("profile_" + what)
            t0 = time.perf_counter()
            try:
                fn()
            finally:
                held["scheduler_" + what] = time.perf_counter() - t0
                if wd is not None:
                    wd.pause_end()
        return run

    def between(fn):
        # the serialized path has no scheduler: between two requests is
        # when no dispatch is in flight
        if sched is not None:
            return sched.run_between_ticks(fn)
        with state.lock:
            return fn()

    def start():
        prof.start()
        window.__enter__()

    def stop():
        window.__exit__(None, None, None)
        prof.stop()

    t = [time.perf_counter()]
    between(declared("start", start))
    t.append(time.perf_counter())
    try:
        time.sleep(seconds)
    finally:
        t.append(time.perf_counter())
        between(declared("stop", stop))
        t.append(time.perf_counter())
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    written = write_chrome_trace(prof.profiler.kineto_results.events(), path)
    t.append(time.perf_counter())
    if not written["n_events"]:
        raise RuntimeError(f"the profiler wrote no event to {path}")
    timings = {k: round(b - a, 4) for k, a, b in
               zip(("start", "window", "stop", "export"), t, t[1:])}
    timings.update({k: round(v, 4) for k, v in held.items()})
    return {"log_dir": out_dir, "seconds": seconds, "n_files": len(os.listdir(out_dir)),
            "trace": path, **written, "timings_s": timings}


def make_handler(state: ApiState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _count_request(self) -> None:
            # unknown paths fold into one label (a scanner cannot blow up
            # the family's cardinality); a query string splits no series
            path = self.path.partition("?")[0]
            state.m_http.labels(path=path if path in _KNOWN_PATHS else "other").inc()

        def log_message(self, fmt, *args):  # quiet access log
            pass

        def _body(self, body: bytes, content_type: str) -> None:
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, payload: dict, status: int = 200,
                  retry_after: int | None = None) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(status)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                # shed, drain and retryable failures say when to come back
                self.send_header("Retry-After", str(retry_after))
            self.end_headers()
            self.wfile.write(body)

        def do_OPTIONS(self):  # CORS preflight (reference: writeCors)
            self.send_response(204)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "GET, POST, PUT, DELETE")
            self.send_header("Access-Control-Allow-Headers", "Content-Type, Authorization")
            self.end_headers()

        def do_GET(self):
            self._count_request()
            if state.replica_id is not None:
                set_thread_replica(state.replica_id)
            path, _, query = self.path.partition("?")
            params = parse_qs(query)

            def arg(name, default=None):
                return (params.get(name) or [default])[0]

            if path == "/v1/models":
                self._json({
                    "object": "list",
                    "data": [{"id": state.model_name, "object": "model", "created": 0,
                              "owned_by": "user"}],
                })
            elif path == "/v1/health":
                # ok / degraded / draining, the snapshot postmortems embed
                self._json(state.health_snapshot())
            elif path == "/metrics":
                # the refresh path the series sampler runs too
                state.obs.run_refresh_hooks()
                self._body(state.obs.render().encode("utf-8"), state.obs.CONTENT_TYPE)
            elif path == "/v1/debug/recorder":
                self._json(state.recorder.dump())
            elif path == "/v1/debug/memory":
                self._json(state.memory_snapshot())
            elif path == "/v1/debug/kv":
                kv = state.kv_manager
                self._json(dict(kv.debug(), enabled=True, native=kv.native) if kv is not None
                           else {"enabled": False})
            elif path == "/v1/debug/compile":
                self._json({"programs": state.engine.graph_report(),
                            "cost": state.engine.cost_report()})
            elif path == "/v1/debug/timeline":
                # Chrome-trace JSON of the span ring; ?request_id= narrows
                # it to one request and adds its millisecond accounting
                try:
                    base = int(arg("pid_base", "0"))
                except ValueError:
                    base = 0
                self._json(state.spans.chrome_trace(
                    request_id=arg("request_id"), replica=arg("replica"),
                    pid_prefix=arg("pid_prefix"), pid_base=base))
            elif path == "/v1/debug/slo":
                self._json(state.slo.snapshot())
            elif path == "/v1/debug/admission":
                self._json(state.admission_snapshot())
            elif path == "/v1/debug/xlalint":
                # the captured-graph lint over every key (analysis/graphlint.py)
                self._json(state.engine.xlalint_report())
            elif path == "/v1/debug/series":
                name = arg("name")
                if name is None:
                    self._json({"names": state.series.names(),
                                "interval_s": state.series.interval_s,
                                "retention_s": state.series.retention_s,
                                "anomaly": state.anomaly.status()})
                    return
                try:
                    window = float(arg("window", "300"))
                except ValueError:
                    self._json({"error": {"message": "bad window"}}, 400)
                    return
                result = state.series.query(name, window)
                if result is None:
                    self._json({"error": {"message": f"no series {name!r}"}}, 404)
                    return
                self._json(result)
            elif path == "/dashboard":
                self._body(render_dashboard(), DASHBOARD_CONTENT_TYPE)
            elif path in ("/health", "/healthz"):
                self._json({"status": "ok"})
            else:
                self.send_error(404, "Not Found")

        def _profile(self) -> None:
            """``POST /v1/debug/profile`` {"seconds": 2.0, "out_dir": ...}
            (both optional): `profile_capture`; 409 while another capture
            runs, 500 with the error when the capture fails."""
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                seconds = float(body.get("seconds", 2.0))
                out_dir = body.get("out_dir")
            except (ValueError, TypeError, AttributeError) as e:
                self._json({"error": {"message": f"bad request: {e}"}}, 400)
                return
            if not 0.0 < seconds <= 60.0:
                self._json({"error": {"message": "seconds must be in (0, 60]"}}, 400)
                return
            if not out_dir:
                import tempfile

                out_dir = os.path.join(tempfile.gettempdir(),
                                       f"dllama-profile-{uuid.uuid4().hex[:8]}")
            if not state.profile_lock.acquire(blocking=False):
                self._json({"error": {"message": "a capture is already running"}}, 409)
                return
            try:
                result = profile_capture(state, seconds, out_dir)
            except Exception as e:
                logger.exception("profile capture failed")
                state.recorder.record("profile_capture_error", error=str(e))
                self._json({"error": {"message": f"profile capture failed: {e}"}}, 500)
                return
            finally:
                state.profile_lock.release()
            state.recorder.record("profile_capture", log_dir=out_dir, seconds=seconds,
                                  n_files=result["n_files"], n_events=result["n_events"])
            self._json(result)

        def do_POST(self):
            self._count_request()
            if state.replica_id is not None:
                # handler threads are per request: tag each one, so the
                # shared span tracker of an in-process fleet knows its replica
                set_thread_replica(state.replica_id)
            path = self.path.partition("?")[0]
            if path == "/v1/debug/profile":
                self._profile()
                return
            if path == "/v1/drain":
                self._json(state.begin_drain())
                return
            if path != "/v1/chat/completions":
                self.send_error(404, "Not Found")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                params = self._parse_params(body)
            except (ValueError, KeyError, TypeError) as e:
                self._json({"error": {"message": f"bad request: {e}"}}, 400)
                return
            if params.trace_id is not None:
                # the fleet's identity adopted: recorded before the shed
                # gate, so a refused relay is attributable too
                state.recorder.record("trace_adopt", trace_id=params.trace_id,
                                      request_id=params.request_id, replica=state.replica_id,
                                      resumed=params.resume_tokens is not None)
            # shed before the request touches the queue: a refusal costs
            # the server nothing
            shed = state.admission_decision(params.priority, params)
            if shed is not None:
                reason, retry_after = shed
                state.note_shed(reason, params.priority, retry_after)
                self._json({"error": {"message": f"request shed: {reason}", "retryable": True,
                                      "retry_after_s": retry_after}},
                           503 if reason == "draining" else 429, retry_after=retry_after)
                return
            if state.scheduler is not None:
                job = state.scheduler.submit(params)
                if params.stream:
                    self._stream(job)
                else:
                    self._complete(job)
                return
            if params.resume_tokens is not None:
                # the serialized path has no resume admission: a resume here
                # would silently retokenize
                self._json({"error": {"message": "resume_tokens requires the lane scheduler "
                                                 "(batch_size > 1)"}}, 400)
                return
            self._serialized(params)

        def _serialized(self, params: InferenceParams) -> None:
            """One request on the serialized path, under the engine lock:
            its queue wait is the lock wait; ``dllama_lanes_active`` is 1
            while it runs. A ``ValueError`` (the client's: a prompt too long)
            answers 400, any other error 500, as JSON; a stream carries the
            error as an event and still ends in ``[DONE]``."""
            span = state.tracer.span(request_id=params.request_id, path="single",
                                     trace_id=params.trace_id)
            with state.lock:
                state.m_queue_wait.observe(span.mark_admitted())
                state.m_admissions.inc()
                state.m_lanes_active.set(1)
                try:
                    if params.stream:
                        self._stream_single(params, span)
                        return
                    try:
                        response = state.complete(params, emit=lambda d: None, span=span)
                    except ValueError as e:
                        self._json({"error": {"message": str(e)}}, 400)
                        return
                    except Exception as e:
                        logger.exception("serialized completion failed")
                        state.recorder.record("completion_error", error=str(e),
                                              error_type=type(e).__name__)
                        self._json({"error": {"message": str(e)}}, 500)
                        return
                    self._json(response)
                finally:
                    state.m_lanes_active.set(0)

        def _stream_single(self, params: InferenceParams, span) -> None:
            """The serialized path's SSE stream (the JAX handler's
            ``_stream``): a chunk a text delta as `complete` emits it; an
            error after the headers is an error event; then the final chunk
            and ``[DONE]``. A client gone mid-stream (an OSError from the
            socket) ends it: `complete` counted the cancellation."""
            self._sse_headers()

            def emit(delta: str) -> None:
                _sse_write(self.wfile, f"data: {json.dumps(_chunk_payload(state, delta, False))}"
                                       "\r\n\r\n")

            finish_reason = "stop"
            try:
                finish_reason = state.complete(params, emit=emit,
                                               span=span)["choices"][0]["finish_reason"]
            except OSError:
                self.close_connection = True
                return
            except Exception as e:
                logger.exception("serialized completion failed")
                state.recorder.record("completion_error", error=str(e),
                                      error_type=type(e).__name__)
                _sse_write(self.wfile, f"data: {json.dumps({'error': {'message': str(e)}})}"
                                       "\r\n\r\n")
            final = _chunk_payload(state, None, True, finish_reason, meta=_span_metadata(span))
            _sse_write(self.wfile, "data: " + json.dumps(final) + "\r\n\r\n")
            _sse_write(self.wfile, "data: [DONE]\r\n\r\n")
            self.wfile.write(b"0\r\n\r\n")

        def _sse_headers(self) -> None:
            self.send_response(200)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Type", "text/event-stream; charset=utf-8")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

        def _stream(self, job: LaneJob) -> None:
            self._sse_headers()
            finish_reason, errored = "stop", False
            try:
                while True:
                    kind, payload = job.events.get()
                    if kind == "delta":
                        if isinstance(payload, dict):
                            # include_tokens: the delta with its exact ids
                            # and text
                            chunk = _chunk_payload(state, payload["text"], stop=False)
                            chunk["dllama_tokens"] = payload["tokens"]
                            chunk["dllama_piece"] = payload["piece"]
                        else:
                            chunk = _chunk_payload(state, payload, stop=False)
                            if job.params.include_tokens:
                                # the public-prompt echo: no generated
                                # token behind it, its text as the piece
                                chunk["dllama_tokens"] = []
                                chunk["dllama_piece"] = payload
                        # one span a frame: a slow client's backpressure
                        # shows on the timeline's http track
                        with state.spans.span("sse_flush", component="http",
                                              request_id=job.request_id, lane=job.lane):
                            # chaos site: an injected flush failure is a
                            # client gone mid-stream (the cancel path below);
                            # ``op`` scopes it to one fleet replica
                            # (sse_flush:op=r1:...)
                            fault = get_fault_plane().draw("sse_flush", op=state.replica_id)
                            if fault is not None:
                                raise OSError(str(fault))
                            _sse_write(self.wfile, f"data: {json.dumps(chunk)}\r\n\r\n")
                    elif kind == "error":
                        _sse_write(self.wfile, f"data: {json.dumps({'error': payload})}\r\n\r\n")
                        errored = True
                        break
                    else:  # done
                        finish_reason = payload
                        break
                if not errored:
                    final = _chunk_payload(state, None, True, finish_reason, meta=job.metadata())
                    _sse_write(self.wfile, "data: " + json.dumps(final) + "\r\n\r\n")
                _sse_write(self.wfile, "data: [DONE]\r\n\r\n")
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                # the client went away: stop paying for its lane; the
                # chunked body is unterminated, so close the connection
                job.cancelled = True
                self.close_connection = True

        def _complete(self, job: LaneJob) -> None:
            while True:
                kind, payload = job.events.get()
                if kind == "error":
                    # an engine fault (retryable) answers 503 and
                    # Retry-After, a request the server could not take 500
                    retryable = bool(payload.get("retryable"))
                    self._json({"error": payload}, 503 if retryable else 500,
                               retry_after=state.predicted_retry_after() if retryable else None)
                    return
                if kind == "done":
                    break
            self._json(_completion_response(state, job.buffer, payload, job.n_prompt_tokens,
                                             job.n_completion, meta=job.metadata()))

        def _parse_params(self, body: dict) -> InferenceParams:
            """(reference: parseRequest, src/dllama-api.cpp:491-520)"""
            params = InferenceParams(temperature=state.default_temperature,
                                     top_p=state.default_top_p, stop=[])
            if body.get("resume_tokens") is not None:
                # a raw fed history in place of the messages (lanes only)
                params.resume_tokens = [int(t) for t in body["resume_tokens"]]
                messages = body.get("messages", [])
            else:
                messages = body["messages"]
            params.messages = [ChatMessage(m["role"], m["content"]) for m in messages]
            if "include_tokens" in body:
                params.include_tokens = bool(body["include_tokens"])
            if "stream" in body:
                params.stream = bool(body["stream"])
            if "temperature" in body:
                params.temperature = float(body["temperature"])
            if "top_p" in body:
                params.top_p = float(body["top_p"])
            if "seed" in body:
                params.seed = int(body["seed"])
            if "max_tokens" in body:
                params.max_tokens = int(body["max_tokens"])
            if "stop" in body:
                stop = body["stop"]
                # OpenAI allows a bare string or a list of strings
                params.stop = [stop] if isinstance(stop, str) else [str(x) for x in stop]
            if "priority" in body:
                priority = str(body["priority"])
                if priority not in PRIORITIES:
                    raise ValueError(f"unknown priority {priority!r}")
                params.priority = priority
            # latency budgets: the body's fields win; the relay header
            # x-dllama-deadline-ms backs deadline_ms up (a malformed or
            # non-positive header is ignored, never fails the request)
            for name in ("deadline_ms", "ttft_budget_ms"):
                if body.get(name) is not None:
                    value = float(body[name])
                    if value <= 0:
                        raise ValueError(f"{name} must be > 0")
                    setattr(params, name, value)
            header = self.headers.get("x-dllama-deadline-ms")
            if header and params.deadline_ms is None:
                try:
                    value = float(header)
                except ValueError:
                    value = 0.0
                if value > 0:
                    params.deadline_ms = value
            # the fleet router's identity of the request; absent outside a fleet
            trace_id = self.headers.get("x-dllama-trace")
            request_id = self.headers.get("x-dllama-request")
            if trace_id:
                params.trace_id = str(trace_id)
            if request_id:
                params.request_id = str(request_id)
            return params

    return Handler


def serve(
    engine: InferenceEngine,
    tokenizer: Tokenizer,
    host: str = "0.0.0.0",
    port: int = 9990,
    model_name: str = "dllama-tpu",
    chat_template_type: ChatTemplateType = ChatTemplateType.UNKNOWN,
    lane_block_size: int | None = None,
    admission_chunk: int | None = None,
    kv_page_size: int | None = None,
    kv_pool_pages: int | None = None,
    kv_native: bool | None = None,
    speculation: str | None = None,
    spec_k: int | None = None,
    draft_model: str | None = None,
    max_streams: int | None = None,
    retry_max: int | None = None,
    retry_backoff_ms: int | None = None,
    max_queue_depth: int | None = None,
    faults: str | None = None,
    trace_out: str | None = None,
    timeline_out: str | None = None,
    postmortem_dir: str | None = None,
    slo_ttft_ms: float | None = None,
    slo_tpot_ms: float | None = None,
    series_retention: float | None = None,
    admission_predict: bool | None = None,
    admission_max_wait_ms: int | None = None,
    deadline_default_ms: int | None = None,
    deadline_priority_step_ms: int | None = None,
    replica_id: str | None = None,
) -> ThreadingHTTPServer:
    """Build the server over the engine: the serialized path at batch
    size 1, else lanes (slab or pool-native, with their page pool, by
    `resolve_kv_knobs`: ``kv_page_size``, ``kv_pool_pages`` and
    ``kv_native`` default to ``DLLAMA_KV_PAGE_SIZE`` /
    ``DLLAMA_KV_POOL_PAGES`` / ``DLLAMA_KV_NATIVE``, then 0, 0 and slab);
    the caller runs ``serve_forever()`` and ``server_close()`` stops the
    scheduler too. ``speculation`` and
    ``spec_k`` default to ``DLLAMA_SPECULATION`` / ``DLLAMA_SPEC_K``, then
    ``off`` and 4; ``speculation="draft"`` loads ``draft_model`` (else
    ``DLLAMA_DRAFT_MODEL``) into the engine before the server's rehearsal,
    and raises ValueError without one; ``max_streams``, ``retry_max``,
    ``retry_backoff_ms`` and
    ``max_queue_depth`` to their ``DLLAMA_*`` variables, then 0, 3, 5 and
    0 (`resolve_stream_knobs`, `resolve_resilience_knobs`). ``faults`` arms
    the process-wide chaos plane (``DLLAMA_FAULTS`` armed it at import).
    Observability: ``trace_out`` appends one JSON line a finished request;
    ``timeline_out`` rewrites the span timeline there (throttled, and once
    more at close); ``postmortem_dir`` (else ``DLLAMA_POSTMORTEM_DIR``)
    receives the flight recorder's dumps; ``slo_ttft_ms`` /
    ``slo_tpot_ms`` (else ``DLLAMA_SLO_*``) set the SLO targets and
    ``series_retention`` (else ``DLLAMA_SERIES_RETENTION_S``, then 3600)
    the series store's seconds. Predictive admission: ``admission_predict``
    and ``admission_max_wait_ms`` default to ``DLLAMA_ADMISSION_PREDICT`` /
    ``DLLAMA_ADMISSION_MAX_WAIT_MS``, then off and 30000;
    ``deadline_default_ms`` and ``deadline_priority_step_ms`` to
    ``DLLAMA_DEADLINE_DEFAULT_MS`` / ``DLLAMA_DEADLINE_PRIORITY_STEP_MS``,
    then 600000 and 60000 (runtime/admission.py). ``replica_id`` names the
    server as a fleet replica (fleet/): /v1/health's ``replica``, its
    threads' span tag and the ``op`` of its ``sse_flush`` faults."""
    if faults is not None:
        set_fault_plane(faults)
    page_size, pool_pages, native = resolve_kv_knobs(kv_page_size, kv_pool_pages, kv_native)
    spec_mode, _ = resolve_spec_knobs(speculation, spec_k)
    if spec_mode == "draft":
        draft_path = resolve_draft_model(draft_model)
        if draft_path is None:
            raise ValueError("--speculation draft needs a draft checkpoint: pass --draft-model "
                             "or set DLLAMA_DRAFT_MODEL")
        # before ApiState: its rehearsal captures the draft's graphs only
        # when the model is there
        engine.init_draft_model(draft_path)
    state = ApiState(
        engine, tokenizer, model_name, chat_template_type,
        lane_block_size=lane_block_size or DEFAULT_LANE_BLOCK, admission_chunk=admission_chunk,
        kv_page_size=page_size, kv_pool_pages=pool_pages, kv_native=native,
        speculation=speculation, spec_k=spec_k, max_streams=max_streams, retry_max=retry_max,
        retry_backoff_ms=retry_backoff_ms, max_queue_depth=max_queue_depth,
        tracer=Tracer(sink_path=trace_out) if trace_out else None, slo_ttft_ms=slo_ttft_ms,
        slo_tpot_ms=slo_tpot_ms, series_retention=series_retention,
        admission_predict=admission_predict, admission_max_wait_ms=admission_max_wait_ms,
        deadline_default_ms=deadline_default_ms,
        deadline_priority_step_ms=deadline_priority_step_ms, replica_id=replica_id,
    )
    if postmortem_dir:
        state.recorder.postmortem_dir = postmortem_dir
    if timeline_out:
        state.spans.set_sink(timeline_out)
    server = ThreadingHTTPServer((host, port), make_handler(state))
    server.state = state
    inner_close = server.server_close

    def _close():
        inner_close()
        if state.scheduler is not None:
            state.scheduler.stop()
            state.watchdog.stop()
        # join the sampler: a closed server leaves no thread writing the
        # shared registry
        state.sampler.stop()
        if timeline_out:
            state.spans.flush()
        if trace_out:
            state.tracer.close()

    server.server_close = _close
    return server


def _install_drain_handler(server) -> None:
    """SIGTERM drains: admission stops, the streams in flight finish (60 s
    at most), then the server shuts down. Signal handlers install only
    from the main thread; elsewhere this does nothing."""
    import signal

    def on_term(signum, frame):
        server.state.begin_drain()

        def wait_and_stop():
            server.state.drained.wait(timeout=60.0)
            server.shutdown()

        threading.Thread(  # dlint: disable=thread-hygiene — process is exiting; server.shutdown() is the terminal act
            target=wait_and_stop, daemon=True, name="dllama-drain-stop").start()

    try:
        signal.signal(signal.SIGTERM, on_term)
    except ValueError:
        pass


def build_parser():
    """The server's flags: host and port, speculation, resilience, and the
    engine's (`cli.add_engine_args`)."""
    import argparse

    from ..cli import add_engine_args, add_obs_args

    parser = argparse.ArgumentParser(prog="dllama-tpu-torch-api")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=9990)
    parser.add_argument("--speculation", default=None,
                        choices=["off", "ngram", "shared", "draft"],
                        help="greedy lanes draft from n-grams of their own history "
                             "(ngram), of sibling streams (shared) and from a resident draft "
                             "model (draft), verified in one pass a tick (default: "
                             "$DLLAMA_SPECULATION, else off)")
    parser.add_argument("--draft-model", default=None, metavar="PATH",
                        help="the draft checkpoint of --speculation draft, with the target's "
                             "vocab (default: $DLLAMA_DRAFT_MODEL)")
    parser.add_argument("--spec-k", type=int, default=None,
                        help="most draft tokens a verify pass checks a lane "
                             "(default: $DLLAMA_SPEC_K, else 4)")
    parser.add_argument("--faults", default=None, metavar="SPEC",
                        help="arm the chaos plane with a fault schedule, e.g. "
                             "'dispatch:op=decode_lanes:nth=2:kind=poison' (runtime/faults.py; "
                             "default: $DLLAMA_FAULTS)")
    parser.add_argument("--retry-max", type=int, default=None,
                        help="retries of a failed engine dispatch on an intact pool "
                             "(default: $DLLAMA_RETRY_MAX, else 3; 0: none)")
    parser.add_argument("--retry-backoff-ms", type=int, default=None,
                        help="backoff before the first retry, doubling after each "
                             "(default: $DLLAMA_RETRY_BACKOFF_MS, else 5)")
    parser.add_argument("--max-queue-depth", type=int, default=None,
                        help="shed (429, Retry-After) once this many requests wait; priority "
                             "low sheds at half, high at twice (default: "
                             "$DLLAMA_MAX_QUEUE_DEPTH, else 0: never)")
    parser.add_argument("--max-streams", type=int, default=None,
                        help="above the lane count, park the most-progressed stream for a "
                             "queued request and resume it later (default: "
                             "$DLLAMA_MAX_STREAMS, else 0: off)")
    add_engine_args(parser)
    add_obs_args(parser)
    parser.add_argument("--slo-ttft-ms", type=float, default=None,
                        help="TTFT SLO target in ms of the windowed attainment and goodput "
                             "gauges (obs/slo.py; default: $DLLAMA_SLO_TTFT_MS, else none)")
    parser.add_argument("--slo-tpot-ms", type=float, default=None,
                        help="mean-TPOT SLO target in ms (obs/slo.py; default: "
                             "$DLLAMA_SLO_TPOT_MS, else none)")
    parser.add_argument("--series-retention", type=float, default=None, metavar="SECONDS",
                        help="seconds of in-process metric series kept for /v1/debug/series "
                             "and /dashboard (obs/timeseries.py; default: "
                             "$DLLAMA_SERIES_RETENTION_S, else 3600)")
    return parser


def main(argv=None):
    """The server's command line. With more than one rank (``--tp``/``--sp``/``--pp``/``--dp``)
    and no torchrun, this process becomes rank 0 and starts the others
    (parallel/launch.lead); under torchrun every process is a rank. Rank 0
    serves and controls the other ranks (parallel/control.py), which
    follow until rank 0 stops."""
    import sys

    import torch.distributed as dist

    from ..cli import resolve_mesh_shape
    from ..parallel.mesh import torchrun_env

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    tp, sp, pp, dp = resolve_mesh_shape(args)
    if tp * sp * pp * dp > 1 and not dist.is_initialized() and not torchrun_env():
        from ..parallel.launch import lead_command

        return lead_command(lambda: _serve_main(args), "server", argv, args.device, tp, sp, pp,
                            dp)
    if torchrun_env() and int(os.environ["RANK"]) != 0:  # rank 0 alone prints
        import contextlib

        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            return _serve_main(args)
    return _serve_main(args)


def _serve_main(args):
    """Build the engine and serve it (rank 0), or follow (every other
    rank). Under world > 1 the server stops once it has drained (SIGTERM or
    ``POST /v1/drain``), then tells the other ranks to stop; a lost rank
    stops it too, and it raises that rank's error."""
    from ..cli import load_engine
    from ..parallel.control import lead_or_follow

    engine, tok = load_engine(args)
    ctl = lead_or_follow(engine)
    if isinstance(ctl, dict):  # a follower, after rank 0's stop
        return ctl
    ttype = (CHAT_TEMPLATE_NAMES[args.chat_template] if args.chat_template
             else ChatTemplateType.UNKNOWN)
    server = serve(
        engine, tok, host=args.host, port=args.port, model_name=os.path.basename(args.model),
        chat_template_type=ttype, lane_block_size=args.lane_block_size,
        admission_chunk=args.admission_chunk, kv_page_size=args.kv_page_size,
        kv_pool_pages=args.kv_pool_pages,
        kv_native=None if args.kv_native is None else bool(args.kv_native),
        speculation=args.speculation, spec_k=args.spec_k, draft_model=args.draft_model,
        max_streams=args.max_streams, retry_max=args.retry_max,
        retry_backoff_ms=args.retry_backoff_ms, max_queue_depth=args.max_queue_depth,
        faults=args.faults, trace_out=args.trace_out, timeline_out=args.timeline_out,
        postmortem_dir=args.postmortem_dir, slo_ttft_ms=args.slo_ttft_ms,
        slo_tpot_ms=args.slo_tpot_ms, series_retention=args.series_retention,
        admission_predict=args.admission_predict,
        admission_max_wait_ms=args.admission_max_wait_ms,
        deadline_default_ms=args.deadline_default_ms,
        deadline_priority_step_ms=args.deadline_priority_step_ms, replica_id=args.replica_id,
    )
    _install_drain_handler(server)
    if ctl is not None:
        for event in (server.state.drained, ctl.lost):
            threading.Thread(  # dlint: disable=thread-hygiene — its event's shutdown() ends serve_forever; the daemon thread exits with the process
                target=lambda ev=event: (ev.wait(), server.shutdown()),
                daemon=True, name="dllama-control-stop").start()
    print(f"Server URL: http://{args.host}:{server.server_address[1]}/v1/", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        summary = ctl.stop() if ctl is not None else None
    if ctl is not None and ctl.lost.is_set():
        raise ctl.error
    return summary


if __name__ == "__main__":
    main()
