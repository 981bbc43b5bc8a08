"""Per-request lifecycle tracing: spans over submit -> queue-wait ->
admit/lane -> prefill -> first-token -> per-token decode -> finish/cancel.

A :class:`Tracer` holds finished-request records in a bounded ring buffer
(old records fall off; a long-lived server never grows) and optionally
appends each record as one JSON line to a sink file (``--trace-out``).
A :class:`RequestSpan` is the mutable in-flight view: the serving layers
mark lifecycle points on it and the span computes the derived intervals
(queue wait, prefill span, TTFT) from a monotonic clock.

Spans are written from two threads (HTTP handler + lane scheduler) but
every field is marked by exactly one side at one lifecycle point, and
``finish`` is idempotent — the first caller wins, later calls no-op.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from collections import deque


def _dumps_safe(rec: dict) -> str:
    """Serialize one trace record, tolerating non-JSON attr values by
    falling back to ``repr`` — a caller attaching an exception object or
    a numpy scalar to a span must degrade the trace line, never raise
    mid-request on the serving thread."""
    try:
        return json.dumps(rec, default=repr)
    except (TypeError, ValueError):
        # non-string keys or self-referencing structures: keep the line
        return json.dumps({"_unserializable": repr(rec)})


class RequestSpan:
    """One request's lifecycle; see module docstring. All ``*_s`` fields
    are seconds on the monotonic clock, ``submitted_unix`` is wall time."""

    def __init__(self, tracer: "Tracer | None", request_id: str | None = None,
                 path: str = "lanes", trace_id: str | None = None) -> None:
        self.tracer = tracer
        self.request_id = request_id or f"req-{uuid.uuid4().hex[:12]}"
        # fleet-level identity: the router mints one trace id
        # per client request and forwards it on every relay INCLUDING
        # failover re-issues, so the same trace id lands in every replica
        # that touched the request. None outside a fleet.
        self.trace_id = trace_id
        self.path = path
        self.submitted_unix = time.time()
        self.t_submit = time.perf_counter()
        self.lane: int | None = None
        self.queue_wait_s: float | None = None
        self.prefill_s: float | None = None
        self.ttft_s: float | None = None
        self.reused_prefix_tokens = 0
        self.n_prompt_tokens: int | None = None
        self.n_completion: int | None = None
        self.finish_reason: str | None = None
        self.total_s: float | None = None
        self._finished = False

    # -- lifecycle marks -------------------------------------------------

    def mark_admitted(self, lane: int | None = None,
                      reused_prefix_tokens: int = 0) -> float:
        """Request left the queue (lane assigned / lock acquired); returns
        the queue wait in seconds."""
        self.queue_wait_s = time.perf_counter() - self.t_submit
        self.lane = lane
        self.reused_prefix_tokens = reused_prefix_tokens
        return self.queue_wait_s

    def set_reused_prefix(self, n_tokens: int) -> None:
        self.reused_prefix_tokens = n_tokens

    def set_prefill_seconds(self, seconds: float) -> None:
        self.prefill_s = seconds

    def set_tokens(self, n_prompt: int | None = None,
                   n_completion: int | None = None) -> None:
        if n_prompt is not None:
            self.n_prompt_tokens = n_prompt
        if n_completion is not None:
            self.n_completion = n_completion

    def mark_first_token(self) -> float | None:
        """First generated token reached the host; returns TTFT seconds,
        or None when already marked (callers observe the return into the
        TTFT histogram, so the None contract keeps that single-shot)."""
        if self.ttft_s is not None:
            return None
        self.ttft_s = time.perf_counter() - self.t_submit
        return self.ttft_s

    def finish(self, reason: str, n_prompt: int | None = None,
               n_completion: int | None = None) -> dict | None:
        """Close the span and record it; idempotent (first reason wins)."""
        if self._finished:
            return None
        self._finished = True
        self.set_tokens(n_prompt, n_completion)
        self.finish_reason = reason
        self.total_s = time.perf_counter() - self.t_submit
        rec = self.to_record()
        if self.tracer is not None:
            self.tracer.record(rec)
        return rec

    # -- views -----------------------------------------------------------

    @property
    def ttft_ms(self) -> float | None:
        return None if self.ttft_s is None else self.ttft_s * 1000.0

    @property
    def queue_wait_ms(self) -> float | None:
        return None if self.queue_wait_s is None else self.queue_wait_s * 1000.0

    def to_record(self) -> dict:
        return {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "path": self.path,
            "submitted_unix": round(self.submitted_unix, 6),
            "lane": self.lane,
            "queue_wait_s": self.queue_wait_s,
            "prefill_s": self.prefill_s,
            "ttft_s": self.ttft_s,
            "reused_prefix_tokens": self.reused_prefix_tokens,
            "n_prompt_tokens": self.n_prompt_tokens,
            "n_completion": self.n_completion,
            "finish_reason": self.finish_reason,
            "cancelled": self.finish_reason == "cancelled",
            "total_s": self.total_s,
        }


class _NullSpan(RequestSpan):
    """Inert span for uninstrumented call sites: every mark is a no-op and
    nothing is ever recorded."""

    def __init__(self):
        super().__init__(tracer=None, request_id="null", path="null")
        self._finished = True  # finish() no-ops forever

    def mark_admitted(self, lane: int | None = None,
                      reused_prefix_tokens: int = 0) -> float:
        return 0.0

    def mark_first_token(self):
        return None


NULL_SPAN = _NullSpan()


class Tracer:
    """Bounded ring buffer of finished-request records + optional JSONL
    sink; thread-safe. See module docstring."""

    def __init__(self, capacity: int = 512, sink_path: str | None = None) -> None:
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.sink_path = sink_path
        self._sink = None
        if sink_path:
            # line-buffered append: each record is durable at the newline,
            # so a crashed server still leaves complete JSONL lines behind
            self._sink = open(sink_path, "a", buffering=1)

    def span(self, request_id: str | None = None,
             path: str = "lanes", trace_id: str | None = None) -> RequestSpan:
        return RequestSpan(self, request_id, path, trace_id=trace_id)

    def record(self, rec: dict) -> None:
        line = _dumps_safe(rec)
        sink_error = None
        with self._lock:
            self._ring.append(rec)
            if self._sink is not None:
                try:
                    self._sink.write(line + "\n")
                except (ValueError, OSError) as e:
                    # closed/broken sink: keep the ring alive, but make
                    # the observability failure itself observable
                    self._sink = None
                    sink_error = e
        if sink_error is not None:
            from .recorder import get_recorder

            get_recorder().record(
                "obs_sink_error", what="trace_jsonl",
                path=self.sink_path, error=str(sink_error),
                error_type=type(sink_error).__name__,
            )

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def export(self, path: str) -> int:
        """Dump the current ring as JSONL; returns the record count.
        Non-serializable attr values degrade to ``repr`` per record."""
        recs = self.records()
        with open(path, "w") as f:
            for rec in recs:
                f.write(_dumps_safe(rec) + "\n")
        return len(recs)

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None


def read_jsonl(path: str) -> list[dict]:
    """Load a ``--trace-out`` file back into records (the round-trip
    counterpart of the sink; tests and analysis notebooks use this)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
