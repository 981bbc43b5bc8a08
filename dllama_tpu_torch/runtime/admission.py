"""Predictive, deadline-aware admission control for the lane server.

The port's copy of dllama_tpu/runtime/admission.py (stdlib only; its cost
inputs come from the port's ``obs/cost.py``). The queue-depth ladder of
``ApiState.admission_decision`` is reactive: it sheds after the queue
has built up. This module closes the loop from measurement to control.
:class:`LoadPredictor` forecasts a candidate request's TTFT and
steady-state TPOT *before* the scheduler commits a lane to it, from three
inputs the engine already tracks:

* the step costs of the lane prefill-chunk and lane decode-block kinds:
  measured once enough dispatches exist (on the card their mean
  device seconds, from the engine's CUDA events; on the CPU the observed
  ``dllama_engine_step_seconds`` median), else the analytic bytes of the
  kind's representative graph key over the card's HBM peak
  (``obs/cost.py``), else a cold floor;
* current occupancy: active lanes, parked streams, queued admission
  chunks and the pending queue ahead of the candidate
  (:class:`OccupancySnapshot`, taken by the scheduler under its lock);
* the radix-tree match length: a matched prefix is prefill the engine
  skips, so a warm-prefix request is predicted (and admitted) cheaper
  than a cold one of the same length.

Requests carry optional deadline hints (``deadline_ms`` /
``ttft_budget_ms`` body fields; ``x-dllama-deadline-ms``, a relay
header). The scheduler turns the forecast into three control actions:

* **infeasible-reject**: a hinted request whose predicted TTFT cannot
  meet its budget even if admitted now is refused up front with a
  retryable error whose ``Retry-After`` is the predicted queue-drain
  time (monotonic in queue depth), not a constant. Unhinted requests are
  NEVER infeasible-rejected: with no hints the controller is exactly the
  queue-depth ladder.
* **EDF lane picking**: the pending queue is ordered by earliest
  effective deadline (:func:`effective_deadline_ms`). The priority
  ladder becomes deadline *offsets* (high before normal before low, FIFO
  within a class), so the order is unchanged when no hints are given.
* **deadline preemption**: an over-budget or deadline-blown
  lower-priority stream is parked through the scheduler's park/resume
  path when that flips a feasible hinted request from "reject" to "meet
  SLO". Parking never alters tokens, so preempted streams resume
  byte-identical.

Prediction error (estimated vs observed TTFT/TPOT) is a first-class
metric; an EWMA multiplicative correction folds the observed ratio back
into the predictor so it calibrates itself on the card. Prediction only
gates and orders work (it never touches ``decode_lanes`` inputs), so
greedy output under predictive admission is byte-identical to
predictive-off runs by construction.

The numbers (the cold floors, ``MIN_STEP_SAMPLES``, ``alpha``, the
clamp, the offsets) and the environment names are the JAX module's, so
both predictors compute the same thing from the same inputs. One input
differs on the card: the JAX predictor reads the step histogram, whose
prefill seconds there are a dispatch's enqueue (a lane prefill chunk
reads nothing back), so the port reads the engine's device seconds.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Callable

# step-histogram kinds the predictor reads (the engine's _m_step labels)
PREFILL_KIND = "prefill_lane_chunk"
DECODE_KIND = "decode_lanes"

# priority -> effective-deadline offset multiplier (offset = mult * step)
PRIORITY_OFFSET_MULT = {"high": -1.0, "normal": 0.0, "low": 1.0}

# EWMA correction clamp: a single wild observation (a capture, a GC
# pause) must not swing the predictor by more than this factor per side
_CORR_MIN, _CORR_MAX = 0.1, 10.0


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    return int(v) if v else default


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name, "").strip().lower()
    if not v:
        return default
    return v not in ("0", "off", "false", "no")


def resolve_admission_knobs(
    predict: bool | None = None,
    max_wait_ms: int | None = None,
) -> tuple[bool, int]:
    """Predictive-admission knobs: explicit (CLI flag) beats the
    environment beats the default.

    * ``DLLAMA_ADMISSION_PREDICT`` turns the predictive controller on
      (infeasible-reject, EDF ordering, deadline preemption); default
      off: the queue-depth ladder alone.
    * ``DLLAMA_ADMISSION_MAX_WAIT_MS`` caps the predicted queue wait a
      ``Retry-After`` may quote (default 30000), so one absurd forecast
      cannot quote an hour.
    """
    if predict is None:
        predict = _env_bool("DLLAMA_ADMISSION_PREDICT")
    if max_wait_ms is None:
        max_wait_ms = _env_int("DLLAMA_ADMISSION_MAX_WAIT_MS", 30_000)
    return bool(predict), int(max_wait_ms)


def resolve_deadline_knobs(
    default_ms: int | None = None,
    priority_step_ms: int | None = None,
) -> tuple[int, int]:
    """Deadline-synthesis knobs for requests with no hints.

    * ``DLLAMA_DEADLINE_DEFAULT_MS``: the synthetic deadline horizon of an
      unhinted request (default 600000 = 10 min: in effect no deadline for
      feasibility, but it anchors the EDF order).
    * ``DLLAMA_DEADLINE_PRIORITY_STEP_MS``: the offset between priority
      rungs (default 60000): ``high`` runs one step earlier than
      ``normal``, ``low`` one step later, so strict priority order holds
      for any queue that drains inside a step while a long-starved ``low``
      request still ages into service.
    """
    if default_ms is None:
        default_ms = _env_int("DLLAMA_DEADLINE_DEFAULT_MS", 600_000)
    if priority_step_ms is None:
        priority_step_ms = _env_int("DLLAMA_DEADLINE_PRIORITY_STEP_MS", 60_000)
    return int(default_ms), int(priority_step_ms)


def effective_deadline_ms(
    arrival_ms: float,
    priority: str = "normal",
    deadline_ms: float | None = None,
    ttft_budget_ms: float | None = None,
    default_ms: int = 600_000,
    priority_step_ms: int = 60_000,
) -> float:
    """The EDF sort key of one request, in the caller's clock domain.

    A hinted request's effective deadline is its arrival plus the tighter
    of its hints. An unhinted request gets the synthetic deadline
    ``arrival + default + offset(priority)``: the priority ladder as
    deadline offsets, so with no hints the EDF order is (priority class,
    arrival).
    """
    hint = None
    for h in (deadline_ms, ttft_budget_ms):
        if h is not None and (hint is None or h < hint):
            hint = h
    if hint is not None:
        return arrival_ms + float(hint)
    mult = PRIORITY_OFFSET_MULT.get(priority, 0.0)
    return arrival_ms + float(default_ms) + mult * float(priority_step_ms)


class OccupancySnapshot:
    """One consistent view of the scheduler's load, taken under its
    condition variable (``LaneScheduler.occupancy``): the static shape
    (lane count, block and chunk sizes) and the dynamic load."""

    __slots__ = (
        "lanes_total", "active_lanes", "parked", "admitting",
        "admitting_chunks", "queue_depth", "block_size", "admission_chunk",
    )

    def __init__(
        self,
        lanes_total: int,
        active_lanes: int,
        parked: int = 0,
        admitting: int = 0,
        admitting_chunks: int = 0,
        queue_depth: int = 0,
        block_size: int = 16,
        admission_chunk: int = 128,
    ) -> None:
        self.lanes_total = lanes_total
        self.active_lanes = active_lanes
        self.parked = parked
        self.admitting = admitting
        self.admitting_chunks = admitting_chunks
        self.queue_depth = queue_depth
        self.block_size = block_size
        self.admission_chunk = admission_chunk

    @property
    def free_lanes(self) -> int:
        return max(0, self.lanes_total - self.active_lanes - self.admitting)

    @property
    def oversubscription(self) -> float:
        """Streams a lane (>= 1.0): parked streams time-share lanes
        through the park/resume rotation, stretching every stream's
        effective TPOT by about this factor."""
        if self.lanes_total <= 0:
            return 1.0
        streams = self.active_lanes + self.admitting + self.parked
        return max(1.0, streams / self.lanes_total)

    def as_dict(self) -> dict:
        return {
            "lanes_total": self.lanes_total,
            "active_lanes": self.active_lanes,
            "free_lanes": self.free_lanes,
            "parked": self.parked,
            "admitting": self.admitting,
            "admitting_chunks": self.admitting_chunks,
            "queue_depth": self.queue_depth,
            "oversubscription": round(self.oversubscription, 3),
        }


class Prediction:
    """One forecast: predicted TTFT and steady-state TPOT of a candidate,
    and the queue-drain estimate behind its ``Retry-After``."""

    __slots__ = ("ttft_ms", "tpot_ms", "queue_wait_ms", "prefill_chunks")

    def __init__(
        self,
        ttft_ms: float,
        tpot_ms: float,
        queue_wait_ms: float,
        prefill_chunks: int,
    ) -> None:
        self.ttft_ms = ttft_ms
        self.tpot_ms = tpot_ms
        self.queue_wait_ms = queue_wait_ms
        self.prefill_chunks = prefill_chunks

    def as_dict(self) -> dict:
        return {
            "ttft_ms": round(self.ttft_ms, 3),
            "tpot_ms": round(self.tpot_ms, 3),
            "queue_wait_ms": round(self.queue_wait_ms, 3),
            "prefill_chunks": self.prefill_chunks,
        }


class LoadPredictor:
    """TTFT/TPOT forecaster over the engine's own measurements.

    A dispatch's cost is measured once ``MIN_STEP_SAMPLES`` dispatches of
    its kind exist, capture dispatches left out: on the card the mean
    device seconds of its dispatches (``engine.device_step_seconds``, from
    CUDA events: a lane prefill chunk returns at its enqueue, so its host
    seconds are not its cost), elsewhere the ``dllama_engine_step_seconds``
    median of its kind; before that, the analytic bytes of the kind's
    representative graph key over the card's HBM peak
    (:func:`~dllama_tpu_torch.obs.cost.analytic_step_seconds`; None on the
    CPU, where the peak is unknown); last, conservative floor constants,
    so the predictor always returns a finite forecast. An EWMA correction
    (observed/predicted ratio a signal) calibrates the model against what
    the serving path delivers.

    ``decode_s`` is one ``decode_lanes`` dispatch, a block of up to
    ``block_size`` steps, and the TPOT forecast takes it as one token's
    time, as the JAX predictor does; the TPOT correction absorbs the
    factor.

    Thread-safety: predictions run on HTTP handler threads while
    observations land from the scheduler thread; the correction state
    takes one short lock.
    """

    # floors used before any measurement or cost model exists; generous
    # on purpose: an optimistic cold predictor would admit infeasible
    # work, a pessimistic one merely queues the first request
    COLD_PREFILL_CHUNK_S = 0.050
    COLD_DECODE_STEP_S = 0.020
    MIN_STEP_SAMPLES = 5

    def __init__(
        self,
        engine: object,
        clock: Callable[[], float] = time.monotonic,
        alpha: float = 0.2,
    ) -> None:
        self.engine = engine
        self._clock = clock
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        # multiplicative EWMA corrections, observed/predicted
        self._ttft_corr = 1.0
        self._tpot_corr = 1.0
        self._n_obs = 0
        # analytic step seconds by kind, kept once known. The JAX engine
        # knows its programs' costs from the rehearsal's compiles and
        # resolves this once; the port's costs exist only after a
        # dispatch of the kind has settled, so an unknown kind is asked
        # again (the measured medians take over after MIN_STEP_SAMPLES)
        self._analytic: dict[str, float] = {}

    # -- step costs --------------------------------------------------------

    def _measured_step_s(self, kind: str) -> float | None:
        device = getattr(self.engine, "device_step_seconds", None)
        timed = device(kind) if device is not None else None
        if timed is not None:
            n, mean_s = timed
            return mean_s if n >= self.MIN_STEP_SAMPLES else None
        hist = getattr(self.engine, "_m_step", None)
        if hist is None:
            return None
        try:
            child = hist.labels(kind=kind)
        except Exception:  # dlint: disable=silent-except — best-effort cost probe; the predictor's cold floor is the documented fallback
            return None
        if getattr(child, "count", 0) < self.MIN_STEP_SAMPLES:
            return None
        return child.percentile(0.5)

    def _analytic_step_s(self, kind: str) -> float | None:
        if kind in self._analytic:
            return self._analytic[kind]
        est = None
        try:
            from ..obs.cost import analytic_step_seconds, hbm_peak_bytes_per_s

            peak = hbm_peak_bytes_per_s()
            report = self.engine.cost_report()
            info = report.get("kinds", {}).get(kind)
            if info is not None:
                est = analytic_step_seconds(info.get("bytes_accessed"), peak)
        except Exception:  # dlint: disable=silent-except — cost model is advisory; a failed walk degrades to the cold floor, never blocks admission
            est = None
        if est is not None:
            self._analytic[kind] = est
        return est

    def step_seconds(self, kind: str, cold_default: float) -> float:
        """Best available estimate of one dispatch of ``kind``: the
        measured seconds, else the analytic bound, else the cold floor."""
        s = self._measured_step_s(kind)
        if s is not None and s > 0:
            return s
        s = self._analytic_step_s(kind)
        if s is not None and s > 0:
            return s
        return cold_default

    # -- forecasting -------------------------------------------------------

    def predict(
        self,
        n_prompt_tokens: int,
        occ: OccupancySnapshot,
        matched_tokens: int = 0,
    ) -> Prediction:
        """Forecast TTFT and steady-state TPOT of a candidate with
        ``n_prompt_tokens`` of prompt, of which ``matched_tokens`` are
        already in the radix tree (prefill the engine skips)."""
        chunk = max(1, occ.admission_chunk)
        prefill_s = self.step_seconds(PREFILL_KIND, self.COLD_PREFILL_CHUNK_S)
        decode_s = self.step_seconds(DECODE_KIND, self.COLD_DECODE_STEP_S)
        todo = max(0, int(n_prompt_tokens) - int(matched_tokens))
        # at least one chunk always runs: admission replays the last
        # matched token to produce the first logits
        n_chunks = max(1, math.ceil(todo / chunk))
        queue_wait_s = self.queue_drain_seconds(occ)
        # the admission loop interleaves one prefill chunk a tick with the
        # active lanes' decode block, so each chunk's wall time is the
        # chunk plus one decode dispatch when lanes are busy
        interleave_s = decode_s if occ.active_lanes > 0 else 0.0
        ttft_s = queue_wait_s + n_chunks * (prefill_s + interleave_s)
        # steady state: one decode dispatch a token, stretched by the
        # park/resume rotation when streams oversubscribe lanes
        tpot_s = decode_s * occ.oversubscription
        with self._lock:
            ttft_corr, tpot_corr = self._ttft_corr, self._tpot_corr
        return Prediction(
            ttft_ms=ttft_s * 1000.0 * ttft_corr,
            tpot_ms=tpot_s * 1000.0 * tpot_corr,
            queue_wait_ms=queue_wait_s * 1000.0 * ttft_corr,
            prefill_chunks=n_chunks,
        )

    def queue_drain_seconds(self, occ: OccupancySnapshot) -> float:
        """Predicted time until the CURRENT backlog is admitted: what a
        shed response quotes as ``Retry-After``. Monotonic in queue depth
        by construction: every queued request adds its expected admission
        cost on top of the in-flight chunk backlog."""
        chunk_s = self.step_seconds(PREFILL_KIND, self.COLD_PREFILL_CHUNK_S)
        decode_s = self.step_seconds(DECODE_KIND, self.COLD_DECODE_STEP_S)
        # chunks still owed by streams mid-admission
        backlog_s = occ.admitting_chunks * chunk_s
        # each queued request: one admission-chunk prefill, plus a share
        # of a lane becoming free when none is (half a block of decode a
        # wave of lane turnover: a coarse but monotonic stand-in for the
        # remaining stream length, which the server cannot know)
        per_req_s = chunk_s
        if occ.free_lanes <= 0:
            per_req_s += max(1, occ.block_size) * decode_s * 0.5
        with self._lock:
            corr = self._ttft_corr
        return (backlog_s + occ.queue_depth * per_req_s) * corr

    def retry_after_s(self, occ: OccupancySnapshot, max_wait_ms: int = 30_000) -> int:
        """``Retry-After`` seconds from the predicted drain: at least 1
        (HTTP Retry-After is whole seconds, and "now" is what the client
        just tried), at most the max-wait knob."""
        drain_s = self.queue_drain_seconds(occ)
        cap_s = max(1.0, max_wait_ms / 1000.0)
        return int(min(cap_s, max(1.0, math.ceil(drain_s))))

    # -- feasibility -------------------------------------------------------

    def infeasible(
        self,
        pred: Prediction,
        ttft_budget_ms: float | None = None,
        deadline_ms: float | None = None,
        slack_factor: float = 1.0,
    ) -> bool:
        """Whether a hinted candidate cannot meet its budget even if
        admitted against the current occupancy. Callers apply it only to
        requests that carry hints."""
        budget = None
        for h in (ttft_budget_ms, deadline_ms):
            if h is not None and (budget is None or h < budget):
                budget = h
        if budget is None:
            return False
        return pred.ttft_ms > budget * slack_factor

    # -- self-calibration --------------------------------------------------

    def observe_ttft(self, predicted_ms: float, observed_ms: float) -> None:
        """Fold one (predicted, observed) TTFT pair into the EWMA
        correction. The ratio is clamped so one stall cannot poison the
        model."""
        if predicted_ms <= 0 or observed_ms <= 0:
            return
        ratio = min(_CORR_MAX, max(_CORR_MIN, observed_ms / predicted_ms))
        with self._lock:
            self._ttft_corr += self.alpha * (ratio * self._ttft_corr - self._ttft_corr)
            self._ttft_corr = min(_CORR_MAX, max(_CORR_MIN, self._ttft_corr))
            self._n_obs += 1

    def observe_tpot(self, predicted_ms: float, observed_ms: float) -> None:
        if predicted_ms <= 0 or observed_ms <= 0:
            return
        ratio = min(_CORR_MAX, max(_CORR_MIN, observed_ms / predicted_ms))
        with self._lock:
            self._tpot_corr += self.alpha * (ratio * self._tpot_corr - self._tpot_corr)
            self._tpot_corr = min(_CORR_MAX, max(_CORR_MIN, self._tpot_corr))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ttft_correction": round(self._ttft_corr, 4),
                "tpot_correction": round(self._tpot_corr, 4),
                "n_observations": self._n_obs,
                "prefill_chunk_s": round(
                    self.step_seconds(PREFILL_KIND, self.COLD_PREFILL_CHUNK_S), 6),
                "decode_step_s": round(
                    self.step_seconds(DECODE_KIND, self.COLD_DECODE_STEP_S), 6),
            }
