"""Predictive admission, EDF and deadline preemption in the port's lane
server, on the CPU, against the JAX package.

* The load predictor: the port's ``runtime/admission.py`` and the JAX
  module driven by one fake engine (step-histogram children with
  ``count``/``percentile``, a ``cost_report``) and one occupancy give the
  same forecasts, queue drains, ``Retry-After``s, infeasibility verdicts,
  snapshots and EWMA corrections (1e-12); ``effective_deadline_ms`` and
  the two knob resolvers agree over grids and environments.
* The lane server, each case the same script on the port's and the JAX
  lane server (tiny f32 Q40 model, 2 lanes): EDF order, the ``infeasible``
  refusal before the queue, a ``Retry-After`` monotonic in queue depth,
  greedy bytes with predictive mode on, off and hinted (and equal across
  the two servers), the forecast scored at a clean finish,
  ``/v1/debug/admission``'s keys, the ``x-dllama-deadline-ms`` refusal, a
  forced preemption whose victim resumes byte for byte (speculation off
  and shared on the port), and the admission families in ``/metrics``.
* The profile: the scheduler decodes across a ``POST /v1/debug/profile``,
  whose start and stop are pauses declared to the watchdog.
"""

import itertools
import json
import math
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dllama_tpu.obs.cost as j_cost
import dllama_tpu.runtime.admission as jadm
import dllama_tpu.runtime.api_server as japi
import dllama_tpu_torch.obs.cost as p_cost
import dllama_tpu_torch.runtime.admission as padm
import dllama_tpu_torch.runtime.api_server as api
from dllama_tpu.formats import FloatType
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu.tokenizer import Tokenizer as JTokenizer
from dllama_tpu_torch.obs.metrics import MetricsRegistry
from dllama_tpu_torch.obs.recorder import FlightRecorder
from dllama_tpu_torch.obs.watchdog import EngineWatchdog
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.tokenizer import Tokenizer

from helpers import make_tiny_model, make_tiny_tokenizer

CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=384)
LIMIT = 120  # seconds any one request, join or event wait may take
TOL = 1e-12
KINDS = (padm.PREFILL_KIND, padm.DECODE_KIND)
ADMISSION_FAMILIES = ("dllama_admission_predicted_ttft_ms", "dllama_admission_predict_error_ms",
                      "dllama_admission_rejected_total", "dllama_preemptions_total")


def _close(a, b):
    return math.isclose(a, b, rel_tol=TOL, abs_tol=TOL)


# -- the load predictor against the JAX one ------------------------------------


class _Child:
    def __init__(self, count, p50):
        self.count, self._p50 = count, p50

    def percentile(self, q):
        return self._p50 * (0.5 + q)


class _Hist:
    def __init__(self, children):
        self.children = children

    def labels(self, kind):
        return self.children.get(kind, _Child(0, 0.0))


class _Engine:
    """The predictor's view of an engine: ``_m_step`` and ``cost_report``."""

    def __init__(self, counts, p50s, nbytes):
        self._m_step = _Hist({k: _Child(c, p) for k, c, p in zip(KINDS, counts, p50s)})
        self.report = {"kinds": {k: {"bytes_accessed": b} for k, b in zip(KINDS, nbytes) if b}}

    def cost_report(self):
        return self.report


ENGINES = {
    "measured": ((9, 40), (0.041, 0.0093), (7.5e9, 6.4e10)),
    "cold": ((0, 4), (0.03, 0.01), (0, 0)),
    "analytic": ((4, 0), (0.03, 0.01), (7.5e9, 6.4e10)),
    "mixed": ((5, 2), (0.0371, 0.011), (0, 6.4e10)),
}
OCCUPANCIES = [
    dict(lanes_total=4, active_lanes=0),
    dict(lanes_total=4, active_lanes=4, queue_depth=3, block_size=8, admission_chunk=512),
    dict(lanes_total=4, active_lanes=2, admitting=2, admitting_chunks=5, queue_depth=17,
         block_size=8, admission_chunk=128),
    dict(lanes_total=2, active_lanes=2, parked=3, queue_depth=250, block_size=4,
         admission_chunk=6),
    dict(lanes_total=0, active_lanes=0, queue_depth=1),
]


def _pair(name, peak, monkeypatch):
    monkeypatch.setattr(j_cost, "hbm_peak_bytes_per_s", lambda *a: peak)
    monkeypatch.setattr(p_cost, "hbm_peak_bytes_per_s", lambda *a: peak)
    counts, p50s, nbytes = ENGINES[name]
    return (jadm.LoadPredictor(_Engine(counts, p50s, nbytes)),
            padm.LoadPredictor(_Engine(counts, p50s, nbytes)))


@pytest.mark.parametrize("peak", [None, 3.35e12])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_predictor_forecasts_match_jax(engine, peak, monkeypatch):
    jp, pp = _pair(engine, peak, monkeypatch)
    for kw in OCCUPANCIES:
        jo, po = jadm.OccupancySnapshot(**kw), padm.OccupancySnapshot(**kw)
        assert po.as_dict() == jo.as_dict()
        assert (po.free_lanes, po.oversubscription) == (jo.free_lanes, jo.oversubscription)
        assert _close(pp.queue_drain_seconds(po), jp.queue_drain_seconds(jo))
        for wait in (30_000, 2_000, 500):
            assert pp.retry_after_s(po, wait) == jp.retry_after_s(jo, wait)
        for n_prompt, matched in itertools.product((1, 6, 100, 1000), (0, 64)):
            a, b = jp.predict(n_prompt, jo, matched), pp.predict(n_prompt, po, matched)
            assert b.prefill_chunks == a.prefill_chunks
            for f in ("ttft_ms", "tpot_ms", "queue_wait_ms"):
                assert _close(getattr(b, f), getattr(a, f)), (f, kw, n_prompt, matched)
            assert b.as_dict() == a.as_dict()
            for budget in (None, 0.001, a.ttft_ms, a.ttft_ms * 2):
                for kwb in (dict(ttft_budget_ms=budget), dict(deadline_ms=budget),
                            dict(ttft_budget_ms=budget, deadline_ms=1e9, slack_factor=1.5)):
                    assert pp.infeasible(b, **kwb) == jp.infeasible(a, **kwb)
    assert pp.snapshot() == jp.snapshot()
    for kind, cold in zip(KINDS, (0.05, 0.02)):
        assert _close(pp.step_seconds(kind, cold), jp.step_seconds(kind, cold))


@pytest.mark.parametrize("signal", ["ttft", "tpot"])
def test_predictor_ewma_matches_jax_and_converges(signal, monkeypatch):
    """The same observations give the same corrections after every step;
    fed its own corrected forecasts, each converges on the true ratio; a
    wild observation moves it by the clamp at most."""
    jp, pp = _pair("measured", None, monkeypatch)
    # no queue ahead: the JAX forecast applies the TTFT correction to the
    # queue wait twice (inside the drain and again on the sum), so only a
    # forecast without one converges on the true ratio itself
    occ = dict(lanes_total=4, active_lanes=2, queue_depth=0, block_size=8, admission_chunk=128)
    jo, po = jadm.OccupancySnapshot(**occ), padm.OccupancySnapshot(**occ)
    rng = np.random.default_rng(7)
    truth = 2.5 * getattr(pp.predict(300, po), f"{signal}_ms")
    for i in range(120):
        a = getattr(jp.predict(300, jo), f"{signal}_ms")
        b = getattr(pp.predict(300, po), f"{signal}_ms")
        assert _close(a, b)
        observed = truth * (1.0 + 0.01 * rng.standard_normal()) if i < 100 else truth
        getattr(jp, f"observe_{signal}")(a, observed)
        getattr(pp, f"observe_{signal}")(b, observed)
        assert pp.snapshot() == jp.snapshot()
    assert abs(pp.snapshot()[f"{signal}_correction"] - 2.5) < 1e-3
    before = pp.snapshot()[f"{signal}_correction"]
    getattr(pp, f"observe_{signal}")(1.0, 1e9)
    getattr(jp, f"observe_{signal}")(1.0, 1e9)
    assert pp.snapshot() == jp.snapshot()
    # snapshots round to 4 decimals
    assert pp.snapshot()[f"{signal}_correction"] <= before * (1 + pp.alpha * 9) + 1e-3
    getattr(pp, f"observe_{signal}")(0.0, 5.0)  # a non-positive pair is ignored
    assert pp.snapshot()[f"{signal}_correction"] == jp.snapshot()[f"{signal}_correction"]


class _TimedEngine(_Engine):
    """An engine on the card: its dispatches' device seconds by kind."""

    def __init__(self, timed, *args):
        super().__init__(*args)
        self.timed = timed

    def device_step_seconds(self, kind):
        return self.timed.get(kind)


@pytest.mark.parametrize("timed,want", [
    # enough timed dispatches: their device mean, not the host histogram's
    ({padm.PREFILL_KIND: (5, 0.0399), padm.DECODE_KIND: (40, 0.0797)}, (0.0399, 0.0797)),
    # too few: the analytic bound (the histogram is not read on the card)
    ({padm.PREFILL_KIND: (4, 0.0399), padm.DECODE_KIND: (40, 0.0797)}, (7.5e9 / 3.35e12, 0.0797)),
    # none timed (the registry off): the host histogram, as in the JAX predictor
    ({}, (0.041, 0.0093)),
])
def test_predictor_reads_device_seconds_on_the_card(timed, want, monkeypatch):
    """On the card the step costs are the engine's device seconds (a lane
    prefill chunk's host seconds are its enqueue); the rest of the forecast
    is the JAX arithmetic on them."""
    monkeypatch.setattr(p_cost, "hbm_peak_bytes_per_s", lambda *a: 3.35e12)
    counts, p50s, nbytes = ENGINES["measured"]
    pp = padm.LoadPredictor(_TimedEngine(timed, counts, p50s, nbytes))
    got = tuple(pp.step_seconds(k, c) for k, c in zip(KINDS, (0.05, 0.02)))
    assert all(_close(a, b) for a, b in zip(got, want)), (got, want)
    snap = pp.snapshot()
    assert (snap["prefill_chunk_s"], snap["decode_step_s"]) == tuple(round(x, 6) for x in want)
    # the JAX predictor over histogram children holding the same seconds
    monkeypatch.setattr(j_cost, "hbm_peak_bytes_per_s", lambda *a: 3.35e12)
    jp = jadm.LoadPredictor(_Engine((9, 40), want, (0, 0)))
    occ = OCCUPANCIES[2]
    jo, po = jadm.OccupancySnapshot(**occ), padm.OccupancySnapshot(**occ)
    assert _close(pp.queue_drain_seconds(po), jp.queue_drain_seconds(jo))
    assert _close(pp.predict(1000, po).ttft_ms, jp.predict(1000, jo).ttft_ms)


def test_engine_device_seconds_none_on_the_cpu(files):
    engine = _port_engine(files)
    assert engine.device_step_seconds(padm.PREFILL_KIND) is None
    assert engine.device_step_seconds(padm.DECODE_KIND) is None


def test_effective_deadline_matches_jax():
    for args in itertools.product((0.0, 1234.5), ("high", "normal", "low", "other"),
                                  (None, 50.0, 5000.0), (None, 20.0, 9000.0),
                                  (600_000, 1000), (60_000, 7)):
        arrival, priority, deadline, ttft, default, step = args
        kw = dict(priority=priority, deadline_ms=deadline, ttft_budget_ms=ttft,
                  default_ms=default, priority_step_ms=step)
        assert padm.effective_deadline_ms(arrival, **kw) == jadm.effective_deadline_ms(
            arrival, **kw), args
    assert padm.PRIORITY_OFFSET_MULT == jadm.PRIORITY_OFFSET_MULT
    assert (padm.PREFILL_KIND, padm.DECODE_KIND) == (jadm.PREFILL_KIND, jadm.DECODE_KIND)
    for name in ("COLD_PREFILL_CHUNK_S", "COLD_DECODE_STEP_S", "MIN_STEP_SAMPLES"):
        assert getattr(padm.LoadPredictor, name) == getattr(jadm.LoadPredictor, name)


@pytest.mark.parametrize("predict_env", ["", "1", "0", "off", "true", "no", "yes"])
@pytest.mark.parametrize("wait_env", ["", "1234"])
def test_admission_knobs_match_jax(predict_env, wait_env, monkeypatch):
    monkeypatch.setenv("DLLAMA_ADMISSION_PREDICT", predict_env)
    monkeypatch.setenv("DLLAMA_ADMISSION_MAX_WAIT_MS", wait_env)
    for args in ((), (True, None), (False, 77), (None, 5)):
        assert padm.resolve_admission_knobs(*args) == jadm.resolve_admission_knobs(*args)


@pytest.mark.parametrize("env", [("", ""), ("1000", ""), ("", "5"), ("42", "24")])
def test_deadline_knobs_match_jax(env, monkeypatch):
    monkeypatch.setenv("DLLAMA_DEADLINE_DEFAULT_MS", env[0])
    monkeypatch.setenv("DLLAMA_DEADLINE_PRIORITY_STEP_MS", env[1])
    for args in ((), (9, None), (None, 3), (1, 2)):
        assert padm.resolve_deadline_knobs(*args) == jadm.resolve_deadline_knobs(*args)


def test_admission_flags_parse():
    """The server's parser takes the four flags into ``serve``'s names."""
    args = api.build_parser().parse_args([
        "--model", "m", "--tokenizer", "t", "--admission-predict",
        "--admission-max-wait-ms", "1500", "--deadline-default-ms", "9000",
        "--deadline-priority-step-ms", "300"])
    assert (args.admission_predict, args.admission_max_wait_ms, args.deadline_default_ms,
            args.deadline_priority_step_ms) == (True, 1500, 9000, 300)
    args = api.build_parser().parse_args(["--model", "m", "--tokenizer", "t"])
    assert (args.admission_predict, args.admission_max_wait_ms, args.deadline_default_ms,
            args.deadline_priority_step_ms) == (None, None, None, None)


# -- the lane server, the port's against the JAX one ---------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_admission")
    mp, tp_ = str(d / "m.m"), str(d / "t.t")
    make_tiny_model(mp, weight_type=FloatType.Q40, cfg=CFG)
    make_tiny_tokenizer(tp_, chat_template="<|start_header_id|>")
    return mp, tp_


def _port_engine(files):
    return InferenceEngine(files[0], dtype=torch.float32, temperature=0.0, seed=3, device="cpu",
                           batch_size=2)


def _jax_engine(files):
    tok = JTokenizer(files[1])
    return JEngine(files[0], tokenizer=tok, tp=1, dtype=jnp.float32, temperature=0.0, seed=3,
                   batch_size=2), tok


def _close_state(state):
    state.scheduler.stop()
    for name in ("watchdog", "sampler"):
        obj = getattr(state, name, None)
        if obj is not None:
            obj.stop()


@pytest.fixture(scope="module")
def states(files):
    """side -> (module, a predictive-mode ApiState driven directly)."""
    jeng, jtok = _jax_engine(files)
    out = {
        "jax": (japi, japi.ApiState(jeng, jtok, lane_block_size=4, admission_chunk=6,
                                    admission_predict=True)),
        "port": (api, api.ApiState(_port_engine(files), Tokenizer(files[1]), lane_block_size=4,
                                   admission_chunk=6, admission_predict=True, kv_native=True)),
    }
    yield out
    for _, state in out.values():
        _close_state(state)


def _params(mod, content, max_tokens=3, **kw):
    return mod.InferenceParams(messages=[mod.ChatMessage("user", content)],
                               max_tokens=max_tokens, temperature=0.0, **kw)


def _drain(job):
    deltas = []
    while True:
        kind, payload = job.events.get(timeout=LIMIT)
        if kind == "delta":
            deltas.append(payload)
        elif kind == "done":
            return "".join(deltas), payload
        else:
            raise AssertionError(f"job errored: {payload}")


def _wait_lanes(state, n):
    sched = state.scheduler
    deadline = time.time() + LIMIT
    while time.time() < deadline:
        with sched.cv:
            if sum(1 for ls in sched.lanes if ls is not None) >= n:
                return
        time.sleep(0.01)
    raise AssertionError(f"{n} lanes never became active")


SIDES = ["jax", "port"]


@pytest.mark.parametrize("side", SIDES)
def test_edf_order(states, side):
    """Three requests queued behind two busy lanes admit in EDF order,
    tightest deadline first and the unhinted high one last, whatever the
    submit order."""
    mod, state = states[side]
    sched, rec = state.scheduler, state.recorder
    blockers = [sched.submit(_params(mod, f"edf blocker {i}", max_tokens=220)) for i in range(2)]
    _wait_lanes(state, 2)
    base = rec.total_recorded
    late = sched.submit(_params(mod, "e " * 30, priority="high"))
    mid = sched.submit(_params(mod, "dd " * 18, deadline_ms=150_000.0))
    tight = sched.submit(_params(mod, "c " * 6, deadline_ms=50_000.0))
    assert tight.edf_deadline_ms < mid.edf_deadline_ms < late.edf_deadline_ms
    for b in blockers:
        b.cancelled = True
        _drain(b)
    for job in (tight, mid, late):
        _drain(job)
    names = {tight.n_prompt_tokens: "tight", mid.n_prompt_tokens: "mid",
             late.n_prompt_tokens: "late"}
    assert len(names) == 3
    order = [names[ev["n_prompt"]] for ev in rec.events()
             if ev["seq"] > base and ev["kind"] == "admit" and ev["n_prompt"] in names]
    assert order == ["tight", "mid", "late"], order


@pytest.mark.parametrize("side", SIDES)
def test_infeasible_refused_before_the_queue(states, side):
    mod, state = states[side]
    sched = state.scheduler
    before = dict(state.m_admission_rejected.child_values())
    depth = len(sched.pending)
    reason, retry_after = state.admission_decision(
        "normal", _params(mod, "budget doom", ttft_budget_ms=0.0001))
    assert reason == "infeasible" and isinstance(retry_after, int) and retry_after >= 1
    after = state.m_admission_rejected.child_values()
    assert after[("infeasible",)] == before.get(("infeasible",), 0) + 1
    assert len(sched.pending) == depth
    # unhinted requests are never infeasible; predictive off is the ladder
    assert state.admission_decision("normal", _params(mod, "no hints")) is None
    state.admission_predict = False
    try:
        assert state.admission_decision(
            "normal", _params(mod, "budget doom", ttft_budget_ms=0.0001)) is None
    finally:
        state.admission_predict = True


@pytest.mark.parametrize("side", SIDES)
def test_retry_after_monotonic_in_queue_depth(states, side):
    """Sentinels parked in the idle scheduler's queue (no notify) never
    lower the quoted Retry-After, which stays within the max-wait cap."""
    _, state = states[side]
    sched = state.scheduler
    ras, sentinels = [], []
    try:
        for extra in (0, 3, 200, 2000):
            with sched.cv:
                while len(sentinels) < extra:
                    sentinels.append(object())
                    sched.pending.append(sentinels[-1])
            ras.append(state.predicted_retry_after())
    finally:
        with sched.cv:
            for s in sentinels:
                sched.pending.remove(s)
    assert all(r >= 1 for r in ras) and ras == sorted(ras), ras
    assert ras[-1] <= max(1, state.admission_max_wait_ms // 1000)
    assert ras[-1] > ras[0]


@pytest.fixture(scope="module")
def greedy_texts(states):
    """side -> the same greedy request with predictive mode on, off and
    with a deadline hint."""
    out = {}
    for side in SIDES:
        mod, state = states[side]
        sched = state.scheduler
        on = _drain(sched.submit(_params(mod, "determinism probe", max_tokens=16)))
        state.admission_predict = False
        try:
            off = _drain(sched.submit(_params(mod, "determinism probe", max_tokens=16)))
        finally:
            state.admission_predict = True
        hinted = _drain(sched.submit(_params(mod, "determinism probe", max_tokens=16,
                                             deadline_ms=90_000.0)))
        out[side] = (on, off, hinted)
    return out


@pytest.mark.parametrize("side", SIDES)
def test_greedy_bytes_equal_predictive_on_and_off(greedy_texts, side):
    on, off, hinted = greedy_texts[side]
    assert on[1] in ("stop", "length")
    assert on == off == hinted
    assert greedy_texts[side] == greedy_texts["jax"]


@pytest.mark.parametrize("side", SIDES)
def test_prediction_error_is_tracked(states, side):
    mod, state = states[side]
    n0 = state.m_predict_error.labels(signal="ttft").count
    _drain(state.scheduler.submit(_params(mod, "score me", max_tokens=8)))
    stats = state.predict_error_stats()
    assert stats["n"] >= 1 and math.isfinite(stats["p50_ms"]) and math.isfinite(stats["p95_ms"])
    assert state.predictor.snapshot()["n_observations"] >= 1
    assert state.m_predict_error.labels(signal="ttft").count == n0 + 1
    assert state.m_predict_error.labels(signal="tpot").count >= 1


# -- over HTTP: the debug route, the header, a forced preemption ---------------

LOW_PROMPTS = ["tell me a long winding story about lane zero",
               "tell me a long winding story about lane one"]
HIGH_PROMPT = "urgent deadline question"


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _url(srv):
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _chat(srv, content, max_tokens=40, headers=None, **fields):
    payload = {"model": "m", "stream": False, "max_tokens": max_tokens, "temperature": 0,
               "messages": [{"role": "user", "content": content}], **fields}
    req = urllib.request.Request(_url(srv) + "/v1/chat/completions",
                                 data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=LIMIT) as r:
        data = json.loads(r.read())
    choice = data["choices"][0]
    assert choice["finish_reason"] in ("stop", "length")
    return choice["message"]["content"]


def _get(srv, path):
    with urllib.request.urlopen(_url(srv) + path, timeout=LIMIT) as r:
        return r.read()


def _preemption_script(srv):
    """The JAX test's seeded preemption: two low greedy streams hold both
    lanes past the park floor; a deterministic forecast calls the hinted
    high request infeasible while it waits and feasible on a freed lane,
    so the scheduler parks one low stream. Returns the solo answers, the
    contended answers and the registry and recorder deltas."""
    state = srv.state
    sched = state.scheduler
    solo_low = [_chat(srv, p, max_tokens=48) for p in LOW_PROMPTS]
    solo_high = _chat(srv, HIGH_PROMPT, max_tokens=8)
    resumes0 = state.m_stream_resumes.value
    pre0 = dict(state.m_preemptions.child_values())
    seq0 = state.recorder.total_recorded
    real_predict = state.predictor.predict

    def fake_predict(n_tok, occ, matched_tokens=0):
        busy = occ.active_lanes >= 2 and occ.queue_depth > 0
        return jadm.Prediction(ttft_ms=1e9 if busy else 1.0, tpot_ms=1.0, queue_wait_ms=0.0,
                               prefill_chunks=1)

    state.predictor.predict = fake_predict
    results = [None, None]
    try:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, _chat(srv, LOW_PROMPTS[i], max_tokens=48, priority="low"))) for i in range(2)]
        for t in threads:
            t.start()
        deadline = time.time() + LIMIT
        while time.time() < deadline:
            with sched.cv:
                active = [i for i, ls in enumerate(sched.lanes) if ls is not None]
                if len(active) == 2 and all(sched._progress[i] > sched.block_size
                                            for i in active):
                    break
            time.sleep(0.005)
        else:
            raise AssertionError("the low streams never filled both lanes")
        high = _chat(srv, HIGH_PROMPT, max_tokens=8, priority="high", deadline_ms=600_000.0)
        for t in threads:
            t.join(LIMIT)
    finally:
        state.predictor.predict = real_predict
    deadline = time.time() + LIMIT
    while time.time() < deadline and (any(sched.lanes) or sched.admitting or sched.pending):
        time.sleep(0.01)
    pre = {k[0]: v - pre0.get(k, 0) for k, v in state.m_preemptions.child_values().items()}
    kinds = [e["kind"] for e in state.recorder.events() if e["seq"] > seq0]
    return dict(solo_low=solo_low, solo_high=solo_high, low=results, high=high,
                preemptions={k: v for k, v in pre.items() if v},
                resumes=state.m_stream_resumes.value - resumes0, kinds=kinds,
                parked=sched._n_parked, pending=len(sched.pending))


def _admission_families(text):
    return {line.split()[2]: line.split()[3] for line in text.splitlines()
            if line.startswith("# TYPE ") and line.split()[2] in ADMISSION_FAMILIES}


@pytest.fixture(scope="module")
def jax_server(files):
    eng, tok = _jax_engine(files)
    srv = _start(japi.serve(eng, tok, host="127.0.0.1", port=0, lane_block_size=4,
                            kv_page_size=4, kv_native=True, max_streams=2,
                            admission_predict=True))
    # the JAX registry is process-wide: this server's parks and resumes must
    # not reach a later JAX test on the same worker that reads the resume
    # counter from zero (tests/test_kv_native.py)
    resumes = srv.state.m_stream_resumes
    before = resumes.value
    yield srv
    srv.shutdown()
    srv.server_close()
    resumes._default()._value = before


@pytest.fixture(scope="module", params=["off", "shared"])
def port_server(files, request):
    srv = _start(api.serve(_port_engine(files), Tokenizer(files[1]), host="127.0.0.1", port=0,
                           lane_block_size=4, kv_page_size=4, kv_native=True, max_streams=2,
                           admission_predict=True, speculation=request.param))
    yield srv
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def jax_preemption(jax_server):
    return _preemption_script(jax_server)


def _check_preemption(run):
    assert run["high"] == run["solo_high"]
    assert run["low"] == run["solo_low"], "the preempted stream parted after its resume"
    assert run["preemptions"].get("priority", 0) >= 1
    assert run["resumes"] >= 1
    assert {"stream_preempt", "stream_park", "stream_resume"} <= set(run["kinds"])
    assert run["parked"] == 0 and run["pending"] == 0


def test_preemption_resumes_its_victim_byte_identical(port_server, jax_preemption):
    """The port's preempted victim resumes byte for byte (speculation off
    and shared: the victim's drafter rides along), as the JAX server's
    does, and every answer equals the JAX server's."""
    _check_preemption(jax_preemption)
    run = _preemption_script(port_server)
    _check_preemption(run)
    for key in ("solo_low", "solo_high", "low", "high"):
        assert run[key] == jax_preemption[key], key
    port_server.state.kv_manager.check()


def test_debug_admission_keys_match_jax(port_server, jax_server):
    snaps = [json.loads(_get(s, "/v1/debug/admission")) for s in (jax_server, port_server)]
    assert set(snaps[1]) == set(snaps[0])
    for key in ("occupancy", "predictor", "prediction_error"):
        assert set(snaps[1][key]) == set(snaps[0][key]), key
    p = snaps[1]
    assert p["predictive"] is True and p["max_wait_ms"] >= 1 and p["retry_after_s"] >= 1
    assert p["occupancy"]["lanes_total"] == 2 and p["prediction_error"]["n"] >= 0


def test_deadline_header_refused_as_infeasible(port_server, jax_server):
    """A relayed ``x-dllama-deadline-ms`` budget that cannot be met is shed
    as infeasible (429, the predicted Retry-After) on both servers; a
    malformed header is ignored."""
    for srv in (jax_server, port_server):
        state = srv.state
        before = dict(state.m_admission_rejected.child_values())
        with pytest.raises(urllib.error.HTTPError) as exc:
            _chat(srv, "relayed doomed budget", headers={"x-dllama-deadline-ms": "0.0001"})
        e = exc.value
        err = json.loads(e.read())["error"]
        assert e.code == 429 and "infeasible" in err["message"] and err["retryable"] is True
        assert int(e.headers["Retry-After"]) >= 1
        after = state.m_admission_rejected.child_values()
        assert after[("infeasible",)] == before.get(("infeasible",), 0) + 1
        _chat(srv, "relayed junk", max_tokens=2, headers={"x-dllama-deadline-ms": "x"})
    for bad in ({"deadline_ms": 0}, {"ttft_budget_ms": -5}):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _chat(port_server, "bad budget", **bad)
        assert exc.value.code == 400


def test_admission_families_match_jax(port_server, jax_server):
    fams = [_admission_families(_get(s, "/metrics").decode()) for s in (jax_server, port_server)]
    assert fams[1] == fams[0] and set(fams[1]) == set(ADMISSION_FAMILIES)


# -- the profile: a declared pause ---------------------------------------------


def test_scheduler_keeps_decoding_across_a_profile(files, tmp_path, monkeypatch):
    """A stream decodes through a profile's window (its decode steps move
    between the request and the stop), its bytes those of an unprofiled
    run; the profiler's start and stop are pauses declared to the
    watchdog: a check made inside the stop with the watchdog's clock moved
    20 s on (past the 5 s decode-stall floor, inside the 30 s dispatch
    timeout) reports nothing, nor does one after it, and no stall is
    counted, where the same gap undeclared is a decode stall."""
    import torch.profiler as tp

    srv = _start(api.serve(_port_engine(files), Tokenizer(files[1]), host="127.0.0.1", port=0,
                           lane_block_size=4, kv_page_size=4, kv_native=True))
    state = srv.state
    # this server's own watchdog: a fake clock, its own registry and
    # recorder, checked by hand (no thread)
    clock = [1000.0]
    state.watchdog.stop()
    wd = state.watchdog = EngineWatchdog(clock=lambda: clock[0], registry=MetricsRegistry(),
                                         recorder=FlightRecorder())
    try:
        inside, steps = [], []
        real_stop = tp.profile.stop

        def slow_stop(prof):
            steps.append(state.engine.lane_decode_steps)
            clock[0] += 20.0
            inside.append(wd.check_once())
            real_stop(prof)

        monkeypatch.setattr(tp.profile, "stop", slow_stop)
        alone = _chat(srv, "a stream across a profile", max_tokens=280)
        got = {}

        def stream():
            got["text"] = _chat(srv, "a stream across a profile", max_tokens=280)

        t = threading.Thread(target=stream)
        t.start()
        _wait_lanes(state, 1)
        steps.append(state.engine.lane_decode_steps)
        body = json.loads(urllib.request.urlopen(urllib.request.Request(
            _url(srv) + "/v1/debug/profile", method="POST",
            data=json.dumps({"seconds": 0.3, "out_dir": str(tmp_path / "p")}).encode()),
            timeout=LIMIT).read())
        t.join(LIMIT)
        assert steps[1] > steps[0], steps
        assert got["text"] == alone
        assert inside == [None] and wd.check_once() is None and not wd.degraded
        assert not wd.m_stalls.child_values()
        timings = body["timings_s"]
        assert 0 <= timings["scheduler_stop"] <= timings["stop"]
        assert 0 <= timings["scheduler_start"] <= timings["start"]
        names = {e.get("name") for e in json.load(open(body["trace"]))["traceEvents"]}
        assert "dllama.profile_window" in names and body["n_events"] > 0
        # the undeclared gap: the same 100 s with no pause is a stall
        wd.beat(n_active=1)
        wd.dispatch_begin("decode_lanes")
        wd.dispatch_end()
        clock[0] += 20.0
        assert wd.check_once() == "decode-stalled"
    finally:
        srv.shutdown()
        srv.server_close()


class _Event:
    """A ``KinetoEvent``'s accessors that `write_chrome_trace` reads."""

    def __init__(self, name, ts_us, dur_us, device=None, corr=0, linked=0, tid=7):
        self._name, self._ts, self._dur, self._dev = name, ts_us, dur_us, device
        self._corr, self._linked, self._tid = corr, linked, tid

    def name(self):
        return self._name

    def start_ns(self):
        return int(self._ts * 1000)

    def duration_ns(self):
        return int(self._dur * 1000)

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CPU if self._dev is None else DeviceType.CUDA

    def device_index(self):
        return self._dev

    def device_resource_id(self):
        return self._tid

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def is_user_annotation(self):
        return False


def test_chrome_trace_keeps_ids_and_links_launches_to_kernels(tmp_path):
    """The trace keeps each event's ids and ties each launch to its
    kernels by a flow, as torch's own export does: a graph launch to both
    kernels of its replay, a driver launch to its kernel; a kernel without
    a recorded launch gets no flow."""
    events = [
        _Event("aten::mm", 10, 50, corr=11),
        _Event("cudaGraphLaunch", 20, 5, corr=501, linked=11),
        _Event("cuLaunchKernel", 30, 3, corr=502, linked=11),
        _Event("gemv_mma_kernel", 40, 8, device=0, corr=501, linked=11, tid=3),
        _Event("flash_decode_mma_kernel", 48, 6, device=0, corr=501, linked=11, tid=3),
        _Event("Memcpy DtoH", 60, 1, device=0, corr=502, linked=11, tid=3),
        _Event("orphan_kernel", 70, 1, device=0, corr=999, tid=3),
    ]
    path = str(tmp_path / "trace.json")
    out = api.write_chrome_trace(events, path)
    assert out == {"n_events": 7, "kernels": ["flash_decode_mma_kernel", "gemv_mma_kernel",
                                              "orphan_kernel"], "n_flows": 2}
    trace = json.load(open(path))["traceEvents"]
    slices = {e["name"]: e for e in trace if e["ph"] == "X"}
    assert {n: e["cat"] for n, e in slices.items()} == {
        "aten::mm": "cpu_op", "cudaGraphLaunch": "cuda_runtime", "cuLaunchKernel": "cuda_driver",
        "gemv_mma_kernel": "kernel", "flash_decode_mma_kernel": "kernel",
        "Memcpy DtoH": "gpu_memcpy", "orphan_kernel": "kernel"}
    assert slices["aten::mm"]["args"] == {"External id": 11}
    assert slices["cudaGraphLaunch"]["args"] == {"correlation": 501, "External id": 11}
    assert slices["gemv_mma_kernel"]["args"] == {
        "correlation": 501, "External id": 11, "device": 0, "stream": 3}
    assert slices["gemv_mma_kernel"]["pid"] == 1 and slices["aten::mm"]["pid"] == 0
    flows = sorted((e["id"], e["ph"], e["ts"], e.get("bp")) for e in trace
                   if e.get("cat") == "ac2g")
    assert flows == [(501, "f", 40.0, "e"), (501, "f", 48.0, "e"), (501, "s", 20.0, None),
                     (502, "f", 60.0, "e"), (502, "s", 30.0, None), (999, "f", 70.0, "e")]
    assert {e["args"]["name"] for e in trace if e["ph"] == "M"} == {"host", "device 0"}
