"""Observability wired into the port's engine, lane server and CLI, on the
CPU, against the JAX lane server on the same tiny f32 model.

* The same request script (a shared prefix, concurrent streams over two
  lanes that park and resume, one fault schedule, one drain) on both
  servers: ``/metrics`` carries the JAX families less the window
  crossings', and the deterministic counters are equal.
* ``/v1/health`` keeps its fields; a forced watchdog stall (a fake clock)
  and an anomaly (sampler ticks driven by hand) report ``degraded`` and
  shed ``low`` requests with ``Retry-After: 2``.
* Each route answers with the JAX route's keys; the profile route writes a
  trace and answers 409 while a capture runs.
* The engine brackets its dispatches (spans, step histograms, recorder
  events, capture counts, cache epochs, COW bytes, a postmortem); the CLI
  takes ``--trace-out``, ``--timeline-out``, ``--postmortem-dir`` and
  ``--profile``.

No test waits for a rule on real time: watchdog and anomaly ticks are
called directly with injected clocks. The port's and the JAX package's
singletons are reset before this module's servers exist.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import pytest
import torch

import dllama_tpu.obs.metrics as j_metrics
import dllama_tpu.obs.recorder as j_recorder
import dllama_tpu.obs.spans as j_spans
import dllama_tpu.runtime.api_server as japi
import dllama_tpu.runtime.faults as jfaults
import dllama_tpu_torch.obs.metrics as p_metrics
import dllama_tpu_torch.obs.recorder as p_recorder
import dllama_tpu_torch.obs.spans as p_spans
import dllama_tpu_torch.runtime.api_server as api
import dllama_tpu_torch.runtime.faults as pfaults
from dllama_tpu.formats import FloatType
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu.tokenizer import Tokenizer as JTokenizer
from dllama_tpu_torch import cli
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.tokenizer import Tokenizer

from helpers import make_tiny_model, make_tiny_tokenizer
from test_torch_graphs import ReplayingGraphs

CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=384)
LIMIT = 120  # seconds any one request, join or event wait may take (each test's limit)
KNOBS = dict(lane_block_size=4, admission_chunk=16, kv_page_size=8, max_streams=4,
             retry_backoff_ms=0)
PREFIX = "You are a helpful assistant who answers in short sentences. " * 2
FAULTS = "dispatch:op=decode_lanes:nth=3,dispatch:op=decode_lanes:nth=9:kind=poison"
# families the port leaves out: the window crossings' (no counterpart in
# the port; README.md lists it)
LEFT_OUT = ("dllama_engine_window_crossings_total",)
# the counters the script makes deterministic, by family
COUNTERS = ("dllama_requests_finished_total", "dllama_admissions_total",
            "dllama_prefix_cache_hits_total", "dllama_prefix_cache_misses_total",
            "dllama_reused_prefix_tokens_total", "dllama_requests_shed_total",
            "dllama_dispatch_retries_total", "dllama_lanes_recovered_total",
            "dllama_faults_injected_total", "dllama_stream_resumes_total",
            "dllama_streams_parked", "dllama_sse_cancellations_total")
HEALTH_FIELDS = {"status", "model", "uptime_s", "lanes", "admitting", "queue_depth", "kv",
                 "speculation", "resilience"}
RESILIENCE_FIELDS = {"retry_max", "dispatch_retries", "recoveries", "lanes_recovered",
                     "cache_epoch", "max_streams", "parked", "parks", "resumes",
                     "resume_reused_tokens", "resume_prefill_tokens", "shed", "faults"}
SPEC_FIELDS = {"mode", "k", "drafted", "accepted", "verify_passes", "tokens_per_lane_pass",
               "sources", "store"}


def _reset_singletons():
    for reg in (j_metrics.get_registry(), p_metrics.get_registry()):
        reg.reset()
        reg.enable()
    for rec in (j_recorder.get_recorder(), p_recorder.get_recorder()):
        rec.clear()
        rec.enable()
        rec.postmortem_dir = None
    for st in (j_spans.get_span_tracker(), p_spans.get_span_tracker()):
        st.clear()
        st.enable()
    pfaults.set_fault_plane("")
    jfaults.set_fault_plane("")


@pytest.fixture(scope="module", autouse=True)
def fresh_singletons():
    _reset_singletons()
    yield
    _reset_singletons()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_obs_server")
    mp, tp_ = str(d / "m.m"), str(d / "t.t")
    make_tiny_model(mp, weight_type=FloatType.Q40, cfg=CFG)
    make_tiny_tokenizer(tp_, chat_template="<|start_header_id|>")
    return mp, tp_


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(srv):
    srv.shutdown()
    srv.server_close()


def _port_server(files, **kw):
    eng = InferenceEngine(files[0], dtype=torch.float32, temperature=0.0, seed=3, device="cpu",
                          batch_size=2)
    return _start(api.serve(eng, Tokenizer(files[1]), host="127.0.0.1", port=0,
                            **dict(KNOBS, kv_native=True, **kw)))


def _jax_server(files):
    tok = JTokenizer(files[1])
    eng = JEngine(files[0], tokenizer=tok, tp=1, dtype=jnp.float32, temperature=0.0, seed=3,
                  batch_size=2)
    return _start(japi.serve(eng, tok, host="127.0.0.1", port=0, kv_native=True, **KNOBS))


@pytest.fixture(scope="module")
def servers(files):
    """(the JAX server, the port's), each driven through the same script
    once: `_script`'s results ride along as ``srv.script``."""
    out = []
    for make, plane in ((lambda: _jax_server(files), jfaults), (lambda: _port_server(files),
                                                                 pfaults)):
        srv = make()
        srv.script = _script(srv, plane)
        out.append(srv)
    yield out
    for srv in out:
        _stop(srv)


def _url(srv):
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _get(srv, path):
    with urllib.request.urlopen(_url(srv) + path, timeout=LIMIT) as r:
        return r.read(), r.headers


def _get_json(srv, path):
    return json.loads(_get(srv, path)[0])


def _post(srv, path, payload=None):
    data = json.dumps(payload or {}).encode()
    req = urllib.request.Request(_url(srv) + path, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=LIMIT) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _chat(srv, prompt, max_tokens=6, **extra):
    return _post(srv, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": prompt}], "max_tokens": max_tokens,
        "temperature": 0, **extra})


def _params(mod, prompt, max_tokens):
    return mod.InferenceParams(messages=[mod.ChatMessage("user", prompt)], temperature=0.0,
                               max_tokens=max_tokens)


def _wait(job):
    text = []
    while True:
        kind, payload = job.events.get(timeout=LIMIT)
        if kind == "delta":
            text.append(payload if isinstance(payload, str) else payload["text"])
        else:
            return kind, payload, "".join(text)


def _together(srv, prompts, max_tokens):
    """Submit every prompt under the scheduler's cv, so the queue holds them
    all before the next tick (the same order of events on both servers)."""
    mod = api if isinstance(srv.state, api.ApiState) else japi
    sched = srv.state.scheduler
    with sched.cv:
        jobs = [sched.submit(_params(mod, p, max_tokens)) for p in prompts]
    return [_wait(j) for j in jobs]


def _answer(status, body, headers):
    """What two servers' answers share: the status, text, finish and usage."""
    choice = body["choices"][0]
    return status, choice["message"]["content"], choice["finish_reason"], body["usage"]


def _script(srv, plane):
    """The request script: two conversations sharing a prefix, one after
    the other (a radix hit); four at once over two lanes with max_streams
    4 (parks and resumes) under a transient and a poison decode fault;
    then a drain, which sheds the next request."""
    out = [_answer(*_chat(srv, PREFIX + "first question")),
           _answer(*_chat(srv, PREFIX + "second one"))]
    armed = plane.set_fault_plane(FAULTS)
    try:
        out.append(_together(srv, [PREFIX + f"stream {i}" for i in range(4)], 12))
    finally:
        out.append(armed.counts())
        plane.set_fault_plane("")
    status, body, headers = _post(srv, "/v1/drain")
    assert status == 200 and body["status"] == "draining"
    assert srv.state.drained.wait(LIMIT)
    status, body, headers = _chat(srv, "late")
    out.append((status, body["error"]["message"], headers.get("Retry-After")))
    return out


def _families(text: str) -> dict[str, str]:
    return {line.split()[2]: line.split()[3] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def _samples(text: str, families) -> dict[str, float]:
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name, value = line.rsplit(" ", 1)
        if name.split("{")[0] in families:
            out[name] = float(value)
    return out


def test_script_runs_alike(servers):
    jax_srv, port_srv = servers
    assert port_srv.script == jax_srv.script
    done = port_srv.script[2]
    assert [d[0] for d in done] == ["done"] * 4
    assert port_srv.script[-1] == (503, "request shed: draining", "5")


def test_metric_families_and_counters_match_jax(servers):
    jax_srv, port_srv = servers
    jtext, ptext = (_get(s, "/metrics")[0].decode() for s in servers)
    jfam, pfam = _families(jtext), _families(ptext)
    want = {k: v for k, v in jfam.items() if k not in LEFT_OUT}
    assert pfam == want
    assert set(LEFT_OUT) <= set(jfam) and not set(LEFT_OUT) & set(pfam)
    jc, pc = _samples(jtext, COUNTERS), _samples(ptext, COUNTERS)
    assert pc == jc
    # the script did move what it claims to
    assert pc["dllama_prefix_cache_hits_total"] >= 1
    assert pc["dllama_dispatch_retries_total"] == 1
    assert pc["dllama_lanes_recovered_total"] >= 1
    assert pc['dllama_faults_injected_total{site="dispatch"}'] == 2
    assert pc["dllama_stream_resumes_total"] >= 1
    assert pc['dllama_requests_shed_total{reason="draining"}'] == 1
    # parks: the recorder's stream_park events
    parks = [len(s.state.recorder.events("stream_park")) for s in servers]
    assert parks[0] == parks[1] >= 1
    assert port_srv.state.scheduler.parks == parks[1]
    # every line parses: a sample is a name, optional labels and a number
    for line in ptext.splitlines():
        if line and not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])


def test_health_keeps_its_fields_and_reads_the_registry(servers):
    port_srv = servers[1]
    h = _get_json(port_srv, "/v1/health")
    assert HEALTH_FIELDS <= set(h) and h["status"] == "draining"
    assert RESILIENCE_FIELDS == set(h["resilience"])
    assert SPEC_FIELDS == set(h["speculation"])
    assert {"page_size", "pool", "radix", "lanes", "dtype", "page_bytes"} <= set(h["kv"])
    res, sched = h["resilience"], port_srv.state.scheduler
    text = _get(port_srv, "/metrics")[0].decode()
    s = _samples(text, COUNTERS)
    assert res["dispatch_retries"] == s["dllama_dispatch_retries_total"] == 1
    assert res["lanes_recovered"] == s["dllama_lanes_recovered_total"]
    assert res["resumes"] == s["dllama_stream_resumes_total"] == sched.resumes
    assert res["shed"] == {"draining": 1} == port_srv.state.shed
    assert res["faults"] == {}  # the plane was disarmed after the round


def test_new_routes_answer_with_the_jax_keys(servers):
    jax_srv, port_srv = servers
    for srv in servers:
        srv.state.sampler.sample_once()
    rid = port_srv.state.tracer.records()[-1]["request_id"]
    jrid = jax_srv.state.tracer.records()[-1]["request_id"]
    for path, jpath in (("/v1/debug/recorder", None), ("/v1/debug/memory", None),
                        ("/v1/debug/kv", None), ("/v1/debug/compile", None),
                        ("/v1/debug/timeline", None), ("/v1/debug/slo", None),
                        ("/v1/debug/series", None), ("/health", None), ("/healthz", None),
                        (f"/v1/debug/timeline?request_id={rid}",
                         f"/v1/debug/timeline?request_id={jrid}"),
                        ("/v1/debug/series?name=dllama_queue_depth&window=60", None)):
        got, want = _get_json(port_srv, path), _get_json(jax_srv, jpath or path)
        assert set(want) <= set(got), (path, set(want) - set(got))
        for key in ("analytic", "comparison", "cost", "dllama"):
            if isinstance(want.get(key), dict):
                assert set(want[key]) <= set(got[key]), (path, key)
    prog = _get_json(port_srv, "/v1/debug/compile")["programs"]
    jprog = _get_json(jax_srv, "/v1/debug/compile")["programs"]
    assert prog and set(prog[0]) == set(jprog[0])
    assert {p["kind"] for p in prog} >= {"decode_lanes", "prefill_lane_chunk"}
    mem = _get_json(port_srv, "/v1/debug/memory")
    assert mem["devices"] == [{"device": "cpu", "platform": "cpu", "available": False}]
    assert mem["analytic"]["pool_bytes"] > 0 and mem["comparison"]["available"] is False
    dash = [_get(s, "/dashboard") for s in servers]
    assert dash[0][0] == dash[1][0] and dash[1][1]["Content-Type"].startswith("text/html")
    # the request's timeline: queue, admission and decode, and engine spans
    tl = _get_json(port_srv, f"/v1/debug/timeline?request_id={rid}")
    names = {e["name"] for e in tl["traceEvents"] if e["ph"] == "X"}
    assert {"queue", "decode", "publish"} <= names
    assert names & {"adopt", "admission_chunk"}
    assert tl["dllama"]["summary"]["coverage"] > 0.5
    every = {e["name"] for e in _get_json(port_srv, "/v1/debug/timeline")["traceEvents"]}
    assert {"decode_lanes", "decode_lanes.device", "prefill_lane_chunk", "sched_tick",
            "kv_match", "park"} <= every
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port_srv, "/nope")
    assert e.value.code == 404
    text = _get(port_srv, "/metrics")[0].decode()
    assert 'dllama_http_requests_total{path="other"} 1' in text
    assert 'dllama_http_requests_total{path="/v1/debug/compile"}' in text


def test_forced_watchdog_stall_degrades_and_sheds_low(files):
    srv = _port_server(files, max_streams=None)
    state, wd = srv.state, srv.state.watchdog
    clk = {"t": 1000.0}
    wd._clock = lambda: clk["t"]
    try:
        assert _get_json(srv, "/v1/health")["status"] == "ok"
        wd.beat(n_active=0)
        wd.dispatch_begin("decode_lanes")
        clk["t"] += 31.0
        assert wd.check_once() == "dispatch-hung"
        h = _get_json(srv, "/v1/health")
        assert h["status"] == "degraded"
        assert h["degraded_reasons"] == ["watchdog:dispatch-hung"]
        assert h["watchdog"]["reason"] == "dispatch-hung"
        status, body, headers = _chat(srv, "hello", priority="low")
        # the JAX server's ladder: a degraded shed answers 429
        assert (status, headers.get("Retry-After")) == (429, "2")
        assert body["error"]["message"] == "request shed: degraded"
        status, body, _ = _chat(srv, "hello", priority="normal")
        assert status == 200 and body["choices"][0]["finish_reason"] in ("stop", "length")
        wd.dispatch_end()
        wd.beat(n_active=0)
        assert wd.check_once() is None
        assert _get_json(srv, "/v1/health")["status"] == "ok"
        assert _chat(srv, "hello", priority="low")[0] == 200
        assert state.shed == {"degraded": 1}
        text = _get(srv, "/metrics")[0].decode()
        assert 'dllama_watchdog_stalls_total{reason="dispatch-hung"} 1' in text
        assert 'dllama_requests_shed_total{reason="degraded"}' in text
    finally:
        _stop(srv)


def test_anomaly_on_hand_driven_ticks_degrades_and_recovers(files):
    """The port's twin of the JAX server's anomaly test, without real
    time: the sampler thread stops and its ticks are called directly with
    an injected time, while the KV free-pages gauge drains on purpose."""
    srv = _port_server(files, max_streams=None)
    state = srv.state
    state.sampler.stop()
    g_free = state.kv_manager.g_free
    try:
        free, t = 10_000.0, 0.0
        for _ in range(40):  # slow churn teaches the baseline
            free -= 1.0
            g_free.set(free)
            t += 1.0
            state.sampler.sample_once(now=t)
        assert not state.anomaly.degraded
        for _ in range(3):  # then a fast drain
            free -= 400.0
            g_free.set(free)
            t += 1.0
            state.sampler.sample_once(now=t)
        assert state.anomaly.degraded
        h = _get_json(srv, "/v1/health")
        assert h["status"] == "degraded" and "anomaly:kv_free_slope" in h["degraded_reasons"]
        assert _chat(srv, "hi", priority="low")[0] == 429
        while state.anomaly.degraded and t < 200:
            free -= 1.0
            g_free.set(free)
            t += 1.0
            state.sampler.sample_once(now=t)
        assert not state.anomaly.degraded
        assert _get_json(srv, "/v1/health")["status"] == "ok"
        series = _get_json(srv, "/v1/debug/series?name=dllama_kv_pages_free&window=600")
        assert len(series["points"]) >= 40
    finally:
        _stop(srv)


def test_profile_route_writes_a_trace_and_refuses_a_second(files, tmp_path):
    srv = _port_server(files, max_streams=None)
    state = srv.state
    try:
        first = {}

        def run():
            first["r"] = _post(srv, "/v1/debug/profile",
                               {"seconds": 0.5, "out_dir": str(tmp_path / "p1")})

        th = threading.Thread(target=run)
        th.start()
        for _ in range(10_000):
            if state.profile_lock.locked():
                break
            threading.Event().wait(0.001)
        status, body, _ = _post(srv, "/v1/debug/profile", {"seconds": 0.1})
        assert status == 409 and "already running" in body["error"]["message"]
        assert _chat(srv, "profiled")[0] == 200  # served while profiled
        th.join(LIMIT)
        status, body, _ = first["r"]
        assert status == 200
        assert {"log_dir", "seconds", "n_files"} <= set(body)
        assert set(body["timings_s"]) == {"start", "window", "stop", "export",
                                          "scheduler_start", "scheduler_stop"}
        assert body["n_events"] > 0 and os.path.exists(body["trace"])
        with open(body["trace"]) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert "dllama.profile_window" in names
        assert _post(srv, "/v1/debug/profile", {"seconds": 0})[0] == 400
        assert state.recorder.events("profile_capture")
    finally:
        _stop(srv)


def test_engine_brackets_every_dispatch(files, tmp_path):
    reg = p_metrics.get_registry()
    rec = p_recorder.get_recorder()
    rec.postmortem_dir = str(tmp_path / "pm")
    rec.clear()
    p_spans.get_span_tracker().clear()
    compiles = reg.counter("dllama_engine_compiles_total", labelnames=("origin",)).labels(
        origin="dispatch")
    c0 = compiles.value
    eng = InferenceEngine(files[0], dtype=torch.float32, temperature=0.0, seed=3, device="cpu",
                          batch_size=2)
    eng.graphs = ReplayingGraphs()
    try:
        # twice: a key's first use (eager, then the capture) counts no cost
        for _ in range(2):
            eng.generate([1, 2, 3, 4, 5, 6, 7], max_steps=24)
            eng.perplexity([1, 2, 3, 4, 5, 6])
            eng.decode_step(3, 30)
        eng.init_kv_pool(8, native=True)
        eng.adopt_pages(0, [1, 2, 3])
        eng.adopt_pages(1, [4, 5, 6])
        for _ in range(2):
            eng.prefill_lane_chunk(0, [5, 6, 7, 8], 0)
            eng.decode_lanes([1, 2], [4, 0], 4, [True, False])
            eng.verify_lanes([[1, 2, 3], [0, 0, 0]], [8, 0], [True, False])
        eng.kv_page_copy([1], [9])
        pfaults.set_fault_plane("dispatch:op=decode_lanes:nth=1:kind=poison")
        with pytest.raises(pfaults.InjectedFault):
            eng.decode_lanes([1, 2], [5, 0], 4, [True, False])
    finally:
        pfaults.set_fault_plane("")
        rec.postmortem_dir = None
    kinds = {"prefill", "decode_block", "score", "decode_step", "prefill_lane_chunk",
             "decode_lanes", "verify_lanes", "kv_page_copy"}
    step = reg.histogram("dllama_engine_step_seconds", labelnames=("kind",))
    assert {k[0] for k in step._children} >= kinds
    done = {e["step"] for e in rec.events("step_complete")}
    assert done >= kinds
    names = {s["name"] for s in p_spans.get_span_tracker().completed()}
    assert names >= kinds | {"decode_block.device", "decode_lanes.device",
                             "verify_lanes.device", "score.device"}
    # one capture a graph key's first use (init_kv_pool dropped the first ones)
    assert compiles.value - c0 == len(rec.events("compile")) > len(eng.graphs.capture_seconds)
    assert reg.counter("dllama_engine_cache_epochs_total").value >= 1
    assert reg.counter("dllama_kv_copy_bytes_total").value >= eng.kv_page_bytes()
    assert reg.histogram("dllama_engine_block_token_seconds").count > 0
    assert os.listdir(tmp_path / "pm")  # the failed dispatch's postmortem
    rep = eng.cost_report()
    assert rep["hbm_peak_bytes_per_s"] is None
    assert all(v["roofline_fraction"] is None for v in rep["kinds"].values())
    assert set(rep["kinds"]) >= kinds
    assert all(v["dispatches"] >= 1 for v in rep["kinds"].values())
    rows = {tuple(r["key"]): r for r in eng.graph_report()}
    assert rows[("lane_block_paged", 4, False)]["compile_seconds"] is not None
    # a decode block of 4 reads the weights 4 times and every attended row
    blk = rows[("lane_block_paged", 4, False)]["cost"]["bytes_accessed"]
    assert blk > 4 * (eng._cost.w["layers"] + eng._cost.w["cls"])


def test_cli_takes_the_obs_flags(files, tmp_path, capsys):
    trace, timeline, prof = (str(tmp_path / n) for n in ("t.jsonl", "tl.json", "prof"))
    res = cli.main(["inference", "--model", files[0], "--tokenizer", files[1], "--prompt", "hi",
                    "--steps", "24", "--temperature", "0", "--device", "cpu", "--dtype", "f32",
                    "--trace-out", trace, "--timeline-out", timeline, "--profile", prof,
                    "--postmortem-dir", str(tmp_path / "pm")])
    out = capsys.readouterr().out
    assert "📐 Roofline:" in out and "📀 Memory:" in out and "🧭 timeline:" in out
    with open(trace) as f:
        (rec,) = [json.loads(line) for line in f]
    assert rec["path"] == "cli" and rec["n_completion"] == len(res["tokens"])
    assert rec["ttft_s"] is not None
    with open(timeline) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"generate", "prefill", "decode_block"} <= names
    assert os.path.exists(os.path.join(prof, "trace.json"))
    assert p_recorder.get_recorder().postmortem_dir == str(tmp_path / "pm")
    p_recorder.get_recorder().postmortem_dir = None
    kinds = res["engine"].cost_report()["kinds"]
    assert kinds["decode_block"]["dispatches"] > 0
