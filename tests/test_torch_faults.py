"""The port's resilience layer on CPU, f32, tiny Q40 ``.m`` files, against
the JAX package where it has a counterpart:

* the chaos plane (runtime/faults.py): the same fire sequences as
  dllama_tpu.runtime.faults over 500 draws for every valid spec of
  tests/test_faults.py, the same rejections, the same `InjectedFault`;
* the engine's dispatch guard at each lane entry: a transient fault leaves
  the pool's bytes and both epochs as they were; a poison fault zeroes the
  pool in place (same ``data_ptr``, an int8 pool's scales back to ones),
  moves both epochs and keeps the graphs, which replay the same tokens
  after a re-prefill; a reset that fails raises from the fault;
* the lane server (4 lanes): the five soak schedules of tests/test_faults.py
  fail exactly as many requests as the JAX server's (0, 0, 0, 1, either-or),
  every completed answer equals the fault-free one, and under the decode
  poison also the JAX lane server's under the same spec; a mid-stream decode
  poison continues byte for byte; ``kv_alloc`` and publish faults are
  absorbed; an ``sse_flush`` fault cancels only its stream; a failed
  admission releases its pages; the queue-full ladder by priority, its
  Retry-After the predicted drain; a bad priority answers 400; a drain
  answers 503 with Retry-After 5 and /v1/health says ``draining``;
* park/resume (``max_streams`` 6 on 2 lanes): every answer equals its solo
  run, with speculation off and shared; a poison recovery under ``shared``
  equals spec-off; a poison recovery on an int8 pool equals its fault-free
  run;
* the knobs' environment fallbacks equal the JAX ``resolve_*`` functions.

No test waits on a sleep: faults are armed by ``nth`` and ``op``, and the
shed and drain tests hold the scheduler thread between two ticks while
they look.
"""

import contextlib
import http.client
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats import FloatType
from dllama_tpu.runtime import api_server as japi
from dllama_tpu.runtime import faults as jfaults
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu.tokenizer import Tokenizer as JTokenizer
from dllama_tpu_torch.ops.kv_cache import kv_tensors
from dllama_tpu_torch.runtime import api_server as api
from dllama_tpu_torch.runtime import faults
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.tokenizer import Tokenizer

from helpers import make_tiny_model, make_tiny_tokenizer
from test_faults import SOAK_PROMPTS, SOAK_SCHEDULES
from test_torch_graphs import ReplayingGraphs

CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=384)
LIMIT = 120  # seconds any one request, join or event wait may take
# the valid specs of tests/test_faults.py, the soak's among them
VALID_SPECS = [
    "dispatch:p=0.05:seed=7,kv_alloc:nth=12,dispatch:every=40:kind=poison:n=2:op=decode_lanes",
    "dispatch:nth=1, ,",
    "dispatch:nth=3",
    "dispatch:every=3:n=2",
    "dispatch:p=0.3:seed=11",
    "dispatch:op=decode_lanes:nth=1",
    "kv_alloc:nth=1:kind=poison",
] + [spec for spec, _ in SOAK_SCHEDULES]
BAD_SPECS = [
    "warp_core:p=0.5", "dispatch:p=0.5:mean=3", "dispatch:p=0.5:kind=flaky", "dispatch",
    "dispatch:kind=poison", "dispatch:p=0.5:nth=3", "dispatch:p=abc", "dispatch:p=1.5",
    "dispatch:nth=0", "dispatch:every=0", "dispatch:p",
]
SITES = [("dispatch", "decode_lanes"), ("dispatch", "prefill_lane_chunk"),
         ("dispatch", "verify_lanes"), ("dispatch", None), ("kv_alloc", "adopt"),
         ("kv_alloc", "publish"), ("sse_flush", None), ("prefetch", None)]
NL = "walk through how the scheduler shares computed prefixes, step by step"


@pytest.fixture(autouse=True)
def _disarm():
    """Every test leaves both processes-wide planes unarmed."""
    yield
    faults.set_fault_plane("")
    jfaults.set_fault_plane("")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_faults")
    mp, tp_ = str(d / "m.m"), str(d / "t.t")
    make_tiny_model(mp, weight_type=FloatType.Q40, cfg=CFG)
    make_tiny_tokenizer(tp_, chat_template="<|start_header_id|>")
    return mp, tp_


# -- the chaos plane, side by side with the JAX one -----------------------------


def _fires(plane, draws):
    out = []
    for site, op in draws:
        f = plane.draw(site, op=op)
        out.append(None if f is None else (f.site, f.op, f.kind, f.seq, f.poison, str(f)))
    return out


@pytest.mark.parametrize("spec", VALID_SPECS)
def test_fault_plane_fires_as_jax(spec):
    rng = np.random.default_rng(7)
    draws = [SITES[i] for i in rng.integers(0, len(SITES), 500)]
    port, ref = faults.FaultPlane(spec), jfaults.FaultPlane(spec)
    assert port.armed == ref.armed
    got, want = _fires(port, draws), _fires(ref, draws)
    assert got == want
    assert port.counts() == ref.counts()
    if spec.strip(" ,"):
        assert any(got)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_spec_rejections_match_jax(spec):
    with pytest.raises(jfaults.FaultSpecError) as want:
        jfaults.parse_fault_spec(spec)
    with pytest.raises(faults.FaultSpecError) as got:
        faults.parse_fault_spec(spec)
    assert isinstance(got.value, ValueError) and str(got.value) == str(want.value)


def test_injected_fault_and_plane_globals_match_jax():
    assert faults.KNOWN_SITES == jfaults.KNOWN_SITES and faults.KINDS == jfaults.KINDS
    a = faults.InjectedFault("dispatch", "decode_lanes", "poison", 2)
    b = jfaults.InjectedFault("dispatch", "decode_lanes", "poison", 2)
    assert isinstance(a, RuntimeError) and str(a) == str(b)
    assert (a.site, a.op, a.kind, a.seq, a.poison) == (b.site, b.op, b.kind, b.seq, b.poison)
    plane = faults.set_fault_plane("sse_flush:nth=1")
    assert faults.get_fault_plane() is plane and plane.armed
    assert not faults.set_fault_plane("").armed
    assert faults.get_fault_plane().draw("dispatch") is None


# -- the engine's dispatch guard ------------------------------------------------

PROMPTS2 = [[1, 5, 9, 13, 17, 21, 25, 29, 33, 37, 41], [2, 4, 8, 16, 32, 64, 3, 6, 12]]


def _guarded_engine(mp, kv_dtype=None):
    """Two lanes on private pages, prefilled, with replaying graphs that a
    first decode captured."""
    e = InferenceEngine(mp, dtype=torch.float32, temperature=0.0, seed=3, device="cpu",
                        batch_size=2, kv_dtype=kv_dtype)
    e.graphs = ReplayingGraphs()
    e.init_kv_pool(8, native=True)
    nb = e._kv_n_blocks
    for lane, p in enumerate(PROMPTS2):
        e.adopt_pages(lane, list(range(1 + lane * nb, 1 + (lane + 1) * nb)))
        e.prefill_lane(lane, p)
    state = ([p[-1] for p in PROMPTS2], [len(p) - 1 for p in PROMPTS2])
    ref = e.decode_lanes(*state, 4)
    return e, state, ref


def _pool(e):
    return [t.clone() for leaf in e.kv_pool.values() for t in kv_tensors(leaf)]


def _call(e, op, state):
    tokens, pos = state
    if op == "decode_lanes":
        return e.decode_lanes(tokens, pos, 4)
    if op == "prefill_lane_chunk":
        return e.prefill_lane_chunk(0, PROMPTS2[0][:-1], 0)
    if op == "verify_lanes":
        return e.verify_lanes([[t, 7] for t in tokens], pos, [True, True])
    return e.kv_page_copy([1], [e._kv_pool_pages - 1])


OPS = ["decode_lanes", "prefill_lane_chunk", "verify_lanes", "kv_page_copy"]


@pytest.mark.parametrize("op", OPS)
def test_transient_fault_leaves_pool_and_epochs(files, op):
    e, state, ref = _guarded_engine(files[0])
    before, epochs, pt = _pool(e), (e.kv_pool_epoch, e.cache_epoch), e._page_table.copy()
    faults.set_fault_plane(f"dispatch:op={op}:nth=1")
    with pytest.raises(faults.InjectedFault) as err:
        _call(e, op, state)
    assert not err.value.poison and err.value.op == op
    assert all(torch.equal(a, b) for a, b in zip(_pool(e), before))
    assert (e.kv_pool_epoch, e.cache_epoch) == epochs
    assert np.array_equal(e._page_table, pt)
    _call(e, op, state)  # the retry runs (nth fired once)
    assert e.decode_lanes(*state, 4) == ref


@pytest.mark.parametrize("op,kv", [(op, None) for op in OPS] + [("decode_lanes", "int8")])
def test_poison_fault_resets_pool_in_place(files, op, kv):
    e, state, ref = _guarded_engine(files[0], kv)
    ptrs = [t.data_ptr() for leaf in e.kv_pool.values() for t in kv_tensors(leaf)]
    epochs, n_graphs = (e.kv_pool_epoch, e.cache_epoch), e.graphs.n_graphs
    faults.set_fault_plane(f"dispatch:op={op}:nth=1:kind=poison")
    with pytest.raises(faults.InjectedFault) as err:
        _call(e, op, state)
    assert err.value.poison
    assert (e.kv_pool_epoch, e.cache_epoch) == (epochs[0] + 1, epochs[1] + 1)
    assert [t.data_ptr() for leaf in e.kv_pool.values() for t in kv_tensors(leaf)] == ptrs
    for leaf in e.kv_pool.values():
        ts = kv_tensors(leaf)
        assert not ts[0].any()
        if kv == "int8":
            assert bool((ts[1] == 1.0).all())
    assert not e._page_table.any()
    assert e.graphs.n_graphs == n_graphs
    # re-adopt and re-prefill: the captured graphs replay the same tokens
    nb = e._kv_n_blocks
    for lane, p in enumerate(PROMPTS2):
        e.adopt_pages(lane, list(range(1 + lane * nb, 1 + (lane + 1) * nb)))
        e.prefill_lane(lane, p)
    assert e.decode_lanes(*state, 4) == ref
    assert e.graphs.n_graphs == n_graphs


def test_failed_reset_raises_from_the_fault(files, monkeypatch):
    e, state, _ = _guarded_engine(files[0])
    epoch = e.cache_epoch

    def broken():
        raise RuntimeError("reset failed")

    monkeypatch.setattr(e, "reset_kv_pool", broken)
    faults.set_fault_plane("dispatch:op=decode_lanes:nth=1:kind=poison")
    with pytest.raises(RuntimeError, match="reset failed") as err:
        _call(e, "decode_lanes", state)
    assert isinstance(err.value.__cause__, faults.InjectedFault)
    assert e.cache_epoch == epoch + 1


# -- the lane server under chaos ------------------------------------------------


def _serve(mp, tp_, **kw):
    eng = InferenceEngine(mp, dtype=torch.float32, temperature=0.0, seed=3, device="cpu",
                          batch_size=kw.pop("batch_size", 4))
    kw.setdefault("kv_native", True)
    srv = api.serve(eng, Tokenizer(tp_), host="127.0.0.1", port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _url(srv):
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server(files):
    srv = _serve(*files, retry_backoff_ms=0)
    yield srv
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def jax_server(files):
    mp, tp_ = files
    tok = JTokenizer(tp_)
    eng = JEngine(mp, tokenizer=tok, tp=1, dtype=jnp.float32, temperature=0.0, seed=3,
                  batch_size=4)
    srv = japi.serve(eng, tok, host="127.0.0.1", port=0, retry_backoff_ms=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv
    srv.shutdown()
    srv.server_close()


def _post(url, path, payload=None):
    data = b"" if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=LIMIT) as r:
        return r.read().decode()


def _ask(srv, prompt, max_tokens=8, **extra):
    """One greedy completion: ("ok", content) or ("error", status, error,
    the Retry-After header)."""
    payload = {"messages": [{"role": "user", "content": prompt}], "max_tokens": max_tokens,
               "temperature": 0, **extra}
    try:
        body = json.loads(_post(_url(srv), "/v1/chat/completions", payload))
        return ("ok", body["choices"][0]["message"]["content"])
    except urllib.error.HTTPError as e:
        return ("error", e.code, json.loads(e.read()).get("error", {}),
                e.headers.get("Retry-After"))


def _ask_many(srv, prompts, max_tokens=8):
    results = [None] * len(prompts)

    def worker(i):
        results[i] = _ask(srv, prompts[i], max_tokens)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=LIMIT)
    assert not any(t.is_alive() for t in threads), "a request hung"
    return results


@contextlib.contextmanager
def _quoted_retry_after(state):
    """Every value ``state.predicted_retry_after`` returns during the block,
    in order: the Retry-After the server read when it answered (a
    retryable error reads it once, as it answers)."""
    quoted, real = [], state.predicted_retry_after

    def spy(*a, **k):
        quoted.append(real(*a, **k))
        return quoted[-1]

    state.predicted_retry_after = spy
    try:
        yield quoted
    finally:
        del state.predicted_retry_after


@contextlib.contextmanager
def _scheduler_held(sched):
    """Hold the scheduler thread between two ticks (`run_between_ticks`)
    for the block: no tick pops the queue or steps a lane, while the cv
    stays free for the handler threads (the admission gate reads the
    occupancy under it)."""
    entered, release = threading.Event(), threading.Event()

    def hold():
        entered.set()
        release.wait(LIMIT)

    t = threading.Thread(target=sched.run_between_ticks, args=(hold,),
                         kwargs={"timeout": LIMIT})
    t.start()
    try:
        assert entered.wait(LIMIT), "the scheduler ran no tick"
        yield
    finally:
        release.set()
        t.join(LIMIT)


def _health(srv):
    with urllib.request.urlopen(_url(srv) + "/v1/health", timeout=LIMIT) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def baseline(server):
    """The soak prompts' fault-free answers: the second of two rounds, so
    every prefix is published (the JAX soak's baseline)."""
    assert all(r[0] == "ok" for r in _ask_many(server, SOAK_PROMPTS))
    second = _ask_many(server, SOAK_PROMPTS)
    assert all(r[0] == "ok" for r in second)
    return {p: r[1] for p, r in zip(SOAK_PROMPTS, second)}


def _chaos_round(srv, plane_mod, spec):
    plane = plane_mod.set_fault_plane(spec)
    try:
        return _ask_many(srv, SOAK_PROMPTS), plane.counts()
    finally:
        plane_mod.set_fault_plane("")


@pytest.mark.parametrize("spec,n_fail", SOAK_SCHEDULES, ids=[s for s, _ in SOAK_SCHEDULES])
def test_chaos_soak_schedule(server, baseline, jax_server, spec, n_fail):
    sched = server.state.scheduler
    recovered = sched.lanes_recovered
    with _quoted_retry_after(server.state) as quoted:
        results, counts = _chaos_round(server, faults, spec)
    failed = []
    for prompt, res in zip(SOAK_PROMPTS, results):
        if res[0] == "ok":
            assert res[1] == baseline[prompt], f"{spec}: {prompt!r} diverged"
        else:
            failed.append(res)
            _, code, err, retry_after = res
            assert code == 503 and err.get("retryable") is True, res
    # each retryable error quotes the predicted drain read as it answered
    assert sorted(r[3] for r in failed) == sorted(str(v) for v in quoted), (failed, quoted)
    assert all(v >= 1 for v in quoted), quoted
    if n_fail is not None:
        assert len(failed) == n_fail, results
    if ":nth=" in spec:
        assert sum(counts.values()) >= 1, counts
    if spec.startswith("dispatch:op=decode_lanes"):
        assert sched.lanes_recovered > recovered
        jresults, _ = _chaos_round(jax_server, jfaults, spec)
        assert results == jresults
    assert sched.thread.is_alive()
    sched.kv.check()
    assert not sched.admitting and not sched.pending and not any(sched.lanes)
    health = _health(server)["resilience"]
    assert health["faults"] == {} and health["dispatch_retries"] == sched.dispatch_retries


def test_transient_schedule_retries(server, baseline):
    retries = server.state.scheduler.dispatch_retries
    results, counts = _chaos_round(server, faults, "dispatch:every=7:seed=1")
    assert results == [("ok", baseline[p]) for p in SOAK_PROMPTS]
    assert counts["dispatch"] >= 1
    assert server.state.scheduler.dispatch_retries - retries == counts["dispatch"]


def _stream(srv, prompt, max_tokens):
    raw = _post(_url(srv), "/v1/chat/completions",
                {"messages": [{"role": "user", "content": prompt}], "max_tokens": max_tokens,
                 "temperature": 0, "stream": True})
    text = ""
    for line in raw.split("\r\n"):
        if line.startswith("data: {"):
            choice = json.loads(line[6:])["choices"][0]
            text += (choice.get("delta") or {}).get("content") or ""
    return text, raw


def test_poison_mid_stream_continues_byte_for_byte(server):
    """The second decode block is poisoned after the first emitted its
    tokens: the lane re-prefills its history and the stream goes on with
    the fault-free bytes."""
    sched = server.state.scheduler
    mt = 2 * sched.block_size + 4
    want, _ = _stream(server, "resume me byte for byte", mt)
    recovered, recoveries = sched.lanes_recovered, sched.recoveries
    faults.set_fault_plane("dispatch:op=decode_lanes:nth=2:kind=poison")
    got, raw = _stream(server, "resume me byte for byte", mt)
    assert faults.get_fault_plane().counts() == {"dispatch": 1}
    assert got == want and raw.rstrip().endswith("data: [DONE]")
    assert (sched.lanes_recovered, sched.recoveries) == (recovered + 1, recoveries + 1)
    assert sched.resume_prefill_tokens > 0
    sched.kv.check()


@pytest.fixture(scope="module")
def slab_server(files):
    srv = _serve(*files, retry_backoff_ms=0, kv_native=False)
    yield srv
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def jax_native_server(files):
    mp, tp_ = files
    tok = JTokenizer(tp_)
    eng = JEngine(mp, tokenizer=tok, tp=1, dtype=jnp.float32, temperature=0.0, seed=3,
                  batch_size=4)
    srv = japi.serve(eng, tok, host="127.0.0.1", port=0, retry_backoff_ms=0, kv_native=True)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv
    srv.shutdown()
    srv.server_close()


# (the lane mode, the spec): the native server takes every spec; the slab
# publish allocates its pages and draws kv_alloc:op=publish there
PUBLISH_FAULTS = [("native", "kv_alloc:nth=1"), ("native", "kv_alloc:op=publish:nth=1"),
                  ("native", "dispatch:op=kv_publish:nth=1"),
                  ("slab", "kv_alloc:op=publish:nth=1")]


@pytest.mark.parametrize("mode,spec", PUBLISH_FAULTS,
                         ids=[s if m == "native" else f"{m}-{s}" for m, s in PUBLISH_FAULTS])
def test_kv_alloc_and_publish_faults_are_absorbed(request, mode, spec):
    """An adopt's allocation fault is retried; a publish fault costs only
    future reuse. Prompts the tree has not seen, so the publish stores. The
    ``kv_alloc:op=publish`` cases draw what a JAX server of the same mode
    draws: a native publish allocates no pages, so nothing fires and
    nothing is skipped; a slab publish fires once and skips one store."""
    server = request.getfixturevalue("server" if mode == "native" else "slab_server")
    sched = server.state.scheduler
    prompts = [f"unseen prompt {mode} {spec} number {i} " * 3 for i in range(4)]
    skips, retries = sched.kv.publish_skips, sched.dispatch_retries
    plane = faults.set_fault_plane(spec)
    first = _ask_many(server, prompts)
    faults.set_fault_plane("")
    assert all(r[0] == "ok" for r in first), first
    if spec.startswith("kv_alloc:op=publish"):
        jax_server = request.getfixturevalue("jax_native_server" if mode == "native"
                                             else "jax_server")
        jplane = jfaults.set_fault_plane(spec)
        try:
            jfirst = _ask_many(jax_server, prompts)
        finally:
            jfaults.set_fault_plane("")
        assert all(r[0] == "ok" for r in jfirst), jfirst
        fired = {k: v for k, v in plane.counts().items() if v}
        want = {k: v for k, v in jplane.counts().items() if v}
        assert fired == want == ({} if mode == "native" else {"kv_alloc": 1})
        assert sched.kv.publish_skips == skips + sum(want.values())
    else:
        assert sum(plane.counts().values()) == 1
        if spec.startswith("kv_alloc:nth"):
            assert sched.dispatch_retries == retries + 1
        else:
            assert sched.kv.publish_skips == skips + 1
    sched.kv.check()
    assert _ask_many(server, prompts) == first


def test_sse_flush_fault_cancels_only_its_stream(server, baseline):
    sched = server.state.scheduler
    plane = faults.set_fault_plane("sse_flush:nth=1")
    other = {}
    t = threading.Thread(target=lambda: other.update(res=_ask(server, SOAK_PROMPTS[0])))
    t.start()
    try:
        raw = _stream(server, "doomed stream", 32)[1]
        assert "data: [DONE]" not in raw
    except (http.client.HTTPException, OSError):
        pass  # a torn connection is a fair view of a dead client
    t.join(timeout=LIMIT)
    assert not t.is_alive()
    assert plane.counts() == {"sse_flush": 1}
    faults.set_fault_plane("")
    assert other["res"] == ("ok", baseline[SOAK_PROMPTS[0]])
    assert _ask(server, "after the torn stream")[0] == "ok"
    assert sched.thread.is_alive() and not any(sched.lanes)
    assert sched.kv.debug()["lanes"] == {}
    sched.kv.check()


def test_failed_admission_releases_pages(server):
    """A prefill that keeps failing on an intact pool fails its job with a
    retryable error once the retries are spent, and releases the pages its
    match retained."""
    sched = server.state.scheduler
    prompt = "leak check conversation " * 8
    assert _ask(server, prompt)[0] == "ok"  # publish a reusable prefix
    prompt2 = prompt + " plus an unpublished suffix to prefill"
    engine = server.state.engine
    real, calls = engine.prefill_lane_chunk, []

    def boom(*a, **k):
        calls.append(1)
        raise RuntimeError("injected admission failure")

    engine.prefill_lane_chunk = boom
    try:
        with _quoted_retry_after(server.state) as quoted:
            res = _ask(server, prompt2)
    finally:
        engine.prefill_lane_chunk = real
    assert res[0] == "error" and len(calls) == 1 + sched.retry_max
    _, code, err, retry_after = res
    assert code == 503 and err["retryable"] is True
    assert len(quoted) == 1 and quoted[0] >= 1 and retry_after == str(quoted[0]), quoted
    assert not sched.admitting and sched.kv.debug()["lanes"] == {}
    sched.kv.check()
    assert _ask(server, prompt2)[0] == "ok"


def test_queue_full_shed_ladder_and_bad_priority(server):
    """With the queue at depth 2 (two sentinels, the scheduler held between
    ticks), normal and low requests shed with 429 and the predicted
    Retry-After (at least 1); high rides out twice the depth. A priority
    outside the ladder answers 400."""
    state, sched = server.state, server.state.scheduler
    shed0 = dict(state.shed)
    state.max_queue_depth = 2
    try:
        with _scheduler_held(sched):
            with sched.cv:
                sched.pending.extend([object(), object()])
            try:
                retry = state.predicted_retry_after()
                assert retry >= 1
                for priority in ("normal", "low"):
                    res = _ask(server, "shed me", priority=priority)
                    assert res[0] == "error" and res[1] == 429, res
                    assert "queue_full" in res[2]["message"] and res[2]["retryable"] is True
                    assert res[3] == str(res[2]["retry_after_s"]) == str(retry)
                assert state.admission_decision("high") is None
                assert state.admission_decision("low") == ("queue_full", retry)
                with sched.cv:
                    sched.pending.pop()
                assert state.admission_decision("low") == (
                    "queue_full", state.predicted_retry_after())
                assert state.admission_decision("normal") is None
            finally:
                with sched.cv:
                    sched.pending.clear()
    finally:
        state.max_queue_depth = 0
    assert state.shed == dict(shed0, queue_full=shed0.get("queue_full", 0) + 2)
    assert _health(server)["resilience"]["shed"] == state.shed
    res = _ask(server, "hi", priority="vip")
    assert res[0] == "error" and res[1] == 400
    assert _ask(server, "shed me no more", priority="low")[0] == "ok"


def test_drain(files):
    """POST /v1/drain while a stream is in flight: new requests answer 503
    with Retry-After 5, /v1/health says draining, the stream runs to its
    end, ``drained`` is set, and a second drain only reports."""
    srv = _serve(*files, batch_size=2)
    state, sched = srv.state, srv.state.scheduler
    started, out = threading.Event(), {}

    def streamer():
        req = urllib.request.Request(
            _url(srv) + "/v1/chat/completions", method="POST",
            data=json.dumps({"messages": [{"role": "user", "content": "drain survivor"}],
                             "max_tokens": 24, "temperature": 0, "stream": True}).encode())
        chunks = []
        with urllib.request.urlopen(req, timeout=LIMIT) as r:
            for raw in r:
                chunks.append(raw.decode())
                if "data: {" in chunks[-1]:
                    started.set()
        out["raw"] = "".join(chunks)

    t = threading.Thread(target=streamer)
    t.start()
    try:
        assert started.wait(timeout=LIMIT), "the stream never started"
        with _scheduler_held(sched):  # the stream is still in flight
            body = json.loads(_post(_url(srv), "/v1/drain"))
            assert body["status"] == "draining" and body["in_flight"] == 1
            assert not body["drained"]
            health = _health(srv)
            assert health["status"] == "draining" and health["draining_since_unix"]
            res = _ask(srv, "too late")
            assert res[0] == "error" and res[1] == 503 and res[3] == "5"
            assert "draining" in res[2]["message"] and res[2]["retryable"] is True
        t.join(timeout=LIMIT)
        assert not t.is_alive()
        assert out["raw"].rstrip().endswith("data: [DONE]") and '"error"' not in out["raw"]
        assert state.drained.wait(timeout=LIMIT), "the drain never completed"
        again = json.loads(_post(_url(srv), "/v1/drain"))
        assert again["status"] == "draining" and again["drained"] and again["in_flight"] == 0
        assert state.shed == {"draining": 1}
    finally:
        srv.shutdown()
        srv.server_close()


# -- park/resume, speculation and int8 under recovery ---------------------------


def _state(files, **kw):
    eng = InferenceEngine(files[0], dtype=torch.float32, temperature=0.0, seed=3, device="cpu",
                          batch_size=kw.pop("batch_size", 2), kv_dtype=kw.pop("kv_dtype", None))
    return api.ApiState(eng, Tokenizer(files[1]), lane_block_size=4, admission_chunk=16,
                        kv_page_size=8, retry_backoff_ms=0, kv_native=True, **kw)


def _drain_job(job):
    deltas = []
    while True:
        kind, payload = job.events.get(timeout=LIMIT)
        if kind == "delta":
            deltas.append(payload)
        elif kind == "done":
            return "".join(deltas), payload
        else:
            raise AssertionError(f"job errored: {payload}")


def _greedy(content, max_tokens):
    return api.InferenceParams(messages=[api.ChatMessage(role="user", content=content)],
                               temperature=0.0, max_tokens=max_tokens, stream=True)


@pytest.mark.parametrize("speculation", ["off", "shared"])
def test_park_resume_equals_solo(files, speculation):
    """Six streams on two lanes with max_streams 6: streams park for the
    queued ones and resume through the radix tree; each answer equals its
    solo run."""
    state = _state(files, max_streams=6, speculation=speculation)
    sched = state.scheduler
    try:
        solo = [_drain_job(sched.submit(_greedy(p, 24))) for p in SOAK_PROMPTS]
        assert sched.parks == 0
        jobs = [sched.submit(_greedy(p, 24)) for p in SOAK_PROMPTS]
        assert [_drain_job(j) for j in jobs] == solo
        assert sched.parks >= 1 and sched.resumes == sched.parks
        assert sched._n_parked == 0 and not sched.pending
        # a resume adopts the published whole pages and re-prefills the tail
        assert sched.resume_reused_tokens > 0
        assert sched.resume_prefill_tokens < sched.resumes * state.kv_manager.page_size
        state.kv_manager.check()
    finally:
        sched.stop()


def test_poison_recovery_under_shared_equals_off(files):
    off, shared = _state(files), _state(files, speculation="shared")
    try:
        want = _drain_job(off.scheduler.submit(_greedy(NL, 40)))
        faults.set_fault_plane("dispatch:op=decode_lanes:nth=2:kind=poison,"
                               "dispatch:op=verify_lanes:nth=2:kind=poison")
        got = _drain_job(shared.scheduler.submit(_greedy(NL, 40)))
        faults.set_fault_plane("")
        sched = shared.scheduler
        assert got == want
        assert sched.recoveries >= 1 and sched.lanes_recovered == sched.recoveries
        assert sched.spec_verify_dispatches > 0 and not sched.drafters
        shared.kv_manager.check()
    finally:
        off.scheduler.stop()
        shared.scheduler.stop()


def test_poison_recovery_on_int8_pool(files):
    state = _state(files, kv_dtype="int8")
    sched = state.scheduler
    try:
        want = _drain_job(sched.submit(_greedy(NL, 20)))
        faults.set_fault_plane("dispatch:op=decode_lanes:nth=2:kind=poison")
        got = _drain_job(sched.submit(_greedy(NL, 20)))
        assert got == want and sched.lanes_recovered == 1
        state.kv_manager.check()
    finally:
        sched.stop()


# -- the knobs ------------------------------------------------------------------

ENVS = [{}, {"DLLAMA_RETRY_MAX": "0", "DLLAMA_RETRY_BACKOFF_MS": "9",
             "DLLAMA_MAX_QUEUE_DEPTH": "4", "DLLAMA_MAX_STREAMS": "6"}]


@pytest.mark.parametrize("env", ENVS, ids=["defaults", "env"])
@pytest.mark.parametrize("args", [(None, None, None, None), (2, 1, 3, 5)], ids=["none", "flags"])
def test_knobs_match_jax(monkeypatch, env, args):
    for name in ("DLLAMA_RETRY_MAX", "DLLAMA_RETRY_BACKOFF_MS", "DLLAMA_MAX_QUEUE_DEPTH",
                 "DLLAMA_MAX_STREAMS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    *res, streams = args
    assert api.resolve_resilience_knobs(*res) == japi.resolve_resilience_knobs(*res)
    assert api.resolve_stream_knobs(streams) == japi.resolve_stream_knobs(streams)
    flags = [] if streams is None else [
        "--retry-max", str(res[0]), "--retry-backoff-ms", str(res[1]), "--max-queue-depth",
        str(res[2]), "--max-streams", str(streams), "--faults", "dispatch:nth=2"]
    a = api.build_parser().parse_args(["--model", "m", "--tokenizer", "t", *flags])
    assert (a.retry_max, a.retry_backoff_ms, a.max_queue_depth, a.max_streams) == (
        *res, streams)
    assert a.faults == (None if streams is None else "dispatch:nth=2")
