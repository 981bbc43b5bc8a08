"""The port's lane server (dllama_tpu_torch.runtime.api_server) on CPU
against the JAX lane server, over the same tiny Q40 model and tokenizer
(tests/test_api_server.py's lane-server files): greedy completions, streamed
and not, carry the same content; concurrent requests complete and equal
their solo answers; a continuing conversation adopts its stored prefix;
an engine error fails the in-flight request and the server keeps
serving."""

import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import pytest
import torch

from dllama_tpu.formats import FloatType
from dllama_tpu.runtime.api_server import serve as jserve
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu.tokenizer import Tokenizer as JTokenizer
from dllama_tpu_torch.runtime.api_server import ApiState, serve
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.tokenizer import Tokenizer

from helpers import make_tiny_model, make_tiny_tokenizer

CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=384)
PROMPTS = ["hello", "the quick brown", "zebra"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_api")
    mp, tp_ = str(d / "m.m"), str(d / "t.t")
    make_tiny_model(mp, weight_type=FloatType.Q40, cfg=CFG)
    make_tiny_tokenizer(tp_, chat_template="<|start_header_id|>")
    return mp, tp_


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def servers(files):
    mp, tp_ = files
    jtok = JTokenizer(tp_)
    jeng = JEngine(mp, tokenizer=jtok, tp=1, dtype=jnp.float32, temperature=0.0, seed=3,
                   batch_size=3)
    jsrv = jserve(jeng, jtok, host="127.0.0.1", port=0)
    eng = InferenceEngine(mp, dtype=torch.float32, temperature=0.0, seed=3, device="cpu",
                          batch_size=3)
    srv = serve(eng, Tokenizer(tp_), host="127.0.0.1", port=0, kv_page_size=8, kv_native=True)
    yield _start(jsrv), _start(srv), srv
    for s in (jsrv, srv):
        s.shutdown()
        s.server_close()


def _post(url, payload):
    req = urllib.request.Request(url + "/v1/chat/completions", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read().decode()


def _ask(url, content, **kw):
    body = json.loads(_post(url, {"messages": [{"role": "user", "content": content}],
                                  "max_tokens": 10, "temperature": 0, **kw}))
    return body


def _stream_text(raw):
    text, reason = "", None
    for line in raw.split("\r\n"):
        if not line.startswith("data: {"):
            continue
        choice = json.loads(line[6:])["choices"][0]
        if choice["finish_reason"] is None:
            text += choice["delta"]["content"]
        else:
            reason = choice["finish_reason"]
    return text, reason


@pytest.mark.parametrize("prompt", PROMPTS)
def test_completion_matches_jax_lane_server(servers, prompt):
    jurl, url, _ = servers
    want, got = _ask(jurl, prompt), _ask(url, prompt)
    assert got["choices"][0]["message"] == want["choices"][0]["message"]
    assert got["choices"][0]["finish_reason"] == want["choices"][0]["finish_reason"]
    assert got["usage"] == want["usage"]


def test_stream_matches_jax_lane_server(servers):
    jurl, url, _ = servers
    payload = {"messages": [{"role": "user", "content": "hi there"}], "max_tokens": 8,
               "temperature": 0, "stream": True}
    want, got = _post(jurl, payload), _post(url, payload)
    assert got.rstrip().endswith("data: [DONE]")
    assert _stream_text(got) == _stream_text(want)
    assert _stream_text(got)[1] in ("stop", "length")


def test_concurrent_requests_equal_solo(servers):
    _, url, srv = servers
    solo = [_ask(url, p)["choices"][0]["message"]["content"] for p in PROMPTS]
    results, errors = [None] * len(PROMPTS), []

    def worker(i):
        try:
            results[i] = _ask(url, PROMPTS[i])["choices"][0]["message"]["content"]
        except Exception as e:  # pragma: no cover
            errors.append((i, e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors and results == solo
    srv.state.kv_manager.check()


def test_continuation_adopts_stored_prefix(servers):
    _, url, srv = servers
    kv = srv.state.kv_manager
    first = _ask(url, "tell me about zebras")
    hits = kv.hits
    msgs = [{"role": "user", "content": "tell me about zebras"},
            {"role": "assistant", "content": first["choices"][0]["message"]["content"]},
            {"role": "user", "content": "and lions"}]
    body = json.loads(_post(url, {"messages": msgs, "max_tokens": 4, "temperature": 0}))
    assert body["dllama"]["reused_prefix_tokens"] > 0
    assert kv.hits == hits + 1
    kv.check()


def test_seeded_sampled_request_repeats(servers):
    _, url, _ = servers
    a = _ask(url, "zebra", temperature=0.9, seed=7, max_tokens=12)
    b = _ask(url, "zebra", temperature=0.9, seed=7, max_tokens=12)
    assert a["choices"][0]["message"] == b["choices"][0]["message"]


def test_models_and_health(servers):
    _, url, _ = servers
    with urllib.request.urlopen(url + "/v1/models") as r:
        assert json.loads(r.read())["data"][0]["object"] == "model"
    with urllib.request.urlopen(url + "/v1/health") as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["lanes"]["total"] == 3


def test_single_stream_server_path_is_refused(files):
    """The batch-1 server serves one request at a time with no scheduler;
    what it refuses is a ``resume_tokens`` request (400: a resume needs
    the lanes), as the JAX server's serialized path does."""
    eng = InferenceEngine(files[0], dtype=torch.float32, temperature=0.0, device="cpu")
    srv = serve(eng, Tokenizer(files[1]), host="127.0.0.1", port=0)
    try:
        assert isinstance(srv.state, ApiState) and srv.state.scheduler is None
        url = _start(srv)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url, {"messages": [], "resume_tokens": [1, 2, 3], "max_tokens": 4})
        assert err.value.code == 400
        assert "lane scheduler" in json.loads(err.value.read())["error"]["message"]
        assert _ask(url, "hello")["choices"][0]["finish_reason"] in ("stop", "length")
    finally:
        srv.shutdown()
        srv.server_close()


def test_engine_error_fails_in_flight_and_keeps_serving(servers):
    """An engine error in a decode block that outlasts the scheduler's
    retries (the pool intact: the epoch did not move) fails the in-flight
    request with the JAX server's retryable error payload (503 and
    Retry-After), and the scheduler goes on serving."""
    _, url, srv = servers
    engine, sched = srv.state.engine, srv.state.scheduler
    inner, calls = engine.decode_lanes, []

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) <= 1 + sched.retry_max:
            raise RuntimeError("injected decode failure")
        return inner(*args, **kw)

    engine.decode_lanes = failing
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _ask(url, "hello")
        assert err.value.code == 503 and err.value.headers["Retry-After"] == "1"
        assert len(calls) == 1 + sched.retry_max
        body = json.loads(err.value.read())
        assert body["error"] == {"message": "injected decode failure", "retryable": True}
        assert _ask(url, "hello")["choices"][0]["finish_reason"] in ("stop", "length")
    finally:
        engine.decode_lanes = inner
    srv.state.kv_manager.check()
    assert not srv.state.kv_manager.debug()["lanes"]
