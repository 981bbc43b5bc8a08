"""The port's serialized server (``--batch-size 1``, the JAX CLI's default:
one request at a time under the engine lock, with the `NaiveCache`) on CPU
against the JAX package's batch-1 server over the same tiny Q40 model and
tokenizer (tests/test_api_server.py's files), f32: the twins of that file's
serialized-path tests. Greedy completions, streamed and not, carry the JAX
server's bytes; a continuing conversation reuses the cached prefix the JAX
server reuses; a seeded sampled request repeats (within each server: torch
cannot replay JAX's PRNG); ``stop`` as a string and as more strings than
EOS ids; an overflowing prompt still ends its stream with an error event
and ``[DONE]``; a failed dispatch answers 500, moves the cache epoch and
clears the NaiveCache, and the next request equals a clean one; a
``resume_tokens`` request answers 400 on both servers; `main` serves with
no ``--batch-size``.
"""

import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import pytest
import torch

from dllama_tpu.formats import FloatType
from dllama_tpu.runtime import api_server as japi
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu.tokenizer import Tokenizer as JTokenizer
from dllama_tpu_torch.runtime import api_server as api
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.tokenizer import Tokenizer

from helpers import make_tiny_model, make_tiny_tokenizer

CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=384)
LIMIT = 300  # seconds any one request may take


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("single")
    mp, tp_ = str(d / "m.m"), str(d / "t.t")
    make_tiny_model(mp, weight_type=FloatType.Q40, cfg=CFG)
    # the tokenizer padded to the model's vocab: a sampled id past the
    # tokenizer's 271 entries answers 400 on both servers
    make_tiny_tokenizer(tp_, chat_template="<|start_header_id|>", pad_to=CFG["vocab_size"])
    return mp, tp_


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _port_server(files):
    eng = InferenceEngine(files[0], dtype=torch.float32, temperature=0.0, seed=3, device="cpu")
    return api.serve(eng, Tokenizer(files[1]), host="127.0.0.1", port=0)


def _jax_server(files):
    tok = JTokenizer(files[1])
    eng = JEngine(files[0], tokenizer=tok, tp=1, dtype=jnp.float32, temperature=0.0, seed=3)
    return japi.serve(eng, tok, host="127.0.0.1", port=0)


@pytest.fixture(scope="module")
def servers(files):
    """(port url, JAX url, port server), both batch 1."""
    srv, jsrv = _port_server(files), _jax_server(files)
    yield _start(srv), _start(jsrv), srv
    for s in (srv, jsrv):
        s.shutdown()
        s.server_close()


def _post(url, payload):
    req = urllib.request.Request(url + "/v1/chat/completions", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=LIMIT)


def _json(url, payload):
    with _post(url, payload) as r:
        return json.loads(r.read())


def _events(raw):
    return [json.loads(line[len("data: "):]) for line in raw.splitlines()
            if line.startswith("data: ") and line != "data: [DONE]"]


def _stream_text(raw):
    return "".join(e["choices"][0]["delta"]["content"] for e in _events(raw)
                   if "choices" in e and e["choices"][0]["finish_reason"] is None)


def _both(servers, payload):
    url, jurl, _ = servers
    return _json(url, payload), _json(jurl, payload)


def test_naive_cache_unit():
    """The same pushes and resolves on the port's and the JAX NaiveCache:
    a strict extension resolves to its delta and the cached end position, a
    mismatch clears, ``probe`` changes nothing."""
    caches = (api.NaiveCache(), japi.NaiveCache())
    outs = []
    for c, mod in zip(caches, (api, japi)):
        m1 = mod.ChatMessage("user", "a")
        c.push(mod.NaiveCacheItem(5, m1))
        c.push(mod.NaiveCacheItem(9, mod.ChatMessage("assistant", "r")))
        ext = [m1, mod.ChatMessage("assistant", "r"), mod.ChatMessage("user", "b")]
        out = [c.probe(ext), c.probe(ext[:2]), len(c.items)]
        msgs, pos = c.resolve_delta_prompt(ext)
        out.append(([m.content for m in msgs], pos))
        msgs, pos = c.resolve_delta_prompt([mod.ChatMessage("user", "x"),
                                            mod.ChatMessage("user", "y")])
        out.append(([m.content for m in msgs], pos, len(c.items)))
        out.append(c.resolve_delta_prompt([m1])[1])
        outs.append(out)
    assert outs[0] == outs[1]
    assert outs[0] == [9, 0, 2, (["b"], 9), (["x", "y"], 0, 0), 0]


def test_chat_completion(servers):
    payload = {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 8,
               "temperature": 0}
    data, jdata = _both(servers, payload)
    assert data["object"] == "chat.completion"
    choice = data["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert choice["finish_reason"] in ("stop", "length")
    usage = data["usage"]
    assert usage["prompt_tokens"] > 0 and usage["completion_tokens"] <= 8
    assert usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"]
    assert choice["message"]["content"] == jdata["choices"][0]["message"]["content"]
    assert usage == jdata["usage"] and choice["finish_reason"] == jdata["choices"][0][
        "finish_reason"]
    assert data["dllama"]["lane"] is None and data["dllama"]["ttft_ms"] is not None


def test_chat_completion_streaming(servers):
    url, jurl, _ = servers
    payload = {"messages": [{"role": "user", "content": "hello world"}], "max_tokens": 6,
               "temperature": 0, "stream": True}
    raws = []
    for u in (url, jurl):
        with _post(u, payload) as r:
            assert r.headers["Content-Type"].startswith("text/event-stream")
            raws.append(r.read().decode())
    raw = raws[0]
    events = _events(raw)
    assert raw.rstrip().endswith("data: [DONE]") and events
    assert events[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    for e in events[:-1]:
        assert e["object"] == "chat.completion.chunk"
        assert e["choices"][0]["delta"]["role"] == "assistant"
    assert _stream_text(raw) == _stream_text(raws[1])
    assert (events[-1]["choices"][0]["finish_reason"]
            == _events(raws[1])[-1]["choices"][0]["finish_reason"])
    # the stream's text is the non-stream answer's
    plain = _json(url, dict(payload, stream=False))
    assert plain["choices"][0]["message"]["content"] == _stream_text(raw)


def test_naive_cache_reuses_prefix(servers):
    """A continuation prefills only its new messages from the cached end
    position: the same prompt tokens, reused prefix and answer as the JAX
    server's."""
    msgs = [{"role": "user", "content": "first question"}]
    first, jfirst = _both(servers, {"messages": msgs, "max_tokens": 4, "temperature": 0})
    assert first["choices"][0]["message"]["content"] == jfirst["choices"][0]["message"][
        "content"]
    reply = first["choices"][0]["message"]["content"]
    msgs2 = msgs + [{"role": "assistant", "content": reply},
                    {"role": "user", "content": "second question"}]
    second, jsecond = _both(servers, {"messages": msgs2, "max_tokens": 4, "temperature": 0})
    assert second["usage"]["prompt_tokens"] < first["usage"]["prompt_tokens"] + 40
    assert second["usage"] == jsecond["usage"]
    assert second["choices"][0]["message"] == jsecond["choices"][0]["message"]
    # the continuation starts where the first turn's rows end: its prompt,
    # its completion and the cut's KV-only step
    n = first["usage"]["prompt_tokens"] + first["usage"]["completion_tokens"]
    assert second["dllama"]["reused_prefix_tokens"] == n
    assert jsecond["dllama"]["reused_prefix_tokens"] == n


def test_seed_param_deterministic(servers):
    url, jurl, _ = servers
    payload = {"messages": [{"role": "user", "content": "tell me"}], "max_tokens": 6,
               "temperature": 0.9, "seed": 42}
    for u in (url, jurl):
        a = _json(u, payload)["choices"][0]["message"]["content"]
        b = _json(u, payload)["choices"][0]["message"]["content"]
        assert a == b


def test_stop_as_string_and_mismatched_count(servers):
    for payload in ({"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
                     "temperature": 0, "stop": "###"},
                    {"messages": [{"role": "user", "content": "hi again"}], "max_tokens": 4,
                     "temperature": 0, "stop": ["###", "END", "@@@"]}):
        data, jdata = _both(servers, payload)
        assert data["object"] == "chat.completion"
        assert data["choices"][0]["message"] == jdata["choices"][0]["message"]


def test_stream_error_still_terminates(servers):
    """A prompt past seq_len raises inside the completion: the stream
    still carries an error event and ends in [DONE]; the non-stream request
    answers 400 (the client's error), as the JAX server's do."""
    url, jurl, _ = servers
    big = {"messages": [{"role": "user", "content": "x" * 4000}]}
    for u in (url, jurl):
        with _post(u, dict(big, stream=True)) as r:
            raw = r.read().decode()
        assert '"error"' in raw and raw.rstrip().endswith("data: [DONE]")
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(u, big)
        assert err.value.code == 400 and "error" in json.loads(err.value.read())


def test_resume_tokens_refused(servers):
    """``resume_tokens`` needs the lanes' resume admission: 400 on both
    serialized servers."""
    url, jurl, _ = servers
    payload = {"messages": [], "resume_tokens": [1, 2, 3], "max_tokens": 4}
    msgs = []
    for u in (url, jurl):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(u, payload)
        assert err.value.code == 400
        msgs.append(json.loads(err.value.read())["error"]["message"])
    assert msgs[0] == msgs[1]


def test_single_stream_crash_recovery(files):
    """An engine error inside a decode block's dispatch answers 500 with
    its message; the dispatch's guard zeroed the slab and moved
    ``cache_epoch``, so the NaiveCache is cleared; the next request equals
    the clean one (nothing resumed from the zeroed rows)."""
    srv = _port_server(files)
    url = _start(srv)
    state, engine = srv.state, srv.state.engine
    payload = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 6,
               "temperature": 0}
    try:
        ok1 = _json(url, payload)
        assert ok1["choices"][0]["message"]["content"] is not None
        assert state.naive_cache.items
        run = engine.graphs.run

        def poisoned(key, step):
            run(key, step)
            if key[0] == "block":
                raise RuntimeError("injected dispatch failure")

        engine.graphs.run = poisoned
        epoch0 = engine.cache_epoch
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(url, payload).read()
        finally:
            engine.graphs.run = run
        assert err.value.code == 500
        assert "injected" in json.loads(err.value.read())["error"]["message"]
        assert engine.cache_epoch == epoch0 + 1 and not state.naive_cache.items
        assert all(not t.any() for t in engine.cache.values())
        ok2 = _json(url, payload)
        assert ok2["choices"][0]["message"]["content"] == ok1["choices"][0]["message"]["content"]
    finally:
        srv.shutdown()
        srv.server_close()


def test_main_serves_batch_size_1(files, monkeypatch, capsys):
    """`main` with no ``--batch-size`` builds the serialized server (no
    scheduler, no KV manager), as the JAX CLI's default does; ``--kv-native``
    takes 0 and 1 and defaults to None (the environment, then slab)."""
    mp, tp_ = files
    built = []
    serve = api.serve

    def recording(*a, **kw):
        srv = serve(*a, **kw)
        srv.serve_forever = lambda: None  # main returns and closes the server
        built.append((srv, kw))
        return srv

    monkeypatch.setattr(api, "serve", recording)
    monkeypatch.setattr(api, "_install_drain_handler", lambda server: None)
    api.main(["--model", mp, "--tokenizer", tp_, "--device", "cpu", "--dtype", "f32",
              "--port", "0", "--host", "127.0.0.1"])
    (srv, kw), = built
    assert srv.state.scheduler is None and srv.state.kv_manager is None
    assert srv.state.engine.batch_size == 1 and kw["kv_native"] is None
    assert "Server URL" in capsys.readouterr().out
    parser = api.build_parser()
    base = ["--model", mp, "--tokenizer", tp_]
    assert parser.parse_args(base).kv_native is None
    assert parser.parse_args(base + ["--kv-native", "0"]).kv_native == 0
    assert parser.parse_args(base + ["--kv-native", "1"]).kv_native == 1
    with pytest.raises(SystemExit):
        parser.parse_args(base + ["--kv-native", "2"])
