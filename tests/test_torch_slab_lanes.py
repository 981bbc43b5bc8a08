"""The port's slab lanes (``kv_native`` off, the JAX engine's and server's
default) on CPU against the JAX package's slab lanes, over tiny ``.m``
files, f32 unless a case says otherwise:

* the engine: `kv_publish` / `kv_adopt` pages and rows against the JAX
  engine's (f32 and int8), greedy streams after an adoption equal the JAX
  engine's and a fresh prefill's; slab `prefill_lane_chunk`,
  `decode_lanes` and `verify_lanes` at mixed positions with a parked lane
  against the JAX slab lanes (rows, tokens, argmax grids); slab lanes equal
  pool-native lanes and single-stream runs; `ReplayingGraphs` equal eager,
  and the rehearsal writes only padding rows;
* the manager in slab mode against the JAX manager: the flows of
  tests/test_kv_pool.py's dedup/COW/eviction, publish-failure narrowing
  and publish-pressure pinning tests give the same accounting;
* the server: the slab lane server's bytes equal the JAX lane server's on
  one script; a decode poison leaves the pool's epoch and the answers as
  they were, a publish poison the slab; park/resume and ``--speculation
  shared`` answer as the solo runs do; a page size < 0 serves with no pool;
  `resolve_kv_knobs` equals the JAX one.

Tolerances: K/V rows and pool pages in f32 within `TOL` (atol and rtol
1e-5: the same arithmetic in another sum order, as tests/test_torch_lanes.py
and tests/test_torch_kv_int8.py hold f32 values); int8 pages dequantized
within one quantization step of their row (its f32 scale) plus `TOL`, since
f32 rows that differ in the last bits may round to neighbouring int8 values;
greedy streams, argmax grids and server bytes equal.
"""

import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats import FloatType
from dllama_tpu.formats.model_file import LlmArch
from dllama_tpu.kv.manager import PagedKVManager as JManager
from dllama_tpu.runtime import api_server as japi
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu.tokenizer import Tokenizer as JTokenizer
from dllama_tpu_torch.kv.manager import PagedKVManager
from dllama_tpu_torch.ops.kv_cache import QuantKV
from dllama_tpu_torch.runtime import api_server as api
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.faults import set_fault_plane
from dllama_tpu_torch.tokenizer import Tokenizer

from helpers import make_tiny_model, make_tiny_tokenizer
from test_torch_graphs import FakeGraphs, ReplayingGraphs

TOL = dict(atol=1e-5, rtol=1e-5)
CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
           vocab_size=256, seq_len=64)
SERVE_CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
                 vocab_size=288, seq_len=384)
ARCHS = {"llama": LlmArch.LLAMA, "qwen3": LlmArch.QWEN3, "qwen3_moe": LlmArch.QWEN3_MOE}
PROMPT = [2 + (i * 7) % 250 for i in range(23)]
PROMPT2 = [5, 9, 13, 17, 21, 25, 29]
LIMIT = 120  # seconds any one request may take
NL = "walk through how the scheduler shares computed prefixes, step by step"


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("slab_lanes")
    out = {}
    for name, arch in ARCHS.items():
        out[name] = str(d / f"{name}.m")
        make_tiny_model(out[name], arch=arch, cfg=None if name == "qwen3_moe" else CFG)
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("slab_server")
    mp, tp_ = str(d / "m.m"), str(d / "t.t")
    make_tiny_model(mp, weight_type=FloatType.Q40, cfg=SERVE_CFG)
    make_tiny_tokenizer(tp_, chat_template="<|start_header_id|>")
    return mp, tp_


def _port(mp, batch_size=3, **kw):
    return InferenceEngine(mp, dtype=torch.float32, temperature=0.0, device="cpu",
                           batch_size=batch_size, **kw)


def _jax(mp, batch_size=3, **kw):
    return JEngine(mp, tp=1, dtype=jnp.float32, temperature=0.0, batch_size=batch_size, **kw)


def _np(x):
    """A cache or pool leaf as numpy: values, or (values, scales) for int8."""
    if isinstance(x, QuantKV):
        return np.asarray(x.q), np.asarray(x.s)
    if hasattr(x, "q") and hasattr(x, "s"):  # the JAX QuantKV
        return np.asarray(x.q), np.asarray(x.s)
    return np.asarray(x)


def _close(got, want):
    """f32 leaves within TOL; int8 leaves dequantized within one step of
    their row's scale plus TOL, scales within TOL."""
    if isinstance(want, tuple):
        (gq, gs), (wq, ws) = got, want
        np.testing.assert_allclose(gs, ws, **TOL)
        np.testing.assert_allclose(gq * gs, wq * ws, atol=float(ws.max()) + 1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def _sel(leaf, index):
    """``leaf[index]`` of a numpy leaf or a (values, scales) pair."""
    if isinstance(leaf, tuple):
        return tuple(x[index] for x in leaf)
    return leaf[index]


def _decode(e, lane, token, pos, steps, temperature=0.0, seed=None):
    """One lane's stream decoded in blocks of 4, the other lanes parked."""
    b = e.batch_size
    toks, t, p = [], token, pos
    active = [i == lane for i in range(b)]
    while len(toks) < steps:
        n = min(4, steps - len(toks))
        rows = e.decode_lanes([t if i == lane else 0 for i in range(b)],
                              [p if i == lane else 0 for i in range(b)], n, active,
                              [temperature] * b, [0.9] * b,
                              seeds=[seed if i == lane else None for i in range(b)])
        toks.extend(r[lane] for r in rows)
        t, p = toks[-1], p + n
    return toks


# -- the engine -----------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_publish_adopt_matches_jax(models, kv_dtype):
    """tests/test_kv_pool.py's publish -> adopt round trip on both engines:
    lane 0's five published pages equal the JAX engine's; adopted into lane
    1 with the unmatched fills chunk-prefilled, its rows equal the JAX
    lane's and its greedy stream the JAX one's and a fresh prefill's; a
    seeded sampled stream after the adoption repeats the fresh one (the
    JAX test's claim, within the port: torch cannot replay JAX's PRNG); the
    pool survives a reset of the slab."""
    kw = {"kv_dtype": kv_dtype} if kv_dtype else {}
    e, je = _port(models["llama"], 2, **kw), _jax(models["llama"], 2, **kw)
    for eng in (e, je):
        eng.init_kv_pool(4, n_pages=16)
    assert not e.kv_native and e.lane_cache is not None
    pages = [1, 2, 3, 4, 5]
    fills = PROMPT[:-1]
    for eng in (e, je):
        eng.prefill_lane(0, PROMPT, pos0=0)
        eng.kv_publish(0, pages, start_page=0)
    for name in ("k", "v"):
        _close(_sel(_np(e.kv_pool[name]), np.s_[:, 1:6]),
               _sel(_np(je.kv_pool[name]), np.s_[:, 1:6]))
    streams = []
    for eng in (e, je):
        eng.reset()
        eng.kv_adopt(1, pages)
        cur = 20
        while cur < len(fills):
            cur += eng.prefill_lane_chunk(1, fills[cur:], cur, budget=8)
    for name in ("k", "v"):
        _close(_sel(_np(e.lane_cache[name]), np.s_[:, 1, :, :22]),
               _sel(_np(je.cache[name]), np.s_[:, 1, :, :22]))
    for eng in (e, je):
        streams.append(_decode(eng, 1, PROMPT[-1], 22, 10))
    assert streams[0] == streams[1]
    e.reset()
    e.prefill_lane(1, PROMPT)
    assert _decode(e, 1, PROMPT[-1], 22, 10) == streams[0]
    assert e.kv_adopt_pages == 5 and e.kv_publish_pages == 5
    # seeded sampled streams: adopted (whole pages, no suffix) equals fresh
    p21 = PROMPT[:21]
    e.reset()
    e.prefill_lane(0, p21)
    fresh = _decode(e, 0, p21[-1], 20, 8, temperature=0.8, seed=7)
    e.reset()
    e.kv_adopt(0, pages)
    assert _decode(e, 0, p21[-1], 20, 8, temperature=0.8, seed=7) == fresh
    e.reset()
    e.kv_adopt(1, pages)
    assert _decode(e, 1, p21[-1], 20, 8, temperature=0.8, seed=7) == fresh


def test_slab_lane_steps_match_jax(models):
    """Slab `prefill_lane_chunk`, `decode_lanes` and `verify_lanes` on three
    lanes, lanes 0 and 2 live at their own positions and lane 1 parked,
    against the JAX engine's slab lanes: the live lanes' rows within TOL,
    the tokens and the verify argmax grid equal; then lane 1 prefills a
    chunk beside them and the live lanes' rows do not move."""
    e, je = _port(models["llama"]), _jax(models["llama"])
    for eng in (e, je):
        eng.prefill_lane(0, PROMPT[:17])
        eng.prefill_lane(2, PROMPT2)
    pos, tok = [16, 0, 6], [PROMPT[16], 0, PROMPT2[-1]]
    active = [True, False, True]
    out = [eng.decode_lanes(tok, pos, 6, active) for eng in (e, je)]
    assert out[0] == out[1]
    assert all(row[1] == 0 for row in out[0])

    def live_rows(eng, cache):
        return [_sel(_np(cache[name]), np.s_[:, lane, :, :p + 6])
                for name in ("k", "v") for lane, p in ((0, 16), (2, 6))]

    for got, want in zip(live_rows(e, e.lane_cache), live_rows(je, je.cache)):
        _close(got, want)
    pos = [22, 0, 12]
    rows = [[out[0][-1][0], 7, 8, 9], [0, 0, 0, 0], [out[0][-1][2], 3, 4, 5]]
    grids = [eng.verify_lanes(rows, pos, active) for eng in (e, je)]
    assert grids[0] == grids[1] and grids[0][1] == [0, 0, 0, 0]
    assert e.lane_verify_steps == 1 and e.lane_decode_steps == 6
    before = [t.clone() for t in (e.lane_cache["k"][:, 0, :, :26], e.lane_cache["k"][:, 2, :, :16])]
    assert e.prefill_lane_chunk(1, PROMPT2[:-1], 0) == len(PROMPT2) - 1
    assert torch.equal(before[0], e.lane_cache["k"][:, 0, :, :26])
    assert torch.equal(before[1], e.lane_cache["k"][:, 2, :, :16])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_slab_lanes_equal_native_and_solo(models, arch):
    """Slab and pool-native lanes give the same greedy streams on ragged
    prompts, and each lane the single-stream path's."""
    prompts = [PROMPT[:9], PROMPT2, PROMPT[3:20]]
    slab, native = _port(models[arch]), _port(models[arch])
    native.init_kv_pool(4, native=True)
    want = native.generate_batch(prompts, max_steps=40, block_size=4)
    assert slab.generate_batch(prompts, max_steps=40, block_size=4) == want
    solo = _port(models[arch], 1)
    for p, w in zip(prompts, want):
        assert solo.generate(p, max_steps=40, block_size=4)[0] == w


def test_replayed_slab_lanes_equal_eager(models):
    """Graph replays (`ReplayingGraphs`: a key's first step replayed with the
    static buffers' new contents) of the slab lanes' prefill chunks, decode
    blocks and verify passes equal the eager engine; the rehearsal captures
    every bucket for every lane and both blocks, and writes only the lanes'
    padding rows."""
    eager, graphed = _port(models["llama"], 2), _port(models["llama"], 2)
    graphed.graphs = ReplayingGraphs()
    prompts = [PROMPT2, PROMPT[:19]]
    for eng in (eager, graphed):
        eng.lane_cache = None
        eng.rehearse_admission(8, spec_k=4)
    assert graphed.graphs.n_graphs > 0 and eager.graphs.n_graphs == 0
    assert graphed.generate_batch(prompts, 40) == eager.generate_batch(prompts, 40)
    rows = [[9, 1, 2], [0, 0, 0]]
    assert (graphed.verify_lanes(rows, [30, 0], [True, False])
            == eager.verify_lanes(rows, [30, 0], [True, False]))
    out = [eng.decode_lanes([3, 0], [33, 0], 8, [True, False], [0.8, 0.0], [0.9, 1.0],
                            seeds=[11, None]) for eng in (eager, graphed)]
    assert out[0] == out[1]

    e = _port(models["llama"], 2)
    e.prefill_lane(0, PROMPT)
    e.graphs = FakeGraphs()
    s = e.header.seq_len
    before = {k: t[:, :, :, :s].clone() for k, t in e.lane_cache.items()}
    e.rehearse_admission(8)
    for k, t in before.items():  # rows below seq_len are the lanes': untouched
        assert torch.equal(t, e.lane_cache[k][:, :, :, :s])
    assert set(e.graphs._graphs) == (
        {("lane_prefill", b, lane) for b in e.prefill_buckets for lane in range(2)}
        | {("lane_block", 8, False), ("lane_block", 8, True)})


# -- the manager in slab mode -----------------------------------------------------


def _dedup_cow_eviction_flow(kv, e):
    """tests/test_kv_pool.py::test_manager_dedup_cow_and_eviction's flow,
    its observations in order."""
    A = [10 + i for i in range(16)]
    obs = []
    e.prefill_lane(0, A + [9], pos0=0)
    obs.append(kv.publish(0, A))
    obs.append((kv.pool.stats().used, kv.tree.n_pages))
    e.prefill_lane(1, A + [9], pos0=0)
    obs.append(kv.publish(1, A))
    m, pages = kv.match(0, A + [9])
    obs.append((m, pages, kv.tree.match(A).pages, kv.pool.stats().shared))
    kv.adopt(0, pages)
    obs.append(kv.pool.stats().shared)
    B = A[:6] + [200, 201] + [210 + i for i in range(4)]
    e.prefill_lane(1, B + [9], pos0=0)
    cow0 = kv.pool.stats().cow_forks
    obs.append((kv.publish(1, B), kv.pool.stats().cow_forks - cow0))
    mb = kv.tree.match(B)
    obs.append((mb.n_tokens, mb.pages, kv.tree.match(A).pages))
    C = [230 + i for i in range(16)]  # in the vocab (JAX clamps an id past it)
    e.prefill_lane(1, C + [9], pos0=0)
    b_ev = kv.c_evictions.value
    obs.append((kv.publish(1, C), kv.c_evictions.value - b_ev))
    obs.append((kv.tree.match(A).n_tokens, kv.tree.match(B).n_tokens))
    kv.check()
    kv.release_lane(0)
    dbg = kv.debug()
    obs.append((kv.pool.stats().shared, dbg["pool"], dbg["radix"]["pages"]))
    kv.reset()
    obs.append((kv.pool.stats().used, kv.tree.n_pages))
    kv.check()
    return obs


def test_manager_dedup_cow_and_eviction_matches_jax(models):
    """Slab-mode dedup (a repeat publish stores nothing), a mid-page
    divergence forking one page, lane retains blocking eviction and the LRU
    eviction under pressure: the port's manager over the port's engine and
    the JAX manager over the JAX engine give the same observations, and the
    adopted rows are the pool's."""
    e, je = _port(models["llama"], 2), _jax(models["llama"], 2)
    kv, jkv = PagedKVManager(e, page_size=4, n_pages=10), JManager(je, page_size=4, n_pages=10)
    assert not kv.native
    obs = _dedup_cow_eviction_flow(kv, e)
    assert obs == _dedup_cow_eviction_flow(jkv, je)
    assert obs[0] == 4 and obs[2] == 0 and obs[5] == (2, 1) and obs[7][1] > 0
    assert e.kv_adopt_pages == 4


def _failure_flow(kv, e, monkeypatch, poison_epoch):
    """tests/test_kv_pool.py::test_manager_publish_failure_narrows_to_culprit's
    flow: a transient publish failure releases only its pages, a poisoning
    one (the pool's epoch moved) resets the accounting."""
    A = [10 + i for i in range(8)]
    e.prefill_lane(0, A + [9], pos0=0)
    obs = [kv.publish(0, A)]
    pa = kv.tree.match(A).pages
    used0 = kv.pool.stats().used

    def boom(*a, **k):
        raise RuntimeError("injected publish failure")

    monkeypatch.setattr(e, "kv_publish", boom)
    obs.append(kv.publish(0, [50 + i for i in range(8)]))
    obs.append((kv.tree.match(A).n_tokens, kv.tree.match(A).pages == pa,
                kv.pool.stats().used == used0))
    kv.check()

    def boom_poison(*a, **k):
        poison_epoch()
        raise RuntimeError("injected poisoning failure")

    monkeypatch.setattr(e, "kv_publish", boom_poison)
    obs.append(kv.publish(0, [90 + i for i in range(8)]))
    obs.append((kv.tree.n_pages, kv.pool.stats().used))
    kv.check()
    monkeypatch.undo()
    return obs


def test_manager_publish_failure_narrows_to_culprit_matches_jax(models, monkeypatch):
    e, je = _port(models["llama"], 2), _jax(models["llama"], 2)
    kv, jkv = PagedKVManager(e, page_size=4, n_pages=8), JManager(je, page_size=4, n_pages=8)

    def bump(eng):
        def go():
            eng.kv_pool_epoch += 1
        return go

    obs = _failure_flow(kv, e, monkeypatch, bump(e))
    assert obs == _failure_flow(jkv, je, monkeypatch, bump(je))
    assert obs == [2, 0, (8, True, True), 0, (0, 0)]
    assert kv.publish_skips == 2


class _StubEngine:
    """Host accounting only (tests/test_kv_pool.py's stub)."""

    kv_pool_epoch = 0

    def init_kv_pool(self, page_size, n_pages, native=False):
        return n_pages

    def kv_adopt(self, lane, pages):
        pass

    def kv_publish(self, lane, pages, start_page):
        pass

    def reset_kv_pool(self):
        pass


def test_publish_pressure_pins_matched_prefix_matches_jax():
    """A publish that extends a stored prefix under pool pressure must not
    evict that prefix's own leaf: the publish is skipped whole, the prefix
    keeps its pages, and a fitting publish works after; the same on the JAX
    manager."""
    def flow(kv):
        A = [10 + i for i in range(8)]
        obs = [kv.publish(0, A)]
        pa = kv.tree.match(A).pages
        obs.append(kv.publish(1, A + [60 + i for i in range(16)]))
        m = kv.tree.match(A)
        obs.append((m.n_tokens, m.pages == pa, kv.tree.match(A + [60]).n_tokens))
        kv.check()
        obs.append(kv.publish(0, [200 + i for i in range(8)]))
        kv.check()
        return obs

    obs = flow(PagedKVManager(_StubEngine(), page_size=4, n_pages=6))
    assert obs == flow(JManager(_StubEngine(), page_size=4, n_pages=6))
    assert obs == [2, 0, (8, True, 8), 2]


# -- the server -----------------------------------------------------------------


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _post(url, payload):
    req = urllib.request.Request(url + "/v1/chat/completions", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=LIMIT) as r:
        return json.loads(r.read())


def _ask(url, content, max_tokens=10, history=()):
    msgs = list(history) + [{"role": "user", "content": content}]
    return _post(url, {"messages": msgs, "max_tokens": max_tokens, "temperature": 0})


def _ask_many(url, prompts, max_tokens=10):
    out = [None] * len(prompts)

    def go(i):
        out[i] = _ask(url, prompts[i], max_tokens)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(LIMIT)
    return [o["choices"][0]["message"]["content"] for o in out]


def _health(url):
    with urllib.request.urlopen(url + "/v1/health", timeout=LIMIT) as r:
        return json.loads(r.read())


def _port_server(files, batch_size=3, **kw):
    eng = InferenceEngine(files[0], dtype=torch.float32, temperature=0.0, seed=3, device="cpu",
                          batch_size=batch_size)
    return api.serve(eng, Tokenizer(files[1]), host="127.0.0.1", port=0, **kw)


PROMPTS = [NL, NL + " with an example", "hello", "the quick brown fox"]


def _script(url):
    """Concurrent requests sharing a prefix, then a continuing conversation
    (a prefix hit): every content, in order."""
    out = _ask_many(url, PROMPTS)
    first = _ask(url, "tell me a story", 12)["choices"][0]["message"]["content"]
    hist = [{"role": "user", "content": "tell me a story"},
            {"role": "assistant", "content": first}]
    follow = _ask(url, "and then?", 8, hist)
    return out + [first, follow["choices"][0]["message"]["content"]], follow


@pytest.fixture(scope="module")
def slab_servers(files):
    mp, tp_ = files
    jtok = JTokenizer(tp_)
    jeng = JEngine(mp, tokenizer=jtok, tp=1, dtype=jnp.float32, temperature=0.0, seed=3,
                   batch_size=3)
    jsrv = japi.serve(jeng, jtok, host="127.0.0.1", port=0, kv_page_size=8)
    srv = _port_server(files, kv_page_size=8)
    yield _start(jsrv), _start(srv), srv
    for s in (jsrv, srv):
        s.shutdown()
        s.server_close()


def test_slab_lane_server_matches_jax(slab_servers):
    """The same script on the port's and the JAX lane server, both in slab
    mode (the default): equal bytes; the continuation adopted its stored
    prefix by a copy; /v1/health says slab."""
    jurl, url, srv = slab_servers
    got, follow = _script(url)
    want, _ = _script(jurl)
    assert got == want
    assert follow["dllama"]["reused_prefix_tokens"] > 0
    eng = srv.state.engine
    assert not eng.kv_native and eng.kv_adopt_pages > 0 and eng.kv_publish_pages > 0
    health = _health(url)
    assert health["capacity"]["kv_native"] is False and health["kv"]["native"] is False
    assert health["kv"]["enabled"] is True
    srv.state.kv_manager.check()


def test_slab_poisons_keep_the_other_kv(files):
    """Slab mode's recovery split (dllama_tpu's scheduler and manager): a
    decode poison zeroes the lanes' slab, not the pool (its epoch stands,
    ``cache_epoch`` moves, the lanes re-adopt their published prefixes) and
    the f32 answers equal the fault-free ones; a publish poison zeroes the
    pool, not the slab (``kv_pool_epoch`` moves, ``cache_epoch`` does not),
    the manager resets its accounting and every answer still comes."""
    srv = _port_server(files, batch_size=4, kv_page_size=8, retry_backoff_ms=0)
    url = _start(srv)
    eng, sched = srv.state.engine, srv.state.scheduler
    try:
        want = _ask_many(url, PROMPTS, 12)
        pool_epoch, epoch = eng.kv_pool_epoch, eng.cache_epoch
        set_fault_plane("dispatch:op=decode_lanes:nth=2:kind=poison")
        try:
            assert _ask_many(url, PROMPTS, 12) == want
        finally:
            set_fault_plane("")
        assert eng.kv_pool_epoch == pool_epoch and eng.cache_epoch == epoch + 1
        assert sched.lanes_recovered >= 1 and sched.resume_reused_tokens > 0
        # new conversations, so that their publish copies (a repeat dedups)
        set_fault_plane("dispatch:op=kv_publish:nth=1:kind=poison")
        try:
            fresh = _ask_many(url, ["zebra crossing at night", "one two three four five"], 12)
        finally:
            set_fault_plane("")
        assert all(fresh)
        assert eng.kv_pool_epoch > pool_epoch and eng.cache_epoch == epoch + 1
        srv.state.kv_manager.check()
        assert _ask_many(url, PROMPTS, 12) == want
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("speculation", ["off", "shared"])
def test_slab_park_resume_and_speculation(files, speculation):
    """Six streams over two slab lanes (``max_streams`` 6: parks publish the
    history by copies, resumes adopt it back) answer as each runs alone,
    with speculation off and shared."""
    prompts = [NL, NL + " twice", "hello", "zebra crossing", NL + " again", "one two three"]
    solo_srv = _port_server(files, batch_size=2, kv_page_size=8)
    url = _start(solo_srv)
    try:
        want = [_ask(url, p, 24)["choices"][0]["message"]["content"] for p in prompts]
    finally:
        solo_srv.shutdown()
        solo_srv.server_close()
    srv = _port_server(files, batch_size=2, kv_page_size=8, max_streams=6, lane_block_size=2,
                       speculation=speculation, spec_k=4)
    url = _start(srv)
    try:
        assert _ask_many(url, prompts, 24) == want
        sched = srv.state.scheduler
        assert sched.parks >= 1 and sched.resumes == sched.parks
        assert srv.state.engine.kv_adopt_pages > 0
        srv.state.kv_manager.check()
    finally:
        srv.shutdown()
        srv.server_close()


def test_lanes_with_no_pool(files):
    """``kv_page_size`` < 0: slab lanes with no pool (the JAX server's
    sharing-off baseline): no manager, nothing reused, the answers of the
    pooled slab server."""
    srv = _port_server(files, kv_page_size=-1)
    url = _start(srv)
    try:
        assert srv.state.kv_manager is None and srv.state.engine.kv_pool is None
        got, follow = _script(url)
        assert follow["dllama"]["reused_prefix_tokens"] == 0
        health = _health(url)
        assert health["kv"]["enabled"] is False and health["capacity"]["kv_native"] is False
        with urllib.request.urlopen(url + "/v1/debug/kv", timeout=LIMIT) as r:
            assert json.loads(r.read()) == {"enabled": False}
    finally:
        srv.shutdown()
        srv.server_close()
    pooled = _port_server(files, kv_page_size=8)
    url = _start(pooled)
    try:
        assert _script(url)[0] == got
    finally:
        pooled.shutdown()
        pooled.server_close()


ENVS = [{}, {"DLLAMA_KV_PAGE_SIZE": "8"}, {"DLLAMA_KV_POOL_PAGES": "40"},
        {"DLLAMA_KV_NATIVE": "1"}, {"DLLAMA_KV_NATIVE": "0", "DLLAMA_KV_PAGE_SIZE": "-1"}]
FLAGS = [(None, None, None), (16, 0, True), (-1, None, False), (0, 64, None)]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(e) or "none")
def test_resolve_kv_knobs_matches_jax(env, monkeypatch):
    for name in ("DLLAMA_KV_PAGE_SIZE", "DLLAMA_KV_POOL_PAGES", "DLLAMA_KV_NATIVE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for flags in FLAGS:
        assert api.resolve_kv_knobs(*flags) == japi.resolve_kv_knobs(*flags)
