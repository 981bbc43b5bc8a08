"""The port's draft-model speculation (``--speculation draft``,
``--draft-model``) on CPU against the JAX package's, f32 on a tiny ``.m``
file that doubles as its own draft (the same tokenizer by construction):

* the engine: `init_draft_model` loads the draft dense beside the target
  and refuses a vocab mismatch; `draft_prefill` + `draft_propose` propose
  the target's greedy continuation (the draft is the target) and equal the
  JAX engine's proposals; parked lanes are untouched; a failed draft
  dispatch resets the draft cache alone; the draft graphs replay and the
  rehearsal captures them, writing only padding rows;
* the server: draft-mode streams equal spec-off's and the JAX draft-mode
  server's, the draft source and its step histogram move; rejected drafts
  rewind and compose with publish and radix reuse; a poisoned dispatch and
  a failed draft step both leave the bytes as spec-off's; the flags.

Streams and proposals are compared for equality (greedy, f32).
"""

import time

import jax.numpy as jnp
import pytest
import torch

from dllama_tpu.runtime import api_server as japi
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu.tokenizer import Tokenizer as JTokenizer
from dllama_tpu_torch.runtime import api_server as api
from dllama_tpu_torch.runtime.engine import KEY_KINDS, InferenceEngine
from dllama_tpu_torch.runtime.faults import set_fault_plane
from dllama_tpu_torch.runtime.graphs import StepGraphs
from dllama_tpu_torch.runtime.spec import spec_buckets
from dllama_tpu_torch.tokenizer import Tokenizer

from helpers import make_tiny_model, make_tiny_tokenizer
from test_torch_graphs import FakeGraphs, ReplayingGraphs

CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=384)
NL = "walk through how the scheduler shares computed prefixes, step by step"
PROMPT = [2 + (i * 5) % 250 for i in range(13)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_draft")
    mp, tp_ = str(d / "m.m"), str(d / "t.t")
    make_tiny_model(mp, cfg=CFG)
    make_tiny_tokenizer(tp_, chat_template="<|start_header_id|>", pad_to=CFG["vocab_size"])
    return mp, tp_


def _engine(mp, lanes=2, **kw):
    return InferenceEngine(mp, dtype=torch.float32, temperature=0.0, seed=3, device="cpu",
                           batch_size=lanes, **kw)


# -- the engine ------------------------------------------------------------------


def test_engine_draft_model_load_and_greedy_parity(files):
    """The draft loads through the reader, keeps its own cache and (being
    the target's own checkpoint) proposes the target's greedy continuation;
    its proposals equal the JAX engine's."""
    mp, _ = files
    e = _engine(mp)
    assert not e.has_draft_model and e.draft_seq_len == 0
    e.init_draft_model(mp)
    assert e.has_draft_model and e.draft_seq_len == CFG["seq_len"] and e.draft_cache_epoch == 1
    assert e.draft_cache["k"].shape[3] == CFG["seq_len"] + max(e.prefill_buckets)
    pos0, pending = len(PROMPT) - 1, PROMPT[-1]
    e.prefill_lane(0, PROMPT, 0)
    ref = [r[0] for r in e.decode_lanes([pending, 0], [pos0, 0], 4, [True, False])]
    e.draft_prefill(0, PROMPT[:-1], 0)
    props = e.draft_propose([pending, 0], [pos0, 0], [True, False], 4)
    assert props[0] == ref and props[1] == [0] * 4
    je = JEngine(mp, tp=1, dtype=jnp.float32, temperature=0.0, seed=3, batch_size=2)
    je.init_draft_model(mp)
    je.draft_prefill(0, PROMPT[:-1], 0)
    assert je.draft_propose([pending, 0], [pos0, 0], [True, False], 4) == props
    # the lane that did not draft kept its rows below the padding
    assert torch.all(e.draft_cache["k"][:, 1, :, : CFG["seq_len"]] == 0)
    assert e.cache_epoch == 0


def test_engine_draft_model_rejects_vocab_mismatch(files, tmp_path):
    mp, _ = files
    other = str(tmp_path / "othervocab.m")
    make_tiny_model(other, cfg={**CFG, "vocab_size": 128})
    e = _engine(mp)
    with pytest.raises(ValueError, match="vocab"):
        e.init_draft_model(other)
    assert not e.has_draft_model
    with pytest.raises(ValueError, match="batch_size > 1"):
        _engine(mp, lanes=1).init_draft_model(mp)


def test_draft_catch_up_in_chunks_and_rewind(files):
    """A catch-up longer than a bucket runs in chunks of the draft's
    buckets; re-feeding from an earlier cursor (a rewind) gives the same
    proposals as a fresh catch-up."""
    mp, _ = files
    long = [3 + (i * 11) % 200 for i in range(75)]
    fresh, again = (_engine(mp, prefill_buckets=(1, 8, 32)) for _ in range(2))
    for e in (fresh, again):
        e.init_draft_model(mp)
    fresh.draft_prefill(1, long, 0)
    want = fresh.draft_propose([0, 9], [0, len(long)], [False, True], 4)
    again.draft_prefill(1, long[:40] + [1] * 20, 0)  # rows past 40 are a rejected tail
    again.draft_prefill(1, long[40:], 40)
    assert again.draft_propose([0, 9], [0, len(long)], [False, True], 4) == want
    assert fresh.draft_propose([0, 9], [0, len(long)], [False, True], 0) == []


def test_failed_draft_dispatch_resets_only_the_draft_cache(files):
    mp, _ = files
    e = _engine(mp)
    e.init_draft_model(mp)
    e.prefill_lane(0, PROMPT, 0)
    e.draft_prefill(0, PROMPT[:-1], 0)
    target = {k: v.clone() for k, v in e.lane_cache.items()}
    epochs = (e.cache_epoch, e.kv_pool_epoch, e.draft_cache_epoch)
    run = e.graphs.run

    def failing(key, step):
        if key[0] == "draft_step":
            raise RuntimeError("injected draft step failure")
        return run(key, step)

    e.graphs.run = failing
    with pytest.raises(RuntimeError, match="injected"):
        e.draft_propose([PROMPT[-1], 0], [len(PROMPT) - 1, 0], [True, False], 2)
    e.graphs.run = run
    assert (e.cache_epoch, e.kv_pool_epoch) == epochs[:2]
    assert e.draft_cache_epoch == epochs[2] + 1
    assert all(torch.equal(target[k], e.lane_cache[k]) for k in target)
    assert all(torch.all(leaf == 0) for leaf in e.draft_cache.values())


def test_replayed_draft_graphs_equal_eager(files):
    mp, _ = files
    eager, graphed = _engine(mp), _engine(mp)
    graphed.graphs = ReplayingGraphs()
    outs = []
    for e in (eager, graphed):
        e.init_draft_model(mp)
        got = []
        for lane, prompt in ((0, PROMPT), (1, PROMPT[3:] + [7, 7])):
            e.draft_prefill(lane, prompt[:-1], 0)
            toks = [0, 0]
            toks[lane] = prompt[-1]
            pos = [0, 0]
            pos[lane] = len(prompt) - 1
            got.append(e.draft_propose(toks, pos, [i == lane for i in range(2)], 4))
            got.append(e.draft_propose(toks, pos, [i == lane for i in range(2)], 4))
        outs.append(got)
    assert outs[0] == outs[1]
    assert graphed.graphs.replays > 0
    assert {k[0] for k in graphed.graphs._graphs} >= {"draft_prefill", "draft_step"}
    assert (KEY_KINDS["draft_prefill"], KEY_KINDS["draft_step"]) == ("draft_prefill",
                                                                    "draft_step")


def test_rehearsal_captures_draft_graphs_in_padding_rows(files):
    mp, _ = files
    e = _engine(mp, lanes=3)
    e.init_draft_model(mp)
    e.graphs = FakeGraphs()
    e.rehearse_admission(4, spec_k=4)
    keys = set(e.graphs._graphs)
    want = {("draft_prefill", b, lane) for b in e.prefill_buckets for lane in range(3)}
    want |= {("draft_step", kb) for kb in spec_buckets(4)}
    assert want <= keys
    s = CFG["seq_len"]
    assert all(torch.all(leaf[:, :, :, :s] == 0) for leaf in e.draft_cache.values())
    assert any(torch.any(leaf[:, :, :, s:] != 0) for leaf in e.draft_cache.values())


# -- the server ------------------------------------------------------------------


def _state(files, draft=False, **kw):
    mp, tp_ = files
    eng = _engine(mp, lanes=3)
    if draft:
        eng.init_draft_model(mp)
    return api.ApiState(eng, Tokenizer(tp_), lane_block_size=4, admission_chunk=6, **kw)


@pytest.fixture(scope="module")
def states(files):
    out = {"off": _state(files),
           "draft": _state(files, draft=True, speculation="draft", spec_k=4)}
    yield out
    for st in out.values():
        st.scheduler.stop()


def _drain(job, timeout=300):
    deltas, deadline = [], time.time() + timeout
    while True:
        kind, payload = job.events.get(timeout=max(0.1, deadline - time.time()))
        if kind == "delta":
            deltas.append(payload)
        elif kind == "done":
            return "".join(deltas), payload
        else:
            raise AssertionError(f"job errored: {payload}")


def _greedy(mod, content, max_tokens=48):
    return mod.InferenceParams(messages=[mod.ChatMessage(role="user", content=content)],
                               temperature=0.0, max_tokens=max_tokens, stream=True)


def _run(state, mod, content, max_tokens=48):
    return _drain(state.scheduler.submit(_greedy(mod, content, max_tokens)))


def _source(state, source):
    return state.m_spec_source.labels(source=source).value if state.m_spec_source else 0.0


def test_draft_mode_stream_parity_and_sources(states, files):
    """Draft-model speculation is byte-invisible on a non-repetitive prompt
    (where the n-gram sources run dry and the model drafts), equal to the
    JAX draft-mode server's, and the draft source, its step histogram and
    the draft step kinds moved."""
    want = _run(states["off"], api, NL)
    drafted = _source(states["draft"], "draft")
    assert _run(states["draft"], api, NL) == want
    assert _source(states["draft"], "draft") > drafted
    eng = states["draft"].engine
    assert eng._m_spec_draft_ms.labels(kind="propose").count > 0
    assert eng._m_spec_draft_ms.labels(kind="prefill").count > 0
    kinds = {k[0] for k in eng.graphs.capture_seconds} | {k[0] for k in eng._key_cost}
    assert {"draft_prefill", "draft_step"} <= kinds
    assert {"draft_prefill", "draft_step"} <= set(eng.cost_report()["kinds"])
    sched = states["draft"].scheduler
    assert sched.spec_accepted > 0  # the draft is the target: it accepts
    mp, tp_ = files
    tok = JTokenizer(tp_)
    je = JEngine(mp, tokenizer=tok, tp=1, dtype=jnp.float32, temperature=0.0, seed=3,
                 batch_size=3)
    je.init_draft_model(mp)
    jst = japi.ApiState(je, tok, lane_block_size=4, admission_chunk=6, speculation="draft",
                        spec_k=4)
    try:
        assert _run(jst, japi, NL) == want
    finally:
        jst.scheduler.stop()


def test_draft_mode_rewind_publish_radix_compose(states):
    """Rejected model drafts rewind, the finished stream publishes only
    verified rows, and the identical follow-up adopts the prefix and
    streams the same bytes."""
    st = states["draft"]
    prompt = "compose rewind publish and reuse in one stream"
    first = _run(st, api, prompt)
    evs = st.recorder.events(kind="spec_verify")
    assert any(e["accepted"] < e["k"] for e in evs), "expected a rejected-draft rewind"
    reused = st.m_reused_tokens.value
    assert _run(st, api, prompt) == first == _run(states["off"], api, prompt)
    assert st.m_reused_tokens.value > reused


def test_draft_mode_poison_recovery_parity(states):
    """A poisoned target dispatch mid-stream: the recovery re-prefills the
    target, the draft cursors restart from the verified history, and the
    bytes equal spec-off's."""
    prompt = "recover the draft cache cursors after a poisoned dispatch"
    want = _run(states["off"], api, prompt, 40)
    st = states["draft"]
    job = st.scheduler.submit(_greedy(api, prompt, 40))
    deadline = time.time() + 300
    while job.n_completion < 6 and time.time() < deadline:
        time.sleep(0.02)
    assert job.n_completion >= 6
    recoveries = st.scheduler.recoveries
    set_fault_plane("dispatch:nth=1:kind=poison")
    try:
        got = _drain(job)
    finally:
        set_fault_plane("")
    assert got == want
    assert st.scheduler.recoveries > recoveries
    assert not st.scheduler._draft_pos  # every cursor dropped with its lane


def test_failed_draft_step_skips_model_drafting_only(states, files):
    """A draft step that raises mid-stream resets the draft cache alone
    (its epoch moves, the target's do not), the scheduler's cursors restart
    and the bytes stay spec-off's."""
    want = _run(states["off"], api, NL, 40)
    # a fresh server with no pool: no anchors, so no sibling drafts from the
    # rounds before; the n-gram sources run dry and the model drafts
    st = _state(files, draft=True, speculation="draft", spec_k=4, kv_page_size=-1)
    eng = st.engine
    epochs = (eng.cache_epoch, eng.kv_pool_epoch, eng.draft_cache_epoch)
    run, fired = eng.graphs.run, []

    def failing(key, step):
        if key[0] == "draft_step" and not fired:
            fired.append(key)
            raise RuntimeError("injected draft step failure")
        return run(key, step)

    eng.graphs.run = failing
    try:
        got = _run(st, api, NL, 40)
    finally:
        eng.graphs.run = run
        st.scheduler.stop()
    assert fired and got == want
    assert (eng.cache_epoch, eng.kv_pool_epoch) == epochs[:2]
    assert eng.draft_cache_epoch == epochs[2] + 1
    assert st.recorder.events(kind="draft_model_error")


def test_draft_cli_flags():
    parser = api.build_parser()
    args = parser.parse_args(["--model", "m", "--tokenizer", "t", "--speculation", "draft",
                              "--draft-model", "d.m"])
    assert args.speculation == "draft" and args.draft_model == "d.m"
    args = parser.parse_args(["--model", "m", "--tokenizer", "t", "--speculation", "shared"])
    assert args.speculation == "shared" and args.draft_model is None


def test_serve_loads_the_draft_from_flag_or_env(files, monkeypatch):
    mp, tp_ = files
    for how in ("flag", "env"):
        eng = _engine(mp, lanes=2)
        if how == "env":
            monkeypatch.setenv("DLLAMA_DRAFT_MODEL", mp)
        server = api.serve(eng, Tokenizer(tp_), port=0, speculation="draft", spec_k=2,
                           draft_model=mp if how == "flag" else None)
        try:
            assert eng.has_draft_model
            assert server.state.scheduler.spec_mode == "draft"
            assert server.state.scheduler.spec_store is not None
        finally:
            server.server_close()


def test_cleared_graphs_give_up_their_pool():
    """`StepGraphs.clear` drops the capture pool with the graphs, so a
    server built again on the same engine (a draft model loaded, whose
    dense products leave a cuBLAS workspace in the old pool) captures into
    a new pool."""
    g = StepGraphs(torch.device("cpu"))
    g._pool = (0, 7)
    g.buffers(("k",), lambda: {"x": torch.zeros(2)})
    g.clear()
    assert g._pool is None and g.n_graphs == 0 and not g._buffers
