"""Model-free speculation in the port (runtime/spec.py, the lane server's
verify path) on CPU, f32 unless stated, against the JAX package:

* the copied module: `spec_buckets`, `bucket_for`, `resolve_spec_knobs`
  (with the environment knobs), `NgramIndex`, `SharedNgramStore` and
  `NgramDrafter` give the JAX module's drafts, feedback-driven k and store
  lookups on the same seeded token streams;
* the KV manager's lane anchor (`anchor_for`) equals the JAX manager's on
  the same admission sequence;
* `InferenceEngine.verify_lanes`: its grid equals stepwise greedy
  `decode_lanes` (a rejected draft's rewind continues the same stream),
  equals the JAX engine's on the same weights (`params_from_jax`) with an
  f32, a bf16 and an int8 pool, leaves a parked lane's pages their bytes
  (and so does a forward at T > 1 with a lane parked at -1), and refuses
  widths the host checks;
* the scheduler: ``ngram`` and ``shared`` greedy streams are the bytes of
  ``off`` and of the JAX lane server with the same flags; a mixed greedy
  and sampled batch falls back per lane; a finished spec-on conversation
  is published and its follow-up hits the radix tree; a fan-out of one
  prompt drafts from the shared store;
* graphs: verify replayed from the step captured on a key's first use
  gives the eager bits, and the rehearsal captures one verify graph per
  draft bucket on the scratch page only;
* the knobs: ``--speculation draft`` is refused, by the parser and by
  `ApiState` (ROADMAP A.12).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats.model_file import LlmArch
from dllama_tpu.kv.manager import PagedKVManager as JManager
from dllama_tpu.runtime import api_server as japi
from dllama_tpu.runtime import spec as jspec
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu.tokenizer import Tokenizer as JTokenizer
from dllama_tpu_torch.kv.manager import PagedKVManager
from dllama_tpu_torch.models import forward
from dllama_tpu_torch.models.convert import params_from_jax
from dllama_tpu_torch.ops.kv_cache import kv_tensors
from dllama_tpu_torch.runtime import api_server as api
from dllama_tpu_torch.runtime import spec
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.tokenizer import Tokenizer

from helpers import make_tiny_model, make_tiny_tokenizer
from test_torch_graphs import FakeGraphs, ReplayingGraphs

CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=384)
# repetitive (JSON-ish) content, the workload prompt lookup exists for, and
# a natural-language prompt for the fan-out (tests/test_spec*.py's)
REPETITIVE = '{"a": 1, "b": 2}, {"a": 1, "b": 2}, {"a": 1, "b": 2}'
NL = "walk through how the scheduler shares computed prefixes, step by step"
PROMPT = [2 + (i * 7) % 250 for i in range(17)]
PROMPT2 = [5, 9, 13, 17, 21, 25, 29, 33, 37, 41, 45]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_spec")
    out = {"llama": str(d / "m.m"), "qwen3_moe": str(d / "moe.m"), "tok": str(d / "t.t")}
    make_tiny_model(out["llama"], cfg=CFG)
    make_tiny_model(out["qwen3_moe"], arch=LlmArch.QWEN3_MOE)
    # padded to the model's vocab: the mixed-lane test samples any id
    make_tiny_tokenizer(out["tok"], chat_template="<|start_header_id|>",
                        pad_to=CFG["vocab_size"])
    return out


# -- the copied module, side by side with the JAX one --------------------------


@pytest.mark.parametrize("k", [0, 1, 4, 6, 9])
def test_spec_buckets_and_bucket_for_match_jax(k):
    assert spec.spec_buckets(k) == jspec.spec_buckets(k)
    buckets = spec.spec_buckets(k)
    for j in range(1, k + 2) if buckets else ():
        assert spec.bucket_for(j, buckets) == jspec.bucket_for(j, buckets)


@pytest.mark.parametrize("env,args", [
    ({}, (None, None)),
    ({"DLLAMA_SPECULATION": "shared", "DLLAMA_SPEC_K": "8"}, (None, None)),
    ({"DLLAMA_SPECULATION": "shared", "DLLAMA_SPEC_K": "8"}, ("ngram", 0)),
    ({"DLLAMA_SPECULATION": "eagle"}, (None, 3)),
])
def test_resolve_spec_knobs_matches_jax(monkeypatch, env, args):
    for name in ("DLLAMA_SPECULATION", "DLLAMA_SPEC_K"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    try:
        want = jspec.resolve_spec_knobs(*args)
    except ValueError as e:
        with pytest.raises(ValueError, match="speculation must be one of"):
            spec.resolve_spec_knobs(*args)
        assert "eagle" in str(e)
        return
    assert spec.resolve_spec_knobs(*args) == want


def _stream(rng, n: int, alphabet: int = 7) -> list[int]:
    """A token stream with repeats: runs copied from earlier in the stream,
    mixed with fresh tokens from a small alphabet."""
    out = [int(t) for t in rng.integers(0, alphabet, 4)]
    while len(out) < n:
        if rng.random() < 0.6 and len(out) > 4:
            start = int(rng.integers(0, len(out) - 2))
            out += out[start: start + int(rng.integers(2, 8))]
        else:
            out += [int(t) for t in rng.integers(0, alphabet, int(rng.integers(1, 4)))]
    return out[:n]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_index_matches_jax(seed):
    rng = np.random.default_rng(seed)
    max_n = int(rng.integers(1, 5))
    mine, theirs = spec.NgramIndex(max_n), jspec.NgramIndex(max_n)
    stream, i = _stream(rng, 240), 0
    while i < len(stream):
        step = int(rng.integers(1, 4))
        mine.extend(stream[i: i + step])
        theirs.extend(stream[i: i + step])
        i += step
        for k in (1, 3, 6):
            assert mine.lookup(k) == theirs.lookup(k)
        suffix = _stream(rng, int(rng.integers(1, 6)))
        assert mine.lookup_suffix_n(suffix, 4) == theirs.lookup_suffix_n(suffix, 4)
    assert mine.tokens == theirs.tokens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shared_store_matches_jax(seed):
    rng = np.random.default_rng(seed)
    kw = dict(max_n=int(rng.integers(2, 8)), max_groups=3, max_streams_per_group=2,
              max_tokens_per_stream=60)
    mine, theirs = spec.SharedNgramStore(**kw), jspec.SharedNgramStore(**kw)
    for _ in range(150):
        anchor, sid = int(rng.integers(0, 5)), "abc"[int(rng.integers(0, 3))]
        if rng.random() < 0.5:
            toks = _stream(rng, int(rng.integers(1, 12)))
            mine.publish(anchor, sid, toks)
            theirs.publish(anchor, sid, toks)
        else:
            suffix, k = _stream(rng, int(rng.integers(1, 9))), int(rng.integers(1, 6))
            exclude = sid if rng.random() < 0.5 else None
            assert (mine.lookup_n(anchor, suffix, k, exclude)
                    == theirs.lookup_n(anchor, suffix, k, exclude))
    assert mine.stats() == theirs.stats()
    assert mine.stats()["hits"] > 0 and mine.stats()["misses"] > 0


@pytest.mark.parametrize("shared", [False, True], ids=["ngram", "shared"])
@pytest.mark.parametrize("seed", [0, 1])
def test_drafter_matches_jax(seed, shared):
    """Two lanes' drafters (one store between them in mode shared) over
    seeded streams, fed back seeded acceptances: every draft, its source,
    the adaptive k and the counters equal the JAX drafters'."""
    rng = np.random.default_rng(seed)
    sides = []
    for mod in (spec, jspec):
        store = mod.SharedNgramStore() if shared else None
        sides.append([mod.NgramDrafter(k_max=5, cooldown=2, shared_store=store,
                                       stream_id=f"s{lane}", anchor=7 if shared else None,
                                       anchor_offset=3) for lane in range(2)])
    prefix = _stream(rng, 6)
    hist = [list(prefix), list(prefix)]
    n_drafts = 0
    for tick in range(120):
        lane = tick % 2
        hist[lane] += _stream(rng, int(rng.integers(1, 5)))
        budget = int(rng.integers(1, 6))
        outs = []
        for drafters in sides:
            drafters[lane].update(hist[lane])
            outs.append((drafters[lane].draft(budget=budget), drafters[lane].last_source))
        assert outs[0] == outs[1]
        if outs[0][0]:
            n_drafts += 1
            accepted = int(rng.integers(0, len(outs[0][0]) + 1))
            for drafters in sides:
                drafters[lane].feedback(len(outs[0][0]), accepted)
        mine, theirs = sides[0][lane], sides[1][lane]
        assert (mine.k, mine.n_drafted, mine.n_accepted) == (theirs.k, theirs.n_drafted,
                                                            theirs.n_accepted)
    assert n_drafts > 20
    if shared:
        assert sides[0][0].shared_store.stats() == sides[1][0].shared_store.stats()


def test_anchor_for_matches_jax_manager(files):
    """The same admissions through both managers (pool-native, page 4): the
    anchor of every match, and none after a release or an empty match."""
    mp = files["llama"]
    jeng = JEngine(mp, tp=1, dtype=jnp.float32, temperature=0.0, batch_size=2)
    eng = InferenceEngine(mp, dtype=torch.float32, temperature=0.0, device="cpu", batch_size=2)
    managers = (PagedKVManager(eng, page_size=4, native=True),
                JManager(jeng, page_size=4, native=True))
    a = list(range(3, 23))
    steps = [("match", 0, a), ("publish", 0, a[:16]), ("release", 0, None),
             ("match", 1, a[:16] + [200, 201, 202, 203]), ("publish", 1, a[:16] + [200] * 8),
             ("match", 0, a[:10] + [99, 98]), ("match", 1, [250, 251, 252]),
             ("release", 1, None), ("match", 1, a[:16] + [200] * 8 + [5])]
    anchors = []
    for op, lane, toks in steps:
        got = []
        for kv in managers:
            if op == "match":
                kv.adopt(lane, kv.match(lane, toks)[1])
            elif op == "publish":
                kv.publish(lane, toks)
            else:
                kv.release_lane(lane)
            got.append((kv.anchor_for(0), kv.anchor_for(1)))
        assert got[0] == got[1], (op, lane)
        anchors.append(got[0])
    assert any(x is not None for pair in anchors for x in pair)
    assert anchors[2][0] is None  # released
    managers[0].release_all_lanes()
    assert managers[0].anchor_for(0) is None and managers[0].anchor_for(1) is None


# -- verify_lanes ----------------------------------------------------------------


def _native(e):
    """Pool-native lanes with private identity pages (page 0 is scratch)."""
    e.init_kv_pool(4, native=True)
    nb = e._kv_n_blocks
    for lane in range(e.batch_size):
        e.adopt_pages(lane, list(range(1 + lane * nb, 1 + (lane + 1) * nb)))
    return e


def _port(mp, **kw):
    return _native(InferenceEngine(mp, dtype=kw.pop("dtype", torch.float32), temperature=0.0,
                                   device="cpu", batch_size=2, **kw))


def _accept(draft, out):
    a = 0
    while a < len(draft) and out[a] == draft[a]:
        a += 1
    return draft[:a] + [out[a]]


@pytest.mark.parametrize("arch", ["llama", "qwen3_moe"])
def test_verify_matches_stepwise_greedy(files, arch):
    """tests/test_spec.py's verify test on the port, both lanes live at
    ragged positions: a perfect draft is accepted whole, a wrong one stops
    at its first token, and each lane continues from its rewound position
    with the stepwise stream."""
    mp = files[arch]
    prompts = (PROMPT, PROMPT2)
    pos0 = [len(p) - 1 for p in prompts]
    pend = [p[-1] for p in prompts]
    e = _port(mp)
    for lane, p in enumerate(prompts):
        e.prefill_lane(lane, p)
    ref = [list(r) for r in zip(*e.decode_lanes(pend, pos0, 12, [True, True]))]

    e2 = _port(mp)
    for lane, p in enumerate(prompts):
        e2.prefill_lane(lane, p)
    drafts = [ref[0][:4], ref[1][:2] + [0, 0]]
    grid = e2.verify_lanes([[pend[i], *drafts[i]] for i in range(2)], pos0, [True, True])
    assert grid[0] == ref[0][:5] and grid[1][:3] == ref[1][:3]
    emitted = [_accept(drafts[0], grid[0]), _accept(ref[1][:2], grid[1])]
    assert emitted == [ref[0][:5], ref[1][:3]]
    pos1 = [pos0[i] + len(emitted[i]) for i in range(2)]
    bad = [[(ref[i][len(emitted[i])] + 1) % CFG["vocab_size"], 3, 5, 9] for i in range(2)]
    grid = e2.verify_lanes([[emitted[i][-1], *bad[i]] for i in range(2)], pos1, [True, True])
    emitted2 = [_accept(bad[i], grid[i]) for i in range(2)]
    assert emitted2 == [[ref[i][len(emitted[i])]] for i in range(2)]
    pos2 = [pos1[i] + 1 for i in range(2)]
    n = 12 - (pos2[0] - pos0[0])
    cont = e2.decode_lanes([emitted2[0][0], emitted2[1][0]], pos2, n, [True, True])
    assert [r[0] for r in cont] == ref[0][pos2[0] - pos0[0]:]
    assert [r[1] for r in cont] == ref[1][pos2[1] - pos0[1]:][:n]
    assert e2.lane_verify_steps == 2


def _carried(jeng, eng, dtype):
    """The JAX engine's params in the port's layout (bf16 leaves through
    f32, exact), the float leaves the port holds in ``dtype`` cast to it."""
    npp = jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a),
        jeng.params)
    p = params_from_jax(npp, eng.header, "cpu")

    def leaf(v):
        return v.to(dtype) if torch.is_tensor(v) and v.dtype == torch.float32 and v.dim() > 1 \
            else v

    out = {key: leaf(v) for key, v in p.items() if key != "layers"}
    out["layers"] = [{key: leaf(v) for key, v in lp.items()} for lp in p["layers"]]
    out["rope_cos"], out["rope_sin"] = eng.params["rope_cos"], eng.params["rope_sin"]
    return out


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_verify_matches_jax_engine(files, pool):
    """The JAX engine's verify_lanes and the port's on the same weights,
    rows, positions and active masks: equal grids, with an f32 pool, a
    bf16 one (bf16 model) and an int8 one (f32 model; a bf16 JAX engine
    rounds dequantized rows to bf16, which the port does not)."""
    mp = files["llama"]
    dtype, jdtype = ((torch.bfloat16, jnp.bfloat16) if pool == "bf16"
                     else (torch.float32, jnp.float32))
    kv = "int8" if pool == "int8" else None
    jeng = _native(JEngine(mp, tp=1, dtype=jdtype, temperature=0.0, batch_size=2, kv_dtype=kv))
    eng = InferenceEngine(mp, dtype=dtype, temperature=0.0, device="cpu", batch_size=2,
                          kv_dtype=kv)
    eng.params = _carried(jeng, eng, dtype)
    _native(eng)
    prompts = (PROMPT, PROMPT2)
    pos = [len(p) - 1 for p in prompts]
    grids = []
    for e in (jeng, eng):
        for lane, p in enumerate(prompts):
            e.prefill_lane(lane, p)
        ref = e.decode_lanes([p[-1] for p in prompts], pos, 3, [True, True])
        rows = [[prompts[0][-1], ref[0][0], ref[1][0], 11, 12],
                [prompts[1][-1], ref[0][1], 40, 41, 42]]
        grids.append([e.verify_lanes(rows, pos, [True, True]),
                      e.verify_lanes([r[:3] for r in rows], pos, [False, True]),
                      e.verify_lanes([r[:2] for r in rows], [p + 2 for p in pos],
                                     [True, False])])
    assert grids[0] == grids[1]
    assert grids[1][1][0] == [0, 0, 0] and grids[1][2][1] == [0, 0]


def _lane_bytes(e, lane):
    pages = sorted(set(e._page_table[lane].tolist()) - {0})
    return [t[:, pages].clone() for leaf in e.kv_pool.values() for t in kv_tensors(leaf)]


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("t", [2, 5])
def test_parked_lane_pages_keep_their_bytes(files, t, kv):
    """A lane that is not verifying (mid-admission: its pages hold its
    prompt) keeps every byte of its pages through a verify pass of the
    other lane, and so through a forward of T > 1 rows with the lane
    parked at -1 (which at T = 1 reads and writes nothing either)."""
    e = _port(files["llama"], kv_dtype=kv)
    for lane, p in enumerate((PROMPT, PROMPT2)):
        e.prefill_lane(lane, p)
    before = _lane_bytes(e, 1)
    e.verify_lanes([[PROMPT[-1]] + [7] * (t - 1), [0] * t], [len(PROMPT) - 1, 0],
                   [True, False])
    for a, b in zip(before, _lane_bytes(e, 1)):
        assert torch.equal(a, b)
    pt = e._page_table_dev()
    toks = torch.tensor([[PROMPT[-1]] + [7] * (t - 1), [3] * t])
    pos = torch.tensor([len(PROMPT) - 1, -1], dtype=torch.int32)
    with torch.inference_mode():
        forward(e.params, e.header, toks, pos, e.kv_pool, "all", page_table=pt)
    for a, b in zip(before, _lane_bytes(e, 1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rows,pos,match", [
    ([[1, 2, 3, 4, 5], [0] * 5], [CFG["seq_len"] - 4, 0], "exceeds seqLen"),
    ([[1], [0]], [3, 0], "pending token"),
    ([[1, 2, 3], [0, 0]], [3, 0], "share one"),
    ([[1] * 129, [0] * 129], [3, 0], "largest prefill bucket"),
    ([[1, 2]], [3], "one entry per lane"),
])
def test_verify_checks_on_the_host(files, rows, pos, match):
    e = _port(files["llama"])
    with pytest.raises(ValueError, match=match):
        e.verify_lanes(rows, pos, [True, False][: len(rows)])
    assert e.lane_verify_steps == 0
    assert e.verify_lanes([[1, 2], [3, 4]], [5, 6], [False, False]) == []


# -- the scheduler ---------------------------------------------------------------


def _state(files, **kw):
    eng = InferenceEngine(files["llama"], dtype=torch.float32, temperature=0.0, seed=3,
                          device="cpu", batch_size=3)
    return api.ApiState(eng, Tokenizer(files["tok"]), lane_block_size=4, admission_chunk=6,
                        **dict(dict(kv_native=True), **kw))


@pytest.fixture(scope="module")
def states(files):
    out = {mode: _state(files, speculation=mode, spec_k=4) for mode in ("off", "ngram", "shared")}
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


@pytest.mark.parametrize("prompt", [REPETITIVE, NL], ids=["repetitive", "nl"])
@pytest.mark.parametrize("mode", ["ngram", "shared"])
def test_spec_streams_equal_off(states, mode, prompt):
    sched = states[mode].scheduler
    drafted, passes = sched.spec_drafted, sched.spec_verify_dispatches
    want = _run(states["off"], api, prompt)
    for _ in range(2):
        assert _run(states[mode], api, prompt) == want
    assert want[1] in ("stop", "length") and want[0]
    assert sched.spec_drafted > drafted and sched.spec_verify_dispatches > passes
    assert 0 <= sched.spec_accepted <= sched.spec_drafted
    assert sched.spec_accept_len_count >= sched.spec_verify_dispatches - passes
    assert states[mode].engine.lane_verify_steps >= sched.spec_verify_dispatches
    assert not sched.drafters  # every finished lane dropped its drafter


@pytest.fixture(scope="module")
def jax_shared(files):
    tok = JTokenizer(files["tok"])
    eng = JEngine(files["llama"], tokenizer=tok, tp=1, dtype=jnp.float32, temperature=0.0,
                  seed=3, batch_size=3)
    return japi.ApiState(eng, tok, lane_block_size=4, admission_chunk=6, speculation="shared",
                         spec_k=4)


@pytest.mark.parametrize("mode", ["ngram", "shared"])
def test_spec_content_matches_jax_lane_server(states, jax_shared, mode):
    """The port's spec-on lane server against the JAX one with speculation
    shared (greedy output is the same bytes in every mode): a repetitive
    prompt, then the same natural-language prompt twice (the second
    drafts from the first through the JAX store)."""
    for prompt in (REPETITIVE, NL, NL):
        assert _run(states[mode], api, prompt, 40) == _run(jax_shared, japi, prompt, 40)
    assert jax_shared.m_spec_drafted.value > 0


def test_mixed_greedy_and_sampled_fall_back_per_lane(states):
    """A seeded sampled request joining a greedy stream takes the decode
    block while the greedy lane verifies: both streams equal spec-off's."""
    def run(state):
        g_job = state.scheduler.submit(_greedy(api, REPETITIVE, 64))
        deadline = time.time() + 300
        while g_job.n_completion < 4 and time.time() < deadline:
            time.sleep(0.01)
        s_job = state.scheduler.submit(api.InferenceParams(
            messages=[api.ChatMessage(role="user", content="tell me a story")],
            temperature=0.8, top_p=0.9, seed=11, max_tokens=24, stream=True))
        return _drain(g_job), _drain(s_job)

    sched = states["ngram"].scheduler
    passes, steps = sched.spec_verify_dispatches, states["ngram"].engine.lane_decode_steps
    assert run(states["ngram"]) == run(states["off"])
    assert sched.spec_verify_dispatches > passes
    assert states["ngram"].engine.lane_decode_steps > steps


def test_spec_conversation_is_published_and_followed_up(states):
    """A finished spec-on conversation (rejected drafts rewound along the
    way) is published: its follow-up adopts the stored prefix and streams
    what spec-off streams."""
    prompt = REPETITIVE + " and more"
    st, kv = states["shared"], states["shared"].kv_manager
    sched = st.scheduler
    drafted, accepted = sched.spec_drafted, sched.spec_accepted
    first = _run(st, api, prompt, 32)
    assert 0 < sched.spec_accepted - accepted < sched.spec_drafted - drafted  # some rejected
    msgs = [api.ChatMessage("user", prompt), api.ChatMessage("assistant", first[0]),
            api.ChatMessage("user", "and more")]
    hits, results = kv.hits, []
    for state in (st, states["off"]):
        job = state.scheduler.submit(api.InferenceParams(messages=msgs, temperature=0.0,
                                                         max_tokens=24, stream=True))
        results.append((_drain(job), job.reused_prefix_tokens))
    assert results[0][0] == results[1][0]
    assert results[0][1] > 0 and kv.hits == hits + 1
    kv.check()


def test_fanout_drafts_from_the_shared_store(states):
    """One system-prompt-like request four times in a row: each stream is
    spec-off's, and the later ones draft from the store (source shared)."""
    st = states["shared"]
    sched = st.scheduler
    want = _run(states["off"], api, NL + " again")
    shared0 = sched.spec_source.get("shared", 0)
    for _ in range(4):
        assert _run(st, api, NL + " again") == want
    assert sched.spec_source.get("shared", 0) > shared0
    stats = sched.spec_stats()
    assert stats["store"]["hits"] > 0 and stats["store"]["tokens"] > 0
    assert stats["tokens_per_lane_pass"] > 1.0
    assert st.health_snapshot()["speculation"]["sources"] == sched.spec_source


def test_off_is_a_pure_bypass(states):
    st = states["off"]
    _run(st, api, REPETITIVE, 16)
    sched = st.scheduler
    assert not sched.spec_on and sched.spec_store is None and not sched.drafters
    assert sched.spec_verify_dispatches == 0 and st.engine.lane_verify_steps == 0
    assert states["ngram"].scheduler.spec_store is None
    assert st.health_snapshot()["speculation"]["verify_passes"] == 0


# -- graphs and the rehearsal ----------------------------------------------------


def test_replayed_verify_equals_eager(files):
    """Verify passes of every width replayed from the step captured on the
    key's first use: the same grids and pool bits as the eager engine."""
    eager, graphed = _port(files["llama"]), _port(files["llama"])
    graphed.graphs = ReplayingGraphs()
    graphed.rehearse_admission(4, spec_k=4)
    out = []
    for e in (eager, graphed):
        for lane, p in enumerate((PROMPT, PROMPT2)):
            e.prefill_lane(lane, p)
        pos, grids = [len(PROMPT) - 1, len(PROMPT2) - 1], []
        for i, t in enumerate((2, 3, 5, 5, 3, 2)):
            rows = [[(7 * i + 3 * j + lane) % 250 for j in range(t)] for lane in range(2)]
            act = [i % 3 != 2, i % 2 == 0]
            grids.append(e.verify_lanes(rows, pos, act))
            pos = [p + 1 for p in pos]
        # pages 1..: page 0 is scratch, which only the rehearsal wrote
        out.append((grids, [t[:, 1:].clone() for leaf in e.kv_pool.values()
                            for t in kv_tensors(leaf)]))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert graphed.graphs.replays >= 6


@pytest.mark.parametrize("spec_k", [0, 4, 8])
def test_rehearsal_captures_one_verify_graph_a_bucket(files, spec_k):
    e = _port(files["llama"])
    gen = torch.Generator().manual_seed(0)
    for leaf in e.kv_pool.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    e.graphs = FakeGraphs()
    before = {k: t.clone() for k, t in e.kv_pool.items()}
    e.rehearse_admission(8, spec_k=spec_k)
    for k in before:  # pages 1.. are the lanes': untouched
        assert torch.equal(before[k][:, 1:], e.kv_pool[k][:, 1:])
    verify = {key for key in e.graphs._graphs if key[0] == "lane_verify_paged"}
    assert verify == {("lane_verify_paged", 1 + b) for b in spec.spec_buckets(spec_k)}
    assert len(verify) == len(spec.spec_buckets(spec_k))
    assert e.lane_verify_steps == 0


# -- the knobs -------------------------------------------------------------------


def test_speculation_flags_and_draft_refused(files, monkeypatch):
    """The flags, ``draft`` and ``--draft-model`` among them; ``draft``
    without a checkpoint is refused by `serve` with the JAX server's
    ValueError, before any state is built."""
    parser = api.build_parser()
    args = parser.parse_args(["--model", "m", "--tokenizer", "t", "--speculation", "shared",
                              "--spec-k", "8"])
    assert (args.speculation, args.spec_k) == ("shared", 8)
    args = parser.parse_args(["--model", "m", "--tokenizer", "t"])
    assert args.speculation is None and args.spec_k is None and args.draft_model is None
    args = parser.parse_args(["--model", "m", "--tokenizer", "t", "--speculation", "draft",
                              "--draft-model", "d.m"])
    assert (args.speculation, args.draft_model) == ("draft", "d.m")
    eng = InferenceEngine(files["llama"], dtype=torch.float32, temperature=0.0, device="cpu",
                          batch_size=2)
    monkeypatch.delenv("DLLAMA_DRAFT_MODEL", raising=False)
    with pytest.raises(ValueError, match="--draft-model"):
        api.serve(eng, Tokenizer(files["tok"]), port=0, speculation="draft")
    monkeypatch.setenv("DLLAMA_SPECULATION", "draft")
    with pytest.raises(ValueError, match="DLLAMA_DRAFT_MODEL"):
        api.serve(eng, Tokenizer(files["tok"]), port=0)
    assert not eng.has_draft_model
    monkeypatch.setenv("DLLAMA_SPECULATION", "ngram")
    monkeypatch.setenv("DLLAMA_SPEC_K", "500")
    st = _state(files)
    try:  # the env knobs hold, k capped by the largest prefill bucket
        assert st.scheduler.spec_mode == "ngram" and st.scheduler.spec_k == 127
        assert st.scheduler.spec_buckets == spec.spec_buckets(127)
    finally:
        st.scheduler.stop()
