"""The port's int8 KV cache (``kv_dtype="int8"``, QuantKV leaves) on CPU
against the JAX package's.

* ops/kv_cache: `quantize_kv_rows` (run compiled in JAX, as its engine
  runs it), `dequant_kv`, `slice_kv`, `gather_pages`, `scatter_pages`,
  `paged_view` and `lane_views` on QuantKV leaves equal JAX's bit for bit.
* The plain versions of the attention functions on QuantKV (the cache
  dequantized in f32, then `attention_stats`) against the TPU kernels'
  QuantKV branches in interpret mode and against JAX's dequantize-then-
  dense route, f32, at `TOL` (the plain attention tests' 1e-5): the values
  are the same, the sums run in another order.
* The engine, f32: greedy streams equal the JAX engine's int8 streams
  (tiny Llama and Qwen3-MoE), single-stream and through pool-native lanes;
  a COW fork carries the scales; `reset_kv_pool` restores them; the
  cache's bytes; CUDA-graph replays on the CPU's eager route equal the
  eager engine; the CLI and the server answer with ``--kv-dtype int8``.
* On CPU tensors the int8-KV wrappers launch nothing.
"""

import argparse
import json
import threading
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats.model_file import LlmArch
from dllama_tpu.ops import flash_attention as JF
from dllama_tpu.ops import jnp_ops as J
from dllama_tpu.ops import kv_cache as JKV
from dllama_tpu.runtime.api_server import serve as jserve
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu.tokenizer import Tokenizer as JTokenizer
from dllama_tpu_torch import cli
from dllama_tpu_torch.kv.manager import PagedKVManager
from dllama_tpu_torch.ops import flash_attention as TF
from dllama_tpu_torch.ops import kv_cache as TKV
from dllama_tpu_torch.runtime.api_server import serve
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.graphs import StepGraphs

from helpers import make_tiny_model, make_tiny_tokenizer

TOL = dict(atol=1e-5, rtol=1e-5)  # f32, sum order only
CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=64)
PROMPT = [2 + (i * 7) % 250 for i in range(23)]
j_quantize_rows = jax.jit(JKV.quantize_kv_rows)


def _rows(shape, seed):
    """Random K/V rows with an all-zero row (scale 1) and a wide row."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0
    x.reshape(-1, shape[-1])[1] *= 50.0
    return x


def _quant(shape, seed):
    """The same int8 leaf for JAX and the port: (JAX QuantKV, port QuantKV)."""
    xq, xs = (np.array(a) for a in j_quantize_rows(jnp.asarray(_rows(shape, seed))))
    return JKV.QuantKV(jnp.asarray(xq), jnp.asarray(xs)), TKV.QuantKV(
        torch.from_numpy(xq), torch.from_numpy(xs))


def _np(leaf):
    return [np.asarray(t) for t in leaf]


# -- ops/kv_cache -------------------------------------------------------------


def test_quantize_kv_rows_matches_jax():
    x = _rows((2, 3, 5, 16), 1)
    xq, xs = TKV.quantize_kv_rows(torch.from_numpy(x))
    jq, js = j_quantize_rows(jnp.asarray(x))
    assert xq.dtype == torch.int8 and xq.shape == x.shape and xs.shape == (2, 3, 5, 1)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(js))
    # bf16 rows quantize from their f32 values
    xb = torch.from_numpy(x).to(torch.bfloat16)
    bq, bs = TKV.quantize_kv_rows(xb)
    jq, js = j_quantize_rows(jnp.asarray(xb.float().numpy()))
    np.testing.assert_array_equal(bq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(bs.numpy(), np.asarray(js))


def test_dequant_slice_and_pages_match_jax():
    j, t = _quant((7, 2, 4, 16), 2)  # a pool leaf: 7 pages of 4 rows
    assert t.shape == (7, 2, 4, 16) and t.dtype == torch.int8
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = TKV.dequant_kv(t, dtype).float().numpy()
        np.testing.assert_array_equal(got, np.asarray(JKV.dequant_kv(j, jdtype), np.float32))
    dense = torch.randn(3, 4)
    assert TKV.dequant_kv(dense, torch.float32) is dense
    ids = np.asarray([5, 1, 3], np.int32)
    tid = torch.from_numpy(ids)
    for a, b in zip(_np(TKV.gather_pages(t, tid)), _np(JKV.gather_pages(j, jnp.asarray(ids)))):
        np.testing.assert_array_equal(a, b)
    rj, rt = _quant((2, 12, 16), 3)  # [KH, n * ps, hd] rows for three pages
    got = TKV.scatter_pages(t, tid, rt)
    want = JKV.scatter_pages(j, jnp.asarray(ids), rj)
    for a, b in zip(_np(got), _np(want)):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(t.q, _quant((7, 2, 4, 16), 2)[1].q)  # a copy: the pool is untouched
    np.testing.assert_array_equal(
        TKV.paged_view(t, tid, torch.float32).numpy(),
        np.asarray(JKV.paged_view(j, jnp.asarray(ids), jnp.float32)))
    # lane_views: every lane's gather, QuantKV leaf by leaf
    pt = torch.tensor([[5, 1, 3], [2, 2, 6]], dtype=torch.int32)
    views = TKV.lane_views(t, pt)
    for lane in range(2):
        for a, b in zip(views, TKV.gather_pages(t, pt[lane])):
            assert torch.equal(a[lane], b)
    sj, st = _quant((2, 2, 9, 16), 4)  # slab [B, KH, S, hd]
    for w in (0, 5):
        for a, b in zip(_np(TKV.slice_kv(st, w)), _np(JKV.slice_kv(sj, w))):
            np.testing.assert_array_equal(a, b)


def test_layer_leaf_views_and_fresh_leaves():
    leaf = TKV.new_kv_leaf((2, 3, 4, 16), torch.int8, "cpu")
    assert leaf.q.dtype == torch.int8 and leaf.s.shape == (2, 3, 4, 1)
    assert torch.all(leaf.q == 0) and torch.all(leaf.s == 1)
    lay = TKV.kv_layer(leaf, 1)
    lay.q.fill_(3)
    lay.s.fill_(0.5)  # a view: the write lands in the leaf
    assert torch.all(leaf.q[1] == 3) and torch.all(leaf.s[1] == 0.5)
    TKV.reset_kv_leaf(leaf)
    assert torch.all(leaf.q == 0) and torch.all(leaf.s == 1)
    assert len(TKV.kv_tensors(leaf)) == 2 and len(TKV.kv_tensors(leaf.q)) == 1


# -- the plain versions against the TPU kernels' QuantKV branches --------------


@pytest.mark.parametrize("q_pos0", [[0, 0], [0, 9], [16, -16], [3, 12]])
def test_stats_ref_matches_interpret_kernel(q_pos0):
    b, t, h, kh, s, hd = 2, 16, 4, 2, 32, 16
    q = np.random.default_rng(sum(q_pos0) + 7).standard_normal((b, t, h, hd)).astype(np.float32)
    (jk, tk), (jv, tv) = _quant((b, kh, s, hd), 10), _quant((b, kh, s, hd), 11)
    pos = jnp.asarray(q_pos0, jnp.int32)
    got = TF.flash_attention_stats(torch.from_numpy(q), tk, tv, q_pos0)
    kern = JF.flash_attention_stats(jnp.asarray(q), jk, jv, pos, jnp.int32(0),
                                    block_t=8, block_s=8, interpret=True)
    for a, w in zip(got, kern):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)
    if q_pos0[1] == -t:  # parked lane: fully masked, zero state
        acc, m, l = got
        assert torch.all(l[1] == 0) and torch.all(acc[1] == 0) and torch.all(m[1] <= -1e29)
    normed = TF.flash_attention(torch.from_numpy(q), tk, tv, q_pos0)
    want = JF.flash_attention(jnp.asarray(q), jk, jv, pos, block_t=8, block_s=8, interpret=True)
    np.testing.assert_allclose(normed.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hd", [16, 64, 128])
def test_paged_stats_ref_matches_interpret_kernel_on_gathered_view(hd):
    """Admission chunks through a shuffled table (two lanes share pages)
    against the TPU stats kernel's QuantKV branch on each lane's gathered
    pages (the JAX engine's route)."""
    rng = np.random.default_rng(hd)
    g, kh, b, nb, ps, t = 2, 2, 3, 5, 4, 8
    pj, pt_ = _quant((1 + b * nb, kh, ps, hd), hd + 1)
    vj, vt = _quant((1 + b * nb, kh, ps, hd), hd + 2)
    pt = (1 + rng.permutation(b * nb)).reshape(b, nb).astype(np.int32)
    pt[1, :2] = pt[0, :2]
    q_pos0 = np.asarray([0, 5, 12], np.int32)
    q = rng.standard_normal((b, t, kh * g, hd)).astype(np.float32)
    got = TF.paged_flash_attention_stats(torch.from_numpy(q), pt_, vt, torch.from_numpy(pt),
                                         torch.from_numpy(q_pos0))
    kd = JKV.QuantKV(*(jnp.stack(x) for x in zip(*(JKV.gather_pages(pj, jnp.asarray(r))
                                                      for r in pt))))
    vd = JKV.QuantKV(*(jnp.stack(x) for x in zip(*(JKV.gather_pages(vj, jnp.asarray(r))
                                                      for r in pt))))
    want = JF.flash_attention_stats(jnp.asarray(q), kd, vd, jnp.asarray(q_pos0), jnp.int32(0),
                                    block_t=8, block_s=4, interpret=True)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w).reshape(a.shape), **TOL)


@pytest.mark.parametrize("g", [2, 4])
def test_paged_decode_ref_matches_interpret_kernel(g):
    """QuantKV pool, shuffled table with shared pages, a parked lane."""
    rng = np.random.default_rng(g)
    kh, hd, b, nb, ps = 2, 16, 3, 6, 4
    kj, kt = _quant((1 + b * nb, kh, ps, hd), 20 + g)
    vj, vt = _quant((1 + b * nb, kh, ps, hd), 30 + g)
    pt = (1 + rng.permutation(b * nb)).reshape(b, nb).astype(np.int32)
    pt[2, :3] = pt[0, :3]
    for pos in ([0, 3, 4], [23, -1, 11], [7, 16, -1]):
        pos = np.asarray(pos, np.int32)
        q = rng.standard_normal((b, 1, kh * g, hd)).astype(np.float32)
        got = TF.paged_flash_decode(torch.from_numpy(q), kt, vt, torch.from_numpy(pt),
                                    torch.from_numpy(pos))
        want = JF.paged_flash_decode(jnp.asarray(q), kj, vj, jnp.asarray(pt), jnp.asarray(pos),
                                     interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for lane in np.flatnonzero(pos < 0):
            assert torch.all(got[lane] == 0)


@pytest.mark.parametrize("pos", [[0, 0], [5, 30], 17])
def test_slab_decode_ref_matches_dequant_then_dense(pos):
    """The port's int8 slab decode route against the JAX engine's:
    ``dequant_kv`` then dense attention, f32."""
    b, h, kh, s, hd = 2, 8, 2, 32, 16
    q = np.random.default_rng(40).standard_normal((b, 1, h, hd)).astype(np.float32)
    (jk, tk), (jv, tv) = _quant((b, kh, s, hd), 41), _quant((b, kh, s, hd), 42)
    got = TF.flash_decode(torch.from_numpy(q), tk, tv, pos)
    kd, vd = JKV.dequant_kv(jk, jnp.float32), JKV.dequant_kv(jv, jnp.float32)
    if isinstance(pos, int):
        want = J.attention_dense(jnp.asarray(q), kd, vd, jnp.int32(pos))
    else:
        acc, _, l = J.attention_stats(jnp.asarray(q), kd, vd, jnp.asarray(pos, jnp.int32), 0)
        want = (acc / jnp.where(l == 0, 1.0, l)[..., None]).transpose(0, 3, 1, 2, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(b, 1, h, hd), **TOL)


def test_cpu_wrappers_launch_nothing_and_mixed_pairs_raise():
    names = ("flash_attention_stats_kv8", "flash_decode_kv8", "paged_flash_decode_kv8")
    before = [getattr(TF, n).launches for n in names]
    _, k = _quant((1, 2, 8, 16), 50)
    _, v = _quant((1, 2, 8, 16), 51)
    TF.flash_attention_stats(torch.randn(1, 4, 4, 16), k, v, 0)
    TF.flash_decode(torch.randn(1, 1, 4, 16), k, v, 5)
    pool = TKV.QuantKV(k.q.reshape(4, 2, 2, 16).contiguous(), k.s.reshape(4, 2, 2, 1).contiguous())
    TF.paged_flash_decode(torch.randn(1, 1, 4, 16), pool, pool,
                          torch.tensor([[1, 2]], dtype=torch.int32),
                          torch.tensor([3], dtype=torch.int32))
    assert [getattr(TF, n).launches for n in names] == before
    with pytest.raises(TypeError, match="both be QuantKV"):
        TF.flash_decode(torch.randn(1, 1, 4, 16), k, torch.randn(1, 2, 8, 16), 5)


# -- the engine, the lanes, the graphs, the CLI and the server -----------------


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("kv_int8")
    llama, moe, tok = str(d / "m.m"), str(d / "moe.m"), str(d / "t.t")
    make_tiny_model(llama, cfg=CFG)
    make_tiny_model(moe, arch=LlmArch.QWEN3_MOE)
    make_tiny_tokenizer(tok, pad_to=CFG["vocab_size"])
    return {"llama": llama, "qwen3_moe": moe, "tok": tok}


def _engine(mp, **kw):
    return InferenceEngine(mp, dtype=torch.float32, temperature=0.0, weight_format="q40",
                           device="cpu", kv_dtype="int8", **kw)


@pytest.mark.parametrize("arch", ["llama", "qwen3_moe"])
@pytest.mark.parametrize("prompt,steps,block", [([1, 2, 3, 4], 24, 8),
                                                (list(range(5, 18)), 40, 5)])
def test_greedy_stream_matches_jax_int8_engine(models, arch, prompt, steps, block):
    mp = models[arch]
    jeng = JEngine(mp, tp=1, dtype=jnp.float32, temperature=0.0, weight_format="q40",
                   kv_dtype="int8")
    want = jeng.generate(prompt, max_steps=steps, block_size=block)[0]
    eng = _engine(mp)
    assert isinstance(eng.cache["k"], TKV.QuantKV)
    assert eng.generate(prompt, max_steps=steps, block_size=block)[0] == want


def test_cache_bytes_and_kv_dtype_names(models):
    mp = models["llama"]
    e8, ef = _engine(mp), InferenceEngine(mp, dtype=torch.float32, device="cpu")
    nbytes = [sum(t.numel() * t.element_size() for leaf in e.cache.values()
                  for t in TKV.kv_tensors(leaf)) for e in (e8, ef)]
    hd = CFG["head_dim"]
    # int8: one byte a value and a 4-byte scale a row of hd values; f32 four bytes a value
    assert nbytes[0] * 4 * hd == nbytes[1] * (hd + 4)
    assert InferenceEngine(mp, dtype=torch.float32, device="cpu", kv_dtype="f32").kv_dtype == \
        torch.float32
    with pytest.raises(ValueError, match="kv_dtype"):
        InferenceEngine(mp, dtype=torch.float32, device="cpu", kv_dtype="int4")
    # a float cache other than dtype (as the JAX engine keeps one): half of f32's bytes
    eb = InferenceEngine(mp, dtype=torch.float32, device="cpu", kv_dtype="bf16")
    assert eb.kv_dtype == torch.bfloat16 and eb.cache["k"].dtype == torch.bfloat16
    assert 2 * sum(t.numel() * t.element_size() for t in eb.cache.values()) == nbytes[1]


def _native(e):
    """Pool-native lanes with private identity pages (page 0 is scratch)."""
    e.init_kv_pool(4, native=True)
    nb = e._kv_n_blocks
    for lane in range(e.batch_size):
        e.adopt_pages(lane, list(range(1 + lane * nb, 1 + (lane + 1) * nb)))
    return e


def _lane_stream(e, lane, prompt, steps, block=4):
    """Greedy decode of one lane (the other lanes parked) after its prefill."""
    e.prefill_lane(lane, prompt)
    toks, tok, pos = [], prompt[-1], len(prompt) - 1
    active = [i == lane for i in range(e.batch_size)]
    while len(toks) < steps:
        rows = e.decode_lanes([tok if i == lane else 0 for i in range(e.batch_size)],
                              [pos if i == lane else 0 for i in range(e.batch_size)],
                              min(block, steps - len(toks)), active)
        toks += [r[lane] for r in rows]
        tok, pos = toks[-1], pos + len(rows)
    return toks


@pytest.mark.parametrize("arch", ["llama", "qwen3_moe"])
def test_native_lanes_equal_slab_int8_engine(models, arch):
    mp = models[arch]
    want = _engine(mp).generate(PROMPT, max_steps=len(PROMPT) - 1 + 12, block_size=4)[0]
    e = _native(_engine(mp, batch_size=2))
    assert isinstance(e.kv_pool["k"], TKV.QuantKV)
    assert _lane_stream(e, 1, PROMPT, 12) == want
    jeng = JEngine(mp, tp=1, dtype=jnp.float32, temperature=0.0, weight_format="q40",
                   kv_dtype="int8", batch_size=2)
    jeng.init_kv_pool(4, native=True)
    nb = jeng._kv_n_blocks
    jeng.adopt_pages(1, list(range(1, nb + 1)))
    assert _lane_stream(jeng, 1, PROMPT, 12) == want


def test_cow_fork_carries_scales_and_reset_restores_them(models):
    mp = models["llama"]
    fresh = _lane_stream(_native(_engine(mp, batch_size=2)), 0, PROMPT, 10)
    e = _engine(mp, batch_size=2)
    kv = PagedKVManager(e, page_size=4, native=True)
    kv.adopt(0, kv.match(0, PROMPT)[1])
    first = _lane_stream(e, 0, PROMPT, 10)
    kv.publish(0, PROMPT + first)
    kv.release_lane(0)
    # a prompt that shares PROMPT's first 22 tokens: a mid-page match (22 % 4)
    other = PROMPT[:22] + [7, 8, 9]
    m, pages = kv.match(1, other)
    assert m == 22 and m % 4
    forks, copies = kv.pool.stats().cow_forks, e.kv_copy_pages
    kv.adopt(1, pages)
    assert kv.pool.stats().cow_forks == forks + 1 and e.kv_copy_pages == copies + 1
    src, fork = pages[-1], kv._lane_pages[1][len(pages) - 1]
    assert fork != src
    for leaf in e.kv_pool.values():
        for t in TKV.kv_tensors(leaf):
            assert torch.equal(t[:, fork], t[:, src])
    assert not torch.all(e.kv_pool["k"].s[:, src] == 1)  # real scales, not the fresh ones
    assert first == fresh
    # the shared prefix's stream from the fork equals a cold run of `other`
    e2 = _native(_engine(mp, batch_size=2))
    want = _lane_stream(e2, 1, other, 6)
    tok, pos = other[-1], len(other) - 1
    e.prefill_lane_chunk(1, other[m:-1], m)
    rows = e.decode_lanes([0, tok], [0, pos], 6, [False, True])
    assert [r[1] for r in rows] == want
    e.reset_kv_pool()
    assert all(torch.all(leaf.q == 0) and torch.all(leaf.s == 1) for leaf in e.kv_pool.values())
    assert e.kv_page_bytes() == 2 * CFG["n_layers"] * CFG["n_kv_heads"] * 4 * (CFG["head_dim"] + 4)


class ReplayingGraphs(StepGraphs):
    """Graphs forced on, on the CPU, whose replay runs the step captured on
    the key's first use (it sees a call's inputs only through the static
    buffers, as a CUDA graph does)."""

    active = True

    def __init__(self):
        super().__init__(torch.device("cpu"))

    def _record(self, step):
        return types.SimpleNamespace(replay=step)


def test_replayed_int8_engine_equals_eager(models):
    mp = models["llama"]
    eager, graphed = _engine(mp), _engine(mp)
    graphed.graphs = ReplayingGraphs()
    for block in (8, 1):  # decode blocks, then decode_step
        want = eager.generate([1, 2, 3, 4, 5], max_steps=40, block_size=block)[0]
        assert graphed.generate([1, 2, 3, 4, 5], max_steps=40, block_size=block)[0] == want
    again = list(range(9, 30))
    assert graphed.generate(again, max_steps=50)[0] == eager.generate(again, max_steps=50)[0]
    assert graphed.graphs.replays > 0
    for prompt in ([3, 1, 4, 1, 5, 9, 2, 6, 5], [2, 7, 1, 8, 2, 8, 1, 8, 2]):
        assert graphed.perplexity(prompt) == eager.perplexity(prompt)


def test_replayed_int8_lanes_equal_eager(models):
    """Lane prefill chunks and lane decode blocks over the int8 pool, replayed."""
    mp = models["llama"]
    eager = _native(_engine(mp, batch_size=2))
    graphed = _engine(mp, batch_size=2)
    graphed.graphs = ReplayingGraphs()
    _native(graphed)
    for lane, prompt in ((0, PROMPT), (1, PROMPT[:9])):
        assert _lane_stream(graphed, lane, prompt, 10) == _lane_stream(eager, lane, prompt, 10)
    assert graphed.graphs.replays > 0


def test_cli_inference_with_int8_kv(models, capsys):
    res = cli.main(["inference", "--model", models["llama"], "--tokenizer", models["tok"],
                    "--prompt", "hello world", "--steps", "20", "--temperature", "0",
                    "--device", "cpu", "--dtype", "f32", "--weight-format", "q40",
                    "--kv-dtype", "int8"])
    assert res["engine"].kv_dtype == torch.int8
    want = _engine(models["llama"]).generate(res["prompt_tokens"], max_steps=20)[0]
    assert res["tokens"] == want
    assert "KvDtype: int8" in capsys.readouterr().out


def test_server_with_int8_kv_matches_jax_and_health(tmp_path):
    mp, tp_ = str(tmp_path / "s.m"), str(tmp_path / "s.t")
    make_tiny_model(mp, cfg=dict(CFG, seq_len=384))
    make_tiny_tokenizer(tp_, chat_template="<|start_header_id|>", pad_to=CFG["vocab_size"])
    parser = argparse.ArgumentParser()
    cli.add_engine_args(parser)
    args = parser.parse_args(["--model", mp, "--tokenizer", tp_, "--device", "cpu", "--dtype",
                              "f32", "--weight-format", "q40", "--batch-size", "2",
                              "--temperature", "0", "--seed", "3", "--kv-dtype", "int8"])
    eng, tok = cli.load_engine(args)
    jtok = JTokenizer(tp_)
    jeng = JEngine(mp, tokenizer=jtok, tp=1, dtype=jnp.float32, temperature=0.0, seed=3,
                   batch_size=2, weight_format="q40", kv_dtype="int8")
    servers = [serve(eng, tok, host="127.0.0.1", port=0, kv_page_size=8, kv_native=True),
               jserve(jeng, jtok, host="127.0.0.1", port=0)]
    try:
        urls = []
        for srv in servers:
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            urls.append(f"http://127.0.0.1:{srv.server_address[1]}")

        def ask(url, content):
            payload = {"messages": [{"role": "user", "content": content}], "max_tokens": 10,
                       "temperature": 0}
            req = urllib.request.Request(url + "/v1/chat/completions",
                                         data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                return json.loads(r.read())["choices"][0]

        got, want = ask(urls[0], "the quick brown"), ask(urls[1], "the quick brown")
        assert got["message"] == want["message"] and got["finish_reason"] == want["finish_reason"]
        assert ask(urls[0], "the quick brown") == got  # again, over its stored prefix
        with urllib.request.urlopen(urls[0] + "/v1/health") as r:
            health = json.loads(r.read())["kv"]
        assert health["dtype"] == "int8"
        assert health["page_bytes"] == eng.kv_page_bytes() == \
            2 * CFG["n_layers"] * CFG["n_kv_heads"] * 8 * (CFG["head_dim"] + 4)
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
