"""The int8 KV cache under sequence parallelism on CPU, against the JAX package.

The port's ranks are processes over gloo (parallel/launch.py); one world of
2 ranks and one of 4 are spawned for the module and run their jobs in turn
(`jobs_target`). The JAX package runs on the 8 host devices
tests/conftest.py sets. The cases:

* the plain versions of the two strided int8 entries: the stats over an
  int8 cyclic shard against the TPU kernel's QuantKV x ``s_stride``
  branch in interpret mode (the cases of tests/test_flash_and_ring.py's
  ``test_flash_stats_quantkv_strided``), the decode stats against the jnp
  stats the JAX engine's int8 sp decode runs on the dequantized shard;
* the ring over QuantKV shards (their int8 values and f32 scales shifted
  rank to rank) against JAX's ``ring_attention_local`` over the same
  shards, with the flash-stats local step in interpret mode and with the
  jnp one (``test_ring_cyclic_flash_quantkv``), at sp 2 and 4;
* greedy streams with ``kv_dtype="int8"`` at sp 2, tp 2 x sp 2 and pp 2 x
  sp 2, and a Qwen3-MoE file at tp 2 x sp 2, against the JAX engine at the
  same mesh (which its own tests hold to its one-device int8 stream,
  exactly) and the port's one-rank int8 engine; prefill logits against the
  one rank's;
* slab lanes over an int8 slab at sp 2 and tp 2 x sp 2 with the page
  pool's copies (a publish gathered over the shards, an adopt that each
  shard takes its rows of), held to the JAX and port engines at sp 1 (the
  JAX engine's own slab copies under sp part from its sp = 1 streams,
  ROADMAP C), and the same lanes with no copies and a verify pass against
  the JAX engine at sp 2;
* the int8 server over slab lanes at sp 2 and tp 2 x sp 2, its answers
  byte-equal to the one-rank int8 server's.

Tolerances: the plain versions within 1e-5 of the JAX functions (the
cache is dequantized in f32 on both sides; they differ in sum order only);
the ring within 1e-5 of JAX's; prefill logits within 2e-4 of the one rank's
(f32; the split changes sum order only); greedy streams, lane returns and
served answers equal.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats import FloatType
from dllama_tpu.formats.model_file import LlmArch
from dllama_tpu.ops.flash_attention import flash_attention_stats as jflash_stats
from dllama_tpu.ops.jnp_ops import attention_stats as jattention_stats
from dllama_tpu.ops.kv_cache import QuantKV as JQuantKV
from dllama_tpu.ops.kv_cache import dequant_kv as jdequant_kv
from dllama_tpu.ops.kv_cache import quantize_kv_rows as jquantize_kv_rows
from dllama_tpu.parallel import make_mesh as jmake_mesh
from dllama_tpu.parallel.ring_attention import ring_attention_local as jring_local
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu.utils.compat import shard_map_compat as shard_map
from dllama_tpu_torch.ops.flash_attention import (
    flash_attention_stats, flash_decode_stats, flash_decode_stats_ref,
)
from dllama_tpu_torch.ops.kv_cache import QuantKV
from dllama_tpu_torch.parallel.launch import ask_all, jobs_target, spawn
from dllama_tpu_torch.runtime.api_server import serve
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.tokenizer import Tokenizer

from helpers import make_tiny_model, make_tiny_tokenizer
from test_torch_parallel_lanes import slab_script, slab_verify_script

CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=64)
CFG_MOE = dict(dim=128, hidden_dim=256, moe_hidden_dim=128, n_layers=2, n_heads=8,
               n_kv_heads=4, head_dim=16, vocab_size=288, seq_len=64, n_experts=8,
               n_active_experts=2)
TOKENS = [3, 17, 92, 5, 44, 120, 7, 3]
CALLS = [([1, 2, 3, 4, 5, 6, 7, 8, 9], 21, 8, 0), ([9, 8, 7, 6, 5, 4, 3, 2, 1], 34, 8, 21)]
LONG = [(list(range(5, 45)), 52, 8, 0)]
REQUESTS = [{"messages": [{"role": "user", "content": f"request {i}: " + "hello world " * i}],
             "max_tokens": 12, "temperature": 0} for i in range(5)]
SPAWN = dict(timeout_s=300, pg_timeout_s=60)
RING = (1, 32, 4, 2, 16)  # b, t, h, kh, hd of the ring case


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("kv_int8_sp")
    out = {"dense": str(d / "dense.m"), "moe": str(d / "moe.m"), "serve": str(d / "serve.m"),
           "tok": str(d / "t.t")}
    make_tiny_model(out["dense"], weight_type=FloatType.F32, cfg=CFG)
    make_tiny_model(out["moe"], arch=LlmArch.QWEN3_MOE, cfg=CFG_MOE)
    make_tiny_model(out["serve"], weight_type=FloatType.F32, cfg=dict(CFG, seq_len=384))
    make_tiny_tokenizer(out["tok"], chat_template="<|start_header_id|>", pad_to=288)
    return out


def _qkv(b, t, h, kh, hd, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, hd)).astype(np.float32),
            rng.standard_normal((b, kh, s, hd)).astype(np.float32),
            rng.standard_normal((b, kh, s, hd)).astype(np.float32))


def _quant(k, v):
    """The int8 pair of k and v by the JAX quantizer, in both packages'
    QuantKV: (JAX k, JAX v), (port k, port v)."""
    jk, jv = (JQuantKV(*jquantize_kv_rows(jnp.asarray(a))) for a in (k, v))
    port = tuple(QuantKV(torch.from_numpy(np.array(x.q)), torch.from_numpy(np.array(x.s)))
                 for x in (jk, jv))
    return (jk, jv), port


# -- the plain versions ---------------------------------------------------------------


@pytest.mark.parametrize("stride,s0,qpos", [(2, 0, 8), (2, 1, 8), (4, 3, 0), (2, 0, 50)])
def test_int8_strided_stats_match_tpu_kernel_interpret(stride, s0, qpos):
    q, k, v = _qkv(1, 16, 4, 2, 16, 32, seed=33)
    (jk, jv), (pk, pv) = _quant(k, v)
    want = jflash_stats(jnp.asarray(q), jk, jv, jnp.int32(qpos), jnp.int32(s0), block_t=8,
                        block_s=8, interpret=True, s_stride=stride)
    got = flash_attention_stats(torch.from_numpy(q), pk, pv, qpos, s0, s_stride=stride)
    acc, m, l = (np.asarray(x) for x in want)
    mask = l > 0
    assert (got[2].numpy() > 0).tolist() == mask.tolist()
    np.testing.assert_allclose(got[2].numpy(), l, rtol=1e-5, atol=1e-5)
    if mask.any():
        np.testing.assert_allclose(got[1].numpy()[mask], m[mask], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[0].numpy()[mask], acc[mask], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pos,s0,stride", [(63, 0, 2), (63, 1, 2), (20, 3, 4), (0, 1, 2)])
def test_int8_decode_stats_match_jnp_stats(pos, s0, stride):
    q, k, v = _qkv(2, 1, 8, 4, 16, 32, seed=7)
    (jk, jv), (pk, pv) = _quant(k, v)
    acc, m, l = (np.asarray(x) for x in jattention_stats(
        jnp.asarray(q), jdequant_kv(jk, jnp.float32), jdequant_kv(jv, jnp.float32),
        jnp.int32(pos), jnp.int32(s0), s_stride=stride))
    got = flash_decode_stats(torch.from_numpy(q), pk, pv, pos, s0, stride)
    for a, b in zip(got, flash_decode_stats_ref(torch.from_numpy(q), pk, pv, pos, s0, stride)):
        assert torch.equal(a, b)  # on the CPU the wrapper is its plain version
    for a, b in zip(got, (acc, m, l)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)


# -- the worlds -------------------------------------------------------------------------


def _ring_job(sp):
    b, t, h, kh, hd = RING
    q, k, v = _qkv(b, t, h, kh, hd, t, seed=35)
    (jk, jv), _ = _quant(k, v)
    pair = lambda x: (np.asarray(x.q), np.asarray(x.s))  # noqa: E731
    shard = t // sp
    rows = [list(range(r * shard, (r + 1) * shard)) for r in range(sp)]
    return ("ring", (q, pair(jk), pair(jv), 0, True, rows))


def _engine(model, tp=1, sp=1, **kw):
    return ("engine", dict(model=model, tp=tp, sp=sp, kv_dtype="int8", logits=TOKENS,
                           generate=CALLS + LONG, **kw))


def _lanes(model, tp, sp, script):
    return ("lanes", dict(model=model, tp=tp, sp=sp, kv_dtype="int8", batch_size=3,
                          script=script))


def _serve(files, tp, sp):
    return ("serve", dict(model=files["serve"], tokenizer=files["tok"], tp=tp, sp=sp,
                          kv_dtype="int8", batch_size=4, requests=REQUESTS,
                          serve=dict(kv_native=False)))


# (name, kind, tp, sp, extra): each world's jobs, in order
JOBS = {
    2: [("ring-sp2", "ring", 1, 2, {}),
        ("engine-sp2", "engine", 1, 2, {}),
        ("slab-sp2", "lanes", 1, 2, dict(script="copies")),
        ("slab-verify-sp2", "lanes", 1, 2, dict(script="verify")),
        ("serve-sp2", "serve", 1, 2, {})],
    4: [("ring-sp4", "ring", 1, 4, {}),
        ("engine-tp2sp2", "engine", 2, 2, {}),
        ("engine-pp2sp2", "engine", 1, 2, dict(pp=2)),
        ("engine-moe-tp2sp2", "engine", 2, 2, dict(model="moe", weight_format="q40")),
        ("slab-tp2sp2", "lanes", 2, 2, dict(script="copies")),
        ("serve-tp2sp2", "serve", 2, 2, {})],
}
SCRIPTS = {"copies": slab_script, "verify": slab_verify_script}


def _jobs(files, world):
    out = []
    for _, kind, tp, sp, kw in JOBS[world]:
        kw = dict(kw)
        if kind == "ring":
            out.append(_ring_job(sp))
        elif kind == "engine":
            out.append(_engine(files[kw.pop("model", "dense")], tp, sp, **kw))
        elif kind == "lanes":
            out.append(_lanes(files["dense"], tp, sp, SCRIPTS[kw["script"]]()))
        else:
            out.append(_serve(files, tp, sp))
    return out


@pytest.fixture(scope="module")
def world2(files):
    return spawn(jobs_target, 2, "cpu", args=(_jobs(files, 2),), **SPAWN)


@pytest.fixture(scope="module")
def world4(files):
    return spawn(jobs_target, 4, "cpu", args=(_jobs(files, 4),), **SPAWN)


def _case(world2, world4, name):
    world = 2 if name in [j[0] for j in JOBS[2]] else 4
    i = [j[0] for j in JOBS[world]].index(name)
    return JOBS[world][i], [r[i] for r in (world2 if world == 2 else world4)]


def _cases(kind):
    return [j[0] for w in (2, 4) for j in JOBS[w] if j[1] == kind]


# -- the ring -------------------------------------------------------------------------


def _jax_ring(sp, use_flash):
    from jax.sharding import PartitionSpec as P

    b, t, h, kh, hd = RING
    q, k, v = _qkv(b, t, h, kh, hd, t, seed=35)
    (jk, jv), _ = _quant(k, v)
    shard = t // sp

    def body(qq, kk, ks, vv, vs):
        idx = jax.lax.axis_index("sp")
        return jring_local(qq, JQuantKV(kk, ks), JQuantKV(vv, vs), q_pos0=idx * (t // sp),
                           shard_size=jnp.int32(shard), axis_name="sp", use_flash=use_flash,
                           interpret=True, cyclic=True)

    kv = P(None, None, "sp", None)
    return np.asarray(shard_map(body, mesh=jmake_mesh(sp=sp),
                                in_specs=(P(None, "sp", None, None), kv, kv, kv, kv),
                                out_specs=P(None, "sp", None, None), check_vma=False)(
        jnp.asarray(q), jk.q, jk.s, jv.q, jv.s))


@pytest.mark.parametrize("name", _cases("ring"))
def test_ring_over_int8_shards_matches_jax(world2, world4, name):
    (_, _, _, sp, _), res = _case(world2, world4, name)
    for out in res:
        assert np.array_equal(out, res[0])
    for use_flash in (True, False):
        np.testing.assert_allclose(res[0], _jax_ring(sp, use_flash), rtol=1e-5, atol=1e-5)


# -- the engine -------------------------------------------------------------------------


def _same_on_every_rank(res):
    for other in res[1:]:
        for key in ("logits", "generate", "script", "summary", "launches", "cache_epoch"):
            if key not in res[0]:
                continue
            a, b = res[0][key], other[key]
            assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b, key
    return res[0]


def _one_rank(model, weight_format="dense"):
    eng = InferenceEngine(model, dtype=torch.float32, temperature=0.0, device="cpu",
                          kv_dtype="int8", weight_format=weight_format)
    logits = eng.prompt_logits(TOKENS).numpy()
    eng.reset()
    return logits, [eng.generate(p, max_steps=s, block_size=b, start_pos=st)[0]
                    for p, s, b, st in CALLS + LONG]


@pytest.mark.parametrize("name", _cases("engine"))
def test_int8_engine_matches_jax_and_one_rank(files, world2, world4, name):
    (_, _, tp, sp, kw), res = _case(world2, world4, name)
    x = _same_on_every_rank(res)
    model = files[kw.get("model", "dense")]
    logits, streams = _one_rank(model, kw.get("weight_format", "dense"))
    got = [g[0] for g in x["generate"]]
    assert got == streams
    np.testing.assert_allclose(x["logits"], logits, rtol=2e-4, atol=2e-4)
    jeng = JEngine(model, dtype=jnp.float32, temperature=0.0, kv_dtype="int8", tp=tp, sp=sp,
                   pp=kw.get("pp", 1))
    assert got == [jeng.generate(p, max_steps=s, block_size=b, start_pos=st)[0]
                   for p, s, b, st in CALLS + LONG]
    # every rank's cache: int8 values [L/pp, 1, KH/tp, S/sp, hd]
    assert x["cache_shape"] == [2 // kw.get("pp", 1), 1, 4 // tp, 64 // sp, 16]


# -- slab lanes ---------------------------------------------------------------------------


def _plain(v):
    if isinstance(v, (list, tuple)):
        return [_plain(a) for a in v]
    return int(v) if isinstance(v, (int, np.integer)) else None


def _script(eng, script):
    out = []
    for name, args in script:
        ret = getattr(eng, name)(*args)
        out.append(_plain(ret) if isinstance(ret, (list, int, np.integer)) else None)
    return out


@pytest.mark.parametrize("name", _cases("lanes"))
def test_int8_slab_lanes_match_sp1(files, world2, world4, name):
    (_, _, tp, sp, kw), res = _case(world2, world4, name)
    x = _same_on_every_rank(res)
    assert not any(isinstance(r, tuple) and r and r[0] == "error" for r in x["script"]), x
    script = SCRIPTS[kw["script"]]()
    copies = kw["script"] == "copies"
    # with copies: the JAX engine at sp 1 (its sp copies part, ROADMAP C)
    jeng = JEngine(files["dense"], dtype=jnp.float32, temperature=0.0, kv_dtype="int8",
                   batch_size=3, tp=tp, sp=1 if copies else sp)
    assert x["script"] == _script(jeng, script)
    one = InferenceEngine(files["dense"], dtype=torch.float32, temperature=0.0, device="cpu",
                          kv_dtype="int8", batch_size=3)
    assert x["script"] == _script(one, script)
    # the rank's shard of the int8 slab [L, B, KH/tp, (S + pad)/sp, hd]
    assert x["lane_shape"] == [2, 3, 4 // tp, (64 + 32) // sp, 16]


# -- serving -------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def truth(files):
    eng = InferenceEngine(files["serve"], dtype=torch.float32, temperature=0.0, device="cpu",
                          kv_dtype="int8", batch_size=4)
    srv = serve(eng, Tokenizer(files["tok"]), host="127.0.0.1", port=0, kv_native=False)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        return ask_all(f"http://127.0.0.1:{srv.server_address[1]}", REQUESTS)
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("name", _cases("serve"))
def test_int8_server_equals_one_rank(world2, world4, truth, name):
    (_, _, tp, sp, _), res = _case(world2, world4, name)
    x = _same_on_every_rank(res)
    answers = x["answers"][0]
    assert all(isinstance(a, str) for a in answers), answers
    assert answers == truth
    assert x["health"]["parallel"] == {"tp": tp, "sp": sp, "backend": "gloo",
                                       "ranks": tp * sp}
    assert x["lane_shape"][2] == 4 // tp
