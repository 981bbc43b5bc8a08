"""Tensor and sequence parallelism of the port on CPU, against the JAX package.

The port's ranks are processes (parallel/launch.py) over gloo on the CPU;
the JAX package runs on the 8 host devices tests/conftest.py sets. Each
world size is spawned once for the module (`world2`, `world4`) and runs
every case of that size in turn (parallel/launch.jobs_target: the ranks
import torch and the port only). Every spawn has a launch timeout and a
process-group timeout, so a hung collective fails its test in seconds.

Tolerances: prefill logits within tests/test_parallel.py's 2e-4 (f32, the
tp/sp split changes sum order only); the q80 all-reduce within 1e-6 of
JAX's ``psum_q80`` and within 2e-2 (relative) of the exact sum
(tests/test_parallel.py's bound); the ring within 1e-5 of JAX's
``ring_attention``. Greedy streams must be equal.
"""

import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu import cli as jcli
from dllama_tpu.formats import FloatType, ModelReader as JReader
from dllama_tpu.formats.model_file import LlmArch
from dllama_tpu.models import forward as jforward, init_kv_cache as jinit_kv_cache
from dllama_tpu.models import load_params as jload_params
from dllama_tpu.parallel import collectives as JC
from dllama_tpu.parallel import make_mesh as jmake_mesh
from dllama_tpu.parallel import mesh as JM
from dllama_tpu.parallel.ring_attention import ring_attention as jring_attention
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu_torch import cli
from dllama_tpu_torch.formats import ModelReader
from dllama_tpu_torch.models.convert import params_from_jax
from dllama_tpu_torch.models.loader import load_params
from dllama_tpu_torch.ops.int8_matmul import pick_group, requantize_params
from dllama_tpu_torch.parallel import collectives as C
from dllama_tpu_torch.parallel import mesh as M
from dllama_tpu_torch.parallel.launch import engine_target, jobs_target, collective_target, spawn
from dllama_tpu_torch.parallel.sharding import role_of, shard_params
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.tokenizer import Tokenizer

from helpers import REPO_ROOT, make_tiny_model, make_tiny_tokenizer

CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
           vocab_size=288, seq_len=64)
# q40 under tp 2: every contraction dim divides by 32 * tp
CFG_Q = dict(CFG, dim=128, hidden_dim=256)
TOKENS = [3, 17, 92, 5, 44, 120, 7, 3]
# a 9-token prompt, then a second turn whose 8-row chunk starts at 21, a
# position that no sp divides (uneven cyclic writes); and a 40-token
# prompt whose fill crosses the 32- and 8-row buckets
CALLS = [([1, 2, 3, 4, 5, 6, 7, 8, 9], 21, 8, 0), ([9, 8, 7, 6, 5, 4, 3, 2, 1], 34, 8, 21)]
LONG = [(list(range(5, 45)), 52, 8, 0)]
PPL_PROMPT = "hello world, the world says hello"
SPAWN = dict(timeout_s=300, pg_timeout_s=60)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    out = {name: str(d / f"{name}.m") for name in ("dense", "qwen3", "q40")}
    make_tiny_model(out["dense"], weight_type=FloatType.F32, cfg=CFG)
    make_tiny_model(out["qwen3"], arch=LlmArch.QWEN3, weight_type=FloatType.F32)
    make_tiny_model(out["q40"], cfg=CFG_Q)
    out["tok"] = str(d / "t.t")
    make_tiny_tokenizer(out["tok"], pad_to=CFG["vocab_size"])
    return out


def _engine_job(model, tp, sp, **kw):
    return ("engine", dict(model=model, tp=tp, sp=sp, **kw))


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, 16, 4, 16)).astype(np.float32),
            rng.standard_normal((1, 2, 16, 16)).astype(np.float32),
            rng.standard_normal((1, 2, 16, 16)).astype(np.float32))


def _ppl_tokens(files):
    return Tokenizer(files["tok"]).encode(PPL_PROMPT, is_start=True, add_special_tokens=True)


def _world2_jobs(files):
    dense, q40 = files["dense"], files["q40"]
    sampled = dict(temperature=0.8, seed=7, generate=[CALLS[0]])
    return [
        _engine_job(dense, 2, 1, logits=TOKENS, generate=CALLS + LONG),
        _engine_job(dense, 1, 2, logits=TOKENS, generate=CALLS + LONG),
        _engine_job(files["qwen3"], 2, 1, logits=TOKENS, generate=CALLS),
        _engine_job(q40, 2, 1, weight_format="q40", logits=TOKENS, generate=CALLS),
        _engine_job(q40, 2, 1, weight_format="q40", buffer_float_type="q80", logits=TOKENS,
                    generate=CALLS),
        _engine_job(dense, 2, 1, **sampled),
        _engine_job(dense, 2, 1, **sampled),
        _engine_job(dense, 2, 1, perplexity=_ppl_tokens(files)),
        ("ring", (*_qkv(2), 0, False)),
        ("ring", (*_qkv(2), 5, True)),
        _engine_job(q40, 2, 1, weight_format="q40i4", logits=TOKENS, generate=CALLS),
        _engine_job(q40, 2, 1, weight_format="q40i8", logits=TOKENS, generate=CALLS),
        _engine_job(dense, 2, 1, kv_dtype="int8", generate=CALLS),
        _engine_job(dense, 2, 1, dtype="bf16", logits=TOKENS, generate=CALLS),
    ]


def _world4_jobs(files):
    dense = files["dense"]
    rng = np.random.default_rng(31)
    x = rng.standard_normal((4, 1, 256)).astype(np.float32)
    x[2, 0, 32:64] = 0.0  # an all-zero block on one rank
    return [
        _engine_job(dense, 4, 1, logits=TOKENS, generate=CALLS),
        _engine_job(dense, 1, 4, logits=TOKENS, generate=CALLS),
        _engine_job(dense, 2, 2, logits=TOKENS, generate=CALLS + LONG),
        ("collective", ("all_reduce", 4, True, x)),
        ("collective", ("all_reduce", 4, False, x)),
        ("collective", ("all_gather", 4, -1, x)),
        ("collective", ("shift", 4, x)),
        ("ring", (*_qkv(4), 0, False)),
        ("ring", (*_qkv(4), 3, True)),
    ]


@pytest.fixture(scope="module")
def world2(files):
    return spawn(jobs_target, 2, "cpu", args=(_world2_jobs(files),), **SPAWN)


@pytest.fixture(scope="module")
def world4(files):
    return spawn(jobs_target, 4, "cpu", args=(_world4_jobs(files),), **SPAWN)


def _same_on_every_rank(results, i):
    first = results[0][i]
    for other in results[1:]:
        r = other[i]
        for key, val in first.items():
            if isinstance(val, np.ndarray):
                assert np.array_equal(val, r[key]), key
            else:
                assert val == r[key], key
    return first


@pytest.fixture(scope="module")
def port_tp1(files):
    """The port's one-rank engines: prefill logits and streams."""
    out = {}
    for name, fmt in (("dense", "dense"), ("qwen3", "dense"), ("q40", "q40")):
        eng = InferenceEngine(files[name], dtype=torch.float32, temperature=0.0,
                              weight_format=fmt, device="cpu")
        logits = eng.prompt_logits(TOKENS).numpy()
        eng.reset()
        streams = [eng.generate(p, max_steps=s, block_size=b, start_pos=st)[0]
                   for p, s, b, st in CALLS + LONG]
        out[name] = logits, streams
    return out


def _jax_streams(model, calls, **kw):
    eng = JEngine(model, dtype=jnp.float32, temperature=0.0, **kw)
    return [eng.generate(p, max_steps=s, block_size=b, start_pos=st)[0]
            for p, s, b, st in calls]


def _jax_logits(model):
    reader = JReader(model)
    h = reader.header
    logits, _ = jforward(jload_params(reader), h, jnp.asarray([TOKENS], jnp.int32), jnp.int32(0),
                         jinit_kv_cache(h, batch_size=1))
    return np.asarray(logits)[0]


# -- the mesh, its checks and the collectives ---------------------------------


def test_validate_tp_and_auto_tp_match_jax(files):
    h, jh = ModelReader(files["dense"]).header, JReader(files["dense"]).header
    for tp in (1, 2, 3, 4, 8, 6):
        try:
            JM.validate_tp(jh, tp)
            want = None
        except ValueError as e:
            want = str(e)
        try:
            M.validate_tp(h, tp)
            got = None
        except ValueError as e:
            got = str(e)
        assert got == want, tp
    for n in (1, 2, 3, 4, 8):
        assert M.auto_tp(files["dense"], n) == JM.auto_tp(files["dense"], n_devices=n)
    assert M.auto_tp(files["dense"]) == 1  # no card on this host


@pytest.mark.parametrize("sp,seq_len", [(3, 64), (0, 64), (8, 60), (2, 64)])
def test_sp_checks_match_jax_engine(tmp_path, sp, seq_len):
    path = str(tmp_path / "m.m")
    make_tiny_model(path, weight_type=FloatType.F32, cfg=dict(CFG, seq_len=seq_len))
    try:
        JEngine(path, sp=sp, dtype=jnp.float32) if sp != 2 else None
        want = None
    except ValueError as e:
        want = str(e)
    try:
        M.validate_sp(ModelReader(path).header, sp)
        got = None
    except ValueError as e:
        got = str(e)
    assert got == want


def test_placement_and_backend_rule():
    assert M.rank_device("cpu", 3) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        M.rank_device("cuda", 0)
    assert M.pick_backend("cpu", 4) == "gloo"
    assert M.pick_backend("cuda", 4) == "nccl"  # a card a rank
    assert M.pick_backend("cuda:0", 4) == "gloo"  # ranks sharing one card
    assert M.pick_backend("cuda:0", 1) == "nccl"
    with pytest.raises(ValueError, match="need 2 ranks"):
        M.make_mesh(2, 1, "cpu")
    one = M.make_mesh(1, 1, "cpu")
    assert (one.world, one.tp.size, one.sp.size) == (1, 1, 1)
    with pytest.raises(ValueError, match="init_method"):
        M.init_distributed(tp=2, sp=1, device="cpu")
    # the launcher places its ranks on the card unless asked for the CPU
    with pytest.raises(RuntimeError, match="is_available"):
        spawn(collective_target, 2, args=([],))
    with pytest.raises(RuntimeError, match="is_available"):
        M.init_distributed(tp=1, sp=1)


def test_q80_quantizer_bit_equal_to_jax():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 7, 128)) * rng.uniform(0.01, 10, (3, 7, 1))).astype(np.float32)
    x[0, 0, :32] = 0.0
    x[1, 2, 64:96] = 0.0
    x[2, 3, 5] = 1e-30
    q, s = C.quantize_q80_blocks(torch.from_numpy(x))
    jq, js = JC.quantize_q80_blocks(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert float(s[0, 0, 0]) == 0.0 and not q[0, 0, :32].any()
    got = C.dequantize_q80_blocks(q, s).numpy()
    assert np.array_equal(got, np.asarray(JC.dequantize_q80_blocks(jq, js)))


def test_collectives_match_jax(world4):
    from jax.sharding import PartitionSpec as P

    from dllama_tpu.utils.compat import shard_map_compat as shard_map

    rng = np.random.default_rng(31)
    x = rng.standard_normal((4, 1, 256)).astype(np.float32)
    x[2, 0, 32:64] = 0.0
    mesh = jmake_mesh(tp=4)
    exact = np.asarray(shard_map(lambda a: jax.lax.psum(a, "tp"), mesh=mesh, in_specs=P("tp"),
                                 out_specs=P("tp"), check_vma=False)(jnp.asarray(x)))[0]
    q80 = np.asarray(shard_map(lambda a: JC.psum_q80(a, "tp"), mesh=mesh, in_specs=P("tp"),
                               out_specs=P("tp"), check_vma=False)(jnp.asarray(x)))[0]
    for rank in world4:
        got_q80, got_exact, gathered, shifted = rank[3:7]
        np.testing.assert_allclose(got_q80, q80, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_exact, exact, rtol=1e-6, atol=1e-6)
        assert np.abs(got_q80 - exact).max() / np.abs(exact).max() < 2e-2
        assert np.array_equal(gathered, np.concatenate(list(x), axis=-1))
    for r, rank in enumerate(world4):
        assert np.array_equal(rank[6], x[(r - 1) % 4])  # i -> i + 1


@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_matches_jax(world, world2, world4):
    results = world2 if world == 2 else world4
    first = 8 if world == 2 else 7
    mesh = jmake_mesh(sp=world)
    for j, (q0, cyclic) in enumerate(((0, False), (5 if world == 2 else 3, True))):
        q, k, v = _qkv(world)
        want = np.asarray(jring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh,
                                          q_pos0=q0, axis_name="sp", use_flash=False))
        for rank in results:
            np.testing.assert_allclose(rank[first + j], want, rtol=1e-5, atol=1e-5)


# -- sharding ------------------------------------------------------------------


def _leaves(params):
    yield from ((k, v) for k, v in params.items() if k != "layers")
    for l, lp in enumerate(params["layers"]):
        yield from ((f"{l}.{k}", v) for k, v in lp.items())


def _whole(parts, key):
    role = role_of(key.split(".")[-1])
    dim = -1 if role == "col" else -2
    if isinstance(parts[0], tuple):
        return tuple(torch.cat([p[i] for p in parts], dim) for i in range(len(parts[0])))
    return torch.cat(parts, dim) if role else parts[0]


@pytest.mark.parametrize("fmt", ["dense", "q40", "q40i4", "q40i8"])
def test_shards_put_together_give_the_whole_weight(files, fmt):
    reader = ModelReader(files["q40"])
    h = reader.header
    load_fmt = "q40" if fmt == "q40i8" else fmt
    whole = load_params(reader, torch.float32, "cpu", load_fmt)
    slices = [load_params(reader, torch.float32, "cpu", load_fmt, shard=(2, r)) for r in range(2)]
    if fmt == "q40i8":
        whole = requantize_params(whole, h, pick_group(h, 2))  # the group a rank can hold
        slices = [requantize_params(s, h, pick_group(h, 2)) for s in slices]
    by_rank = [dict(_leaves(s)) for s in slices]
    for key, val in _leaves(whole):
        got = _whole([br[key] for br in by_rank], key)
        want = tuple(val) if isinstance(val, tuple) else val
        if isinstance(want, tuple):
            assert all(torch.equal(a, b) for a, b in zip(got, want)), key
        else:
            assert torch.equal(got, want), key
    for r in range(2):  # shard_params on a whole dict gives the loader's slices
        for key, a in _leaves(shard_params(whole, h, 2, r)):
            b = by_rank[r][key]
            a, b = (tuple(a), tuple(b)) if isinstance(a, tuple) else ((a,), (b,))
            assert all(torch.equal(x, y) for x, y in zip(a, b)), key


def test_shard_params_of_params_from_jax(files):
    reader = JReader(files["dense"])
    jp = jax.tree.map(np.asarray, jload_params(reader))
    whole = params_from_jax(jp, reader.header, device="cpu")
    own = load_params(ModelReader(files["dense"]), torch.float32, "cpu", "dense", shard=(4, 3))
    own = dict(_leaves(own))
    mesh = M.Mesh(4, 3, M.Axis(4, 3, (0, 1, 2, 3)), M.Axis(1, 0, (3,)), torch.device("cpu"),
                  "gloo")
    for key, a in _leaves(shard_params(whole, reader.header, mesh)):
        assert a.shape == own[key].shape and torch.equal(a, own[key]), key


# -- the engine ------------------------------------------------------------------


@pytest.mark.parametrize("case", [(2, 2, 1, 0), (2, 1, 2, 1), (4, 4, 1, 0), (4, 1, 4, 1),
                                  (4, 2, 2, 2)], ids=lambda c: f"tp{c[1]}-sp{c[2]}")
def test_engine_matches_jax_and_one_rank(files, world2, world4, port_tp1, case):
    world, tp, sp, i = case
    res = _same_on_every_rank(world2 if world == 2 else world4, i)
    logits, streams = port_tp1["dense"]
    np.testing.assert_allclose(res["logits"], _jax_logits(files["dense"]), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(res["logits"], logits, rtol=2e-4, atol=2e-4)
    got = [g[0] for g in res["generate"]]
    calls = CALLS + LONG if tp * sp == 2 or tp == sp else CALLS  # the long prompt: tp 2, sp 2, 2x2
    assert got == streams[:len(calls)]
    assert got == _jax_streams(files["dense"], calls, tp=tp, sp=sp)
    assert res["cache_shape"] == [2, 1, 4 // tp, 64 // sp, 16]
    if sp > 1:
        assert all(b == 1 or b % sp == 0 for b in res["buckets"])


def test_qwen3_tp2_matches_jax(files, world2, port_tp1):
    res = _same_on_every_rank(world2, 2)
    logits, streams = port_tp1["qwen3"]
    np.testing.assert_allclose(res["logits"], logits, rtol=2e-4, atol=2e-4)
    got = [g[0] for g in res["generate"]]
    assert got == streams[:2] == _jax_streams(files["qwen3"], CALLS, tp=2)


def test_q40_tp2_matches_jax(files, world2, port_tp1):
    res = _same_on_every_rank(world2, 3)
    logits, streams = port_tp1["q40"]
    np.testing.assert_allclose(res["logits"], logits, rtol=2e-4, atol=2e-4)
    got = [g[0] for g in res["generate"]]
    assert got == streams[:2] == _jax_streams(files["q40"], CALLS, tp=2, weight_format="q40")


def test_q80_engine_matches_jax_q80_engine(files, world2, monkeypatch):
    """The JAX CPU path skips the shard_map of quantized matmuls (GSPMD
    sums them exactly); as tests/test_parallel.py does, force its
    shard_map branch with the reference matmul, so its col-split partial
    sums go through ``psum_q80`` as on a TPU mesh."""
    from dllama_tpu.ops import quant_matmul as qm

    monkeypatch.setattr(qm, "_use_pallas", lambda: True)
    monkeypatch.setattr(qm, "qmatmul", lambda x, w, block_n=256: qm.qmatmul_ref(x, w))
    res = _same_on_every_rank(world2, 4)
    exact = world2[0][3]
    err = np.abs(res["logits"] - exact["logits"]).max() / np.abs(exact["logits"]).max()
    assert 0 < err < 2e-2
    want = _jax_streams(files["q40"], CALLS, tp=2, weight_format="q40", buffer_float_type="q80")
    assert [g[0] for g in res["generate"]] == want


def test_sampled_stream_same_on_every_rank_and_per_seed(world2):
    a = _same_on_every_rank(world2, 5)
    b = _same_on_every_rank(world2, 6)
    assert a["generate"] == b["generate"] and len(a["generate"][0][0]) == 13


def test_perplexity_lines_match_jax_cli(files, world2, capsys):
    res = _same_on_every_rank(world2, 7)
    argv = ["perplexity", "--model", files["dense"], "--tokenizer", files["tok"], "--prompt",
            PPL_PROMPT, "--dtype", "f32", "--tp", "2"]
    jcli.run_perplexity(jcli._build_parser().parse_args(argv))
    want = capsys.readouterr().out.splitlines()[-4:]
    nll, ppl, n = res["perplexity"]
    got = [f"    nTokens: {n + 1}", f"    nScored: {n}", f"        nll: {nll:.4f}",
           f" perplexity: {ppl:.4f}"]
    assert got[:2] == want[:2]
    # the values to one unit of the last printed place, and 1e-5 relative
    # (sum order: tests/test_torch_perplexity.py's bound)
    for g, w in zip(got[2:], want[2:]):
        g, w = float(g.split(": ")[1]), float(w.split(": ")[1])
        assert abs(g - w) <= 1e-4 + 1e-5 * abs(w), (got, want)


# -- refusals and failures ----------------------------------------------------------


def _fake_mesh(tp, sp, pp=1, dp=1):
    return M.Mesh(tp * sp * pp * dp, 0, M.Axis(tp, 0, tuple(range(tp))),
                  M.Axis(sp, 0, tuple(range(sp))), torch.device("cpu"), "gloo",
                  pp=M.Axis(pp, 0, tuple(range(pp))), dp=M.Axis(dp, 0, tuple(range(dp))))


def test_engine_refusals(files, tmp_path):
    """What the JAX engine refuses raises its messages (native lanes and the
    draft model under sp and under pp, a batch that dp does not divide, a
    pp that does not divide the layers); what waited for ROADMAP A.14 builds:
    an int8 cache under sp holds its int8 shard, Qwen3-MoE under tp its F/tp
    expert slices (their values in tests/test_torch_kv_int8_sp.py and
    tests/test_torch_moe_tp.py); Qwen3-MoE at pp, lanes, the pool and the
    draft model under tp are ported (tests/test_torch_parallel_lanes.py,
    tests/test_torch_pipeline.py)."""
    dense = files["dense"]
    with pytest.raises(ValueError, match="needs this rank's Mesh"):
        InferenceEngine(dense, dtype=torch.float32, device="cpu", tp=2)
    with pytest.raises(ValueError, match="buffer_float_type"):
        InferenceEngine(dense, dtype=torch.float32, device="cpu", buffer_float_type="q40")
    kv8 = InferenceEngine(dense, device="cpu", sp=2, mesh=_fake_mesh(1, 2), kv_dtype="int8")
    assert kv8.cache["k"].q.dtype == torch.int8 and kv8.cache["k"].shape == (2, 1, 4, 32, 16)
    assert kv8.cache["k"].s.shape == (2, 1, 4, 32, 1)
    moe = str(tmp_path / "moe.m")
    make_tiny_model(moe, arch=LlmArch.QWEN3_MOE, weight_type=FloatType.F32)  # F 96: 48 a rank
    moe_tp = InferenceEngine(moe, device="cpu", tp=2, mesh=_fake_mesh(2, 1))
    lp = moe_tp.params["layers"][0]
    assert lp["w1"].shape == (4, 48, 64) and lp["w2"].shape == (4, 64, 48)
    assert lp["moe_gate"].shape == (4, 64)
    moe_pp = InferenceEngine(moe, device="cpu", pp=2, mesh=_fake_mesh(1, 1, pp=2))
    assert len(moe_pp.params["layers"]) == 1 and moe_pp.cache["k"].shape[0] == 1
    for kw, jkw in ((dict(dp=2, batch_size=3, mesh=_fake_mesh(1, 1, dp=2)),
                     dict(pp=1, dp=2, batch_size=3)),
                    (dict(pp=4, mesh=_fake_mesh(1, 1, pp=4)), dict(pp=4))):
        with pytest.raises(ValueError) as want:
            JEngine(dense, dtype=jnp.float32, **jkw)
        with pytest.raises(ValueError) as got:
            InferenceEngine(dense, dtype=torch.float32, device="cpu", **kw)
        assert str(got.value) == str(want.value)
    eng = InferenceEngine(dense, dtype=torch.float32, device="cpu", tp=2, mesh=_fake_mesh(2, 1),
                          batch_size=2)
    assert not eng.graphs.enabled and eng.world == 2
    assert eng.init_kv_pool(8, native=True) == (2 + 2) * 8 + 1
    assert tuple(eng.kv_pool["k"].shape) == (2, 33, 2, 8, 16)  # KH/tp heads a page
    for axis in ("sp", "pp"):
        port = InferenceEngine(dense, dtype=torch.float32, device="cpu", batch_size=2,
                               mesh=_fake_mesh(1, 1, **{axis: 2}) if axis == "pp" else
                               _fake_mesh(1, 2), **{axis: 2})
        jeng = JEngine(dense, dtype=jnp.float32, batch_size=2, **{axis: 2})
        for call in (lambda e: e.init_kv_pool(8, native=True),
                     lambda e: e.init_draft_model(dense)):
            with pytest.raises(ValueError) as want:
                call(jeng)
            with pytest.raises(ValueError) as got:
                call(port)
            assert str(got.value) == str(want.value), axis
    with pytest.raises(ValueError, match="divisible by 64"):  # q40: dims of 32 * tp
        InferenceEngine(dense, device="cpu", tp=2, mesh=_fake_mesh(2, 1), weight_format="q40")
    with pytest.raises(ValueError, match="exceeds nKvHeads"):
        InferenceEngine(dense, device="cpu", tp=8, mesh=_fake_mesh(8, 1))


def test_cli_refusals(files):
    """A batch that ``--dp`` does not divide and a ``--pp`` that does not
    divide the layers are refused in every mode, the server's too, with the
    JAX engine's reasons, before any rank starts; ``--sync-measure`` is
    accepted; the server takes the CLI's mesh rule (tp 0: one rank on a host
    without a card, 1 under ``--pp``)."""
    base = ["--model", files["dense"], "--tokenizer", files["tok"], "--device", "cpu"]
    with pytest.raises(SystemExit, match="batch_size 1 must divide over dp=2 lanes"):
        cli.main(["inference", *base, "--dp", "2", "--prompt", "a", "--steps", "4"])
    with pytest.raises(SystemExit, match="nLayers=2 not divisible by pp=3"):
        cli.main(["inference", *base, "--pp", "3", "--prompt", "a", "--steps", "4"])
    with pytest.raises(SystemExit, match="nLayers=2 not divisible by pp=4"):
        cli.main(["chat", *base, "--tp", "2", "--pp", "4"])
    from dllama_tpu_torch.runtime import api_server

    with pytest.raises(SystemExit, match="batch_size 3 must divide over dp=2 lanes"):
        api_server.main([*base, "--tp", "2", "--dp", "2", "--batch-size", "3"])
    args = cli._build_parser().parse_args(["inference", *base, "--workers", "4",
                                           "--sync-measure", "off"])
    assert cli.resolve_mesh_shape(args) == (4, 1, 1, 1)
    args = cli._build_parser().parse_args(["inference", *base])
    assert cli.resolve_mesh_shape(args) == (1, 1, 1, 1)
    args = api_server.build_parser().parse_args([*base, "--tp", "2", "--sp", "2"])
    assert cli.resolve_mesh_shape(args) == (2, 2, 1, 1)
    args = api_server.build_parser().parse_args(base)
    assert cli.resolve_mesh_shape(args) == (1, 1, 1, 1)
    args = api_server.build_parser().parse_args([*base, "--pp", "2", "--dp", "2",
                                                 "--batch-size", "4"])
    assert cli.resolve_mesh_shape(args) == (1, 1, 2, 2)


def test_failed_rank_ends_the_launch(files):
    with pytest.raises(RuntimeError, match=r"(?s)rank \d of 2 failed.*FileNotFoundError"):
        spawn(engine_target, 2, "cpu", args=([dict(model=files["dense"] + ".missing", tp=2)],),
              timeout_s=60, pg_timeout_s=10)
    # ranks whose collectives disagree (payloads of different sizes) fail
    # within the process group's timeout instead of hanging
    x = [np.ones((1, 64), np.float32), np.ones((1, 32), np.float32)]
    with pytest.raises((RuntimeError, TimeoutError)):
        spawn(collective_target, 2, "cpu", args=([("all_reduce", 2, False, x)],),
              timeout_s=60, pg_timeout_s=5)


# -- the CLI ---------------------------------------------------------------------


def _cli_summary(out: str) -> dict:
    lines = out.splitlines()
    pred = [l for l in lines if l.startswith("🔶 Pred")]
    ev = [l for l in lines if l.startswith("🔷️ Eval")]
    sent = [re.search(r"Sent\s*(\d+) kB Recv\s*(\d+) kB", l).groups() for l in ev + pred]
    text = "".join(l.split(" | ", 2)[2] for l in pred)
    counts = re.findall(r"^\s+nTokens: (\d+)$", out, re.M)
    return dict(sent=sent, text=text, counts=counts, eval_tokens=ev[0].rsplit("(", 1)[1])


def test_cli_inference_tp2_matches_jax_cli(files, capsys):
    argv = ["inference", "--model", files["dense"], "--tokenizer", files["tok"], "--prompt",
            "hello world", "--steps", "20", "--temperature", "0", "--dtype", "f32", "--tp", "2"]
    jcli.run_inference(jcli._build_parser().parse_args(argv + ["--sync-measure", "off"]))
    want = _cli_summary(capsys.readouterr().out)
    r = subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *argv, "--device", "cpu"],
                       capture_output=True, text=True, timeout=300, cwd=REPO_ROOT)
    assert r.returncode == 0, r.stderr
    assert "backend gloo" in r.stdout and "💡 Tp: 2 rank(s) [gloo]" in r.stdout
    got = _cli_summary(r.stdout)
    assert got == want
    assert len(got["sent"]) == 19 and got["sent"][1] != ("0", "0")


@pytest.mark.parametrize("fmt,i", [("q40i4", 10), ("q40i8", 11)])
def test_packed_and_int8_formats_tp2_match_jax(files, world2, port_tp1, fmt, i):
    """The loader's slices of the packed-nibble and grouped-int8 formats
    through their kernels' plain versions: q40i4 within 2e-4 of one rank's
    q40 logits (the same weights), q40i8 at the group a rank holds (64 at tp
    2, as JAX's ``pick_group(h, tp)``); greedy streams equal the JAX
    engine's at tp 2."""
    res = _same_on_every_rank(world2, i)
    if fmt == "q40i4":
        np.testing.assert_allclose(res["logits"], port_tp1["q40"][0], rtol=2e-4, atol=2e-4)
    else:
        assert res["i8_group"] == 64
    got = [g[0] for g in res["generate"]]
    assert got == _jax_streams(files["q40"], CALLS, tp=2, weight_format=fmt)


def test_int8_kv_tp2_matches_jax(files, world2):
    """An int8 KV cache under tp (its heads split, each row quantized on its
    rank): the JAX int8 engine's greedy streams at tp 2."""
    res = _same_on_every_rank(world2, 12)
    got = [g[0] for g in res["generate"]]
    assert got == _jax_streams(files["dense"], CALLS, tp=2, kv_dtype="int8")


def test_dense_bf16_tp2_matches_one_rank(files, world2, port_tp1):
    """A bf16 model of dense weights under tp: the wo and w2 partials come
    out of the product in f32 and are summed before the one downcast, as
    one rank's product rounds its f32 accumulation once, so the logits stay
    within bf16's rounding of one rank's bf16 logits (2e-2 of their largest,
    a few bf16 ulps) and of the f32 model's."""
    res = _same_on_every_rank(world2, 13)
    eng = InferenceEngine(files["dense"], dtype=torch.bfloat16, temperature=0.0, device="cpu")
    want = eng.prompt_logits(TOKENS).numpy()
    scale = np.abs(want).max()
    err = float(np.abs(res["logits"] - want).max() / scale)
    assert err <= 2e-2, err
    f32_logits = port_tp1["dense"][0]
    assert float(np.abs(res["logits"] - f32_logits).max() / np.abs(f32_logits).max()) <= 5e-2
    assert res["generate"][0][0] == eng.generate(CALLS[0][0], max_steps=CALLS[0][1],
                                                 block_size=CALLS[0][2])[0]
