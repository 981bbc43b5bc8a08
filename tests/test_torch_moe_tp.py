"""Qwen3-MoE under tensor and sequence parallelism on CPU, against the JAX package.

The port's ranks are processes over gloo (parallel/launch.py); one world of
2 ranks and one of 4 are spawned for the module and run their jobs in turn
(`jobs_target`). The JAX package runs on the 8 host devices
tests/conftest.py sets. The cases:

* the F-slices: a tp rank's experts (rows [r F/tp, (r+1) F/tp) of
  ``w1``/``w3``, the same columns of ``w2``, a Q40 ``w2``'s scales with
  them) put back together give the whole experts, Q40 and dense; the
  loader's slices are `shard_params`' of the whole params and of
  ``params_from_jax``'s; a rank holds 1/tp of the expert bytes; a Q40
  file whose F/tp is not a multiple of 32 is refused;
* ``moe_ffn`` on the ranks' slices at tp 2 and 4 (`moe_target`) against
  the JAX ``shard_map`` branches of ``_moe_ffn_pallas`` (the active
  kernel, the two-tier dedup) and ``_moe_ffn_grouped`` with the TPU
  kernels in interpret mode, dense and Q40 experts, and with the q80 sync;
* greedy streams of a tiny Qwen3-MoE Q40 file at tp 2, sp 2, tp 4, tp 2 x
  sp 2, tp 2 x pp 2 and tp 2 x dp 2 against the JAX engine at the same mesh
  and the port's one-rank engine, its f32 prefill logits against the JAX
  forward's and the one rank's;
* the served mix (f32) at tp 2 over pool-native lanes (with the two-tier
  decode: every rank's tier tally equal), slab lanes and the serialized
  path, with n-gram speculation (verify) and the draft model at tp 2, at
  sp 2 and tp 2 x sp 2 over slab lanes, each byte-equal to the one-rank
  server's, and ``chat --tp 2`` against the one-rank chat.

Tolerances: f32 ``moe_ffn`` within 1e-5 (normalized) of the JAX branches,
Q40 experts against the branch over the same experts dequantized. The
TPU grouped kernels round x to bf16 even for f32 inputs, so the inputs
are made bf16-exact (x, dense experts, Q40 scales of four significant
bits, so that q * d is too) and that rounding is a no-op: the two sides
then differ in sum order only. The TPU Q40 kernels round the SwiGLU
hidden to bf16 whatever x's type (ROADMAP C), so the port's bf16 run of
each Q40 case is held to the JAX Q40 branch in bf16 at 2^-7 (one rounding
of the bf16 outputs, tests/test_torch_moe.py's bound).
The q80 sync within JAX's ``test_moe_pallas_tp_q80_sync_close`` bound
(2e-2 of the exact sum, and above 0); prefill logits within
tests/test_parallel.py's 2e-4; greedy streams and served answers equal.
"""

import io
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats import FloatType, ModelReader as JReader
from dllama_tpu.formats.model_file import LlmArch
from dllama_tpu.models import forward as jforward, init_kv_cache as jinit_kv_cache
from dllama_tpu.models import load_params as jload_params
from dllama_tpu.models.transformer import _moe_ffn_grouped, _moe_ffn_pallas
from dllama_tpu.ops.quant_matmul import QuantWeight as JQuantWeight
from dllama_tpu.parallel import make_mesh as jmake_mesh
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu_torch import cli
from dllama_tpu_torch.formats import ModelReader
from dllama_tpu_torch.models.convert import params_from_jax
from dllama_tpu_torch.models.loader import load_params
from dllama_tpu_torch.obs.cost import param_bytes
from dllama_tpu_torch.ops import moe as TM
from dllama_tpu_torch.parallel.launch import ask_all, jobs_target, spawn
from dllama_tpu_torch.parallel.sharding import role_of, shard_params
from dllama_tpu_torch.runtime.api_server import serve
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.tokenizer import Tokenizer

from helpers import REPO_ROOT, make_tiny_model, make_tiny_tokenizer

# F 128: F/tp 64 at tp 2 and 32 at tp 4, whole Q40 blocks; every
# contraction dim divides by 32 tp up to tp 4
CFG = dict(dim=128, hidden_dim=256, moe_hidden_dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
           head_dim=16, vocab_size=288, seq_len=64, n_experts=8, n_active_experts=2)
TOKENS = [3, 17, 92, 5, 44, 120, 7, 3]
# a 9-token prompt, then a second turn whose 8-row chunk starts at 21 (no
# sp divides it), and a 40-token prompt through the 32- and 8-row buckets
CALLS = [([1, 2, 3, 4, 5, 6, 7, 8, 9], 21, 8, 0), ([9, 8, 7, 6, 5, 4, 3, 2, 1], 34, 8, 21)]
LONG = [(list(range(5, 45)), 52, 8, 0)]
BATCH = ([[1, 2, 3, 4], [9, 8, 7, 6, 5, 4]], 16)
REQUESTS = [{"messages": [{"role": "user", "content": f"request {i}: " + "hello world " * i}],
             "max_tokens": 12, "temperature": 0} for i in range(5)]
CHAT_TURNS = "hello there\nand one more thing\n"
SPAWN = dict(timeout_s=300, pg_timeout_s=60)
E, D, F = 8, 64, 128  # moe_ffn's experts


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_tp")
    out = {"q40": str(d / "q40.m"), "f32": str(d / "f32.m"), "tok": str(d / "t.t")}
    make_tiny_model(out["q40"], arch=LlmArch.QWEN3_MOE, cfg=CFG)
    make_tiny_model(out["f32"], arch=LlmArch.QWEN3_MOE, weight_type=FloatType.F32,
                    cfg=dict(CFG, seq_len=384))
    make_tiny_tokenizer(out["tok"], chat_template="<|start_header_id|>", pad_to=288)
    return out


# -- moe_ffn's operands --------------------------------------------------------


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _experts(seed, quant, e=E):
    """The same experts in both layouts: port (w1 [E, F, D], w2 [E, D, F],
    w3; a Q40 weight as (int8 values, f16 scales [.., cols / 32])) and JAX
    (w1 [E, D, F], w2 [E, F, D], w3; QuantWeight with f32 scales
    [E, in / 32, out]). Values bf16-exact (module docstring)."""
    rng = np.random.default_rng(seed)
    port, jax_ = [], []
    for rows, cols in ((F, D), (D, F), (F, D)):
        if quant:
            q = rng.integers(-8, 8, (e, rows, cols), dtype=np.int8)
            s = (2.0 ** rng.integers(-9, -5, (e, rows, cols // 32))
                 * (1 + rng.integers(0, 8, (e, rows, cols // 32)) / 8)).astype(np.float16)
            s[rng.random(s.shape) < 0.5] *= -1
            port.append((q, s))
            jax_.append(JQuantWeight(jnp.asarray(q.transpose(0, 2, 1)),
                                     jnp.asarray(s.astype(np.float32).transpose(0, 2, 1))))
        else:
            w = _bf16(rng.standard_normal((e, rows, cols)) * 0.1)
            port.append(w)
            jax_.append(jnp.asarray(w.transpose(0, 2, 1)))
    gate = rng.standard_normal((e, D)).astype(np.float32)
    return port, jax_, gate


def _x(seed, n, shared=False):
    rng = np.random.default_rng(seed)
    if shared:  # rows that route alike: the grouped tier of the two-tier decode
        x = np.repeat(rng.standard_normal((1, 1, D)), n, 0) + rng.standard_normal((n, 1, D)) * 1e-3
    else:
        x = rng.standard_normal((n, 1, D))
    return _bf16(x.astype(np.float32))


# (name, seed, n rows, Q40, k, JAX function, dedup, shared rows, sync_quant, experts)
MOE_CASES = [
    ("active", 1, 1, False, 3, "pallas", False, False, False, E),
    ("active-q40-4rows", 2, 4, True, 3, "pallas", False, False, False, E),
    ("grouped", 3, 24, False, 3, "grouped", False, False, False, E),
    ("grouped-q40", 4, 40, True, 2, "grouped", False, False, False, E),
    ("dedup-grouped-tier", 5, 8, False, 3, "pallas", True, True, False, 32),
    ("dedup-active-tier", 6, 8, True, 3, "pallas", True, False, False, 32),
    ("q80-sync", 7, 1, False, 3, "pallas", False, False, True, E),
]


# the Q40 cases run again in bf16 (after the f32 jobs, in this order)
BF16_CASES = [i for i, c in enumerate(MOE_CASES) if c[3]]


def _moe_jobs():
    jobs = []
    for i in list(range(len(MOE_CASES))) + BF16_CASES:
        _, seed, n, quant, k, _, dedup, shared, sync, e = MOE_CASES[i]
        port, _, gate = _experts(seed, quant, e)
        jobs.append(("moe", dict(x=_x(seed, n, shared), gate=gate, w1=port[0], w2=port[1],
                                 w3=port[2], k=k, dedup=dedup, sync_quant=sync,
                                 dtype="bf16" if len(jobs) >= len(MOE_CASES) else "f32")))
    return jobs


def _jax_moe(case, tp, sync_quant=None, dequantized=False, dtype=jnp.float32):
    """The JAX branch of ``case`` at tp; with ``dequantized`` over the Q40
    experts dequantized to dense f32 (bf16-exact)."""
    _, seed, n, quant, k, fn, dedup, shared, sync, e = case
    _, jws, gate = _experts(seed, quant, e)
    if dequantized:
        jws = [jnp.asarray(np.asarray(w.q, np.float32).reshape(e, -1, 32, w.q.shape[-1])
                           * np.asarray(w.d)[:, :, None, :]).reshape(w.q.shape) for w in jws]
    x = jnp.asarray(_x(seed, n, shared)).astype(dtype)
    mesh = jmake_mesh(tp=tp)
    sync = sync if sync_quant is None else sync_quant
    if fn == "grouped":
        out = _moe_ffn_grouped(x, jnp.asarray(gate.T), *jws, k, mesh, interpret=True,
                               sync_quant=sync)
    else:
        out = _moe_ffn_pallas(x, jnp.asarray(gate.T), *jws, k, mesh, interpret=True,
                              sync_quant=sync, dedup=dedup)
    return np.asarray(out)


# -- the worlds --------------------------------------------------------------------


def _engine(model, tp=1, sp=1, **kw):
    return ("engine", dict(model=model, tp=tp, sp=sp, weight_format="q40", logits=TOKENS,
                           generate=CALLS + LONG, **kw))


def _serve(files, tp, sp, batch_size=4, **serve_kw):
    return ("serve", dict(model=files["f32"], tokenizer=files["tok"], tp=tp, sp=sp,
                          batch_size=batch_size, requests=REQUESTS, serve=serve_kw))


# (name, tp, sp, extra engine args): the engine jobs of each world
ENGINES = {2: [("tp2", 2, 1, {}), ("sp2", 1, 2, {})],
           4: [("tp4", 4, 1, {}), ("tp2sp2", 2, 2, {}), ("tp2pp2", 2, 1, dict(pp=2)),
               ("tp2dp2", 2, 1, dict(dp=2, batch_size=2, generate_batch=BATCH))]}
# (name, tp, sp, server args, the one-rank truth)
# (the native server decodes its lanes in two tiers, the draft server's
# draft is the target's own file)
SERVERS = {2: [("native-dedup-tp2", 2, 1, dict(kv_native=True, moe_decode_dedup=True), "native"),
               ("slab-tp2", 2, 1, dict(kv_native=False), "slab"),
               ("single-tp2", 2, 1, dict(batch_size=1), "single"),
               ("ngram-tp2", 2, 1, dict(kv_native=True, speculation="ngram"), "native"),
               ("draft-tp2", 2, 1, dict(kv_native=False, speculation="draft", draft_model="f32"),
                "slab"),
               ("slab-sp2", 1, 2, dict(kv_native=False), "slab")],
           4: [("slab-tp2sp2", 2, 2, dict(kv_native=False), "slab")]}


def _jobs(files, world):
    jobs = [_engine(files["q40"], tp, sp, **kw) for _, tp, sp, kw in ENGINES[world]]
    jobs += _moe_jobs()
    for _, tp, sp, kw, _ in SERVERS[world]:
        kw = dict(kw)
        if "draft_model" in kw:
            kw["draft_model"] = files[kw["draft_model"]]
        job = _serve(files, tp, sp, kw.pop("batch_size", 4), **kw)
        job[1]["moe_decode_dedup"] = job[1]["serve"].pop("moe_decode_dedup", "auto")
        jobs.append(job)
    return jobs


@pytest.fixture(scope="module")
def world2(files):
    return spawn(jobs_target, 2, "cpu", args=(_jobs(files, 2),), **SPAWN)


@pytest.fixture(scope="module")
def world4(files):
    return spawn(jobs_target, 4, "cpu", args=(_jobs(files, 4),), **SPAWN)


def _world(world2, world4, n):
    return world2 if n == 2 else world4


def _same_on_every_rank(results, i):
    first = results[0][i]
    for other in results[1:]:
        for key, val in first.items():
            if key in ("stage", "dp_group", "allocated"):
                continue
            if isinstance(val, np.ndarray):
                assert np.array_equal(val, other[i][key]), key
            else:
                assert val == other[i][key], key
    return first


@pytest.fixture(scope="module")
def port_tp1(files):
    eng = InferenceEngine(files["q40"], dtype=torch.float32, temperature=0.0,
                          weight_format="q40", device="cpu", batch_size=2)
    logits = eng.prompt_logits(TOKENS).numpy()
    eng.reset()
    streams = [eng.generate(p, max_steps=s, block_size=b, start_pos=st)[0]
               for p, s, b, st in CALLS + LONG]
    return logits, streams, eng.generate_batch(*BATCH), param_bytes(eng.params, eng.header)


# -- the F-slices --------------------------------------------------------------------


def _whole(parts, key):
    dim = -1 if role_of(key) == "col" else -2
    if isinstance(parts[0], tuple):
        return tuple(torch.cat([p[i] for p in parts], dim) for i in range(len(parts[0])))
    return torch.cat(parts, dim)


@pytest.mark.parametrize("fmt", ["q40", "dense"])
@pytest.mark.parametrize("tp", [2, 4])
def test_expert_slices_put_together_give_the_whole_experts(files, fmt, tp):
    reader = ModelReader(files["q40"])
    h = reader.header
    whole = load_params(reader, torch.float32, "cpu", fmt)
    slices = [load_params(reader, torch.float32, "cpu", fmt, shard=(tp, r)) for r in range(tp)]

    def parts(w):  # a leaf's tensors: (values, scales) of a Q40 weight
        return tuple(w) if fmt == "q40" else (w,)

    for l, lp in enumerate(whole["layers"]):
        for key in ("w1", "w2", "w3"):
            mine = [parts(s["layers"][l][key]) for s in slices]
            f_ax = -1 if key == "w2" else -2
            assert all(p[0].shape[f_ax] == h.ff_dim // tp for p in mine), key
            assert all(t.is_contiguous() for p in mine for t in p), key
            got = [torch.cat([p[i] for p in mine], f_ax) for i in range(len(mine[0]))]
            assert all(torch.equal(a, b) for a, b in zip(got, parts(lp[key]))), (l, key)
        assert all(torch.equal(s["layers"][l]["moe_gate"], lp["moe_gate"]) for s in slices)
    for r in range(tp):  # shard_params on the whole params gives the loader's slices
        for l, lp in enumerate(shard_params(whole, h, tp, r)["layers"]):
            for key in ("w1", "w2", "w3"):
                a, b = parts(lp[key]), parts(slices[r]["layers"][l][key])
                assert all(torch.equal(x, y) for x, y in zip(a, b)), (r, l, key)
    whole_b = param_bytes(whole, h)["experts"]
    assert all(param_bytes(s, h)["experts"] * tp == whole_b for s in slices)


def test_shard_params_of_params_from_jax_moe(files):
    reader = JReader(files["f32"])
    jp = jax.tree.map(np.asarray, jload_params(reader))
    whole = params_from_jax(jp, reader.header, device="cpu")
    own = load_params(ModelReader(files["f32"]), torch.float32, "cpu", "dense", shard=(2, 1))
    for l, lp in enumerate(shard_params(whole, reader.header, 2, 1)["layers"]):
        for key, val in lp.items():
            assert val.shape == own["layers"][l][key].shape, key
            assert torch.equal(val, own["layers"][l][key]), (l, key)


def test_q40_expert_slice_off_whole_blocks_is_refused(tmp_path):
    path = str(tmp_path / "m.m")
    make_tiny_model(path, arch=LlmArch.QWEN3_MOE, cfg=dict(CFG, moe_hidden_dim=96))
    with pytest.raises(ValueError, match="F/tp = 48 hidden units is not a multiple of 32"):
        load_params(ModelReader(path), torch.float32, "cpu", "dense", shard=(2, 0))


# -- moe_ffn at tp 2 and 4 ---------------------------------------------------------


def _moe_result(results, world, case_i):
    i = len(ENGINES[world]) + case_i
    res = _same_on_every_rank(results, i)
    return res


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case_i", range(len(MOE_CASES)), ids=[c[0] for c in MOE_CASES])
def test_moe_ffn_tp_matches_jax_branches(world2, world4, world, case_i):
    case = MOE_CASES[case_i]
    res = _moe_result(_world(world2, world4, world), world, case_i)
    got = res["out"].reshape(case[2], D)
    assert res["w1_shape"] == [case[9], F // world, D]
    want = _jax_moe(case, world, dequantized=case[3]).reshape(case[2], D)
    scale = np.abs(want).max()
    if case[3]:
        # the Q40 branch rounds x and the hidden to bf16 (f32 x too): the
        # port's bf16 run against it, bf16 outputs one rounding step apart
        bf = _moe_result(_world(world2, world4, world), world,
                         len(MOE_CASES) + BF16_CASES.index(case_i))["out"].reshape(case[2], D)
        q40 = _jax_moe(case, world, dtype=jnp.bfloat16).astype(np.float32).reshape(case[2], D)
        assert np.abs(bf - q40).max() / np.abs(q40).max() < 2.0**-7
    if case[8]:  # q80: the compressed sum, against JAX's and the exact one
        exact = _jax_moe(case, world, sync_quant=False).reshape(case[2], D)
        assert np.abs(got - want).max() / scale < 2e-2
        err = np.abs(got - exact).max() / np.abs(exact).max()
        assert 0.0 < err < 2e-2, err
    else:
        assert np.abs(got - want).max() / scale < 1e-5, np.abs(got - want).max() / scale
    if case[6]:  # every rank took the tier JAX's unique count picks, once
        x = torch.tensor(_x(case[1], case[2], case[7]).reshape(case[2], D))
        top_i, _ = TM.moe_route(x, torch.from_numpy(_experts(case[1], case[3], case[9])[2]), case[4])
        u = len(torch.unique(top_i))
        cap = TM.dedup_cap(case[2], case[4], True)
        assert res["tally"] == [int(u <= cap), 1] and (u <= cap) == case[7], (u, cap)


# -- the engine ------------------------------------------------------------------


def _jax_streams(model, **kw):
    eng = JEngine(model, dtype=jnp.float32, temperature=0.0, **kw)
    return [eng.generate(p, max_steps=s, block_size=b, start_pos=st)[0]
            for p, s, b, st in CALLS + LONG]


@pytest.fixture(scope="module")
def jax_logits(files):
    """The JAX forward's f32 prefill logits of TOKENS (one device:
    tests/test_parallel.py holds its tp forward to them at 2e-4)."""
    reader = JReader(files["q40"])
    h = reader.header
    logits, _ = jforward(jload_params(reader), h, jnp.asarray([TOKENS], jnp.int32), jnp.int32(0),
                         jinit_kv_cache(h, batch_size=1))
    return np.asarray(logits)[0]


ENGINE_CASES = [(w, i, c[0]) for w in (2, 4) for i, c in enumerate(ENGINES[w])]


@pytest.mark.parametrize("world,i,name", ENGINE_CASES, ids=[c[2] for c in ENGINE_CASES])
def test_engine_matches_jax_and_one_rank(files, world2, world4, port_tp1, jax_logits, world, i,
                                        name):
    _, tp, sp, kw = ENGINES[world][i]
    res = _same_on_every_rank(_world(world2, world4, world), i)
    logits, streams, batch, bytes1 = port_tp1
    np.testing.assert_allclose(res["logits"], logits, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(res["logits"], jax_logits, rtol=2e-4, atol=2e-4)
    got = [g[0] for g in res["generate"]]
    assert got == streams
    jkw = {k: v for k, v in kw.items() if k in ("pp", "dp", "batch_size")}
    assert got == _jax_streams(files["q40"], tp=tp, sp=sp, **jkw)
    if "generate_batch" in kw:
        assert res["generate_batch"] == batch
    pp = kw.get("pp", 1)
    # a rank holds 1/tp of every expert of its stage's layers
    assert res["expert_bytes"] * tp * pp == bytes1["experts"]
    assert res["cache_shape"] == [2 // pp, 1, 4 // tp, 64 // sp, 16]


# -- serving and chat ----------------------------------------------------------------


def _port_answers(files, batch_size=4, **kw):
    eng = InferenceEngine(files["f32"], dtype=torch.float32, temperature=0.0, device="cpu",
                          batch_size=batch_size)
    srv = serve(eng, Tokenizer(files["tok"]), host="127.0.0.1", port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        return ask_all(f"http://127.0.0.1:{srv.server_address[1]}", REQUESTS)
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.fixture(scope="module")
def truth(files):
    return {"native": _port_answers(files, kv_native=True),
            "slab": _port_answers(files, kv_native=False),
            "single": _port_answers(files, batch_size=1)}


SERVE_CASES = [(w, i, c[0]) for w in (2, 4) for i, c in enumerate(SERVERS[w])]


@pytest.mark.parametrize("world,i,name", SERVE_CASES, ids=[c[2] for c in SERVE_CASES])
def test_served_mix_equals_one_rank(world2, world4, truth, world, i, name):
    _, tp, sp, kw, want = SERVERS[world][i]
    results = _world(world2, world4, world)
    j = len(ENGINES[world]) + len(MOE_CASES) + len(BF16_CASES) + i
    jobs = [r[j] for r in results]
    for other in jobs[1:]:  # every rank ran rank 0's commands, the same kernels and tiers
        for key in ("summary", "launches", "tier_tally", "cache_epoch"):
            assert other[key] == jobs[0][key], key
    if kw.get("moe_decode_dedup"):  # the lanes' decode steps ran in two tiers
        assert jobs[0]["tier_tally"][1] > 0
    answers = jobs[0]["answers"][0]
    assert all(isinstance(a, str) for a in answers), answers
    assert answers == truth[want]
    assert jobs[0]["health"]["parallel"] == {"tp": tp, "sp": sp, "backend": "gloo",
                                             "ranks": world}


def test_chat_tp2_equals_one_rank(files, monkeypatch, capsys):
    argv = ["chat", "--model", files["f32"], "--tokenizer", files["tok"], "--temperature", "0",
            "--dtype", "f32", "--weight-format", "dense", "--chat-template", "llama3",
            "--max-seq-len", "256"]
    monkeypatch.setattr("sys.stdin", io.StringIO(CHAT_TURNS))
    cli.main(argv + ["--device", "cpu"])
    want = capsys.readouterr().out
    want = want[want.index("💬 Chat mode"):]
    proc = subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *argv, "--tp", "2",
                           "--device", "cpu"], input=CHAT_TURNS, capture_output=True, text=True,
                          timeout=300, cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = proc.stdout[proc.stdout.index("💬 Chat mode"):]
    assert got == want
    assert got.count("🤖 Assistant: ") == 2
