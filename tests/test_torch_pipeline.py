"""Pipeline stages and dp lane shards of the port on CPU, against the JAX package.

The port's ranks are processes over gloo (parallel/launch.py); the JAX
package runs ``forward_pp`` and its engine on the 8 host devices
tests/conftest.py sets. Each world size (2, 4 and 8 ranks) is spawned once
for the module and runs every job of its size in turn
(parallel/launch.jobs_target).

The cases are tests/test_pipeline.py's: ``forward_pp`` at pp 2 (one chunk
and 2 and 4 sequence waves), pp 4, pp x tp, pp x sp, an int8 cache and
Qwen3-MoE, held to the JAX ``forward_pp`` at the same mesh (logits, and the
stage's cache rows where the cache is a plain f32 one); the engine at pp
2 (dense and q40 weights, a prefill in waves, perplexity,
``generate_batch``), pp 4, pp x dp, pp x tp, pp x sp, pp x dp x tp and pp x
sp x tp, held to the JAX engine at the same mesh.

Tolerances (f32 throughout): logits within 1e-5 of the JAX ``forward_pp``
(2e-4 under tp and 1e-4 with waves or sp, the bounds of tests/test_
pipeline.py: the split changes sum order only); caches within 1e-5;
perplexity within 1e-5 relative; greedy streams equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dllama_tpu.formats import FloatType, ModelReader as JReader
from dllama_tpu.formats.model_file import LlmArch
from dllama_tpu.models import init_kv_cache as jinit_kv_cache, load_params as jload_params
from dllama_tpu.parallel.mesh import make_mesh as jmake_mesh
from dllama_tpu.parallel.pipeline import forward_pp as jforward_pp
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu_torch.formats import ModelReader
from dllama_tpu_torch.parallel.launch import jobs_target, spawn
from dllama_tpu_torch.parallel.pipeline import stage_range, validate_pp

from helpers import make_tiny_model

# tests/test_pipeline.py's CFG4_TP: q40 column splits need dims % (32 tp)
CFG4 = dict(dim=64, hidden_dim=256, n_layers=4, n_heads=4, n_kv_heads=2, head_dim=16,
            vocab_size=256, seq_len=64)
TOKENS = [3, 17, 92, 5, 44, 120, 7, 3]
WAVES = list(range(3, 35))  # 32 rows: 2 or 4 waves of 16 or 8
SP_ROWS = list(range(2, 30))  # 28 rows, tests/test_pipeline.py's pp x sp chunk
LONG = list(range(2, 36))  # 34 tokens: a 32-row bucket in 4 waves at pp 2
SHORT = [1, 2, 3, 4, 5]
PPL = [(i * 7) % 250 + 1 for i in range(40)]
PROMPTS = [[1, 2, 3, 4], [9, 8, 7, 6, 5]]
PROMPTS8 = [[1, 2, 3], [7, 6, 5, 4]]
SPAWN = dict(timeout_s=400, pg_timeout_s=60)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    out = {"m": str(d / "m.m"), "moe": str(d / "moe.m")}
    make_tiny_model(out["m"], weight_type=FloatType.Q40, seed=11, cfg=CFG4)
    make_tiny_model(out["moe"], arch=LlmArch.QWEN3_MOE, weight_type=FloatType.F32, seed=3)
    return out


def _eng(model, **kw):
    return ("engine", dict(model=model, **kw))


def _world2_jobs(f):
    return [
        _eng(f["m"], pp=2, forward=[(TOKENS, 1), (WAVES, 2), (WAVES, 4)]),
        _eng(f["m"], pp=2, kv_dtype="int8", forward=[(TOKENS, 1)]),
        _eng(f["moe"], pp=2, forward=[(TOKENS, 1)], generate=[(TOKENS, 20, 8, 0)]),
        _eng(f["m"], pp=2, generate=[(SHORT, 16, 8, 0), (LONG, 44, 8, 0)], perplexity=PPL),
        _eng(f["m"], pp=2, weight_format="q40", generate=[(SHORT, 16, 8, 0)]),
        _eng(f["m"], pp=2, batch_size=2, generate_batch=(PROMPTS, 16)),
    ]


def _world4_jobs(f):
    return [
        _eng(f["m"], pp=4, forward=[(TOKENS, 1)], generate=[(LONG, 44, 8, 0)]),
        _eng(f["m"], pp=2, tp=2, forward=[(TOKENS, 1)]),
        _eng(f["m"], pp=2, tp=2, weight_format="q40", generate=[(LONG, 44, 8, 0)]),
        _eng(f["m"], pp=2, sp=2, forward=[(SP_ROWS, 1)], generate=[(SHORT + [6, 7], 18, 8, 0)]),
        _eng(f["m"], pp=2, dp=2, batch_size=2, generate_batch=(PROMPTS, 14)),
    ]


def _world8_jobs(f):
    return [
        _eng(f["m"], pp=2, dp=2, tp=2, batch_size=2, generate_batch=(PROMPTS8, 12)),
        _eng(f["m"], pp=2, sp=2, tp=2, generate=[(SHORT + [6, 7], 18, 8, 0)]),
    ]


@pytest.fixture(scope="module")
def world2(files):
    return spawn(jobs_target, 2, "cpu", args=(_world2_jobs(files),), **SPAWN)


@pytest.fixture(scope="module")
def world4(files):
    return spawn(jobs_target, 4, "cpu", args=(_world4_jobs(files),), **SPAWN)


@pytest.fixture(scope="module")
def world8(files):
    return spawn(jobs_target, 8, "cpu", args=(_world8_jobs(files),), **SPAWN)


def _same_tokens(results, i):
    """Job i on every rank: the same logits (every stage computes the head)
    and the same tokens; returns rank 0's."""
    first = results[0][i]
    for other in results[1:]:
        r = other[i]
        for key in ("generate", "generate_batch", "perplexity"):
            assert r.get(key) == first.get(key), key
        for (a, _), (b, _) in zip(first.get("forward", []), r.get("forward", [])):
            assert np.array_equal(a, b)
    return first


_JAX_PARAMS = {}


def _jax_forward(model, toks, mesh_kw, n_micro=1, kv_dtype=None):
    """The JAX ``forward_pp``'s logits [T, V] and cache of one chunk at 0."""
    if model not in _JAX_PARAMS:
        reader = JReader(model)
        _JAX_PARAMS[model] = (reader.header, jload_params(reader))
    h, params = _JAX_PARAMS[model]
    cache = jinit_kv_cache(h, 1, dtype=jnp.int8) if kv_dtype == "int8" else jinit_kv_cache(h, 1)
    logits, cache = jforward_pp(params, h, jnp.asarray([toks], jnp.int32), jnp.int32(0), cache,
                                jmake_mesh(**mesh_kw), n_micro=n_micro)
    return np.asarray(logits)[0], cache


def _jax_engine(model, calls=(), batch=None, ppl=None, **kw):
    eng = JEngine(model, dtype=jnp.float32, temperature=0.0, **kw)
    out = [eng.generate(p, max_steps=s, block_size=b, start_pos=st)[0] for p, s, b, st in calls]
    if batch is not None:
        out.append(eng.generate_batch(*batch))
    if ppl is not None:
        out.append(eng.perplexity(ppl))
    return out


def _stage_cache(results, i, j, h, pp):
    """The stages' caches of forward j of job i put back along the layers:
    [L, 1, KH, S, hd] (one rank a stage: pp only)."""
    parts = {}
    for r in results:
        parts[r[i]["stage"]] = r[i]["forward"][j][1]
    return {k: np.concatenate([parts[s][k] for s in range(pp)], axis=0) for k in ("k", "v")}


# -- stages and their checks ---------------------------------------------------


def test_validate_pp_and_stage_range_match_jax(files):
    from dllama_tpu.parallel.pipeline import validate_pp as jvalidate_pp

    h, jh = ModelReader(files["m"]).header, JReader(files["m"]).header
    for pp in (1, 2, 4, 0, 3, 8):
        try:
            jvalidate_pp(jh, pp)
            want = None
        except ValueError as e:
            want = str(e)
        try:
            validate_pp(h, pp)
            got = None
        except ValueError as e:
            got = str(e)
        assert got == want, pp
    assert [list(stage_range(h, 2, s)) for s in range(2)] == [[0, 1], [2, 3]]
    assert [list(stage_range(h, 4, s)) for s in range(4)] == [[0], [1], [2], [3]]


# -- forward_pp against the JAX forward_pp ------------------------------------------


@pytest.mark.parametrize("j,toks,n_micro", [(0, TOKENS, 1), (1, WAVES, 2), (2, WAVES, 4)],
                         ids=["pp2", "pp2-waves2", "pp2-waves4"])
def test_forward_pp_matches_jax(files, world2, j, toks, n_micro):
    res = _same_tokens(world2, 0)
    h = ModelReader(files["m"]).header
    want, jcache = _jax_forward(files["m"], toks, dict(pp=2), n_micro)
    tol = 1e-5 if n_micro == 1 else 1e-4
    np.testing.assert_allclose(res["forward"][j][0], want, rtol=tol, atol=tol)
    got = _stage_cache(world2, 0, j, h, 2)
    for k in ("k", "v"):
        np.testing.assert_allclose(got[k], np.asarray(jcache[k]), rtol=1e-5, atol=1e-5)
    # every stage read only its own layers' weights and holds their rows
    assert [r[0]["cache_shape"][0] for r in world2] == [2, 2]


def test_forward_pp_int8_cache_matches_jax(files, world2):
    res = _same_tokens(world2, 1)
    want, _ = _jax_forward(files["m"], TOKENS, dict(pp=2), kv_dtype="int8")
    np.testing.assert_allclose(res["forward"][0][0], want, rtol=1e-5, atol=1e-5)


def test_forward_pp_qwen3_moe_matches_jax(files, world2):
    """Qwen3-MoE at pp 2, tp = sp = 1: each stage's experts whole on it, as
    in the JAX ``forward_pp`` (stage-local layers, no mesh inside)."""
    res = _same_tokens(world2, 2)
    want, _ = _jax_forward(files["moe"], TOKENS, dict(pp=2))
    np.testing.assert_allclose(res["forward"][0][0], want, rtol=1e-5, atol=1e-5)
    assert res["generate"][0][0] == _jax_engine(files["moe"], [(TOKENS, 20, 8, 0)], pp=2)[0]


def test_forward_pp4_matches_jax(files, world4):
    res = _same_tokens(world4, 0)
    want, jcache = _jax_forward(files["m"], TOKENS, dict(pp=4))
    np.testing.assert_allclose(res["forward"][0][0], want, rtol=1e-5, atol=1e-5)
    got = _stage_cache(world4, 0, 0, ModelReader(files["m"]).header, 4)
    np.testing.assert_allclose(got["k"], np.asarray(jcache["k"]), rtol=1e-5, atol=1e-5)


def test_forward_pp_tp_matches_jax(files, world4):
    res = _same_tokens(world4, 1)
    want, _ = _jax_forward(files["m"], TOKENS, dict(pp=2, tp=2))
    np.testing.assert_allclose(res["forward"][0][0], want, rtol=2e-4, atol=2e-4)
    # a rank holds its stage's 2 layers and its tp group's 1 of 2 KV heads
    assert all(r[1]["cache_shape"][:3] == [2, 1, 1] for r in world4)


def test_forward_pp_sp_matches_jax(files, world4):
    res = _same_tokens(world4, 3)
    want, _ = _jax_forward(files["m"], SP_ROWS, dict(pp=2, sp=2))
    np.testing.assert_allclose(res["forward"][0][0], want, rtol=1e-4, atol=1e-4)
    assert all(r[3]["cache_shape"] == [2, 1, 2, 32, 16] for r in world4)


# -- the engine against the JAX engine at the same mesh -----------------------------


def test_engine_pp2_matches_jax(files, world2):
    """Bucketed prefill (the 34-token prompt's 32-row bucket in 4 waves) and
    block decode on one cache, and perplexity, at pp 2."""
    res = _same_tokens(world2, 3)
    want = _jax_engine(files["m"], [(SHORT, 16, 8, 0), (LONG, 44, 8, 0)], ppl=PPL, pp=2)
    assert [g[0] for g in res["generate"]] == want[:2]
    nll, ppl, n = res["perplexity"]
    assert n == want[2][2]
    np.testing.assert_allclose(nll, want[2][0], rtol=1e-5)
    np.testing.assert_allclose(ppl, want[2][1], rtol=1e-5)


def test_engine_pp2_q40_matches_jax(files, world2):
    res = _same_tokens(world2, 4)
    want = _jax_engine(files["m"], [(SHORT, 16, 8, 0)], pp=2, weight_format="q40")
    assert res["generate"][0][0] == want[0]


def test_engine_pp2_lanes_match_jax(files, world2):
    res = _same_tokens(world2, 5)
    assert res["generate_batch"] == _jax_engine(files["m"], batch=(PROMPTS, 16), pp=2,
                                                batch_size=2)[0]


def test_engine_pp4_matches_jax(files, world4):
    res = _same_tokens(world4, 0)
    assert res["generate"][0][0] == _jax_engine(files["m"], [(LONG, 44, 8, 0)], pp=4)[0]


def test_engine_pp_tp_q40_matches_jax(files, world4):
    res = _same_tokens(world4, 2)
    want = _jax_engine(files["m"], [(LONG, 44, 8, 0)], pp=2, tp=2, weight_format="q40")
    assert res["generate"][0][0] == want[0]


def test_engine_pp_sp_matches_jax(files, world4):
    res = _same_tokens(world4, 3)
    want = _jax_engine(files["m"], [(SHORT + [6, 7], 18, 8, 0)], pp=2, sp=2)
    assert res["generate"][0][0] == want[0]


def test_engine_pp_dp_matches_jax(files, world4):
    """pp 2 x dp 2: each dp group decodes its own lane, the tokens gathered
    over dp onto every rank."""
    res = _same_tokens(world4, 4)
    want = _jax_engine(files["m"], batch=(PROMPTS, 14), pp=2, dp=2, batch_size=2)
    assert res["generate_batch"] == want[0]


def test_engine_pp_dp_tp_matches_jax(files, world8):
    res = _same_tokens(world8, 0)
    want = _jax_engine(files["m"], batch=(PROMPTS8, 12), pp=2, dp=2, tp=2, batch_size=2)
    assert res["generate_batch"] == want[0]
    # stage s of dp group g: ranks 4 s + 2 g + t (the JAX mesh's order)
    assert [(r[0]["stage"], r[0]["dp_group"]) for r in world8] == [
        (r // 4, (r // 2) % 2) for r in range(8)]


def test_engine_pp_sp_tp_matches_jax(files, world8):
    res = _same_tokens(world8, 1)
    want = _jax_engine(files["m"], [(SHORT + [6, 7], 18, 8, 0)], pp=2, sp=2, tp=2)
    assert res["generate"][0][0] == want[0]
