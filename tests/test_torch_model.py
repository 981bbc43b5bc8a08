"""The port's forward against dllama_tpu.models.forward on tiny `.m` files
(f32, CPU, atol 1e-4): Llama, Qwen3 and rope-scaled Llama, both
logits_modes, q40 and dense weights; and params carried across from the
JAX loader's fused layout give the same logits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats import ModelReader as JReader
from dllama_tpu.formats.model_file import LlmArch
from dllama_tpu.models import forward as j_forward
from dllama_tpu.models import init_kv_cache as j_init
from dllama_tpu.models import load_params as j_load
from dllama_tpu_torch.formats import ModelReader
from dllama_tpu_torch.models import forward, init_kv_cache, load_params
from dllama_tpu_torch.models.convert import params_from_jax

from helpers import make_tiny_model

TOKENS = np.array([[1, 5, 9, 20, 33, 7, 2, 100, 41, 3]], np.int64)
CASES = {
    "llama": dict(arch=LlmArch.LLAMA),
    "qwen3": dict(arch=LlmArch.QWEN3),
    "llama_rope_scaling": dict(arch=LlmArch.LLAMA, rope_scaling=True),
}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    out = {}
    for name, kw in CASES.items():
        p = str(tmp_path_factory.mktemp("m") / f"{name}.m")
        make_tiny_model(p, **kw)
        out[name] = p
    return out


def _run_port(params, h, logits_mode):
    cache = init_kv_cache(h, 1, torch.float32, device="cpu")
    pre, cache = forward(params, h, torch.from_numpy(TOKENS[:, :8]), 0, cache, logits_mode)
    dec, _ = forward(params, h, torch.from_numpy(TOKENS[:, 8:9]), 8, cache, logits_mode)
    return pre.numpy(), dec.numpy()


def _run_jax(params, h, logits_mode):
    cache = j_init(h, 1, jnp.float32)
    pre, cache = j_forward(params, h, jnp.asarray(TOKENS[:, :8], jnp.int32), jnp.int32(0), cache,
                           logits_mode=logits_mode)
    dec, _ = j_forward(params, h, jnp.asarray(TOKENS[:, 8:9], jnp.int32), jnp.int32(8), cache,
                       logits_mode=logits_mode)
    return np.asarray(pre), np.asarray(dec)


@pytest.mark.parametrize("logits_mode", ["all", "last"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax_q40(models, case, logits_mode):
    reader, jreader = ModelReader(models[case]), JReader(models[case])
    params = load_params(reader, torch.float32, "cpu", weight_format="q40")
    jparams = j_load(jreader, dtype=jnp.float32, weight_format="q40")
    got = _run_port(params, reader.header, logits_mode)
    want = _run_jax(jparams, jreader.header, logits_mode)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", ["llama", "qwen3"])
def test_forward_matches_jax_dense(models, case):
    reader, jreader = ModelReader(models[case]), JReader(models[case])
    params = load_params(reader, torch.float32, "cpu", weight_format="dense")
    jparams = j_load(jreader, dtype=jnp.float32, weight_format="dense")
    for g, w in zip(_run_port(params, reader.header, "all"),
                    _run_jax(jparams, jreader.header, "all")):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", ["llama", "qwen3"])
def test_params_from_jax_fused_layout(models, case):
    reader, jreader = ModelReader(models[case]), JReader(models[case])
    jparams = j_load(jreader, dtype=jnp.float32, weight_format="q40", fuse=1)
    assert "wqkv" in jparams["layers"] and "w13" in jparams["layers"]
    carried = params_from_jax(jax.tree.map(np.asarray, jparams), reader.header, "cpu")
    own = load_params(reader, torch.float32, "cpu", weight_format="q40")
    for g, w in zip(_run_port(carried, reader.header, "all"),
                    _run_port(own, reader.header, "all")):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    for key in ("wq", "wk", "wv", "w1", "w3"):
        torch.testing.assert_close(carried["layers"][0][key].q, own["layers"][0][key].q)
        torch.testing.assert_close(carried["layers"][0][key].d, own["layers"][0][key].d)


def test_bf16_forward_runs_close_to_f32(models):
    reader = ModelReader(models["llama"])
    h = reader.header
    p32 = load_params(reader, torch.float32, "cpu", weight_format="q40")
    p16 = load_params(reader, torch.bfloat16, "cpu", weight_format="q40")
    c16 = init_kv_cache(h, 1, torch.bfloat16, device="cpu")
    out16, _ = forward(p16, h, torch.from_numpy(TOKENS[:, :8]), 0, c16, "last")
    out32, _ = _run_port(p32, h, "last")[0], None
    assert out16.dtype == torch.float32
    err = np.abs(out16.numpy() - out32).max() / np.abs(out32).max()
    assert err < 5e-2, err


def test_forward_refuses_chunk_past_cache(models):
    reader = ModelReader(models["llama"])
    h = reader.header
    params = load_params(reader, torch.float32, "cpu", weight_format="q40")
    cache = init_kv_cache(h, 1, torch.float32, device="cpu")
    with pytest.raises(ValueError):
        forward(params, h, torch.zeros((1, 8), dtype=torch.long), h.seq_len - 4, cache)
