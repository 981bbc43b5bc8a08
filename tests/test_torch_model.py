"""The port's forward against dllama_tpu.models.forward on tiny `.m` files
(f32, CPU, atol 1e-4): Llama, Qwen3, Qwen3-MoE and rope-scaled Llama, both
logits_modes, q40 and dense weights; params carried across from the JAX
loader's fused layout give the same logits; and a Qwen3-MoE forward takes
the active-experts wrapper for a 1-row step and the grouped one for a
20-row chunk. The q40i4 and q40i8 formats: the port's own params give the
JAX logits with the JAX engine's weights (atol 1e-4), the JAX params,
fused or not, carry across exactly, and every int8 matmul takes its
activations from `forward`'s act_quant."""

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
from dllama_tpu.ops import int8_matmul as JI
from dllama_tpu_torch.formats import ModelReader
from dllama_tpu_torch.models import forward, init_kv_cache, load_params
from dllama_tpu_torch.models.convert import params_from_jax
from dllama_tpu_torch.ops.int8_matmul import Int8Weight, pick_group, requantize_params
from dllama_tpu_torch.ops.quant_matmul import PackedQuantWeight, QuantWeight

from helpers import make_tiny_model

TOKENS = np.array([[1, 5, 9, 20, 33, 7, 2, 100, 41, 3]], np.int64)
CASES = {
    "llama": dict(arch=LlmArch.LLAMA),
    "qwen3": dict(arch=LlmArch.QWEN3),
    "qwen3_moe": dict(arch=LlmArch.QWEN3_MOE),
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


@pytest.mark.parametrize("case", ["llama", "qwen3", "qwen3_moe"])
def test_forward_matches_jax_dense(models, case):
    reader, jreader = ModelReader(models[case]), JReader(models[case])
    params = load_params(reader, torch.float32, "cpu", weight_format="dense")
    jparams = j_load(jreader, dtype=jnp.float32, weight_format="dense")
    for g, w in zip(_run_port(params, reader.header, "all"),
                    _run_jax(jparams, jreader.header, "all")):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", ["llama", "qwen3", "qwen3_moe"])
def test_params_from_jax_fused_layout(models, case):
    reader, jreader = ModelReader(models[case]), JReader(models[case])
    jparams = j_load(jreader, dtype=jnp.float32, weight_format="q40", fuse=1)
    # the JAX loader fuses w1|w3 for a dense FFN only; MoE experts stay stacked
    assert "wqkv" in jparams["layers"]
    assert ("w13" in jparams["layers"]) == (case != "qwen3_moe")
    carried = params_from_jax(jax.tree.map(np.asarray, jparams), reader.header, "cpu")
    own = load_params(reader, torch.float32, "cpu", weight_format="q40")
    for g, w in zip(_run_port(carried, reader.header, "all"),
                    _run_port(own, reader.header, "all")):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    for key in ("wq", "wk", "wv", "w1", "w3"):
        torch.testing.assert_close(carried["layers"][0][key].q, own["layers"][0][key].q)
        torch.testing.assert_close(carried["layers"][0][key].d, own["layers"][0][key].d)
    if case == "qwen3_moe":  # JAX [D, E] gate and [E, D, F] experts, carried across
        torch.testing.assert_close(carried["layers"][1]["moe_gate"], own["layers"][1]["moe_gate"])
        for key in ("w1", "w2", "w3"):
            assert carried["layers"][1][key].q.shape == own["layers"][1][key].q.shape
            torch.testing.assert_close(carried["layers"][1][key].q, own["layers"][1][key].q)
            torch.testing.assert_close(carried["layers"][1][key].d, own["layers"][1][key].d)


def _formats(reader, jreader, weight_format, fuse=0):
    """(port params, JAX params) of a quantized format, each from its own
    package's loader (q40i8: q40, then requantized with pick_group)."""
    h, jh = reader.header, jreader.header
    if weight_format == "q40i4":
        return (load_params(reader, torch.float32, "cpu", weight_format="q40i4"),
                j_load(jreader, dtype=jnp.float32, weight_format="q40i4", fuse=fuse))
    own = load_params(reader, torch.float32, "cpu", weight_format="q40")
    jq = j_load(jreader, dtype=jnp.float32, weight_format="q40", fuse=fuse)
    return (requantize_params(own, h, pick_group(h)),
            JI.requantize_params(jq, jh, JI.pick_group(jh, 1)))


@pytest.mark.parametrize("weight_format", ["q40i4", "q40i8"])
@pytest.mark.parametrize("case", ["llama", "qwen3", "qwen3_moe"])
def test_forward_matches_jax_quantized(models, case, weight_format):
    reader, jreader = ModelReader(models[case]), JReader(models[case])
    params, jparams = _formats(reader, jreader, weight_format)
    kind = PackedQuantWeight if weight_format == "q40i4" else Int8Weight
    assert isinstance(params["wcls"], kind) and isinstance(params["layers"][0]["wq"], kind)
    assert isinstance(params["layers"][0]["w1"], QuantWeight if case == "qwen3_moe" else kind)
    for g, w in zip(_run_port(params, reader.header, "all"),
                    _run_jax(jparams, jreader.header, "all")):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


@pytest.mark.parametrize("weight_format", ["q40i4", "q40i8"])
@pytest.mark.parametrize("case", ["llama", "qwen3", "qwen3_moe"])
def test_params_from_jax_quantized(models, case, weight_format):
    """Int8Weight, PackedQuantWeight and the FusedQuantWeights around them
    carry across with their exact values and scales: the fused JAX params
    give the port's own leaves (Q40 experts for Qwen3-MoE)."""
    reader, jreader = ModelReader(models[case]), JReader(models[case])
    own, jparams = _formats(reader, jreader, weight_format, fuse=1)
    assert "wqkv" in jparams["layers"]
    carried = params_from_jax(jax.tree.map(np.asarray, jparams), reader.header, "cpu")
    for key in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
        for lc, lo in zip(carried["layers"], own["layers"]):
            assert type(lc[key]) is type(lo[key]), key
            for a, b in zip(lc[key], lo[key]):
                assert a.dtype == b.dtype and a.shape == b.shape, key
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(carried["wcls"], own["wcls"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["llama", "qwen3_moe"])
def test_forward_int8_activations_come_from_act_quant(models, case):
    """`forward`'s act_quant quantizes every int8 matmul's activations, one
    call a matmul in a fixed order: the plain path replaying what a kernel
    run recorded gives that run's logits exactly, and a quantizer that
    zeroes them zeroes the logits (q40i8, f32, CPU)."""
    from dllama_tpu_torch.ops.int8_matmul import quantize_acts

    reader = ModelReader(models[case])
    h = reader.header
    own = load_params(reader, torch.float32, "cpu", weight_format="q40")
    params = requantize_params(own, h, pick_group(h))
    tokens = torch.from_numpy(TOKENS[:, :8])
    tape = []

    def record(x, group):
        tape.append(quantize_acts(x, group))
        return tape[-1]

    def run(plain, act_quant):
        cache = init_kv_cache(h, 1, torch.float32, device="cpu")
        return forward(params, h, tokens, 0, cache, "all", plain=plain, act_quant=act_quant)[0]

    want = run(False, record)
    assert len(tape) == (4 if case == "qwen3_moe" else 7) * h.n_layers + 1
    replay = iter(tape)
    torch.testing.assert_close(run(True, lambda x, g: next(replay)), want, rtol=0, atol=0)
    assert next(replay, None) is None
    zero = run(True, lambda x, g: (torch.zeros_like(x, dtype=torch.int8),
                                   torch.ones(x.shape[0], x.shape[1] // g)))
    assert not zero.any()


def test_qwen3_moe_f32_file_matches_jax_dense(tmp_path):
    """A Qwen3-MoE file stored in f32 (experts dequantized on the host, not
    unpacked on the device) gives the JAX logits."""
    from dllama_tpu.formats import FloatType

    p = str(tmp_path / "moe_f32.m")
    make_tiny_model(p, arch=LlmArch.QWEN3_MOE, weight_type=FloatType.F32)
    reader, jreader = ModelReader(p), JReader(p)
    params = load_params(reader, torch.float32, "cpu", weight_format="dense")
    assert params["layers"][0]["w2"].shape == (4, 64, 96)
    jparams = j_load(jreader, dtype=jnp.float32, weight_format="dense")
    for g, w in zip(_run_port(params, reader.header, "all"),
                    _run_jax(jparams, jreader.header, "all")):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


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


@pytest.mark.parametrize("weight_format", ["q40", "dense"])
def test_moe_forward_takes_both_kernel_branches(models, monkeypatch, weight_format):
    """A 20-row chunk goes through the grouped wrapper and a 1-row step
    through the active-experts one (B*T <= MOE_KERNEL_MAX_TOKENS), once a
    layer each, and both give the plain path's logits."""
    from dllama_tpu_torch.models import transformer as T

    suffix = "_q40" if weight_format == "q40" else ""
    calls = []
    for kind in ("active", "grouped"):
        name = f"moe_{kind}_experts{suffix}"
        real = getattr(T, name)
        monkeypatch.setattr(
            T, name, lambda *a, _real=real, _kind=kind: calls.append((_kind, a[0].shape[0])) or _real(*a)
        )
    reader = ModelReader(models["qwen3_moe"])
    h = reader.header
    params = load_params(reader, torch.float32, "cpu", weight_format=weight_format)
    tokens = torch.arange(1, 22).reshape(1, 21) % h.vocab_size
    outs = {}
    for plain in (False, True):
        cache = init_kv_cache(h, 1, torch.float32, device="cpu")
        pre, cache = forward(params, h, tokens[:, :20], 0, cache, "last", plain=plain)
        dec, _ = forward(params, h, tokens[:, 20:], 20, cache, "last", plain=plain)
        outs[plain] = (pre, dec)
    assert calls == [("grouped", 20)] * h.n_layers + [("active", 1)] * h.n_layers
    for a, b in zip(outs[False], outs[True]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
