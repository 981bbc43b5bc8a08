"""The port's grouped-int8 matmul (weight_format q40i8) against the JAX
package, on CPU.

Exact: `requantize_q40` (ints and scales), `quantize_acts` and
`pick_group` against JAX's, whose layout is the port's transposed. The JAX
functions run compiled (`jax.jit`), as the JAX engine runs them: XLA turns
their ``/ 127.0`` into a product with the f32 reciprocal, which decides the
round-half-even ties Q40 values meet, and the port computes that product.
Plain version: `i8matmul_ref` against JAX's `i8matmul_ref` in f32, and
`i8matmul_2d_ref` against the TPU kernel `i8matmul_2d` in interpret mode
on the same quantized operands; both sides compute exact integer group
dots and the same scaled group sums, so they differ only in the f32 order
of the group sum: normalized error <= 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats.quants import q40_to_planar, quantize_q40
from dllama_tpu.models.synthetic import make_header as j_make_header
from dllama_tpu.ops import int8_matmul as JI
from dllama_tpu.ops import quant_matmul as JQ
from dllama_tpu_torch.models.synthetic import make_header
from dllama_tpu_torch.ops import int8_matmul as TI
from dllama_tpu_torch.ops.quant_matmul import QuantWeight

j_requantize = jax.jit(JI.requantize_q40, static_argnames="group")
j_quantize_acts = jax.jit(JI.quantize_acts, static_argnames="group")
j_i8matmul_ref = jax.jit(JI.i8matmul_ref)


def _q40(n, k, seed=0, lead=()):
    """The same Q40 weight for JAX ([.., in, out], f32 scales) and the port
    ([.., out, in], f16 scales)."""
    rng = np.random.default_rng(seed)
    size = int(np.prod(lead, dtype=np.int64)) * n * k
    q, d = q40_to_planar(quantize_q40((rng.standard_normal(size) * 0.1).astype(np.float32)), size)
    q, d = q.reshape(*lead, n, k), d.reshape(*lead, n, k // 32)
    jw = JQ.QuantWeight(jnp.asarray(np.swapaxes(q, -1, -2)),
                        jnp.asarray(np.swapaxes(d, -1, -2).astype(np.float32)))
    return jw, QuantWeight(torch.from_numpy(q.copy()), torch.from_numpy(d.copy()))


def _norm_err(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("group", [512, 256, 128, 32])
def test_requantize_matches_jax_bit_for_bit(group):
    jw, tw = _q40(96, 1024, seed=group)
    j8, t8 = j_requantize(jw, group=group), TI.requantize_q40(tw, group)
    assert t8.q.dtype == torch.int8 and t8.s.dtype == torch.float32 and t8.group == group
    np.testing.assert_array_equal(t8.q.numpy(), np.asarray(j8.q).T)
    np.testing.assert_array_equal(t8.s.numpy(), np.asarray(j8.s).T)


def test_requantize_stacked_equals_per_layer():
    jw, tw = _q40(64, 256, seed=3, lead=(2,))
    t8 = TI.requantize_q40(tw, 128)
    one = TI.requantize_q40(QuantWeight(tw.q[1], tw.d[1]), 128)
    torch.testing.assert_close(t8.q[1], one.q, rtol=0, atol=0)
    torch.testing.assert_close(t8.s[1], one.s, rtol=0, atol=0)
    j8 = j_requantize(jw, group=128)
    np.testing.assert_array_equal(t8.q.numpy(), np.swapaxes(np.asarray(j8.q), -1, -2))


def test_requantize_zero_columns_and_bad_group():
    _, tw = _q40(32, 256)
    zero = QuantWeight(torch.zeros_like(tw.q), tw.d)
    t8 = TI.requantize_q40(zero, 128)
    assert (t8.s == 1).all() and (t8.q == 0).all()
    with pytest.raises(ValueError):
        TI.requantize_q40(tw, 192)
    with pytest.raises(ValueError):
        TI.quantize_acts(torch.ones(2, 256), 192)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_acts_matches_jax(dtype):
    x = np.random.default_rng(4).standard_normal((2, 3, 512)).astype(np.float32)
    x[0, 1, :256] = 0  # an all-zero group takes scale 1
    xt = torch.from_numpy(x).to(dtype)
    xq, sx = TI.quantize_acts(xt, 256)
    jxq, jsx = j_quantize_acts(jnp.asarray(xt.float().numpy()), group=256)
    assert xq.dtype == torch.int8 and xq.shape == (2, 3, 512) and sx.shape == (2, 3, 2)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))


@pytest.mark.parametrize("preset,group", [("tiny", 32), ("llama-8b", 512), ("qwen3-30b-a3b", 256)])
def test_pick_group_matches_jax(preset, group):
    h, jh = make_header(preset), j_make_header(preset)
    assert TI.pick_group(h) == JI.pick_group(jh, 1) == group


@pytest.mark.parametrize("m,group", [(1, 512), (3, 256), (16, 128)])
def test_plain_matches_jax_ref_f32(m, group):
    jw, tw = _q40(96, 1024, seed=m)
    j8, t8 = j_requantize(jw, group=group), TI.requantize_q40(tw, group)
    x = np.random.default_rng(20 + m).standard_normal((m, 1024)).astype(np.float32)
    got = TI.i8matmul_ref(torch.from_numpy(x), t8).numpy()
    assert _norm_err(got, np.asarray(j_i8matmul_ref(jnp.asarray(x), j8))) <= 1e-6


@pytest.mark.parametrize("m,n,k,group", [(1, 256, 1024, 512), (4, 512, 2048, 256), (16, 256, 1024, 128)])
def test_plain_matches_i8_kernel_interpret(m, n, k, group):
    jw, tw = _q40(n, k, seed=n + group)
    j8, t8 = j_requantize(jw, group=group), TI.requantize_q40(tw, group)
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16)
    xq, sx = TI.quantize_acts(x, group)
    got = TI.i8matmul_2d_ref(xq, sx, t8).numpy()
    want = np.asarray(JI.i8matmul_2d(jnp.asarray(xq.numpy()), jnp.asarray(sx.numpy()), j8.q, j8.s,
                                     block_n=128, interpret=True))
    assert _norm_err(got, want) <= 1e-6


def test_plain_refuses_groups_past_exact_f32():
    xq = torch.ones((1, 2048), dtype=torch.int8)
    with pytest.raises(ValueError):
        TI.i8matmul_2d_ref(xq, torch.ones(1, 1), TI.Int8Weight(xq, torch.ones(1, 1)))


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    _, tw = _q40(32, 512)
    t8 = TI.requantize_q40(tw, 256)
    x = torch.randn(2, 3, 512)
    before = TI.i8matmul_2d.launches
    out = TI.i8matmul(x, t8)
    assert out.shape == (2, 3, 32) and out.dtype == torch.float32
    torch.testing.assert_close(out, TI.i8matmul_ref(x.reshape(6, 512), t8).reshape(2, 3, 32),
                               rtol=0, atol=0)
    assert TI.i8matmul_2d.launches == before
    with pytest.raises(TypeError):
        TI.i8matmul(x.half(), t8)


def test_requantize_params_keeps_moe_experts_q40():
    _, attn = _q40(64, 128, seed=1)
    _, expert = _q40(96, 64, seed=2, lead=(4,))
    _, wcls = _q40(256, 64, seed=3)
    params = {"wcls": wcls, "embed": torch.zeros(4), "layers": [
        {"wq": attn, "w1": expert, "w2": expert, "w3": expert, "att_norm": torch.ones(64)}]}
    moe = make_header({**dict(dim=64, hidden_dim=160, moe_hidden_dim=96, n_layers=1, n_heads=4,
                               n_kv_heads=2, head_dim=16, vocab_size=256, seq_len=64),
                       "n_experts": 4, "n_active_experts": 2})
    out = TI.requantize_params(params, moe, 32)
    lp = out["layers"][0]
    assert isinstance(lp["wq"], TI.Int8Weight) and lp["wq"].group == 32
    assert all(lp[k] is expert for k in ("w1", "w2", "w3"))
    assert lp["att_norm"] is params["layers"][0]["att_norm"]
    assert isinstance(out["wcls"], TI.Int8Weight)
    assert isinstance(params["layers"][0]["wq"], QuantWeight)  # the input is left as it was
