"""The port's packed-nibble Q40 layout (weight_format q40i4) against the JAX
package, on CPU.

Exact: `pack_nibbles`, `unpack_nibbles`, `dequant_packed`, the numpy
`pack_q40_device`, the loader's on-device split of the file's bytes and
its q40i4 leaves, each against JAX's (whose layout is the port's
transposed). Plain version: `qmatmul_ref` on packed weights against JAX's
`qmatmul_ref` in f32 (normalized error <= 1e-6: sum order only), and in
bf16 against the TPU kernel `qmatmul_i4_2d` in interpret mode (both round
x and the dequantized weight to bf16 and sum in f32: rtol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats import ModelReader as JReader
from dllama_tpu.formats.model_file import LlmArch
from dllama_tpu.formats.quants import pack_q40_device as j_pack_q40_device
from dllama_tpu.formats.quants import q40_to_planar, quantize_q40
from dllama_tpu.models import load_params as j_load
from dllama_tpu.ops import quant_matmul as JQ
from dllama_tpu_torch.formats import ModelReader
from dllama_tpu_torch.formats.quants import pack_q40_device
from dllama_tpu_torch.models import load_params
from dllama_tpu_torch.models.loader import q40_split
from dllama_tpu_torch.ops import quant_matmul as TQ

from helpers import make_tiny_model


def _weights(n, k, seed=0):
    """One Q40 weight as JAX (QuantWeight, PackedQuantWeight), the port's
    (QuantWeight, PackedQuantWeight), and the file's bytes."""
    rng = np.random.default_rng(seed)
    raw = quantize_q40((rng.standard_normal(n * k) * 0.05).astype(np.float32))
    q, d = q40_to_planar(raw, n * k)
    q, d = q.reshape(n, k), d.reshape(n, k // 32)
    jw = JQ.from_planar(q, d)
    tw = TQ.QuantWeight(torch.from_numpy(q.copy()), torch.from_numpy(d.copy()))
    return jw, JQ.pack_nibbles(jw), tw, TQ.pack_nibbles(tw), raw


def _norm_err(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("n,k", [(64, 128), (96, 512)])
def test_pack_unpack_dequant_match_jax(n, k):
    jw, jp, tw, tp, _ = _weights(n, k, seed=n)
    assert tp.qp.dtype == torch.uint8 and tp.qp.shape == (n, k // 2) and tp.in_dim == k
    np.testing.assert_array_equal(tp.qp.numpy().view(np.int8), np.asarray(jp.qp).T)
    np.testing.assert_array_equal(tp.d.numpy(), np.asarray(jp.d).T)
    np.testing.assert_array_equal(
        TQ.unpack_nibbles(tp.qp).numpy(), np.asarray(JQ.unpack_nibbles(jp.qp)).T
    )
    np.testing.assert_array_equal(
        TQ.dequant_packed(tp).numpy(), np.asarray(JQ.dequant_packed(jp, jnp.float32)).T
    )
    np.testing.assert_array_equal(TQ.dequant_packed(tp).numpy(), TQ.dequant(tw).numpy())


def test_pack_stacked_leading_dims():
    _, _, a, pa, _ = _weights(32, 64, seed=1)
    _, _, b, pb, _ = _weights(32, 64, seed=2)
    stacked = TQ.pack_nibbles(TQ.QuantWeight(torch.stack([a.q, b.q]), torch.stack([a.d, b.d])))
    assert stacked.qp.shape == (2, 32, 32)
    torch.testing.assert_close(stacked.qp[1], pb.qp, rtol=0, atol=0)
    torch.testing.assert_close(TQ.unpack_nibbles(stacked.qp)[0], a.q, rtol=0, atol=0)


@pytest.mark.parametrize("n,k", [(32, 64), (96, 160)])
def test_numpy_pack_and_device_split_match_jax(n, k):
    """The numpy twin of pack_q40_device gives JAX's bytes, and the loader's
    split of the file's blocks gives the same bytes and scales."""
    jw, _, tw, _, raw = _weights(n, k, seed=k)
    qp, d = pack_q40_device(tw.q.numpy(), tw.d.numpy())
    jqp, jd = j_pack_q40_device(np.asarray(jw.q), np.asarray(jw.d))
    np.testing.assert_array_equal(qp.view(np.int8), jqp.T)
    np.testing.assert_array_equal(d, jd.T)
    split = q40_split(torch.from_numpy(raw.copy()), n, k)
    np.testing.assert_array_equal(split.qp.numpy(), qp)
    np.testing.assert_array_equal(split.d.numpy(), d)
    assert split.qp.is_contiguous() and split.d.dtype == torch.float16


@pytest.mark.parametrize("m", [1, 3, 16])
def test_plain_on_packed_matches_jax_ref_f32(m):
    k, n = 256, 96
    _, jp, _, tp, _ = _weights(n, k, seed=m)
    x = np.random.default_rng(10 + m).standard_normal((m, k)).astype(np.float32)
    got = TQ.qmatmul_ref(torch.from_numpy(x), tp).numpy()
    assert _norm_err(got, np.asarray(JQ.qmatmul_ref(jnp.asarray(x), jp))) <= 1e-6


# (1, 256, 512) is left out: the JAX package's own test of qmatmul_i4_2d at
# that shape fails in interpret mode on the tree this port starts from
@pytest.mark.parametrize("m,n,k", [(8, 512, 256), (16, 256, 1024), (3, 384, 1024)])
def test_plain_bf16_matches_i4_kernel_interpret(m, n, k):
    _, jp, _, tp, _ = _weights(n, k, seed=m)
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(JQ.qmatmul_i4_2d(xj, jp.qp, jp.d, block_n=128, interpret=True))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    np.testing.assert_allclose(TQ.qmatmul_ref(xt, tp).numpy(), want, rtol=1e-5, atol=1e-6)


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    _, _, _, tp, _ = _weights(32, 64)
    x = torch.randn(2, 3, 64)
    before = TQ.qmatmul_i4.launches
    out = TQ.qmatmul_i4(x, tp)
    assert out.shape == (2, 3, 32) and out.dtype == torch.float32
    torch.testing.assert_close(out, TQ.qmatmul_ref(x, tp), rtol=0, atol=0)
    assert TQ.qmatmul_i4.launches == before
    with pytest.raises(TypeError):
        TQ.qmatmul_i4(x.half(), tp)


def test_packed_bytes_per_weight():
    _, _, tw, tp, _ = _weights(256, 512)
    assert (tp.qp.numel() + tp.d.numel() * 2) / (256 * 512) == 0.5625
    assert tp.qp.numel() * 2 == tw.q.numel()


@pytest.mark.parametrize("arch", [LlmArch.LLAMA, LlmArch.QWEN3_MOE])
def test_loader_q40i4_leaves_match_jax_loader(tmp_path, arch):
    """Non-expert matmul weights and wcls load packed, with JAX's bytes and
    scales; Qwen3-MoE experts stay int8 QuantWeights with JAX's values."""
    p = str(tmp_path / "m.m")
    make_tiny_model(p, arch=arch)
    own = load_params(ModelReader(p), torch.float32, "cpu", weight_format="q40i4")
    jp = j_load(JReader(p), dtype=jnp.float32, weight_format="q40i4")
    moe = arch == LlmArch.QWEN3_MOE
    for key in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
        jw = jp["layers"][key]
        for l, lp in enumerate(own["layers"]):
            if moe and key in ("w1", "w2", "w3"):
                assert isinstance(lp[key], TQ.QuantWeight)
                np.testing.assert_array_equal(lp[key].q.numpy(), np.swapaxes(np.asarray(jw.q[l]), -1, -2))
                continue
            assert isinstance(lp[key], TQ.PackedQuantWeight)
            np.testing.assert_array_equal(lp[key].qp.numpy().view(np.int8), np.asarray(jw.qp[l]).T)
            np.testing.assert_array_equal(lp[key].d.numpy(), np.asarray(jw.d[l]).T)
    assert isinstance(own["wcls"], TQ.PackedQuantWeight)
    np.testing.assert_array_equal(own["wcls"].qp.numpy().view(np.int8), np.asarray(jp["wcls"].qp).T)
