"""The port's Q40 matmul plain version and device unpack against the JAX
package, on CPU.

Roundings: the port's kernel and plain version form W exactly in f32 and
round it to x's dtype. For float32 x that is the JAX ``qmatmul_ref`` (atol
1e-5). For bfloat16 x it is the TPU kernel's own roundings (x and the
dequantized tile in bf16, ``qmatmul_2d``), so against ``qmatmul_2d``
in interpret mode the two differ only in summation order: rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats.quants import q40_to_planar as j_q40_to_planar
from dllama_tpu.formats.quants import quantize_q40
from dllama_tpu.ops import quant_matmul as JQ
from dllama_tpu_torch.formats.quants import q40_to_planar
from dllama_tpu_torch.models.loader import q40_unpack
from dllama_tpu_torch.ops import quant_matmul as TQ


def _weights(k, n, seed=0):
    """The same Q40 weight in both layouts: JAX [in, out] + f32 scales, the
    port's [out, in] + f16 scales."""
    rng = np.random.default_rng(seed)
    raw = quantize_q40((rng.standard_normal(n * k) * 0.05).astype(np.float32))
    q, d = j_q40_to_planar(raw, n * k)
    q, d = q.reshape(n, k), d.reshape(n, k // 32)
    jw = JQ.from_planar(q, d)
    tw = TQ.QuantWeight(torch.from_numpy(q.copy()), torch.from_numpy(d.copy()))
    return jw, tw, raw


def test_dequant_matches():
    jw, tw, _ = _weights(128, 96)
    np.testing.assert_array_equal(
        TQ.dequant(tw).numpy(), np.asarray(JQ.dequant(jw, jnp.float32)).T
    )


@pytest.mark.parametrize("m", [1, 3, 16])
def test_plain_matches_jax_qmatmul_ref_f32(m):
    k, n = 160, 96
    jw, tw, _ = _weights(k, n, seed=m)
    x = np.random.default_rng(10 + m).standard_normal((m, k)).astype(np.float32)
    got = TQ.qmatmul_ref(torch.from_numpy(x), tw).numpy()
    np.testing.assert_allclose(got, np.asarray(JQ.qmatmul_ref(jnp.asarray(x), jw)), atol=1e-5)


@pytest.mark.parametrize("m", [1, 8, 24])
def test_plain_bf16_matches_tpu_kernel_interpret(m):
    k, n = 256, 256
    jw, tw, _ = _weights(k, n, seed=20 + m)
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(JQ.qmatmul_2d(xj, jw.q, jw.d, block_n=128, interpret=True))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = TQ.qmatmul_ref(xt, tw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    _, tw, _ = _weights(64, 32)
    x = torch.randn(2, 3, 64)
    before = TQ.qmatmul.launches
    out = TQ.qmatmul(x, tw)
    assert out.shape == (2, 3, 32) and out.dtype == torch.float32
    torch.testing.assert_close(out, TQ.qmatmul_ref(x, tw), rtol=0, atol=0)
    assert TQ.qmatmul.launches == before


def test_wrapper_rejects_other_dtypes():
    _, tw, _ = _weights(64, 32)
    with pytest.raises(TypeError):
        TQ.qmatmul(torch.randn(2, 64).half(), tw)


@pytest.mark.parametrize("n,k", [(32, 64), (96, 160)])
def test_device_unpack_matches_numpy(n, k):
    _, _, raw = _weights(k, n, seed=n)
    w = q40_unpack(torch.from_numpy(raw.copy()), n, k)
    q, d = q40_to_planar(raw, n * k)
    np.testing.assert_array_equal(w.q.numpy(), q.reshape(n, k))
    np.testing.assert_array_equal(w.d.numpy(), d.reshape(n, k // 32))
    assert w.q.dtype == torch.int8 and w.d.dtype == torch.float16
