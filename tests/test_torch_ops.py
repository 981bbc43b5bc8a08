"""ops/torch_ops against their jnp twins (dllama_tpu/ops/jnp_ops.py), f32 on
CPU, atol = rtol = 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.models.synthetic import make_header as j_make_header
from dllama_tpu.ops import jnp_ops as J
from dllama_tpu_torch.models.synthetic import make_header
from dllama_tpu_torch.ops import torch_ops as T

TOL = dict(atol=1e-5, rtol=1e-5)
RNG = np.random.default_rng(0)


def _x(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _headers(rope_scaling: bool):
    cfg = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
               vocab_size=256, seq_len=64, rope_theta=500000.0)
    h, jh = make_header(cfg), j_make_header(cfg)
    if rope_scaling:
        for hh in (h, jh):
            hh.rope_type = 2  # llama3.1
            hh.rope_scaling_factor = 8.0
            hh.rope_scaling_low_freq_factor = 1.0
            hh.rope_scaling_high_freq_factor = 4.0
            hh.rope_scaling_orig_max_seq_len = 32
    return h, jh


@pytest.mark.parametrize("fn", ["rms_norm", "qk_rms_norm"])
def test_norms(fn):
    x, w = _x(3, 5, 4, 16), _x(16) + 1.0
    _close(getattr(T, fn)(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           getattr(J, fn)(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("fn", ["silu", "gelu"])
def test_activations(fn):
    x = _x(4, 33, scale=3.0)
    _close(getattr(T, fn)(torch.from_numpy(x)), getattr(J, fn)(jnp.asarray(x)))


@pytest.mark.parametrize("rope_scaling", [False, True])
def test_rope_tables(rope_scaling):
    h, jh = _headers(rope_scaling)
    np.testing.assert_allclose(T.rope_frequencies(h), J.rope_frequencies(jh), **TOL)
    cos, sin = T.rope_cache(h, device="cpu")
    jcos, jsin = J.rope_cache(jh)
    _close(cos, jcos)
    _close(sin, jsin)


def test_rope_cache_defaults_to_cuda():
    """Only an explicit request gives the CPU: with no device the tables go
    to the card, or the call raises where there is none."""
    h, _ = _headers(False)
    if torch.cuda.is_available():
        assert T.rope_cache(h)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            T.rope_cache(h)


@pytest.mark.parametrize("interleaved", [True, False])
@pytest.mark.parametrize("per_lane", [False, True])
def test_apply_rope(interleaved, per_lane):
    h, jh = _headers(False)
    cos, sin = J.rope_cache(jh)
    x = _x(2, 5, 4, 16)
    if per_lane:  # [B, T, half] tables: lanes at positions 3 and 11
        idx = np.array([[3 + i for i in range(5)], [11 + i for i in range(5)]])
        c, s = np.asarray(cos)[idx], np.asarray(sin)[idx]
    else:
        c, s = np.asarray(cos)[7:12], np.asarray(sin)[7:12]
    _close(
        T.apply_rope(torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(s), interleaved),
        J.apply_rope(jnp.asarray(x), jnp.asarray(c), jnp.asarray(s), interleaved),
    )


@pytest.mark.parametrize(
    "q_pos0,s_pos0,s_stride",
    [(0, 0, 1), (9, 0, 1), ([0, 13, -6], 0, 1), (20, 8, 1), ([5, 30, 1], 2, 2)],
)
def test_attention_stats(q_pos0, s_pos0, s_stride):
    b, t, h, kh, s, hd = 3, 6, 4, 2, 24, 16
    q, k, v = _x(b, t, h, hd), _x(b, kh, s, hd), _x(b, kh, s, hd)
    got = T.attention_stats(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            q_pos0, s_pos0, s_stride)
    want = J.attention_stats(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(q_pos0, jnp.int32), s_pos0, s_stride)
    for a, w in zip(got, want):
        _close(a, w)


@pytest.mark.parametrize("pos", [0, 5, 17])
def test_attention_dense(pos):
    q, k, v = _x(2, 3, 4, 16), _x(2, 2, 24, 16), _x(2, 2, 24, 16)
    _close(
        T.attention_dense(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos),
        J.attention_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos)),
    )
