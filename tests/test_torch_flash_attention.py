"""The port's attention plain versions against the JAX Pallas kernels in
interpret mode and against jnp attention_stats, on CPU (f32, atol 1e-5).
Includes per-lane positions and a parked lane at -T."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import flash_attention as JF
from dllama_tpu.ops import jnp_ops as J
from dllama_tpu_torch.ops import flash_attention as TF

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(b, t, h, kh, s, hd, seed):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    return f(b, t, h, hd), f(b, kh, s, hd), f(b, kh, s, hd)


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("q_pos0", [[0, 0], [0, 9], [16, -16], [3, 12]])
def test_stats_match_interpret_kernel_and_jnp(q_pos0):
    b, t, h, kh, s, hd = 2, 16, 4, 2, 32, 16
    q, k, v = _qkv(b, t, h, kh, s, hd, seed=sum(q_pos0) + 50)
    got = TF.flash_attention_stats(*_t(q, k, v), q_pos0)
    pos = jnp.asarray(q_pos0, jnp.int32)
    kern = JF.flash_attention_stats(*_j(q, k, v), pos, jnp.int32(0),
                                    block_t=8, block_s=8, interpret=True)
    ref = J.attention_stats(*_j(q, k, v), pos, 0)
    for a, w1, w2 in zip(got, kern, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(w1), **TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(w2), **TOL)
    if q_pos0[1] == -t:  # parked lane: fully masked, zero state
        acc, m, l = got
        assert torch.all(l[1] == 0) and torch.all(acc[1] == 0) and torch.all(m[1] <= -1e29)


def test_stats_with_shard_start_match_jnp():
    q, k, v = _qkv(1, 8, 4, 2, 16, 16, seed=3)
    got = TF.flash_attention_stats(*_t(q, k, v), 20, s_pos0=8)
    ref = J.attention_stats(*_j(q, k, v), 20, 8)
    for a, w in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("pos", [0, 11])
def test_flash_attention_normalized_matches_interpret(pos):
    q, k, v = _qkv(1, 16, 4, 2, 32, 16, seed=pos)
    got = TF.flash_attention(*_t(q, k, v), pos)
    want = JF.flash_attention(*_j(q, k, v), jnp.int32(pos), block_t=8, block_s=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pos", [[0, 0, 0], [0, 13, 31], [7, 8, 16]])
def test_decode_matches_interpret_kernel_and_dense(pos):
    b, h, kh, s, hd = 3, 8, 2, 32, 16
    q, k, v = _qkv(b, 1, h, kh, s, hd, seed=pos[1])
    got = TF.flash_decode(*_t(q, k, v), pos)
    p = jnp.asarray(pos, jnp.int32)
    kern = JF.flash_decode(*_j(q, k, v), p, block_s=8, interpret=True)
    acc, _, l = J.attention_stats(*_j(q, k, v), p, 0)
    dense = np.asarray(acc / jnp.where(l == 0, 1.0, l)[..., None]).transpose(0, 3, 1, 2, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)
    np.testing.assert_allclose(got.numpy(), dense.reshape(b, 1, h, hd), **TOL)


def test_decode_scalar_pos_matches_attention_dense():
    q, k, v = _qkv(2, 1, 4, 2, 24, 16, seed=9)
    got = TF.flash_decode(*_t(q, k, v), 17)
    want = J.attention_dense(*_j(q, k, v), jnp.int32(17))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_wrappers_launch_nothing():
    q, k, v = _t(*_qkv(1, 4, 4, 2, 8, 16, seed=1))
    before = (TF.flash_attention_stats.launches, TF.flash_decode.launches)
    TF.flash_attention_stats(q, k, v, 0)
    TF.flash_decode(q[:, :1].contiguous(), k, v, 3)
    assert (TF.flash_attention_stats.launches, TF.flash_decode.launches) == before


# The edge shapes of the card kernels' plain versions (what chip_smoke holds
# the CUDA kernels to): head dims 64 and 128, G = 4 and 8 query heads a KV
# head, a ragged T (37: no multiple of 16 or 64) and a parked lane.
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", [4, 8])
def test_stats_edge_shapes_match_interpret_kernel_and_jnp(g, hd):
    b, t, kh, s = 3, 37, 2, 128
    q_pos0 = [60, -t, 0]
    q, k, v = _qkv(b, t, g * kh, kh, s, hd, seed=g + hd)
    got = TF.flash_attention_stats(*_t(q, k, v), torch.tensor(q_pos0, dtype=torch.int32))
    pos = jnp.asarray(q_pos0, jnp.int32)
    kern = JF.flash_attention_stats(*_j(q, k, v), pos, jnp.int32(0),
                                    block_t=t, block_s=32, interpret=True)
    ref = J.attention_stats(*_j(q, k, v), pos, 0)
    for a, w1, w2 in zip(got, kern, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(w1).reshape(a.shape), **TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(w2).reshape(a.shape), **TOL)
    acc, m, l = got
    assert torch.all(l[1] == 0) and torch.all(acc[1] == 0) and torch.all(m[1] <= -1e29)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", [4, 8])
def test_decode_edge_shapes_match_interpret_kernel_and_dense(g, hd):
    b, kh, s = 3, 2, 128
    pos = [-1, 0, 100]  # a parked lane, the first row, a ragged frontier
    q, k, v = _qkv(b, 1, g * kh, kh, s, hd, seed=g * hd)
    got = TF.flash_decode(*_t(q, k, v), torch.tensor(pos, dtype=torch.int32))
    p = jnp.asarray(pos, jnp.int32)
    kern = JF.flash_decode(*_j(q, k, v), p, block_s=32, interpret=True)
    acc, _, l = J.attention_stats(*_j(q, k, v), p, 0)
    dense = np.asarray(acc / jnp.where(l == 0, 1.0, l)[..., None]).transpose(0, 3, 1, 2, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)
    np.testing.assert_allclose(got.numpy(), dense.reshape(b, 1, g * kh, hd), **TOL)
    assert torch.all(got[0] == 0)
