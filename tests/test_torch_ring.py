"""The two kernel options of sequence parallelism, on CPU, against the TPU
kernels in interpret mode: the strided prefill stats (``s_stride``: key row
j at position s_pos0 + j * s_stride, the ring's local step over a cyclic
shard) against dllama_tpu ``flash_attention_stats(..., s_stride,
interpret=True)``, and the decode stats (``emit_stats``: the unnormalized
state of one shard) against ``flash_decode_stats(..., interpret=True)`` at
stride 1 and against jnp ``attention_stats(..., s_stride)`` above 1 (the
JAX decode kernel has no stride). Tolerance 1e-5 on f32 (sum order only).
The wrappers route CPU tensors to their plain versions and count no launch;
the merge of two states matches the JAX ring's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import flash_attention as JF
from dllama_tpu.ops.jnp_ops import attention_stats as j_attention_stats
from dllama_tpu.parallel import ring_attention as JR
from dllama_tpu_torch.ops import flash_attention as F
from dllama_tpu_torch.parallel.ring_attention import merge_stats

TOL = 1e-5


def _qkv(seed: int, t: int, s: int, h: int = 4, kh: int = 2, hd: int = 16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, t, h, hd)).astype(np.float32)
    k = rng.standard_normal((1, kh, s, hd)).astype(np.float32)
    v = rng.standard_normal((1, kh, s, hd)).astype(np.float32)
    return q, k, v


def _close(got, want):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("stride", [2, 4])
@pytest.mark.parametrize("q_pos0,s_pos0", [(0, 0), (37, 1), (70, 3), (5, 9)])
def test_strided_stats_match_tpu_kernel(stride, q_pos0, s_pos0):
    q, k, v = _qkv(stride * 100 + q_pos0, t=16, s=32)
    want = JF.flash_attention_stats(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.int32(q_pos0), jnp.int32(s_pos0), interpret=True,
                                    s_stride=stride)
    got = F.flash_attention_stats_ref(*map(torch.from_numpy, (q, k, v)), q_pos0, s_pos0,
                                      s_stride=stride)
    _close(got, want)


@pytest.mark.parametrize("pos,s_pos0", [(0, 0), (31, 0), (40, 8), (3, 8)])
def test_decode_stats_match_tpu_kernel(pos, s_pos0):
    """Stride 1: the TPU kernel's emit_stats, a shard wholly in the future
    (pos 3 before s_pos0 8) included."""
    q, k, v = _qkv(pos + 1, t=1, s=32)
    want = JF.flash_decode_stats(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.int32(pos), jnp.int32(s_pos0), interpret=True)
    got = F.flash_decode_stats_ref(*map(torch.from_numpy, (q, k, v)), pos, s_pos0)
    _close(got, want)
    if pos < s_pos0:
        assert float(got[1].max()) == float(np.float32(-1e30)) and float(got[2].abs().max()) == 0.0
        assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("sp,idx,pos", [(2, 0, 40), (2, 1, 40), (2, 1, 0), (4, 3, 2), (4, 2, 63)])
def test_decode_stats_strided_match_jnp(sp, idx, pos):
    q, k, v = _qkv(sp * 10 + idx, t=1, s=16)
    want = j_attention_stats(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
                             jnp.int32(idx), s_stride=sp)
    got = F.flash_decode_stats_ref(*map(torch.from_numpy, (q, k, v)), pos, idx, sp)
    _close(got, want)


def test_wrappers_route_cpu_tensors_to_plain_versions():
    q, k, v = map(torch.from_numpy, _qkv(7, t=8, s=32))
    before = (F.flash_attention_stats_strided.launches, F.flash_decode_stats.launches,
              F.flash_attention_stats.launches)
    got = F.flash_attention_stats(q, k, v, 20, 1, s_stride=2)
    want = F.flash_attention_stats_ref(q, k, v, 20, 1, s_stride=2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = F.flash_decode_stats(q[:, :1], k, v, 20, 1, 2)
    want = F.flash_decode_stats_ref(q[:, :1], k, v, 20, 1, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (F.flash_attention_stats_strided.launches, F.flash_decode_stats.launches,
            F.flash_attention_stats.launches) == before
    with pytest.raises(ValueError, match="s_stride"):
        F.flash_attention_stats(q, k, v, 0, 0, s_stride=0)
    with pytest.raises(ValueError, match="T=1"):
        F.flash_decode_stats(q, k, v, 0)


def test_merge_stats_matches_jax_ring_merge():
    q, k, v = _qkv(11, t=4, s=32)
    a = F.flash_attention_stats_ref(*map(torch.from_numpy, (q, k[:, :, :16], v[:, :, :16])), 20, 0)
    b = F.flash_attention_stats_ref(*map(torch.from_numpy, (q, k[:, :, 16:], v[:, :, 16:])), 20,
                                    16)
    got = merge_stats(*a, *b)
    want = JR._merge_stats(*(jnp.asarray(x.numpy()) for x in (*a, *b)))
    _close(got, want)
