"""The port's paged KV helpers and paged attention (ops/kv_cache.py,
ops/flash_attention.py) against the JAX package on CPU, f32: the page
gather/scatter/view equal JAX's exactly; `paged_flash_decode_ref` (what the
wrapper runs on CPU tensors, and the card kernel's plain version) matches
the TPU kernel ``paged_flash_decode`` in interpret mode and JAX's
``paged_view`` + ``attention_dense`` within 1e-5, with pages shared between
lanes, shuffled, and positions at page edges; the paged chunk path matches
the TPU ``flash_attention_stats`` on the gathered view."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import kv_cache as jkv
from dllama_tpu.ops.flash_attention import flash_attention_stats as jflash_stats
from dllama_tpu.ops.flash_attention import paged_flash_decode as jpaged_decode
from dllama_tpu.ops.jnp_ops import attention_dense as jattention_dense
from dllama_tpu_torch.ops import flash_attention as fa
from dllama_tpu_torch.ops import kv_cache as tkv

TOL = 1e-5


def _pool(rng, p, kh, ps, hd):
    return rng.normal(size=(p, kh, ps, hd)).astype(np.float32)


def test_gather_scatter_paged_view_equal_jax():
    rng = np.random.default_rng(0)
    pool_l = _pool(rng, 6, 2, 4, 8)
    ids = np.asarray([3, 1, 4], np.int32)
    want = np.asarray(jkv.gather_pages(jnp.asarray(pool_l), jnp.asarray(ids)))
    got = tkv.gather_pages(torch.from_numpy(pool_l), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    rows = rng.normal(size=want.shape).astype(np.float32)
    want = np.asarray(jkv.scatter_pages(jnp.asarray(pool_l), jnp.asarray(ids), jnp.asarray(rows)))
    got = tkv.scatter_pages(torch.from_numpy(pool_l), torch.from_numpy(ids),
                            torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jkv.paged_view(jnp.asarray(pool_l), jnp.asarray(ids), jnp.float32))
    got = tkv.paged_view(torch.from_numpy(pool_l), torch.from_numpy(ids), torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def _case(rng, g, ps, kh=2, hd=16, b=3, n_blocks=6):
    """A pool whose lanes 0 and 1 share their first two pages; every lane's
    pages shuffled over the pool; unfilled slots at scratch page 0."""
    p = 1 + b * n_blocks
    perm = rng.permutation(np.arange(1, p)).astype(np.int32)
    pt = perm[: b * n_blocks].reshape(b, n_blocks).copy()
    pt[1, :2] = pt[0, :2]
    pt[2, -1] = 0  # beyond lane 2's frontier
    k = _pool(rng, p, kh, ps, hd)
    v = _pool(rng, p, kh, ps, hd)
    return k, v, pt


def _positions(ps, n_blocks, b):
    edges = [0, ps - 1, ps, 2 * ps - 1, n_blocks * ps - 1]
    return [np.asarray([edges[(i + j) % len(edges)] for j in range(b)], np.int32)
            for i in range(len(edges))]


@pytest.mark.parametrize("ps", [4, 8])
@pytest.mark.parametrize("g", [2, 4])
def test_paged_decode_ref_matches_tpu_kernel_and_dense(g, ps):
    rng = np.random.default_rng(10 * g + ps)
    kh, hd, b, nb = 2, 16, 3, 6
    k, v, pt = _case(rng, g, ps, kh, hd, b, nb)
    for pos in _positions(ps, nb, b):
        pos[2] = min(pos[2], (nb - 1) * ps - 1)  # lane 2's last slot is unfilled
        q = rng.normal(size=(b, 1, kh * g, hd)).astype(np.float32)
        got = fa.paged_flash_decode(*(torch.from_numpy(a) for a in (q, k, v, pt, pos))).numpy()
        kernel = np.asarray(jpaged_decode(*(jnp.asarray(a) for a in (q, k, v, pt, pos)),
                                          interpret=True))
        np.testing.assert_allclose(got, kernel, atol=TOL, rtol=0)
        kd = jnp.stack([jkv.paged_view(jnp.asarray(k), jnp.asarray(pt[i]), jnp.float32)
                        for i in range(b)])
        vd = jnp.stack([jkv.paged_view(jnp.asarray(v), jnp.asarray(pt[i]), jnp.float32)
                        for i in range(b)])
        dense = np.asarray(jattention_dense(jnp.asarray(q), kd, vd, jnp.asarray(pos)))
        np.testing.assert_allclose(got, dense, atol=TOL, rtol=0)
    assert fa.paged_flash_decode.launches == 0  # CPU tensors: the plain version


def test_parked_lane_reads_nothing():
    rng = np.random.default_rng(3)
    k, v, pt = _case(rng, 2, 4)
    q = torch.randn(3, 1, 4, 16)
    out = fa.paged_flash_decode(q, torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(pt), torch.tensor([5, -1, 9], dtype=torch.int32))
    assert torch.all(out[1] == 0) and torch.all(out[0] != 0)


@pytest.mark.parametrize("ps", [4, 8])
def test_paged_chunk_stats_match_tpu_flash_stats(ps):
    """An admission chunk of T rows at q_pos0 through the page table equals
    the TPU prefill kernel (interpret mode) on the gathered slab view."""
    rng = np.random.default_rng(ps)
    g, kh, hd, b, nb, t = 4, 2, 16, 3, 6, 8
    k, v, pt = _case(rng, g, ps, kh, hd, b, nb)
    q_pos0 = np.asarray([0, ps + 1, 2 * ps], np.int32)
    q = rng.normal(size=(b, t, kh * g, hd)).astype(np.float32)
    got = fa.paged_flash_attention_stats(*(torch.from_numpy(a) for a in (q, k, v, pt, q_pos0)))
    kd = jnp.stack([jkv.paged_view(jnp.asarray(k), jnp.asarray(pt[i]), jnp.float32)
                    for i in range(b)])
    vd = jnp.stack([jkv.paged_view(jnp.asarray(v), jnp.asarray(pt[i]), jnp.float32)
                    for i in range(b)])
    want = jflash_stats(jnp.asarray(q), kd, vd, jnp.asarray(q_pos0), 0, interpret=True)
    acc, m, l = (np.asarray(x) for x in want)
    np.testing.assert_allclose(got[0].numpy(), acc, atol=TOL, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), m.reshape(got[1].shape), atol=TOL, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), l.reshape(got[2].shape), atol=TOL, rtol=0)
    normalized = fa.paged_flash_attention(*(torch.from_numpy(a) for a in (q, k, v, pt, q_pos0)))
    dense = np.asarray(jattention_dense(jnp.asarray(q), kd, vd, jnp.asarray(q_pos0)))
    np.testing.assert_allclose(normalized.numpy(), dense, atol=TOL, rtol=0)


def test_lane_views_is_gather_per_lane():
    rng = np.random.default_rng(5)
    k, _, pt = _case(rng, 2, 4)
    views = tkv.lane_views(torch.from_numpy(k), torch.from_numpy(pt))
    for i in range(pt.shape[0]):
        assert torch.equal(views[i], tkv.gather_pages(torch.from_numpy(k),
                                                      torch.from_numpy(pt[i])))


# The edge shapes of the card kernels' plain versions (what chip_smoke holds
# the CUDA kernels to): page sizes 8, 16 (the server's) and 64, head dims 64
# and 128, G = 4 and 8, a parked lane, and for chunks a ragged T = 37.
EDGES = [(8, 4, 64), (16, 8, 128), (64, 4, 128), (16, 4, 64), (8, 8, 128), (64, 8, 64)]


@pytest.mark.parametrize("ps,g,hd", EDGES)
def test_paged_decode_edge_shapes_match_tpu_kernel_and_dense(ps, g, hd):
    rng = np.random.default_rng(ps + g + hd)
    kh, b, nb = 2, 3, 256 // ps
    k, v, pt = _case(rng, g, ps, kh, hd, b, nb)
    pos = np.asarray([-1, ps, (nb - 1) * ps - 1], np.int32)  # lane 2's last slot is unfilled
    q = rng.normal(size=(b, 1, kh * g, hd)).astype(np.float32)
    got = fa.paged_flash_decode(*(torch.from_numpy(a) for a in (q, k, v, pt, pos))).numpy()
    kernel = np.asarray(jpaged_decode(*(jnp.asarray(a) for a in (q, k, v, pt, pos)),
                                      interpret=True))
    np.testing.assert_allclose(got, kernel, atol=TOL, rtol=TOL)
    kd = jnp.stack([jkv.paged_view(jnp.asarray(k), jnp.asarray(pt[i]), jnp.float32)
                    for i in range(b)])
    vd = jnp.stack([jkv.paged_view(jnp.asarray(v), jnp.asarray(pt[i]), jnp.float32)
                    for i in range(b)])
    dense = np.asarray(jattention_dense(jnp.asarray(q), kd, vd, jnp.asarray(pos)))
    np.testing.assert_allclose(got, dense, atol=TOL, rtol=TOL)
    assert np.all(got[0] == 0)


@pytest.mark.parametrize("ps,g,hd", EDGES)
def test_paged_chunk_stats_edge_shapes_match_tpu_flash_stats(ps, g, hd):
    rng = np.random.default_rng(2 * ps + g + hd)
    kh, b, nb, t = 2, 3, 256 // ps, 37
    k, v, pt = _case(rng, g, ps, kh, hd, b, nb)
    q_pos0 = np.asarray([ps + 3, -t, 0], np.int32)
    q = rng.normal(size=(b, t, kh * g, hd)).astype(np.float32)
    got = fa.paged_flash_attention_stats(*(torch.from_numpy(a) for a in (q, k, v, pt, q_pos0)))
    kd = jnp.stack([jkv.paged_view(jnp.asarray(k), jnp.asarray(pt[i]), jnp.float32)
                    for i in range(b)])
    vd = jnp.stack([jkv.paged_view(jnp.asarray(v), jnp.asarray(pt[i]), jnp.float32)
                    for i in range(b)])
    want = jflash_stats(jnp.asarray(q), kd, vd, jnp.asarray(q_pos0), 0, block_t=t, block_s=64,
                        interpret=True)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w).reshape(a.shape), atol=TOL, rtol=TOL)
    acc, m, l = got
    assert torch.all(l[1] == 0) and torch.all(acc[1] == 0) and torch.all(m[1] <= -1e29)
