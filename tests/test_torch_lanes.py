"""The port's pool-native lanes (runtime/engine.py lanes, kv/manager.py) on
CPU, f32, against the JAX engine's (batch_size 2, ``init_kv_pool(4,
native=True)``): greedy lane streams, alone and side by side at ragged
positions, equal the JAX engine's on tiny Llama, Qwen3 and Qwen3-MoE files;
``generate_batch`` with ragged prompts equals the JAX one; the top-p mask's
support sets equal ``_topp_mask``'s. Within the port (torch cannot replay
the JAX PRNG): a full-page adoption copies no page and a mid-page one forks
exactly one, with streams equal to cold runs, and a seeded sampled lane
repeats across block splits and whatever the other lane does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats.model_file import LlmArch
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu.runtime.engine import _topp_mask
from dllama_tpu_torch.kv.manager import PagedKVManager
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.sampler import topp_mask

from helpers import make_tiny_model

CFG = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
           vocab_size=256, seq_len=64)
ARCHS = {"llama": LlmArch.LLAMA, "qwen3": LlmArch.QWEN3, "qwen3_moe": LlmArch.QWEN3_MOE}
PROMPT = [2 + (i * 7) % 250 for i in range(23)]
PROMPT2 = [5, 9, 13, 17, 21, 25, 29]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("lanes")
    out = {}
    for name, arch in ARCHS.items():
        out[name] = str(d / f"{name}.m")
        make_tiny_model(out[name], arch=arch, cfg=None if name == "qwen3_moe" else CFG)
    return out


def _native(engine):
    """Pool-native lanes with private identity pages (page 0 is scratch)."""
    engine.init_kv_pool(4, native=True)
    nb = engine._kv_n_blocks
    for lane in range(engine.batch_size):
        engine.adopt_pages(lane, list(range(1 + lane * nb, 1 + (lane + 1) * nb)))
    return engine


def _lanes(e, prompts, steps, block, temperature=0.0, seeds=None):
    """Prefill each lane's prompt (None: idle), then decode them together
    in blocks of ``block``; returns each lane's tokens."""
    b = e.batch_size
    pos, tok, outs = [0] * b, [0] * b, [[] for _ in range(b)]
    for lane, p in enumerate(prompts):
        if p is not None:
            e.prefill_lane(lane, p)
            pos[lane], tok[lane] = len(p) - 1, p[-1]
    active = [p is not None for p in prompts]
    while any(len(outs[i]) < steps for i in range(b) if active[i]):
        n = min(block, steps - min(len(outs[i]) for i in range(b) if active[i]))
        rows = e.decode_lanes(tok, pos, n, active, [temperature] * b, [0.9] * b, seeds=seeds)
        for row in rows:
            for lane in range(b):
                if active[lane] and len(outs[lane]) < steps:
                    outs[lane].append(row[lane])
                    tok[lane], pos[lane] = row[lane], pos[lane] + 1
    return outs


def _engines(mp):
    jeng = _native(JEngine(mp, tp=1, dtype=jnp.float32, temperature=0.0, batch_size=2))
    eng = _native(InferenceEngine(mp, dtype=torch.float32, temperature=0.0, device="cpu",
                                  batch_size=2))
    return jeng, eng


@pytest.mark.parametrize("arch", list(ARCHS))
def test_native_greedy_lanes_match_jax(models, arch):
    jeng, eng = _engines(models[arch])
    want = _lanes(jeng, [None, PROMPT], 10, 4)
    assert _lanes(eng, [None, PROMPT], 10, 4) == want
    # side by side, ragged: each lane at its own position
    want = _lanes(jeng, [PROMPT2, PROMPT[:17]], 12, 5)
    got = _lanes(eng, [PROMPT2, PROMPT[:17]], 12, 5)
    assert got == want
    assert eng.lane_decode_steps > 0


def test_generate_batch_ragged_matches_jax(models):
    mp = models["llama"]
    prompts = [PROMPT[:9], PROMPT2]
    jeng = JEngine(mp, tp=1, dtype=jnp.float32, temperature=0.0, batch_size=2)
    want = jeng.generate_batch(prompts, max_steps=30, block_size=4)
    eng = InferenceEngine(mp, dtype=torch.float32, temperature=0.0, device="cpu", batch_size=2)
    eng.init_kv_pool(4, native=True)
    assert eng.generate_batch(prompts, max_steps=30, block_size=4) == want


def _stream(e, lane, prompt, steps, seed, temperature=0.8, block=4):
    """One lane's seeded stream decoded alone (the other lane parked)."""
    b = e.batch_size
    toks, t, p = [], prompt[-1], len(prompt) - 1
    active = [i == lane for i in range(b)]
    while len(toks) < steps:
        n = min(block, steps - len(toks))
        rows = e.decode_lanes([t if i == lane else 0 for i in range(b)],
                              [p if i == lane else 0 for i in range(b)], n, active,
                              [temperature] * b, [0.9] * b,
                              seeds=[seed if i == lane else None for i in range(b)])
        toks.extend(r[lane] for r in rows)
        t, p = toks[-1], p + n
    return toks


def test_manager_zero_copy_adopt_and_cow_fork(models):
    """test_kv_native's manager flow on the port: a full-page adopt copies
    no page, a mid-page adopt forks exactly one, and the adopted streams
    equal cold ones (seeded sampled, port against port)."""
    mp = models["llama"]
    ref = _native(InferenceEngine(mp, dtype=torch.float32, temperature=0.8, device="cpu",
                                  batch_size=2))
    ref.prefill_lane(1, PROMPT)
    expected = _stream(ref, 1, PROMPT, 10, seed=42)

    e = InferenceEngine(mp, dtype=torch.float32, temperature=0.8, device="cpu", batch_size=2)
    kv = PagedKVManager(e, page_size=4, native=True)
    assert kv.match(0, PROMPT) == (0, [])
    kv.adopt(0, [])  # allocates the lane's private pages
    e.prefill_lane(0, PROMPT)
    first = _stream(e, 0, PROMPT, 10, seed=42)
    assert first == expected
    assert kv.publish(0, (PROMPT + first)[:20]) == 5  # 5 full pages
    kv.release_lane(0)
    kv.check()

    # full-page adopt into the other lane: no page copied
    copies = e.kv_copy_pages
    m, pages = kv.match(1, PROMPT)
    assert m == 20
    kv.adopt(1, pages)
    assert e.kv_copy_pages == copies
    fills, cur = PROMPT[:-1], m
    while cur < len(fills):
        cur += e.prefill_lane_chunk(1, fills[cur:], cur, budget=8)
    got = _stream(e, 1, PROMPT, 10, seed=42)
    assert got == expected
    assert kv.publish(1, (PROMPT + got)[:24]) == 1  # one page over the 5 shared
    kv.release_lane(1)
    kv.check()

    # mid-page boundary: share 22 of the stored 24 tokens, then diverge
    p2 = PROMPT[:22] + [199, 198, 197]
    ref.prefill_lane(0, p2)
    exp2 = _stream(ref, 0, p2, 8, seed=9)
    m, pages = kv.match(0, p2)
    assert m == 22 and m % 4 != 0
    kv.adopt(0, pages)
    assert e.kv_copy_pages == copies + 1  # exactly the boundary page forked
    assert kv.pool.stats().cow_forks == 1
    fills, cur = p2[:-1], m
    while cur < len(fills):
        cur += e.prefill_lane_chunk(0, fills[cur:], cur, budget=8)
    assert _stream(e, 0, p2, 8, seed=9) == exp2
    kv.release_lane(0)
    kv.check()


def test_seeded_lane_repeats_across_blocks_and_neighbours(models):
    e = _native(InferenceEngine(models["llama"], dtype=torch.float32, temperature=0.8,
                                device="cpu", batch_size=2))
    alone = _lanes(e, [PROMPT, None], 12, 4, temperature=0.8, seeds=[5, None])[0]
    split = _lanes(e, [PROMPT, None], 12, 3, temperature=0.8, seeds=[5, None])[0]
    busy = _lanes(e, [PROMPT, PROMPT2], 12, 5, temperature=0.8, seeds=[5, 77])[0]
    assert alone == split == busy
    other = _lanes(e, [PROMPT, None], 12, 4, temperature=0.8, seeds=[6, None])[0]
    assert other != alone


@pytest.mark.parametrize("topp", [0.0, 0.3, 0.9, 0.999999, 1.0])
def test_topp_mask_support_matches_jax(topp):
    rng = np.random.default_rng(int(topp * 1000))
    logits = rng.normal(size=(3, 200)).astype(np.float32) * 3
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    tp = np.asarray([topp, 0.5, topp], np.float32)
    want = np.asarray(_topp_mask(jnp.asarray(probs), jnp.asarray(tp)))
    got = topp_mask(torch.from_numpy(probs), torch.from_numpy(tp)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_array_equal(got, want)


def test_init_kv_pool_slab_mode_is_refused(models):
    """Slab lanes park their writes in padding rows past seq_len, so the
    slab mode (the default) is refused at batch size 1, as the JAX
    engine's; pool-native lanes are not."""
    e = InferenceEngine(models["llama"], dtype=torch.float32, device="cpu", batch_size=1)
    with pytest.raises(ValueError, match="batch_size > 1"):
        e.init_kv_pool(4, native=False)
    with pytest.raises(ValueError, match="batch_size > 1"):
        e.init_kv_pool(4)
    assert e.init_kv_pool(4, native=True) > 0
