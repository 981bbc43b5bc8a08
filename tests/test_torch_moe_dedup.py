"""The port's Qwen3-MoE two-tier decode (``moe_decode_dedup``,
``--moe-decode-dedup``; ops/moe.py `moe_decode_tiers`) on CPU against the
JAX package's (``_moe_ffn_pallas`` with ``dedup``, the TPU kernels in
interpret mode):

* the two regimes: lanes that share most experts take the grouped tier,
  lanes spread wide the active one, each shown by the device tally
  (`tier_tally`), and both match the single-tier output;
* the capped schedule: one run per shared expert, the grid bound
  ceil(A / R) + min(E, A, cap), rows past the cap clamped into the grid;
* the engine: dedup-on lane streams equal the JAX engine's default ones
  (f32, Q40 experts, 4 lanes), the ``"auto"`` resolution, the CLI flag,
  graphs replayed.

Tolerances: the port's tiers against its plain version exactly (on the
CPU both tiers are `moe_experts_ref`); against the JAX kernels at the JAX
test's 2e-2 (its grouped kernel rounds x to bf16 even for f32 inputs);
greedy streams equal.
"""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu import cli as jcli
from dllama_tpu.formats import FloatType
from dllama_tpu.formats.model_file import LlmArch
from dllama_tpu.models.transformer import _moe_ffn_pallas, _moe_route
from dllama_tpu.runtime.engine import InferenceEngine as JEngine
from dllama_tpu_torch import cli
from dllama_tpu_torch.ops import moe as TM
from dllama_tpu_torch.runtime.engine import InferenceEngine

from helpers import make_tiny_model, make_tiny_tokenizer
from test_torch_graphs import ReplayingGraphs

E, D, F, K = 64, 64, 128, 3
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 4]]


def _moe(seed):
    """Experts and gate in both layouts: port (w1 [E, F, D], w2 [E, D, F],
    w3, gate [E, D]) and JAX (w1 [E, D, F], w2 [E, F, D], w3, gate [D, E])."""
    rng = np.random.default_rng(seed)
    w1 = (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((E, F, D)) * 0.1).astype(np.float32)
    w3 = (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32)
    gate = rng.standard_normal((D, E)).astype(np.float32)
    port = [torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1))) for w in (w1, w2, w3)]
    return port, torch.from_numpy(np.ascontiguousarray(gate.T)), [
        jnp.asarray(w) for w in (w1, w2, w3)], jnp.asarray(gate)


def _tally_delta(fn):
    t = TM.tier_tally("cpu")
    before = t.clone()
    out = fn()
    return out, (t - before).tolist()


def test_moe_two_tier_dedup_matches_ragged():
    """With lanes sharing most experts the grouped tier takes the step, with
    distinct experts the active one; the tally shows each regime on its
    tier, and both match the single-tier output and the JAX two-tier one."""
    ports, gate, jws, jgate = _moe(31)
    m = 8
    cap = TM.dedup_cap(m, K, True)
    assert cap == (m * K) // 2 and TM.dedup_cap(1, K, True) == 0 and TM.dedup_cap(m, K, False) == 0
    rng = np.random.default_rng(31)
    x_shared = (np.repeat(rng.standard_normal((1, 1, D)), m, axis=0)
                + rng.standard_normal((m, 1, D)) * 1e-3).astype(np.float32)
    x_div = rng.standard_normal((m, 1, D)).astype(np.float32)
    for x, grouped in ((x_shared, True), (x_div, False)):
        xt = torch.from_numpy(x.reshape(m, D))
        top_i, w = TM.moe_route(xt, gate, K)
        jti, _ = _moe_route(jnp.asarray(x.reshape(m, D)), jgate, K)
        assert np.array_equal(top_i.numpy(), np.asarray(jti))
        u = len(np.unique(top_i.numpy()))
        assert (u <= cap) == grouped, (u, cap)
        got, (took, steps) = _tally_delta(lambda: TM.moe_decode_tiers(xt, *ports, top_i, w, cap))
        assert (took, steps) == (int(grouped), 1)
        torch.testing.assert_close(got, TM.moe_experts_ref(xt, *ports, top_i, w), rtol=0, atol=0)
        base = _moe_ffn_pallas(jnp.asarray(x), jgate, *jws, K, mesh=None, interpret=True)
        two = _moe_ffn_pallas(jnp.asarray(x), jgate, *jws, K, mesh=None, interpret=True,
                              dedup=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(two).reshape(m, D), rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(got.numpy(), np.asarray(base).reshape(m, D), rtol=2e-2,
                                   atol=2e-2)


def test_moe_grouped_schedule_dedups_shared_experts():
    """The schedule collapses shared experts to one run each, bounds its
    grid by ceil(A / R) + min(E, A) (+ the cap when capped), and keeps a
    capped schedule's rows inside its grid when the experts do not fit."""
    e, m, k = 128, 8, 4
    top_i = torch.tensor([[3, 7, 11, 90]], dtype=torch.int32).repeat(m, 1)
    wts = torch.full((m, k), 0.25)
    a = m * k
    s = TM.grouped_schedule(top_i, wts, e)
    assert s.tile_expert.shape[0] == -(-a // TM.GROUP_ROWS) + min(e, a)
    assert int(s.n_tiles) == 4 and int(s.n_used) == 4  # one run a unique expert
    assert sorted(s.tile_expert[:4].tolist()) == [3, 7, 11, 90]
    capped = TM.grouped_schedule(top_i, wts, e, max_segments=a // 2)
    assert capped.tile_expert.shape[0] == -(-a // TM.GROUP_ROWS) + a // 2
    assert torch.equal(capped.row_token[: 4 * TM.GROUP_ROWS], s.row_token[: 4 * TM.GROUP_ROWS])
    # 32 distinct experts past a cap of 16: every row clamped into the 17-run grid
    distinct = torch.arange(a, dtype=torch.int32).view(m, k) * 3
    over = TM.grouped_schedule(distinct, wts, e, max_segments=a // 2)
    assert int(over.n_used) == a > a // 2
    assert int(over.inv.max()) < over.row_token.shape[0] == 17 * TM.GROUP_ROWS


def test_moe_ffn_two_tier_only_at_decode_sizes():
    """The model's FFN takes the tiers at 2..16 rows with dedup on, never at
    one row, past 16 rows or with dedup off."""
    from dllama_tpu_torch.formats.model_file import LlmHeader
    from dllama_tpu_torch.models.transformer import moe_ffn

    ports, gate, _, _ = _moe(5)
    h = LlmHeader.__new__(LlmHeader)
    h.n_active_experts = K
    lp = {"moe_gate": gate, "w1": ports[0], "w2": ports[1], "w3": ports[2]}
    rng = np.random.default_rng(5)
    for n, dedup, steps in ((1, True, 0), (8, True, 1), (17, True, 0), (8, False, 0)):
        y = torch.from_numpy(rng.standard_normal((n, 1, D)).astype(np.float32))
        _, (_, got) = _tally_delta(lambda: moe_ffn(y, lp, h, False, dedup))
        assert got == steps, (n, dedup)


@pytest.fixture(scope="module")
def moe_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_dedup")
    mp, tp_ = str(d / "moe.m"), str(d / "t.t")
    make_tiny_model(mp, arch=LlmArch.QWEN3_MOE, weight_type=FloatType.Q40, seed=7)
    make_tiny_tokenizer(tp_)
    return mp, tp_


def test_engine_moe_decode_dedup_parity(moe_file):
    """moe_decode_dedup=True through the engine (Q40 experts, 4 concurrent
    lanes): lane streams equal the JAX engine's default ones and the
    port's dedup-off ones, and the decode steps ran two-tier."""
    mp, _ = moe_file
    base = JEngine(mp, tp=1, dtype=jnp.float32, temperature=0.0, batch_size=4)
    expected = base.generate_batch(PROMPTS, max_steps=10)
    off = InferenceEngine(mp, dtype=torch.float32, temperature=0.0, device="cpu", batch_size=4,
                          moe_decode_dedup=False)
    assert off.generate_batch(PROMPTS, max_steps=10) == expected
    on = InferenceEngine(mp, dtype=torch.float32, temperature=0.0, device="cpu", batch_size=4,
                         moe_decode_dedup=True)
    assert on.moe_decode_dedup is True
    got, (_, steps) = _tally_delta(lambda: on.generate_batch(PROMPTS, max_steps=10))
    assert got == expected and steps > 0


def test_moe_decode_dedup_auto_resolution(moe_file, tmp_path):
    """'auto' (the default) is on iff the model has experts and >= 8 lanes,
    as the JAX engine resolves it."""
    mp, _ = moe_file
    dense = str(tmp_path / "dense.m")
    make_tiny_model(dense)
    for path, lanes in ((mp, 8), (mp, 4), (dense, 8)):
        e = InferenceEngine(path, dtype=torch.float32, device="cpu", batch_size=lanes)
        je = JEngine(path, tp=1, dtype=jnp.float32, batch_size=lanes)
        assert e.moe_decode_dedup is je.moe_decode_dedup is (path == mp and lanes == 8)


def test_cli_moe_decode_dedup_flag(moe_file):
    mp, tp_ = moe_file
    for argv, want in (([], "auto"), (["--moe-decode-dedup"], "on"),
                       (["--moe-decode-dedup", "off"], "off"),
                       (["--moe-decode-dedup", "on"], "on")):
        args = cli._build_parser().parse_args(["inference", "--model", mp, "--tokenizer", tp_,
                                               "--device", "cpu", "--batch-size", "2"] + argv)
        p = argparse.ArgumentParser()
        jcli.add_engine_args(p)
        assert args.moe_decode_dedup == p.parse_args(argv).moe_decode_dedup == want
        eng, _ = cli.load_engine(args)
        assert eng.moe_decode_dedup is (want == "on")


def test_replayed_dedup_lanes_equal_eager(moe_file):
    """The two-tier decode captured as a graph: the tier is a device
    predicate, so a replayed lane block gives the eager streams."""
    mp, _ = moe_file
    eager, graphed = (InferenceEngine(mp, dtype=torch.float32, temperature=0.0, device="cpu",
                                      batch_size=4, moe_decode_dedup=True) for _ in range(2))
    graphed.graphs = ReplayingGraphs()
    want = eager.generate_batch(PROMPTS, max_steps=12, block_size=4)
    assert graphed.generate_batch(PROMPTS, max_steps=12, block_size=4) == want
    assert graphed.graphs.replays > 0
