"""The port's MoE ops (dllama_tpu_torch/ops/moe.py) against the JAX package
on CPU, inputs made with numpy from a seed.

* ``moe_route`` vs ``transformer._moe_route``: the same top-k sets, weights
  matched by expert id within 1e-6.
* ``moe_experts_ref`` with bfloat16 x vs the four TPU kernels run in
  interpret mode: they round where the port rounds (x, W and the hidden in
  bf16, f32 sums), so they differ in sum order only; a changed order can
  flip one bf16 rounding of a hidden unit, hence a normalized error of
  2^-7.
* ``moe_experts_ref`` with float32 x vs ``_moe_ffn`` and ``_moe_ffn_gather``
  in f32 (nothing rounded on either side): normalized error 1e-5.
* The wrappers on CPU tensors are the plain version and refuse bad
  operands; the grouped schedule places every assignment exactly once, in
  runs of one expert whose real rows come first, with sizes from the
  shapes alone; the grouped kernels' arithmetic over it, emulated run by
  run in torch, equals the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.models import transformer as JT
from dllama_tpu.ops import moe_kernel as JM
from dllama_tpu.ops.jnp_ops import silu as j_silu
from dllama_tpu.ops.quant_matmul import QuantWeight as JQuantWeight
from dllama_tpu_torch.ops import moe as TM
from dllama_tpu_torch.ops.quant_matmul import QuantWeight

WRAPPERS = {
    "moe_active_experts": (TM.moe_active_experts, False),
    "moe_active_experts_q40": (TM.moe_active_experts_q40, True),
    "moe_grouped_experts": (TM.moe_grouped_experts, False),
    "moe_grouped_experts_q40": (TM.moe_grouped_experts_q40, True),
}


def _norm_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _experts(e, d, f, quant, seed):
    """The same experts in both layouts: (port w1, w2, w3), (JAX w1, w2, w3).
    Q40: int8 values + f16-exact scales; dense: bf16-exact f32 values."""
    rng = np.random.default_rng(seed)
    port, jax_ = [], []
    for rows, cols in ((f, d), (d, f), (f, d)):  # w1, w2, w3 in file rows
        if quant:
            q = rng.integers(-8, 8, (e, rows, cols), dtype=np.int8)
            s = ((rng.random((e, rows, cols // 32)) + 0.5) * 0.01).astype(np.float16)
            s[rng.random(s.shape) < 0.5] *= -1
            port.append(QuantWeight(torch.from_numpy(q), torch.from_numpy(s)))
            jax_.append(JQuantWeight(
                jnp.asarray(q.transpose(0, 2, 1)), jnp.asarray(s.astype(np.float32).transpose(0, 2, 1))
            ))
        else:
            w = (rng.standard_normal((e, rows, cols)) * 0.05).astype(np.float32)
            w = np.array(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))
            port.append(torch.from_numpy(w))
            jax_.append(jnp.asarray(w.transpose(0, 2, 1)))
    return port, jax_


def _routing(n, e, k, seed):
    rng = np.random.default_rng(seed)
    top_i = np.stack([rng.permutation(e)[:k] for _ in range(n)]).astype(np.int32)
    w = rng.random((n, k)).astype(np.float32) + 0.1
    return top_i, (w / w.sum(1, keepdims=True)).astype(np.float32)


def _port_dtype(ws, dtype):
    return [w if isinstance(w, QuantWeight) else w.to(dtype) for w in ws]


@pytest.mark.parametrize("n,e,k,seed", [(1, 8, 2, 0), (7, 16, 4, 1), (33, 128, 8, 2)])
def test_route_matches_jax(n, e, k, seed):
    rng = np.random.default_rng(seed)
    d = 64
    x = rng.standard_normal((n, d)).astype(np.float32)
    gate = (rng.standard_normal((e, d)) * 0.3).astype(np.float32)  # file layout [E, D]
    ti, w = TM.moe_route(torch.from_numpy(x), torch.from_numpy(gate), k)
    jti, jw = JT._moe_route(jnp.asarray(x), jnp.asarray(gate.T), k)
    assert ti.dtype == torch.int32 and w.dtype == torch.float32
    for t in range(n):
        got = dict(zip(ti[t].tolist(), w[t].tolist()))
        want = dict(zip(np.asarray(jti[t]).tolist(), np.asarray(jw[t]).tolist()))
        assert set(got) == set(want)
        for key in want:
            assert abs(got[key] - want[key]) <= 1e-6


ACTIVE_CASES = [(m, k) for m in (1, 5, 16) for k in (2, 4)]
GROUPED_CASES = [(n, k) for n in (40, 70) for k in (2, 4)]


@pytest.mark.parametrize(
    "name,n,k",
    [(nm, m, k) for nm in ("moe_active_experts", "moe_active_experts_q40") for m, k in ACTIVE_CASES]
    + [(nm, n, k) for nm in ("moe_grouped_experts", "moe_grouped_experts_q40")
       for n, k in GROUPED_CASES],
)
def test_ref_bf16_matches_tpu_kernel_interpret(name, n, k):
    _ref_bf16_vs_interpret(name, n, k, e=8, d=256, f=512)


# the active kernels' edges on the card, scaled down: m 1, 4 and 16, k 2
# and 8, D and F multiples of 32 but not of the 64-value block pair that a
# lane's fragment load takes
@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("name", ["moe_active_experts", "moe_active_experts_q40"])
def test_ref_bf16_matches_tpu_active_kernel_interpret_edges(name, m, k):
    _ref_bf16_vs_interpret(name, m, k, e=8, d=96, f=160)


def _ref_bf16_vs_interpret(name, n, k, e, d, f):
    """moe_experts_ref in bf16 against the TPU kernel ``name`` in interpret
    mode on the same experts and routing: 2^-7 (a flipped hidden rounding)."""
    quant = name.endswith("q40")
    (p1, p2, p3), (j1, j2, j3) = _experts(e, d, f, quant, seed=n * 10 + k)
    top_i, w = _routing(n, e, k, seed=n + k)
    x = np.random.default_rng(n).standard_normal((n, d)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    if quant:
        want = getattr(JM, name)(xj, j1.q, j1.d, j2.q, j2.d, j3.q, j3.d, jnp.asarray(top_i),
                                 jnp.asarray(w), interpret=True)
    else:
        want = getattr(JM, name)(xj, j1.astype(jnp.bfloat16), j2.astype(jnp.bfloat16),
                                 j3.astype(jnp.bfloat16), jnp.asarray(top_i), jnp.asarray(w),
                                 interpret=True)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    p1, p2, p3 = _port_dtype((p1, p2, p3), torch.bfloat16)
    got = TM.moe_experts_ref(xt, p1, p2, p3, torch.from_numpy(top_i), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (n, d)
    assert _norm_err(got.numpy(), want) <= 2.0**-7


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "q40"])
@pytest.mark.parametrize("jax_fn", ["_moe_ffn", "_moe_ffn_gather"])
def test_ref_f32_matches_jax_moe_ffn(jax_fn, quant):
    e, d, f, k, n = 8, 128, 96, 3, 12
    (p1, p2, p3), (j1, j2, j3) = _experts(e, d, f, quant, seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((n, d)).astype(np.float32)
    gate = (rng.standard_normal((e, d)) * 0.3).astype(np.float32)
    want = getattr(JT, jax_fn)(jnp.asarray(x)[None], jnp.asarray(gate.T), j1, j2, j3, k, j_silu)
    xt = torch.from_numpy(x)
    ti, w = TM.moe_route(xt, torch.from_numpy(gate), k)
    got = TM.moe_experts_ref(xt, p1, p2, p3, ti, w)
    assert _norm_err(got.numpy(), np.asarray(want)[0]) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_on_cpu_is_plain_version(name, dtype):
    fn, quant = WRAPPERS[name]
    e, d, f, k, n = 8, 64, 96, 2, 20
    ws = _port_dtype(_experts(e, d, f, quant, seed=7)[0], dtype)
    top_i, w = (torch.from_numpy(a) for a in _routing(n, e, k, seed=8))
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(0)).to(dtype)
    before = fn.launches
    got = fn(x, *ws, top_i, w)
    torch.testing.assert_close(got, TM.moe_experts_ref(x, *ws, top_i, w), rtol=0, atol=0)
    assert fn.launches == before


def _bad_args(case, x, ws, top_i, w, quant):
    w1, w2, w3 = ws
    if case == "x_f16":
        return x.half(), ws, top_i, w
    if case == "x_3d":
        return x[None], ws, top_i, w
    if case == "w2_shaped_like_w1":
        return x, [w1, w1, w3], top_i, w
    if case == "top_i_rows":
        return x, ws, top_i[:-1], w[:-1]
    if case == "top_i_float":
        return x, ws, top_i.float(), w
    if case == "dense_not_x_dtype":
        return x.to(torch.bfloat16), ws, top_i, w
    assert case == "other_weight_kind"  # dense tensors to Q40, Q40 to dense
    if quant:
        return x, [TM._expert(v, 0, torch.float32)[None] for v in ws], top_i, w
    return x, [QuantWeight(v.to(torch.int8), v.half()) for v in ws], top_i, w


BAD_CASES = ["x_f16", "x_3d", "w2_shaped_like_w1", "top_i_rows", "top_i_float",
             "dense_not_x_dtype", "other_weight_kind"]


@pytest.mark.parametrize(
    "name,case",
    [(nm, c) for nm in WRAPPERS for c in BAD_CASES
     if not (WRAPPERS[nm][1] and c == "dense_not_x_dtype")],
)
def test_wrapper_refuses_bad_operands(name, case):
    fn, quant = WRAPPERS[name]
    e, d, f, k, n = 4, 64, 96, 2, 3
    ws = _experts(e, d, f, quant, seed=9)[0]
    top_i, w = (torch.from_numpy(a) for a in _routing(n, e, k, seed=10))
    x, ws, top_i, w = _bad_args(case, torch.randn(n, d), ws, top_i, w, quant)
    with pytest.raises((TypeError, ValueError)):
        fn(x, *ws, top_i, w)


@pytest.mark.parametrize("d,f", [(48, 96), (64, 80)], ids=["D48", "F80"])
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_refuses_widths_off_32(name, d, f):
    fn, quant = WRAPPERS[name]
    e, k, n = 4, 2, 3
    if quant:
        ws = [QuantWeight(torch.zeros(e, r, c, dtype=torch.int8),
                          torch.ones(e, r, max(c // 32, 1), dtype=torch.float16))
              for r, c in ((f, d), (d, f), (f, d))]
    else:
        ws = [torch.zeros(e, r, c) for r, c in ((f, d), (d, f), (f, d))]
    top_i, w = (torch.from_numpy(a) for a in _routing(n, e, k, seed=11))
    with pytest.raises(ValueError):
        fn(torch.randn(n, d), *ws, top_i, w)


def _emulate_grouped(x, ws, sched, k):
    """What csrc/moe_grouped.cu computes over a schedule, in torch, run by
    run: the run's expert's SwiGLU on its real rows only (a prefix of the
    run), scaled by the row weight; padding rows are never written (NaN
    here, so that a combine that read one would show it); then the combine
    by the inverse permutation."""
    w1, w2, w3 = ws
    rows = TM.GROUP_ROWS
    tok = sched.row_token.long()
    out = torch.full((tok.shape[0], x.shape[1]), float("nan"))
    for g in range(int(sched.n_tiles[0])):
        e = int(sched.tile_expert[g])
        run = tok[g * rows:(g + 1) * rows]
        nv = int((run >= 0).sum())
        assert nv >= 1 and (run[:nv] >= 0).all(), "a run's real rows come first"
        r = slice(g * rows, g * rows + nv)
        xs = x.float()[run[:nv]]
        h1 = xs @ TM._expert(w1, e, x.dtype).t()
        h3 = xs @ TM._expert(w3, e, x.dtype).t()
        hidden = ((h1 / (1 + torch.exp(-h1))) * h3).to(x.dtype).float()
        out[r] = (hidden @ TM._expert(w2, e, x.dtype).t()) * sched.row_weight[r, None]
    n = x.shape[0]
    return out[sched.inv].view(n, k, -1).sum(1)


def _skewed(n, k):
    """Every token routed to experts 0 .. k - 1: one long segment each."""
    return np.tile(np.arange(k, dtype=np.int32), (n, 1))


# (n, E, k, skewed): E > A, A3B's uniform and skewed routing at N = 17 and
# 512 (several runs an expert when skewed), MOE_EDGE's E 16 k 10 at N = 17
# and 64
@pytest.mark.parametrize(
    "n,e,k,skew",
    [(1, 8, 2, False), (17, 128, 8, False), (40, 8, 4, False), (70, 8, 2, True),
     (512, 128, 8, False), (3, 16, 2, False), (512, 128, 8, True), (17, 16, 10, False),
     (64, 16, 10, False), (64, 16, 10, True)],
)
def test_grouped_schedule_places_every_assignment_once(n, e, k, skew):
    top_i, w = _routing(n, e, k, seed=n)
    if skew:
        top_i = _skewed(n, k)
    s = TM.grouped_schedule(torch.from_numpy(top_i), torch.from_numpy(w), e)
    a, r = n * k, TM.GROUP_ROWS
    max_tiles = -(-a // r) + min(e, a)
    assert s.tile_expert.shape == (max_tiles,) and s.row_token.shape == (max_tiles * r,)
    # the grid bound depends on the shapes alone: the other routing gives the same sizes
    other = _routing(n, e, k, seed=n + 1)[0] if skew else _skewed(n, k)
    s2 = TM.grouped_schedule(torch.from_numpy(other), torch.from_numpy(w), e)
    assert [t.shape for t in s2] == [t.shape for t in s]
    inv = s.inv.numpy()
    assert len(set(inv.tolist())) == a  # each assignment owns one row
    np.testing.assert_array_equal(s.row_token.numpy()[inv], np.arange(a) // k)
    np.testing.assert_array_equal(s.row_weight.numpy()[inv], w.reshape(-1))
    # each run holds one expert
    np.testing.assert_array_equal(s.tile_expert.numpy()[inv // r], top_i.reshape(-1))
    real = s.row_token.numpy() >= 0
    assert real.sum() == a and not s.row_weight.numpy()[~real].any()
    n_tiles = int(s.n_tiles[0])
    counts = np.bincount(top_i.reshape(-1), minlength=e)
    assert n_tiles == int((-(-counts // r)).sum()) <= max_tiles
    assert not real[n_tiles * r:].any()
    assert (s.tile_expert.numpy()[n_tiles:] == e).all()
    # a run's real rows come first, and only an expert's last run is short
    per_run = real[:n_tiles * r].reshape(n_tiles, r)
    nv = per_run.sum(1)
    assert (nv >= 1).all() and all(per_run[g, :nv[g]].all() for g in range(n_tiles))
    te = s.tile_expert.numpy()[:n_tiles]
    last = np.append(te[1:] != te[:-1], True)
    assert (nv[~last] == r).all()


def _emulation_vs_plain(dtype, quant, n, e, k, d, f, skew):
    ws = _port_dtype(_experts(e, d, f, quant, seed=12)[0], dtype)
    top_i, w = _routing(n, e, k, seed=13)
    if skew:
        top_i = _skewed(n, k)
    top_i, w = torch.from_numpy(top_i), torch.from_numpy(w)
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(1)).to(dtype)
    s = TM.grouped_schedule(top_i, w, e)
    got = _emulate_grouped(x, ws, s, k)
    want = TM.moe_experts_ref(x, *ws, top_i, w)
    assert torch.isfinite(got).all()
    assert _norm_err(got.numpy(), want.numpy()) <= 1e-6


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "q40"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_grouped_schedule_emulation_matches_plain(dtype, quant):
    _emulation_vs_plain(dtype, quant, n=45, e=8, k=4, d=64, f=96, skew=False)


# the runs past uniform routing: skewed (70 rows an expert, two runs each),
# E > A (one token); at widths of multiples of 64 and 32 (MOE_EDGE's
# ragged D and F, scaled down)
@pytest.mark.parametrize("d,f", [(64, 128), (96, 160)], ids=["D64F128", "D96F160"])
@pytest.mark.parametrize("n,skew", [(70, True), (1, False)], ids=["skewed", "E_gt_A"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "q40"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_grouped_emulation_runs_match_plain(dtype, quant, n, skew, d, f):
    _emulation_vs_plain(dtype, quant, n=n, e=8, k=2, d=d, f=f, skew=skew)
