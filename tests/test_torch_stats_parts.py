"""The arithmetic of the prefill stats kernel's one tensor-core body
(dllama_tpu_torch/csrc/flash_attention.cu) for every pair of q's and the
cache's types, on CPU, where the kernel cannot run: the spec of its bf16
parts.

* Each value enters the tensor cores as a sum of bf16 parts, part p the
  bf16 rounding of what parts 0 .. p - 1 left: bf16 and int8 one part, f16
  two, f32 three. The parts sum back to the input exactly, on random and
  adversarial inputs.
* The passes a key tile issues (QK^T over the part pairs i + j <= 2; PV over
  P's hi and lo parts and V's first two parts with i + j <= 1) are the ones
  the source's table states, pair by pair.
* A torch emulation of exactly those partial products (bf16-exact operands,
  f32 sums), the online softmax over 64-key tiles with the kernel's guards,
  int8 K's row scale on the score column and V's on P's column before the
  hi/lo split, lies within `TOL` of the port's plain version
  (`flash_attention_stats_ref`) and of the JAX package's kernel in
  interpret mode, at hd 64 and 128 and G 1 and 4, with a parked lane.

Inputs are made from a seed with numpy. The adversarial ones: q rows scaled
by 2^12 or 2^-12 and V rows by 2^12 or 2^-12, K scaled by 2^-12 (and some
rows by 2^-24) so that no score leaves the range a softmax meets in use; f32
values at bf16 rounding ties; f16 values near 65504 and subnormal (V); int8
values at +-127 with K's scales at 2^-20 .. 2^-18 and V's large, 2^8 .. 2^12.

Tolerance: `TOL` = 1e-4, normalized (max|a - b| / max|b|): the emulation
differs from an f32 evaluation by sum order and by the terms it leaves out,
each at most 2^-18 (4e-6) of a product (the source's table), far inside it.
"""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import flash_attention as JF
from dllama_tpu.ops import kv_cache as JKV
from dllama_tpu_torch.ops import flash_attention as TF
from dllama_tpu_torch.ops.kv_cache import QuantKV

TOL = 1e-4
TILE = 64  # keys a tile of the body (TC_BN)
NEG_INF = -1e30
N_PARTS = {"bf16": 1, "int8": 1, "f16": 2, "f32": 3}
PAIRS = [(q, c) for q in ("bf16", "f32") for c in ("bf16", "int8", "f16", "f32")]
T_TYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
J_TYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
SOURCE = os.path.join(os.path.dirname(TF.__file__), os.pardir, "csrc", "flash_attention.cu")
B, T, KH, S = 3, 16, 2, 96  # 96 keys: a whole tile and a partial one
Q_POS0 = [S - T, 5, -T]  # the full frontier, a partial one, a parked lane


def parts(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """The first n bf16 parts of x, as f32: each the bf16 rounding of what
    the parts before left (every subtraction exact in f32)."""
    out, rest = [], x.float()
    for _ in range(n):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return out


def qk_pairs(qn: str, kn: str) -> list[tuple[int, int]]:
    """The (q part, K part) products of S = Q K^T."""
    return [(i, j) for i in range(N_PARTS[qn]) for j in range(N_PARTS[kn]) if i + j <= 2]


def pv_pairs(kn: str) -> list[tuple[int, int]]:
    """The (P part, V part) products of O += P V: P is hi + lo, V takes at
    most its first two parts, i + j <= 1."""
    return [(0, 0), (1, 0)] + ([(0, 1)] if N_PARTS[kn] > 1 else [])


def emulate(q, k, v, q_pos0, qn: str, kn: str):
    """The body's partial products and online softmax: q [B, T, H, hd] in
    q's type, k/v [B, KH, S, hd] in the cache's type or QuantKV -> f32 acc
    [B, KH, G, T, hd], m and l [B, KH, G, T]."""
    b, t, h, hd = q.shape
    quant = isinstance(k, QuantKV)
    kvals, vvals = (k.q.float(), v.q.float()) if quant else (k.float(), v.float())
    kh, s = kvals.shape[1], kvals.shape[2]
    g = h // kh
    qp = [x.view(b, t, kh, g, hd).permute(0, 2, 3, 1, 4) for x in parts(q, N_PARTS[qn])]
    kp = [x[:, :, None] for x in parts(kvals, N_PARTS[kn])]
    vp = [x[:, :, None] for x in parts(vvals, min(N_PARTS[kn], 2))]
    pos = torch.as_tensor(q_pos0)[:, None] + torch.arange(t)  # [B, T]
    acc = torch.zeros((b, kh, g, t, hd))
    m = torch.full((b, kh, g, t), NEG_INF)
    l = torch.zeros((b, kh, g, t))
    for s0 in range(0, s, TILE):
        keys = torch.arange(s0, min(s0 + TILE, s))
        sl = slice(s0, s0 + len(keys))
        sc = sum(qp[i] @ kp[j][..., sl, :].transpose(-1, -2) for i, j in qk_pairs(qn, kn))
        if quant:  # K's row scale on its score column
            sc = sc * k.s[:, :, None, None, sl, 0]
        vis = (keys[None, None, :] <= pos[:, :, None])[:, None, None]  # [B, 1, 1, T, n]
        sc = torch.where(vis, sc / math.sqrt(hd), torch.tensor(NEG_INF))
        m_new = torch.maximum(m, sc.max(-1).values)
        alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_new))
        p = torch.where(m_new[..., None] <= NEG_INF / 2, 0.0, torch.exp(sc - m_new[..., None]))
        l = alpha * l + p.sum(-1)
        if quant:  # V's row scale on P's column, after l took the unscaled sum
            p = p * v.s[:, :, None, None, sl, 0]
        hi = p.to(torch.bfloat16).float()
        pp = [hi, (p - hi).to(torch.bfloat16).float()]
        acc = acc * alpha[..., None] + sum(pp[i] @ vp[j][..., sl, :] for i, j in pv_pairs(kn))
        m = m_new
    return acc, m, l


# -- inputs ---------------------------------------------------------------


def _floats(rng, shape, role: str, kind: str, name: str) -> np.ndarray:
    """Normal values; adversarial: the row scales, ties and f16 extremes of
    the module docstring, for q, k or v (``role``) in type ``name``."""
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "random":
        return x
    r = rng.integers(0, 8, size=shape[:-1])[..., None]
    if role == "k":
        x *= np.where(r == 0, 2.0**-24, 2.0**-12).astype(np.float32)
    else:
        x *= np.where(r == 0, 2.0**12, np.where(r == 1, 2.0**-12, 1.0)).astype(np.float32)
    if name == "f32":  # a quarter of the values halfway between two bf16 values
        b = torch.from_numpy(x).bfloat16().float().numpy()
        ulp = np.exp2(np.floor(np.log2(np.abs(b) + 1e-38)) - 7).astype(np.float32)
        x = np.where(rng.random(shape) < 0.25, b + ulp / 2, x).astype(np.float32)
    if name == "f16" and role == "v":
        pick = rng.random(shape)
        big = (65504.0 - 32.0 * rng.integers(0, 4, size=shape)) * rng.choice([-1.0, 1.0], shape)
        tiny = rng.integers(1, 1024, size=shape) * 2.0**-24 * rng.choice([-1.0, 1.0], shape)
        x = np.where(pick < 1 / 32, big, np.where(pick < 1 / 16, tiny, x)).astype(np.float32)
    return x


def _int8(rng, shape, role: str, kind: str):
    """An int8 leaf (values, f32 [..., S, 1] scales) as numpy: random rows
    quantized as the engine writes them; adversarial: a quarter of the
    values at +-127, K's scales small and V's large."""
    if kind == "random":
        x = rng.standard_normal(shape).astype(np.float32)
        sc = np.abs(x).max(-1, keepdims=True) / 127.0
        return np.clip(np.round(x / sc), -127, 127).astype(np.int8), sc.astype(np.float32)
    vals = rng.integers(-127, 128, size=shape)
    vals = np.where(rng.random(shape) < 0.25, 127 * rng.choice([-1, 1], shape), vals)
    lo, hi = (-20, -18) if role == "k" else (8, 12)
    sc = np.exp2(rng.uniform(lo, hi, size=shape[:-1] + (1,)))
    return vals.astype(np.int8), sc.astype(np.float32)


def _case(qn: str, kn: str, hd: int, g: int, kind: str, seed: int):
    """The same inputs for the port (torch) and JAX: q, k, v of each."""
    rng = np.random.default_rng(seed)
    h = KH * g
    q = torch.from_numpy(_floats(rng, (B, T, h, hd), "q", kind, qn)).to(T_TYPES[qn])
    qj = jnp.asarray(q.float().numpy()).astype(J_TYPES[qn])
    tk, jk = [], []
    for role in ("k", "v"):
        if kn == "int8":
            vals, sc = _int8(rng, (B, KH, S, hd), role, kind)
            tk.append(QuantKV(torch.from_numpy(vals), torch.from_numpy(sc)))
            jk.append(JKV.QuantKV(jnp.asarray(vals), jnp.asarray(sc)))
        else:
            x = torch.from_numpy(_floats(rng, (B, KH, S, hd), role, kind, kn)).to(T_TYPES[kn])
            tk.append(x)
            jk.append(jnp.asarray(x.float().numpy()).astype(J_TYPES[kn]))
    return (q, *tk), (qj, *jk)


def _err(a, b) -> float:
    a, b = (torch.from_numpy(np.array(x, dtype=np.float32)) for x in (a, b))
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _close(got, want, what: str) -> None:
    """acc and l within TOL normalized; m within TOL over the rows that see a
    key and -1e30 on the rows that see none."""
    acc, m, l = (np.asarray(x, dtype=np.float32) for x in got)
    w_acc, w_m, w_l = (np.asarray(x, dtype=np.float32) for x in want)
    live = w_m > NEG_INF / 2
    for name, a, w in (("acc", acc, w_acc), ("l", l, w_l), ("m", m[live], w_m[live])):
        e = _err(a, w)
        assert e <= TOL, f"{what}: {name} error {e:.3e} > {TOL}"
    assert np.array_equal(m[~live], w_m[~live]) and not l[~live].any() and not acc[~live].any()


# -- the tests -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "adversarial"])
@pytest.mark.parametrize("name", ["bf16", "int8", "f16", "f32"])
def test_parts_sum_back_exactly(name, kind):
    rng = np.random.default_rng(17)
    shape = (4, 64, 128)
    if name == "int8":
        vals = [torch.from_numpy(_int8(rng, shape, r, kind)[0]) for r in ("k", "v")]
    else:
        vals = [torch.from_numpy(_floats(rng, shape, r, kind, name)).to(T_TYPES[name])
                for r in ("q", "k", "v")]
    for x in vals:
        ps = parts(x, N_PARTS[name])
        assert all(torch.equal(p, p.to(torch.bfloat16).float()) for p in ps)  # each a bf16 value
        total = sum(p.double() for p in ps)
        assert torch.equal(total, x.double()), f"{name} {kind}: the parts do not sum back"
        if N_PARTS[name] > 1:  # nothing is left for a further part
            assert torch.equal((x.float() - sum(ps)).to(torch.bfloat16).float(),
                               torch.zeros_like(ps[0]))


@pytest.mark.parametrize("qn,kn", PAIRS)
def test_passes_are_the_source_table(qn, kn):
    with open(SOURCE) as f:
        text = f.read()
    table = {(a, b): (int(x), int(y)) for a, b, x, y in
             re.findall(r"//   \| (\w+)/(\w+) +\| (\d+) \| (\d+) \|", text)}
    assert len(table) == len(PAIRS)
    assert table[(qn, kn)] == (len(qk_pairs(qn, kn)), len(pv_pairs(kn)))


@pytest.mark.parametrize("kind", ["random", "adversarial"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("qn,kn", PAIRS)
def test_emulated_parts_match_plain_and_jax(qn, kn, hd, g, kind):
    seed = 1000 * PAIRS.index((qn, kn)) + 10 * hd + g + (5 if kind == "adversarial" else 0)
    (q, k, v), (qj, kj, vj) = _case(qn, kn, hd, g, kind, seed)
    got = emulate(q, k, v, Q_POS0, qn, kn)
    plain = TF.flash_attention_stats_ref(q, k, v, Q_POS0)
    _close(got, plain, f"{qn}/{kn} hd {hd} G {g} {kind} against the plain version")
    want = JF.flash_attention_stats(qj, kj, vj, jnp.asarray(Q_POS0, jnp.int32), jnp.int32(0),
                                    block_t=T, block_s=S, interpret=True)
    _close(got, want, f"{qn}/{kn} hd {hd} G {g} {kind} against the JAX kernel")
