"""Grouped-int8 matmul (weight_format q40i8): the CUDA kernel's wrapper and
its plain version.

Counterpart of dllama_tpu/ops/int8_matmul.py. A Q40 file is requantized
once at load to int8 values with one f32 scale per (column, group of G
inputs), G from `pick_group` (512 for llama-8b); activations are quantized
per (row, group) on the fly, and each group's int8 dot is exact in int32
and scaled by ``sx[m, g] * s[n, g]`` before the groups are summed in f32.
The port keeps the rows of the ``.m`` file (the TPU package stores
``[in, out]``):

    q int8 [..., out, in] in [-127, 127],  s f32 [..., out, in // G]
    W[o, i] = q[o, i] * s[o, i // G]

(1 + 4/G B per weight). The scales stay f32: f16 would round JAX's.

Activation quantization (`quantize_acts`) is torch ops outside the kernel,
as in JAX. The plain version computes each group's dot as an f32 product,
which is exact while G * 127^2 < 2^24 (G <= 1040), since CUDA has no int32
matmul; it sums the groups in order, as the kernel does, so the two give
the same bits. They must: activation quantization is discontinuous, so a
last-bit difference in one layer's output can flip a rounding in the next
layer's int8 activations, and such flips grow through the layers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _build
from .quant_matmul import QuantWeight, dequant

MAX_EXACT_GROUP = 1040  # G * 127^2 < 2^24: f32 group dots are exact
# 1/127 rounded to f32. JAX writes the scale as max|g| / 127.0, and XLA
# compiles that division by a constant into a product with this reciprocal;
# the product is what the JAX engine's programs compute, and it decides the
# round-half-even ties that Q40 values meet often (a ratio of 1/2 maps to
# 63.5), so the port computes the same product
_INV_127 = float(1.0 / torch.tensor(127.0, dtype=torch.float32))


class Int8Weight(NamedTuple):
    """Grouped-int8 tensor in the port's device layout (see module doc)."""

    q: torch.Tensor  # int8 [..., out, in]
    s: torch.Tensor  # f32 [..., out, in // G]

    @property
    def in_dim(self) -> int:
        return self.q.shape[-1]

    @property
    def out_dim(self) -> int:
        return self.q.shape[-2]

    @property
    def group(self) -> int:
        return self.q.shape[-1] // self.s.shape[-1]


def _quantize_groups(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last axis of g (f32): scale max|g| / 127
    (as the f32 product with 1/127, see `_INV_127`; 1 where the group is
    all zero), values round-half-even and clipped."""
    s = g.abs().amax(dim=-1) * _INV_127
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(g / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def requantize_q40(w: QuantWeight, group: int) -> Int8Weight:
    """Q40 -> grouped int8 on the weight's device, in f32 torch ops: the
    ints and scales of the JAX package's compiled requantization bit for
    bit. Stacked [..., out, in] works; the f32 scratch is a few times the
    tensor's own f32 size."""
    k = w.in_dim
    if k % group:
        raise ValueError(f"k={k} not divisible by group={group}")
    *lead, n, _ = w.q.shape
    g = dequant(w, torch.float32).reshape(*lead, n, k // group, group)
    q, s = _quantize_groups(g)
    return Int8Weight(q.reshape(*lead, n, k), s)


def quantize_acts(x: torch.Tensor, group: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(row, group) int8 activations: (xq int8 [..., k], sx f32
    [..., k // G]), the Q80 step with group-sized blocks."""
    *lead, k = x.shape
    if k % group:
        raise ValueError(f"k={k} not divisible by group={group}")
    xq, sx = _quantize_groups(x.float().reshape(*lead, k // group, group))
    return xq.reshape(*lead, k), sx


def i8matmul_2d_ref(xq: torch.Tensor, sx: torch.Tensor, w: Int8Weight) -> torch.Tensor:
    """Plain version of the kernel on quantized operands: xq int8 [m, k],
    sx f32 [m, k/G] and W -> f32 [m, n]. Each group's dot is an exact f32
    product, scaled by sx * s; the groups are summed in order."""
    k, group = xq.shape[1], w.group
    if group > MAX_EXACT_GROUP:
        raise ValueError(f"group {group} > {MAX_EXACT_GROUP}: f32 group dots would round")
    out = torch.zeros((xq.shape[0], w.out_dim), dtype=torch.float32, device=xq.device)
    for g in range(k // group):
        cols = slice(g * group, (g + 1) * group)
        idot = torch.matmul(xq[:, cols].float(), w.q[:, cols].float().t())
        out += idot * (sx[:, g, None] * w.s[None, :, g])
    return out


def i8matmul_ref(x: torch.Tensor, w: Int8Weight, act_quant=quantize_acts) -> torch.Tensor:
    """Plain version: x [..., in] -> [..., out] f32 (activations quantized
    per group by ``act_quant``, then `i8matmul_2d_ref`)."""
    *lead, k = x.shape
    xq, sx = act_quant(x.reshape(-1, k), w.group)
    return i8matmul_2d_ref(xq, sx, w).reshape(*lead, w.out_dim)


def i8matmul_2d(xq: torch.Tensor, sx: torch.Tensor, w: Int8Weight) -> torch.Tensor:
    """The kernel on quantized operands (xq int8 [m, k], sx f32 [m, k/G])
    -> f32 [m, n]: CPU tensors take `i8matmul_2d_ref`; CUDA tensors launch
    csrc/i8_matmul.cu (dp4a GEMV for up to 8 rows, a dp4a tiled product
    above) or raise. ``i8matmul_2d.launches`` counts kernel launches."""
    if xq.device.type == "cpu":
        return i8matmul_2d_ref(xq, sx, w)
    m, k = xq.shape
    n, group = w.out_dim, w.group
    if w.q.dim() != 2 or w.q.shape[1] != k or k % group or group % 32:
        raise ValueError(
            f"i8matmul: weight {tuple(w.q.shape)} / group {group} does not take xq {tuple(xq.shape)} "
            "(the kernel needs a group that is a multiple of 32)"
        )
    if w.q.dtype != torch.int8 or w.s.dtype != torch.float32 or w.s.shape != (n, k // group):
        raise TypeError("i8matmul: weight must be int8 values [out, in] + f32 scales [out, in/G]")
    if xq.dtype != torch.int8 or sx.dtype != torch.float32 or sx.shape != (m, k // group):
        raise TypeError("i8matmul: activations must be int8 [m, k] + f32 scales [m, k/G]")
    if not all(t.is_cuda and t.is_contiguous() for t in (xq, sx, w.q, w.s)):
        raise ValueError("i8matmul: CUDA operands must be contiguous on the card")
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    if m:
        code = _build.load("i8_matmul")(
            xq.data_ptr(), sx.data_ptr(), w.q.data_ptr(), w.s.data_ptr(), out.data_ptr(),
            m, n, k, group, _build.stream(xq.device),
        )
        _build.check(code, "i8_matmul")
        i8matmul_2d.launches += 1
    return out


def i8matmul(x: torch.Tensor, w: Int8Weight, act_quant=quantize_acts) -> torch.Tensor:
    """x [..., in] @ W^T -> [..., out] f32: activations quantized per group
    by ``act_quant`` (`quantize_acts`: torch ops), then `i8matmul_2d` (the
    kernel on the card, its plain version on the CPU)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"i8matmul takes float32 or bfloat16 activations, got {x.dtype}")
    *lead, k = x.shape
    xq, sx = act_quant(x.reshape(-1, k), w.group)
    return i8matmul_2d(xq, sx, w).reshape(*lead, w.out_dim)


i8matmul_2d.launches = 0


def pick_group(h) -> int:
    """Largest group <= 512 dividing every contraction dim (dim, q_dim and
    ff_dim)."""
    dims = [h.dim, h.q_dim, h.ff_dim]
    g = math.gcd(*dims)
    group = min(512, g)
    while group > 1 and any(d % group for d in dims):
        group //= 2
    if group < 32:
        raise ValueError(f"no viable int8 group for dims {dims} (gcd {g}); use weight_format='q40'")
    return group


def requantize_params(params: dict, h, group: int) -> dict:
    """A q40 params dict with every attention, FFN and classifier
    QuantWeight requantized to an Int8Weight, one tensor at a time. MoE
    expert tensors stay Q40 for the MoE kernels."""
    moe = bool(getattr(h, "n_experts", 0))

    def conv(v, name: str):
        if isinstance(v, QuantWeight) and not (moe and name in ("w1", "w2", "w3")):
            return requantize_q40(v, group)
        return v

    out = dict(params)
    out["layers"] = [{key: conv(v, key) for key, v in lp.items()} for lp in params["layers"]]
    out["wcls"] = conv(params["wcls"], "wcls")
    return out
