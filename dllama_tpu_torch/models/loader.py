"""Load `.m` weights into the port's params (one device, no mesh).

Counterpart of dllama_tpu/models/loader.py ``load_params``. Tensors are
read one at a time off the file's memmap (reference: loadLlmNetWeight,
src/llm.cpp:614-669). For ``weight_format="q40"`` the packed Q40 bytes go
to the device as they are and are unpacked there with torch ops
(`q40_unpack`), so the host never expands the ~7.5 G weights of an 8B
model; the unpack is held against the numpy ``q40_to_planar``. For
``weight_format="q40i4"`` the bytes are split on the device into the
packed-nibble values and the scales (`q40_split`): the file's blocks are
already that layout, so nothing is unpacked. Like the JAX loader, the file
is consumed as-is (the converter pre-permutes llama q/k rows for
interleaved RoPE). ``q40i8`` is q40 requantized afterwards
(ops/int8_matmul.requantize_params, called by the engine).

Qwen3-MoE experts are stacked per layer (``w1``/``w3`` [E, F, D], ``w2``
[E, D, F]; 18,432 tensors at Qwen3-30B-A3B). One layer's experts are
contiguous in the file, so a Q40 file sends them to the device in one
copy per layer and unpacks them there. Under q40i4 they stay in this int8
``QuantWeight`` layout, the one the MoE kernels take (as in JAX).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..formats.model_file import LlmArch, ModelReader
from ..formats.quants import Q40_BLOCK_BYTES, Q40_BLOCK_SIZE, FloatType
from ..ops.quant_matmul import PackedQuantWeight, QuantWeight, dequant
from ..ops.torch_ops import rope_cache
from .transformer import Params

_MATMULS = {"wq": "q", "wk": "k", "wv": "v", "wo": "wo", "w1": "w1", "w2": "w2", "w3": "w3"}


def q40_unpack(raw: torch.Tensor, out_dim: int, in_dim: int) -> QuantWeight:
    """Packed Q40 bytes (uint8, any device) of an [out, in] tensor ->
    QuantWeight(q int8 [out, in] in [-8, 7], d f16 [out, in/32]), on the
    bytes' device. Block layout: f16 scale, then 16 bytes whose low nibble
    is element j and high nibble element j + 16 (formats/quants.py)."""
    blocks = raw.reshape(-1, Q40_BLOCK_BYTES)
    d = blocks[:, :2].contiguous().view(torch.float16).reshape(out_dim, in_dim // Q40_BLOCK_SIZE)
    packed = blocks[:, 2:]
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    q = torch.cat([lo, hi], dim=1).reshape(out_dim, in_dim)
    return QuantWeight(q.contiguous(), d.contiguous())


def q40_split(raw: torch.Tensor, out_dim: int, in_dim: int) -> PackedQuantWeight:
    """Packed Q40 bytes (uint8, any device) of an [out, in] tensor ->
    PackedQuantWeight(qp uint8 [out, in/2], d f16 [out, in/32]) on the bytes'
    device: each 18-byte block split into its f16 scale and its 16 nibble
    bytes, which stay as they are."""
    blocks = raw.reshape(-1, Q40_BLOCK_BYTES)
    d = blocks[:, :2].contiguous().view(torch.float16).reshape(out_dim, in_dim // Q40_BLOCK_SIZE)
    qp = blocks[:, 2:].reshape(out_dim, in_dim // 2)
    return PackedQuantWeight(qp.contiguous(), d.contiguous())


def load_params(
    reader: ModelReader,
    dtype=torch.float32,
    device=None,
    weight_format: str = "dense",
) -> Params:
    """Params for `models.transformer.forward`. ``dtype`` is the activation
    dtype (embedding and dense weights); norm weights and the rope tables
    stay f32. ``weight_format="q40"`` keeps matmul weights Q40 on the device
    (needs a Q40 file), ``"q40i4"`` keeps the non-expert ones as packed
    nibbles (experts stay ``"q40"``); ``"dense"`` dequantizes them to
    ``dtype``. The device defaults to ``cuda``."""
    device = resolve_device(device)
    h = reader.header
    if weight_format not in ("dense", "q40", "q40i4"):
        raise ValueError(f"weight_format must be 'dense', 'q40' or 'q40i4', got {weight_format!r}")
    quant = weight_format != "dense"
    if quant and h.weight_type != FloatType.Q40:
        raise ValueError(
            f"weight_format={weight_format!r} needs a Q40 model file, got {h.weight_type.name}"
        )

    def f32(name: str) -> torch.Tensor:
        return torch.from_numpy(reader.dense_f32(name)).to(device)

    def matmul_weight(name: str):
        if quant:
            out_dim, in_dim = reader.by_name[name].shape
            raw = torch.from_numpy(np.array(reader.raw(name))).to(device)
            split = q40_split if weight_format == "q40i4" else q40_unpack
            return split(raw, out_dim, in_dim)
        return f32(name).to(dtype)  # [out, in]

    def experts(l: int) -> dict:
        """Layer l's experts stacked [E, rows, cols] (w1/w3 [E, F, D], w2
        [E, D, F]): Q40 bytes go to the device in one copy and unpack there."""
        e_n, f, d = h.n_experts, h.ff_dim, h.dim
        shapes = {"w1": (f, d), "w2": (d, f), "w3": (f, d)}
        if h.weight_type != FloatType.Q40:
            return {
                w: torch.from_numpy(
                    np.stack([reader.dense_f32(f"layers.{l}.experts.{e}.{w}") for e in range(e_n)])
                ).to(device=device, dtype=dtype)
                for w in shapes
            }
        span = reader.raw_span(f"layers.{l}.experts.0.w1", f"layers.{l}.experts.{e_n - 1}.w3")
        raw = torch.from_numpy(np.array(span))
        raw = raw.to(device).reshape(e_n, 3, -1)  # w1, w2, w3 bytes of each expert
        out = {}
        for i, (w, (rows, cols)) in enumerate(shapes.items()):
            u = q40_unpack(raw[:, i], e_n * rows, cols)
            qw = QuantWeight(u.q.view(e_n, rows, cols), u.d.view(e_n, rows, cols // Q40_BLOCK_SIZE))
            out[w] = qw if quant else dequant(qw, dtype)
        return out

    moe = h.arch == LlmArch.QWEN3_MOE
    layers = []
    for l in range(h.n_layers):
        parts = {k: v for k, v in _MATMULS.items() if not (moe and k in ("w1", "w2", "w3"))}
        lp = {key: matmul_weight(f"layers.{l}.{part}") for key, part in parts.items()}
        if moe:
            lp["moe_gate"] = f32(f"layers.{l}.moe_gate")  # [E, D]
            lp.update(experts(l))
        lp["att_norm"] = f32(f"layers.{l}.att_norm")
        lp["ffn_norm"] = f32(f"layers.{l}.ffn_norm")
        if h.arch in (LlmArch.QWEN3, LlmArch.QWEN3_MOE):
            lp["q_norm"] = f32(f"layers.{l}.q_norm")
            lp["k_norm"] = f32(f"layers.{l}.k_norm")
        layers.append(lp)
    cos, sin = rope_cache(h, device=device)
    return {
        "embed": f32("embed").to(dtype),
        "wcls": matmul_weight("wcls"),
        "final_norm": f32("final_norm"),
        "rope_cos": cos,
        "rope_sin": sin,
        "layers": layers,
    }
