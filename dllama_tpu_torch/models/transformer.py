"""Decoder forward pass for Llama / Qwen3 / Qwen3-MoE in PyTorch.

Counterpart of dllama_tpu/models/transformer.py for one device. The layer
walk is the same (reference: src/llm.cpp:263-557):

    x += wo(attn(rope(q), rope(k), v))  over rms_norm(x), [qk-norm for Qwen3]
    x += w2(act(w1(y)) * w3(y))          over y = rms_norm(x)
    logits = rms_norm(x) @ wcls

with a Python loop over layers in place of ``lax.scan``. Params are a dict:
``embed`` [V, D], ``wcls``, ``final_norm``, ``rope_cos``/``rope_sin``
[S, hd/2] f32, and ``layers``, a list of per-layer dicts. Matmul weights
are ``QuantWeight`` (q40), ``PackedQuantWeight`` (q40i4) or ``Int8Weight``
(q40i8), each with its CUDA kernel on the card, or dense [out, in]
tensors. The KV cache is head-major, [L, B, KH, S, hd], and is updated in
place (JAX returns a new cache; the port writes the rows where they go).
Qwen3-MoE layers hold ``moe_gate`` [E, D] f32 and stacked experts
``w1``/``w3`` [E, F, D] and ``w2`` [E, D, F] in place of the dense FFN.

A Qwen3-MoE layer's FFN routes each row of y to its top-k experts
(``moe_route``, plain torch as in JAX) and sums their SwiGLUs: batches of
B*T <= 16 rows (decode, and the 8-row prefill bucket) through the
active-experts kernel, larger ones through the grouped kernel, Q40 or
dense by the expert leaves' type (ops/moe.py).

Attention: chunks of T > 1 go through the prefill stats kernel, T = 1
through the decode kernel, which reads rows 0..pos only — so the port
needs no attention windows. ``plain=True`` runs the plain PyTorch version
of every kernel instead, on any device: the on-card reference the kernel
path is held against; the engine never sets it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..device import resolve_device
from ..formats.model_file import HiddenAct, LlmArch, LlmHeader, RopeType
from ..ops.flash_attention import (
    flash_attention,
    flash_attention_ref,
    flash_decode,
    flash_decode_ref,
)
from ..ops.moe import (
    MOE_KERNEL_MAX_TOKENS,
    moe_active_experts,
    moe_active_experts_q40,
    moe_experts_ref,
    moe_grouped_experts,
    moe_grouped_experts_q40,
    moe_route,
)
from ..ops.int8_matmul import Int8Weight, i8matmul, i8matmul_ref, quantize_acts
from ..ops.quant_matmul import PackedQuantWeight, QuantWeight, qmatmul, qmatmul_i4, qmatmul_ref
from ..ops.torch_ops import apply_rope, gelu, qk_rms_norm, rms_norm, silu

Params = Dict[str, Any]
KvCache = Dict[str, torch.Tensor]


def init_kv_cache(
    h: LlmHeader, batch_size: int, dtype=torch.float32, seq_len: int | None = None, device=None
) -> KvCache:
    """Zeroed head-major KV cache [L, B, KH, S, hd] on ``device`` (default
    ``cuda``; reference: per-layer k/v buffers, src/llm.cpp:260-261)."""
    device = resolve_device(device)
    shape = (h.n_layers, batch_size, h.n_kv_heads, seq_len or h.seq_len, h.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


# Q40 weight type -> (kernel wrapper, plain version), both -> f32
_Q40_MATMULS = {
    QuantWeight: (qmatmul, qmatmul_ref),
    PackedQuantWeight: (qmatmul_i4, qmatmul_ref),
}


def _quant_mm(x: torch.Tensor, w, plain: bool, act_quant) -> torch.Tensor | None:
    """f32 x @ W^T through the weight type's kernel (or its plain version),
    None for a dense weight. An Int8Weight's activations come from
    ``act_quant`` (see `forward`)."""
    if isinstance(w, Int8Weight):
        return (i8matmul_ref if plain else i8matmul)(x, w, act_quant)
    pair = _Q40_MATMULS.get(type(w))
    if pair is None:
        return None
    kernel, ref = pair
    return (ref if plain else kernel)(x, w)


def _mm(x: torch.Tensor, w, plain: bool, act_quant) -> torch.Tensor:
    """x [..., in] @ W -> [..., out] in x's dtype: the weight type's kernel
    for a quantized leaf, a dense product for an [out, in] tensor."""
    out = _quant_mm(x, w, plain, act_quant)
    if out is not None:
        return out.to(x.dtype)
    return torch.matmul(x, w.transpose(-1, -2))


def moe_ffn(y: torch.Tensor, lp: Params, h: LlmHeader, plain: bool) -> torch.Tensor:
    """Qwen3-MoE FFN of y [B, T, D] -> [B, T, D] in y's dtype (reference:
    src/llm.cpp:425-499; JAX: transformer.py _moe_ffn_pallas /
    _moe_ffn_grouped)."""
    b, t, d = y.shape
    n = b * t
    yf = y.reshape(n, d)
    top_i, weights = moe_route(yf, lp["moe_gate"], h.n_active_experts)
    quant = isinstance(lp["w1"], QuantWeight)
    if plain:
        run = moe_experts_ref
    elif n <= MOE_KERNEL_MAX_TOKENS:
        run = moe_active_experts_q40 if quant else moe_active_experts
    else:
        run = moe_grouped_experts_q40 if quant else moe_grouped_experts
    out = run(yf, lp["w1"], lp["w2"], lp["w3"], top_i, weights)
    return out.reshape(b, t, d).to(y.dtype)


def logits_head(x: torch.Tensor, params: Params, h: LlmHeader, logits_mode: str, plain=False,
                act_quant=quantize_acts):
    """Final norm + vocab matmul, f32 logits (reference: src/llm.cpp:560-599).
    ``logits_mode="last"`` computes the last chunk row only."""
    if logits_mode not in ("all", "last"):
        raise ValueError(f"unknown logits_mode: {logits_mode!r}")
    if logits_mode == "last":
        x = x[:, -1:, :]
    y = rms_norm(x, params["final_norm"], h.norm_epsilon)
    wcls = params["wcls"]
    out = _quant_mm(y, wcls, plain, act_quant)
    if out is not None:
        return out
    return torch.matmul(y.float(), wcls.float().transpose(-1, -2))


def forward(
    params: Params,
    h: LlmHeader,
    tokens: torch.Tensor,  # [B, T] int
    pos: int,  # absolute position of tokens[:, 0]
    cache: KvCache,
    logits_mode: str = "all",
    plain: bool = False,
    act_quant=quantize_acts,
):
    """Run the decoder on T tokens at ``pos``; the cache rows [pos, pos+T)
    are written in place. Returns (logits [B, T or 1, V] f32, cache).

    ``act_quant(x [n, k], group) -> (xq, sx)`` quantizes the activations of
    every int8 matmul (q40i8), in the order of the calls. The default is
    `quantize_acts`; a caller that holds one run to another can hand both
    the same int8 activations (chip_smoke.py's parity check)."""
    b, t = tokens.shape
    s = cache["k"].shape[3]
    if pos < 0 or pos + t > s:
        # a write past the cache would drop rows; fail loudly instead
        raise ValueError(f"chunk [{pos}, {pos + t}) outside the cache of {s} rows")
    interleaved = h.rope_type in (RopeType.LLAMA, RopeType.LLAMA3_1)
    act = silu if h.hidden_act == HiddenAct.SILU else gelu
    is_qwen3 = h.arch in (LlmArch.QWEN3, LlmArch.QWEN3_MOE)
    is_moe = h.arch == LlmArch.QWEN3_MOE
    if is_moe and h.hidden_act != HiddenAct.SILU:
        raise ValueError("Qwen3-MoE experts are SwiGLU: hidden_act must be SILU")
    attend = (flash_decode_ref if plain else flash_decode) if t == 1 else (
        flash_attention_ref if plain else flash_attention
    )
    hq, hkv, hd = h.n_heads, h.n_kv_heads, h.head_dim

    def mm(x, w):
        return _mm(x, w, plain, act_quant)

    x = params["embed"][tokens]  # [B, T, D] (reference: OP_EMBEDDING)
    cos = params["rope_cos"][pos : pos + t]
    sin = params["rope_sin"][pos : pos + t]
    for l, lp in enumerate(params["layers"]):
        y = rms_norm(x, lp["att_norm"], h.norm_epsilon)
        q = mm(y, lp["wq"]).reshape(b, t, hq, hd)
        k = mm(y, lp["wk"]).reshape(b, t, hkv, hd)
        v = mm(y, lp["wv"]).reshape(b, t, hkv, hd)
        if is_qwen3:
            q = qk_rms_norm(q, lp["q_norm"], h.norm_epsilon)
            k = qk_rms_norm(k, lp["k_norm"], h.norm_epsilon)
        q = apply_rope(q, cos, sin, interleaved)
        k = apply_rope(k, cos, sin, interleaved)
        k_cache, v_cache = cache["k"][l], cache["v"][l]  # [B, KH, S, hd] views
        k_cache[:, :, pos : pos + t] = k.transpose(1, 2).to(k_cache.dtype)
        v_cache[:, :, pos : pos + t] = v.transpose(1, 2).to(v_cache.dtype)
        z = attend(q, k_cache, v_cache, pos).reshape(b, t, hq * hd)
        x = x + mm(z, lp["wo"]).to(x.dtype)

        y = rms_norm(x, lp["ffn_norm"], h.norm_epsilon)
        if is_moe:
            f = moe_ffn(y, lp, h, plain)
        else:
            d = act(mm(y, lp["w1"]))
            u = mm(y, lp["w3"])
            f = mm(d * u.to(d.dtype), lp["w2"])
        x = x + f.to(x.dtype)
    return logits_head(x, params, h, logits_mode, plain, act_quant), cache
