"""Plain PyTorch model ops: the counterparts of dllama_tpu/ops/jnp_ops.py.

Same math, same f32 internals: norms, RoPE and softmax compute in float32
whatever the activation dtype and cast back at the end, as the jnp
versions do (and as the reference's CPU kernels accumulate in f32). None of
these is a TPU kernel in the JAX package, so none gets a CUDA kernel here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..formats.model_file import LlmHeader, RopeType

_NEG_INF = -1e30


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over the last axis (reference: OP_INV_RMS + OP_RMS_NORM,
    src/nn/nn-cpu-ops.cpp:114-189)."""
    xf = x.float()
    inv = torch.reciprocal(torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps))
    return (xf * inv * weight.float()).to(x.dtype)


def qk_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head RMS norm for Qwen3 QK-norm: ``x`` [..., nHeads, headDim],
    ``weight`` [headDim] (reference: src/llm.cpp:322-346)."""
    return rms_norm(x, weight, eps)


def silu(x: torch.Tensor) -> torch.Tensor:
    """(reference: src/nn/nn-cpu-ops.cpp:454-478)"""
    xf = x.float()
    return (xf / (1.0 + torch.exp(-xf))).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approx GELU (reference: gelu_F32, src/nn/nn-cpu-ops.cpp:480-500)."""
    xf = x.float()
    return (
        0.5 * xf * (1.0 + torch.tanh(0.797884560802865 * (xf + 0.044715 * xf * xf * xf)))
    ).to(x.dtype)


def _scale_frequency_llama3(freq: np.ndarray, h: LlmHeader) -> np.ndarray:
    """Llama-3.1 NTK-by-parts frequency scaling
    (reference: src/nn/nn-core.cpp:326-340)."""
    wave_len = 2.0 * np.pi / freq
    high_freq_wavelen = h.rope_scaling_orig_max_seq_len / h.rope_scaling_high_freq_factor
    low_freq_wavelen = h.rope_scaling_orig_max_seq_len / h.rope_scaling_low_freq_factor
    smooth = (h.rope_scaling_orig_max_seq_len / wave_len - h.rope_scaling_low_freq_factor) / (
        h.rope_scaling_high_freq_factor - h.rope_scaling_low_freq_factor
    )
    return np.where(
        wave_len < high_freq_wavelen,
        freq,
        np.where(
            wave_len > low_freq_wavelen,
            freq / h.rope_scaling_factor,
            (1.0 - smooth) * freq / h.rope_scaling_factor + smooth * freq,
        ),
    )


def rope_frequencies(h: LlmHeader) -> np.ndarray:
    """Per-pair inverse frequencies [headDim // 2], f32, on host
    (reference: src/nn/nn-core.cpp:342-374)."""
    half = h.head_dim // 2
    exponents = 2.0 * np.arange(half, dtype=np.float32) / np.float32(h.head_dim)
    freqs = (1.0 / (h.rope_theta**exponents)).astype(np.float32)
    if h.rope_type == RopeType.LLAMA3_1 and h.rope_scaling_factor != 1.0:
        freqs = _scale_frequency_llama3(freqs, h).astype(np.float32)
    return freqs


def rope_cache(h: LlmHeader, seq_len: int | None = None, device=None):
    """(cos, sin) f32 tables [seqLen, headDim // 2] on ``device`` (``cuda``
    unless the caller asks for the CPU), computed on host in numpy exactly
    as the jnp version does
    (reference: fullfillRopeCache, src/nn/nn-core.cpp:376-383)."""
    device = resolve_device(device)
    if seq_len is None:
        seq_len = h.seq_len
    freqs = rope_frequencies(h)
    angles = np.arange(seq_len, dtype=np.float32)[:, None] * freqs[None, :]
    return (
        torch.from_numpy(np.cos(angles)).to(device),
        torch.from_numpy(np.sin(angles)).to(device),
    )


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, interleaved: bool
) -> torch.Tensor:
    """Rotate ``x`` [..., T, nHeads, headDim] by position. ``cos``/``sin``
    are [T, headDim//2] (or [B, T, headDim//2] per lane). ``interleaved``
    pairs (2j, 2j+1) — llama (src/nn/nn-cpu-ops.cpp:843-863); otherwise
    (j, j+headDim/2) — falcon/neox, Qwen3 (src/nn/nn-cpu-ops.cpp:865-885)."""
    xf = x.float()
    c = cos.unsqueeze(-2)  # [(B,) T, 1, half]
    s = sin.unsqueeze(-2)
    if interleaved:
        x0 = xf[..., 0::2]
        x1 = xf[..., 1::2]
        out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).reshape(xf.shape)
    else:
        half = xf.shape[-1] // 2
        x0 = xf[..., :half]
        x1 = xf[..., half:]
        out = torch.cat([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    return out.to(x.dtype)


def _lane_positions(pos, b: int, device) -> torch.Tensor:
    """Scalar or [B] positions as an int64 [B] tensor on ``device``."""
    p = torch.as_tensor(pos, dtype=torch.int64, device=device).reshape(-1)
    return p.expand(b) if p.numel() == 1 else p


def attention_stats(
    q: torch.Tensor,  # [B, Tq, H, hd]
    k: torch.Tensor,  # [B, KH, Ts, hd] head-major cache layout
    v: torch.Tensor,  # [B, KH, Ts, hd]
    q_pos0,  # int or [B]: absolute position of q[:, 0] per lane
    s_pos0=0,  # int: absolute position of k[:, :, 0]
    s_stride: int = 1,
):
    """Causal GQA attention partial state in f32: (acc [B,KH,G,T,hd]
    unnormalized, m [B,KH,G,T] row max, l [B,KH,G,T] denominator) — the
    reference's multiheadAtt_F32 math (src/nn/nn-cpu-ops.cpp:753-788).
    Fully masked rows give m = -1e30, l = 0, acc = 0."""
    b, tq, h, hd = q.shape
    kh, ts = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.float().reshape(b, tq, kh, g, hd)
    scores = torch.einsum("btkgh,bksh->bkgts", qf, k.float()) / np.float32(np.sqrt(hd))
    q_pos = _lane_positions(q_pos0, b, q.device)[:, None] + torch.arange(
        tq, device=q.device
    )[None, :]
    s_pos = int(s_pos0) + torch.arange(ts, device=q.device) * s_stride
    mask = s_pos[None, None, :] <= q_pos[:, :, None]  # [B, tq, ts]
    scores = torch.where(
        mask[:, None, None], scores, torch.tensor(_NEG_INF, device=q.device)
    )
    m = torch.amax(scores, dim=-1)
    p = torch.exp(scores - m[..., None])
    p = torch.where(m[..., None] <= _NEG_INF / 2, torch.zeros_like(p), p)
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bkgts,bksh->bkgth", p, v.float())
    return acc, m, l


def normalize_stats(acc, l, dtype) -> torch.Tensor:
    """(acc, l) of `attention_stats` -> normalized [B, T, H, hd] in ``dtype``."""
    b, kh, g, t, hd = acc.shape
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = acc / l_safe[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, kh * g, hd).to(dtype)


def attention_dense(
    q: torch.Tensor,  # [B, T, H, hd]
    k_cache: torch.Tensor,  # [B, KH, S, hd]
    v_cache: torch.Tensor,
    pos,  # int or [B]: absolute position of q[:, 0]
) -> torch.Tensor:
    """Normalized causal GQA attention over the cache; [B, T, H, hd]."""
    acc, _, l = attention_stats(q, k_cache, v_cache, pos, 0)
    return normalize_stats(acc, l, q.dtype)
