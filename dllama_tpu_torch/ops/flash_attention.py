"""Causal GQA attention over the head-major KV cache: kernel wrappers.

Counterpart of dllama_tpu/ops/flash_attention.py. Two CUDA kernels:

* ``flash_attention_stats`` (csrc/flash_attention.cu) — prefill chunks:
  unnormalized online-softmax state (acc [B,KH,G,T,hd], m and l
  [B,KH,G,T], f32) for T query rows per lane starting at ``q_pos0[b]``;
  ``flash_attention`` normalizes it.
* ``flash_decode`` (csrc/flash_decode.cu) — T = 1: normalized output
  [B, 1, H, hd] over cache rows 0..pos per lane, reading only those rows.

Semantics are ops/torch_ops.attention_stats / attention_dense: query head h
reads KV head h // (H / KH), keys at positions ``s_pos0 + j`` are visible to
a query at position p when ``s_pos0 + j <= p``, softmax in f32, and a fully
masked row gives m = -1e30, l = 0 and a zero output. CPU tensors take the
plain versions; CUDA tensors launch the kernels or raise. Each wrapper
counts its launches in ``.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .torch_ops import attention_stats, normalize_stats

_KERNEL_HEAD_DIMS = (64, 128)


def _lane_pos(pos, b: int, device) -> torch.Tensor:
    """int or [B] positions -> contiguous int32 [B] on ``device``. A Python
    int is filled on the device: a host-to-device copy from pageable memory
    would make the host wait for the card on every layer."""
    if isinstance(pos, int):
        return torch.full((b,), pos, dtype=torch.int32, device=device)
    p = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1)
    return (p.expand(b) if p.numel() == 1 else p).contiguous()


def _check_cuda(name: str, q, k, v) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share a dtype")
    for t in (q, k, v):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: CUDA tensors must be contiguous on the card")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd or h % k.shape[1]:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit cache {tuple(k.shape)}")
    if hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} has no kernel (takes {_KERNEL_HEAD_DIMS})")
    if h // k.shape[1] > 32:
        raise ValueError(f"{name}: more than 32 query heads per KV head")


def flash_attention_stats_ref(q, k, v, q_pos0, s_pos0=0):
    """Plain version of `flash_attention_stats`."""
    return attention_stats(q, k, v, q_pos0, s_pos0)


def flash_attention_stats(
    q: torch.Tensor,  # [B, T, H, hd]
    k: torch.Tensor,  # [B, KH, S, hd]
    v: torch.Tensor,  # [B, KH, S, hd]
    q_pos0,  # int or [B]: position of q[:, 0] per lane
    s_pos0: int = 0,  # absolute position of k[:, :, 0]
):
    """Blockwise causal GQA attention state (acc, m, l), f32."""
    if q.device.type == "cpu":
        return flash_attention_stats_ref(q, k, v, q_pos0, s_pos0)
    _check_cuda("flash_attention_stats", q, k, v)
    b, t, h, hd = q.shape
    kh, s = k.shape[1], k.shape[2]
    pos = _lane_pos(q_pos0, b, q.device)
    acc = torch.empty((b, kh, h // kh, t, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, kh, h // kh, t), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    code = _build.load("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), int(s_pos0),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, t, h, kh, s, hd,
        float(1.0 / np.sqrt(hd)), int(q.dtype == torch.bfloat16), _build.stream(q.device),
    )
    _build.check(code, "flash_attention_stats")
    flash_attention_stats.launches += 1
    return acc, m, l


flash_attention_stats.launches = 0


def flash_attention(q, k_cache, v_cache, pos) -> torch.Tensor:
    """Normalized causal GQA attention [B, T, H, hd] in q's dtype, from the
    stats kernel (the normalization is plain torch, as in the JAX package)."""
    acc, _, l = flash_attention_stats(q, k_cache, v_cache, pos, 0)
    return normalize_stats(acc, l, q.dtype)


def flash_attention_ref(q, k_cache, v_cache, pos) -> torch.Tensor:
    """Plain version of `flash_attention`."""
    acc, _, l = flash_attention_stats_ref(q, k_cache, v_cache, pos, 0)
    return normalize_stats(acc, l, q.dtype)


def flash_decode_ref(q, k_cache, v_cache, pos) -> torch.Tensor:
    """Plain version of `flash_decode`."""
    acc, _, l = attention_stats(q, k_cache, v_cache, pos, 0)
    return normalize_stats(acc, l, q.dtype)


def flash_decode(
    q: torch.Tensor,  # [B, 1, H, hd]
    k_cache: torch.Tensor,  # [B, KH, S, hd]
    v_cache: torch.Tensor,
    pos,  # int or [B] per-lane positions
) -> torch.Tensor:
    """Normalized single-token decode attention [B, 1, H, hd] in q's dtype."""
    if q.shape[1] != 1:
        raise ValueError("flash_decode is the T=1 path")
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, pos)
    _check_cuda("flash_decode", q, k_cache, v_cache)
    b, _, h, hd = q.shape
    kh, s = k_cache.shape[1], k_cache.shape[2]
    p = _lane_pos(pos, b, q.device)
    out = torch.empty_like(q)
    code = _build.load("flash_decode")(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), p.data_ptr(), 0,
        out.data_ptr(), b, h, kh, s, hd, float(1.0 / np.sqrt(hd)),
        int(q.dtype == torch.bfloat16), _build.stream(q.device),
    )
    _build.check(code, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
