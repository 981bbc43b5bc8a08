"""Causal GQA attention over the head-major KV cache: kernel wrappers.

Counterpart of dllama_tpu/ops/flash_attention.py. Three CUDA kernels:

* ``flash_attention_stats`` (csrc/flash_attention.cu) — prefill chunks:
  unnormalized online-softmax state (acc [B,KH,G,T,hd], m and l
  [B,KH,G,T], f32) for T query rows per lane starting at ``q_pos0[b]``;
  ``flash_attention`` normalizes it. ``paged_flash_attention_stats`` is the
  same kernel reading keys through a page table (its launches count under
  ``flash_attention_stats``).
* ``flash_decode`` (csrc/flash_decode.cu) — T = 1: normalized output
  [B, 1, H, hd] over cache rows 0..pos per lane, reading only those rows.
* ``paged_flash_decode`` (csrc/flash_decode.cu) — the same through a page
  table: logical row r of lane b lives in pool page ``page_table[b, r //
  ps]`` of the pool [P, KH, ps, hd], at page row ``r % ps``.

Each takes the cache as dense leaves in q's dtype, as dense leaves in
another float type (``--kv-dtype`` f32, f16 or bf16 unlike the model's
dtype), or as int8 `QuantKV` pairs (``--kv-dtype int8``: int8 values and
one f32 scale a row). A dense cache in a type other than q's goes to the
kernels' mixed-type entries (the ``_mx`` C entries, q's and the cache's type
codes), which read q and each K/V row in their own types, as every TPU
kernel upcasts its q, K and V tiles to f32: the prefill stats run one
tensor-core body for every pair of types, each operand entering as exact
bf16 parts (csrc/flash_attention.cu's table), the decode kernels' CUDA-core
bodies compute in f32. Their launches count apart, in the `KernelCount`s
``flash_attention_stats_mixed`` (slab and paged), ``flash_decode_mixed``
and ``paged_flash_decode_mixed``. bf16 q over a bf16 cache keeps the
decode kernels' tensor-core bodies. A QuantKV
cache goes to the same kernels' int8 instantiations (the ``_q8`` C
entries), which read the int8 planes and the scales and put each row's
scale on its score and on its probability in f32 (the TPU kernels' QuantKV
branch dequantizes the tile in f32: the same arithmetic). Their launches
count apart, in the `KernelCount`s ``flash_attention_stats_kv8`` (slab and
paged), ``flash_decode_kv8`` and ``paged_flash_decode_kv8``. The JAX
engine decodes an int8 slab with ``dequant_kv`` and XLA attention; the
port's int8 slab decode is the kernel.

Sequence parallelism (parallel/ring_attention.py, models/transformer.py)
adds two options on the slab entries: ``flash_attention_stats(...,
s_stride)``, key row j at position ``s_pos0 + j * s_stride`` (a cyclic
sequence shard: the ring's local step), and ``flash_decode_stats``, the
decode kernel emitting the unnormalized (acc, m, l) of one strided shard
(the sp decode's local step), counted in
``flash_attention_stats_strided`` and ``flash_decode_stats``. Both take
a dense shard (q and the cache in their own float types) or an int8
`QuantKV` shard (the ``_q8`` C entries ``flash_attention_stats_strided_q8``,
the TPU kernel's QuantKV branch under ``s_stride``, and
``flash_decode_stats_q8``, the port's route where the JAX engine decodes
its int8 sp cache with ``dequant_kv`` and jnp stats), counted in
``flash_attention_stats_strided_kv8`` and ``flash_decode_stats_kv8``.

Semantics are ops/torch_ops.attention_stats / attention_dense: query head h
reads KV head h // (H / KH), keys at positions ``s_pos0 + j`` are visible to
a query at position p when ``s_pos0 + j <= p``, softmax in f32, and a fully
masked row gives m = -1e30, l = 0 and a zero output. The plain versions
dequantize a QuantKV cache in f32 (values * scales) first. CPU tensors take
the plain versions; CUDA tensors launch the kernels or raise. Each wrapper
counts its launches in ``.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .kv_cache import QuantKV, dequant_kv, lane_views
from .torch_ops import attention_stats, normalize_stats

_KERNEL_HEAD_DIMS = (64, 128)
# the C entries' type codes (csrc/common.cuh TypeCode)
_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _lane_pos(pos, b: int, device) -> torch.Tensor:
    """int or [B] positions -> contiguous int32 [B] on ``device``. A Python
    int is filled on the device: a host-to-device copy from pageable memory
    would make the host wait for the card on every layer."""
    if isinstance(pos, int):
        return torch.full((b,), pos, dtype=torch.int32, device=device)
    p = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1)
    return (p.expand(b) if p.numel() == 1 else p).contiguous()


def _quant(name: str, k, v) -> bool:
    """Whether the cache is int8 (both leaves QuantKV); a mixed pair raises."""
    quant = isinstance(k, QuantKV)
    if isinstance(v, QuantKV) != quant:
        raise TypeError(f"{name}: k and v must both be QuantKV or both dense, got "
                        f"k={type(k).__name__}, v={type(v).__name__}")
    return quant


def _mixed(q, k) -> bool:
    """Whether a dense cache is in a float type other than q's (the ``_mx``
    entries)."""
    return not isinstance(k, QuantKV) and k.dtype != q.dtype


def _types(q, k) -> tuple:
    """The C entry's trailing type arguments: (q's code, the cache's code)
    for a mixed pair, else the one flag ``bf16`` (q's type, which the cache
    shares, or an int8 cache's q)."""
    if _mixed(q, k):
        return _TYPE_CODES[q.dtype], _TYPE_CODES[k.dtype]
    return (int(q.dtype == torch.bfloat16),)


def _strided_types(q, k) -> tuple:
    """The strided entries' trailing type arguments: an int8 shard's bf16
    flag, or a dense shard's two type codes (q's and the cache's, which
    may differ)."""
    if isinstance(k, QuantKV):
        return _types(q, k)
    return _TYPE_CODES[q.dtype], _TYPE_CODES[k.dtype]


def _check_kv(name: str, q, k, v) -> None:
    """The cache leaves' contract on CUDA tensors: dense leaves of one float
    type (float32, bfloat16 or float16; q's or another), or QuantKV pairs of
    int8 values [..., S, hd] and f32 scales [..., S, 1]; q float32 or
    bfloat16; every tensor contiguous on the card."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: takes float32 or bfloat16, got {q.dtype}")
    if _quant(name, k, v):
        for leaf in (k, v):
            if leaf.q.dtype != torch.int8 or leaf.s.dtype != torch.float32:
                raise TypeError(f"{name}: a QuantKV leaf holds int8 values and float32 scales, "
                                f"got {leaf.q.dtype} and {leaf.s.dtype}")
            if leaf.s.shape != leaf.q.shape[:-1] + (1,):
                raise ValueError(f"{name}: scales {tuple(leaf.s.shape)} do not fit values "
                                 f"{tuple(leaf.q.shape)} (want [..., S, 1])")
        tensors = (q, k.q, k.s, v.q, v.s)
    else:
        if k.dtype != v.dtype or k.dtype not in _TYPE_CODES:
            raise TypeError(f"{name}: k and v must share one of float32, bfloat16 or float16, "
                            f"got {k.dtype} and {v.dtype}")
        tensors = (q, k, v)
    for t in tensors:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: CUDA tensors must be contiguous on the card")


def _check_paged(name: str, q, k_pages, v_pages, page_table, pos) -> None:
    """The paged kernels' contract on CUDA tensors: `_check_kv` for the
    pool, int32 page table and positions on the card, head dims the kernels
    instantiate, and a page size that divides 32 or is a multiple of 32."""
    _check_kv(name, q, k_pages, v_pages)
    for t in (page_table, pos):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: CUDA tensors must be contiguous on the card")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"{name}: page_table and pos must be int32")
    b, _, h, hd = q.shape
    _, kh, ps, khd = k_pages.shape
    if k_pages.shape != v_pages.shape or khd != hd or h % kh:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit pool {tuple(k_pages.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"{name}: page_table {tuple(page_table.shape)} and pos "
                         f"{tuple(pos.shape)} must be [B, n_blocks] and [B], B = {b}")
    if hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} has no kernel (takes {_KERNEL_HEAD_DIMS})")
    if h // kh > 32:
        raise ValueError(f"{name}: more than 32 query heads per KV head")
    if (32 % ps) if ps < 32 else (ps % 32):
        raise ValueError(f"{name}: page size {ps} neither divides 32 nor is a multiple of 32")


def _check_cuda(name: str, q, k, v) -> None:
    _check_kv(name, q, k, v)
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd or h % k.shape[1]:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit cache {tuple(k.shape)}")
    if hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} has no kernel (takes {_KERNEL_HEAD_DIMS})")
    if h // k.shape[1] > 32:
        raise ValueError(f"{name}: more than 32 query heads per KV head")


def _kv_ptrs(k, v) -> tuple:
    """The C entry's cache pointers: (k, v), or (k values, k scales, v
    values, v scales) for a QuantKV cache."""
    if isinstance(k, QuantKV):
        return k.q.data_ptr(), k.s.data_ptr(), v.q.data_ptr(), v.s.data_ptr()
    return k.data_ptr(), v.data_ptr()


def _plain_kv(k, v) -> tuple:
    """The plain versions' cache: a QuantKV dequantized in f32 (the TPU
    kernels' arithmetic), a dense leaf as it is."""
    return dequant_kv(k, torch.float32), dequant_kv(v, torch.float32)


def flash_attention_stats_ref(q, k, v, q_pos0, s_pos0=0, s_stride: int = 1):
    """Plain version of `flash_attention_stats`."""
    return attention_stats(q, *_plain_kv(k, v), q_pos0, s_pos0, s_stride)


def _stats_out(q, kh: int):
    b, t, h, hd = q.shape
    acc = torch.empty((b, kh, h // kh, t, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, kh, h // kh, t), dtype=torch.float32, device=q.device)
    return acc, m, torch.empty_like(m)


class KernelCount:
    """The ``.launches`` of a kernel's int8-KV instantiation (``*_kv8``),
    which the kernel's wrapper counts here rather than on itself (ops
    ``KERNELS`` reads both alike)."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


flash_attention_stats_kv8 = KernelCount("flash_attention_stats_kv8")
flash_decode_kv8 = KernelCount("flash_decode_kv8")
paged_flash_decode_kv8 = KernelCount("paged_flash_decode_kv8")
# the mixed-type entries' launches (a float cache type unlike q's)
flash_attention_stats_mixed = KernelCount("flash_attention_stats_mixed")
flash_decode_mixed = KernelCount("flash_decode_mixed")
paged_flash_decode_mixed = KernelCount("paged_flash_decode_mixed")
# the stats kernel over a strided sequence shard (sequence parallelism's
# ring step), whose launches count apart from the contiguous ones, and the
# int8 instantiations of both strided entries
flash_attention_stats_strided = KernelCount("flash_attention_stats_strided")
flash_attention_stats_strided_kv8 = KernelCount("flash_attention_stats_strided_kv8")
flash_decode_stats_kv8 = KernelCount("flash_decode_stats_kv8")


def _entry(base: str, q, k) -> str:
    """The C entry of a launch: ``base``, its ``_q8`` for an int8 cache or
    its ``_mx`` for a mixed pair."""
    if isinstance(k, QuantKV):
        return base + "_q8"
    return base + "_mx" if _mixed(q, k) else base


def _count(q, k, plain, kv8: KernelCount, mixed: KernelCount) -> None:
    """One launch on the counter of its instantiation."""
    (kv8 if isinstance(k, QuantKV) else mixed if _mixed(q, k) else plain).launches += 1


def flash_attention_stats(
    q: torch.Tensor,  # [B, T, H, hd]
    k,  # [B, KH, S, hd], or a QuantKV
    v,  # [B, KH, S, hd], or a QuantKV
    q_pos0,  # int or [B]: position of q[:, 0] per lane
    s_pos0: int = 0,  # absolute position of k[:, :, 0]
    s_stride: int = 1,  # key row j at position s_pos0 + j * s_stride
):
    """Blockwise causal GQA attention state (acc, m, l), f32. With
    ``s_stride`` > 1 the keys are a strided sequence shard (sequence
    parallelism's cyclic layout: shard i of sp holds positions i, i + sp,
    ...): the C entry ``flash_attention_stats_strided``, whose launches
    count under `flash_attention_stats_strided`, or for an int8 shard
    ``flash_attention_stats_strided_q8``, counted under
    `flash_attention_stats_strided_kv8`."""
    quant = _quant("flash_attention_stats", k, v)
    if s_stride < 1:
        raise ValueError(f"flash_attention_stats: s_stride must be >= 1, got {s_stride}")
    if q.device.type == "cpu":
        return flash_attention_stats_ref(q, k, v, q_pos0, s_pos0, s_stride)
    _check_cuda("flash_attention_stats", q, k, v)
    b, t, h, hd = q.shape
    kh, s = k.shape[1], k.shape[2]
    pos = _lane_pos(q_pos0, b, q.device)
    acc, m, l = _stats_out(q, kh)
    if s_stride > 1:
        entry = "flash_attention_stats_strided" + ("_q8" if quant else "")
        code = _build.load(entry)(
            q.data_ptr(), *_kv_ptrs(k, v), pos.data_ptr(), int(s_pos0), int(s_stride),
            acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, t, h, kh, s, hd,
            float(1.0 / np.sqrt(hd)), *_strided_types(q, k), _build.stream(q.device),
        )
        _build.check(code, entry)
        (flash_attention_stats_strided_kv8 if quant else flash_attention_stats_strided).launches += 1
        return acc, m, l
    code = _build.load(_entry("flash_attention_stats", q, k))(
        q.data_ptr(), *_kv_ptrs(k, v), pos.data_ptr(), int(s_pos0),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, t, h, kh, s, hd,
        float(1.0 / np.sqrt(hd)), *_types(q, k), _build.stream(q.device),
    )
    _build.check(code, "flash_attention_stats")
    _count(q, k, flash_attention_stats, flash_attention_stats_kv8, flash_attention_stats_mixed)
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
    acc, _, l = attention_stats(q, *_plain_kv(k_cache, v_cache), pos, 0)
    return normalize_stats(acc, l, q.dtype)


def flash_decode(
    q: torch.Tensor,  # [B, 1, H, hd]
    k_cache,  # [B, KH, S, hd], or a QuantKV
    v_cache,
    pos,  # int or [B] per-lane positions
) -> torch.Tensor:
    """Normalized single-token decode attention [B, 1, H, hd] in q's dtype
    (for an int8 slab the port's own route: the JAX engine takes
    ``dequant_kv`` and XLA attention there)."""
    if q.shape[1] != 1:
        raise ValueError("flash_decode is the T=1 path")
    _quant("flash_decode", k_cache, v_cache)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, pos)
    _check_cuda("flash_decode", q, k_cache, v_cache)
    b, _, h, hd = q.shape
    kh, s = k_cache.shape[1], k_cache.shape[2]
    p = _lane_pos(pos, b, q.device)
    out = torch.empty_like(q)
    code = _build.load(_entry("flash_decode", q, k_cache))(
        q.data_ptr(), *_kv_ptrs(k_cache, v_cache), p.data_ptr(), 0,
        out.data_ptr(), b, h, kh, s, hd, float(1.0 / np.sqrt(hd)),
        *_types(q, k_cache), _build.stream(q.device),
    )
    _build.check(code, "flash_decode")
    _count(q, k_cache, flash_decode, flash_decode_kv8, flash_decode_mixed)
    return out


flash_decode.launches = 0


def flash_decode_stats_ref(q, k, v, pos, s_pos0: int = 0, s_stride: int = 1):
    """Plain version of `flash_decode_stats`: `attention_stats` at T = 1."""
    return attention_stats(q, *_plain_kv(k, v), pos, s_pos0, s_stride)


def flash_decode_stats(
    q: torch.Tensor,  # [B, 1, H, hd]
    k,  # [B, KH, Ss, hd]: one sequence shard, dense or a QuantKV
    v,
    pos,  # int or [B]: the query's position per lane
    s_pos0: int = 0,  # absolute position of k[:, :, 0]
    s_stride: int = 1,  # key row j at position s_pos0 + j * s_stride
):
    """Unnormalized decode state over one sequence shard, f32: (acc [B, KH,
    G, 1, hd], m and l [B, KH, G, 1]), the `attention_stats` contract that
    sequence parallelism merges by log-sum-exp across shards (the TPU
    kernel's ``emit_stats``; JAX surface ``flash_decode_stats``, which has
    no stride: the port's sp cache is cyclic, as the JAX engine's is). A
    shard wholly in the query's future reads nothing and gives m = -1e30,
    l = 0, acc = 0. An int8 shard launches ``flash_decode_stats_q8``,
    counted under `flash_decode_stats_kv8`."""
    if q.shape[1] != 1:
        raise ValueError("flash_decode_stats is the T=1 path")
    quant = _quant("flash_decode_stats", k, v)
    if s_stride < 1:
        raise ValueError(f"flash_decode_stats: s_stride must be >= 1, got {s_stride}")
    if q.device.type == "cpu":
        return flash_decode_stats_ref(q, k, v, pos, s_pos0, s_stride)
    _check_cuda("flash_decode_stats", q, k, v)
    b, _, h, hd = q.shape
    kh, s = k.shape[1], k.shape[2]
    p = _lane_pos(pos, b, q.device)
    acc, m, l = _stats_out(q, kh)
    entry = "flash_decode_stats" + ("_q8" if quant else "")
    code = _build.load(entry)(
        q.data_ptr(), *_kv_ptrs(k, v), p.data_ptr(), int(s_pos0), int(s_stride),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, kh, s, hd, float(1.0 / np.sqrt(hd)),
        *_strided_types(q, k), _build.stream(q.device),
    )
    _build.check(code, entry)
    (flash_decode_stats_kv8 if quant else flash_decode_stats).launches += 1
    return acc, m, l


flash_decode_stats.launches = 0


def paged_flash_decode_ref(q, k_pages, v_pages, page_table, pos) -> torch.Tensor:
    """Plain version of `paged_flash_decode`: every lane's pages gathered
    into a slab view (`kv_cache.lane_views`, JAX's ``paged_view``), then the
    dense attention."""
    k = lane_views(k_pages, page_table)
    v = lane_views(v_pages, page_table)
    acc, _, l = attention_stats(q, *_plain_kv(k, v), pos, 0)
    return normalize_stats(acc, l, q.dtype)


def paged_flash_decode(
    q: torch.Tensor,  # [B, 1, H, hd]
    k_pages,  # [P, KH, ps, hd] one layer of the pool, or a QuantKV
    v_pages,
    page_table: torch.Tensor,  # [B, n_blocks] int32, on q's device
    pos: torch.Tensor,  # [B] int32, on q's device; a lane at pos < 0 reads nothing
) -> torch.Tensor:
    """Normalized single-token decode attention [B, 1, H, hd] in q's dtype,
    K/V read through the page table (no row or scale at or past a lane's
    frontier is read)."""
    if q.shape[1] != 1:
        raise ValueError("paged_flash_decode is the T=1 path")
    _quant("paged_flash_decode", k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_flash_decode_ref(q, k_pages, v_pages, page_table, pos)
    _check_paged("paged_flash_decode", q, k_pages, v_pages, page_table, pos)
    b, _, h, hd = q.shape
    kh, ps = k_pages.shape[1], k_pages.shape[2]
    out = torch.empty_like(q)
    code = _build.load(_entry("paged_flash_decode", q, k_pages))(
        q.data_ptr(), *_kv_ptrs(k_pages, v_pages), page_table.data_ptr(),
        pos.data_ptr(), out.data_ptr(), b, h, kh, page_table.shape[1], ps, hd,
        float(1.0 / np.sqrt(hd)), *_types(q, k_pages), _build.stream(q.device),
    )
    _build.check(code, "paged_flash_decode")
    _count(q, k_pages, paged_flash_decode, paged_flash_decode_kv8, paged_flash_decode_mixed)
    return out


paged_flash_decode.launches = 0


def paged_flash_attention_stats_ref(q, k_pages, v_pages, page_table, q_pos0):
    """Plain version of `paged_flash_attention_stats`."""
    k = lane_views(k_pages, page_table)
    v = lane_views(v_pages, page_table)
    return attention_stats(q, *_plain_kv(k, v), q_pos0, 0)


def paged_flash_attention_stats(
    q: torch.Tensor,  # [B, T, H, hd]
    k_pages,  # [P, KH, ps, hd], or a QuantKV
    v_pages,
    page_table: torch.Tensor,  # [B, n_blocks] int32
    q_pos0: torch.Tensor,  # [B] int32: position of q[:, 0] per lane
):
    """`flash_attention_stats` with the keys read through the page table
    (logical rows from 0); its launches count under flash_attention_stats
    (flash_attention_stats_kv8 for an int8 pool, flash_attention_stats_mixed
    for a pool in a float type other than q's)."""
    _quant("paged_flash_attention_stats", k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_flash_attention_stats_ref(q, k_pages, v_pages, page_table, q_pos0)
    _check_paged("paged_flash_attention_stats", q, k_pages, v_pages, page_table, q_pos0)
    b, t, h, hd = q.shape
    kh, ps = k_pages.shape[1], k_pages.shape[2]
    acc, m, l = _stats_out(q, kh)
    code = _build.load(_entry("flash_attention_stats_paged", q, k_pages))(
        q.data_ptr(), *_kv_ptrs(k_pages, v_pages), page_table.data_ptr(),
        q_pos0.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, t, h, kh,
        page_table.shape[1], ps, hd, float(1.0 / np.sqrt(hd)), *_types(q, k_pages),
        _build.stream(q.device),
    )
    _build.check(code, "paged_flash_attention_stats")
    _count(q, k_pages, flash_attention_stats, flash_attention_stats_kv8,
           flash_attention_stats_mixed)
    return acc, m, l


def paged_flash_attention(q, k_pages, v_pages, page_table, pos) -> torch.Tensor:
    """Normalized causal attention [B, T, H, hd] through the page table."""
    acc, _, l = paged_flash_attention_stats(q, k_pages, v_pages, page_table, pos)
    return normalize_stats(acc, l, q.dtype)


def paged_flash_attention_ref(q, k_pages, v_pages, page_table, pos) -> torch.Tensor:
    """Plain version of `paged_flash_attention`."""
    acc, _, l = paged_flash_attention_stats_ref(q, k_pages, v_pages, page_table, pos)
    return normalize_stats(acc, l, q.dtype)
