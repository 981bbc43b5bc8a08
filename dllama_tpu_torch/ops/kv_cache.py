"""KV cache leaves: the int8 ``QuantKV`` pair and the paged pool's views.

Counterpart of dllama_tpu/ops/kv_cache.py. A cache leaf is a dense tensor
or a `QuantKV`: int8 values ``q`` [..., S, hd] and one f32 scale a row
``s`` [..., S, 1] (``--kv-dtype int8``). Rows are quantized once, when
they are written (`quantize_kv_rows`, the int8 matmul path's rule with one
group a row), and read by the attention kernels as they are stored: the
kernels take the int8 planes and the scales and never see a dense copy.
`dequant_kv` is the plain versions' read.

A pool leaf is one layer's pages, [P, KH, ps, hd] (a QuantKV of [P, KH,
ps, hd] values and [P, KH, ps, 1] scales); a page list [n] names the pages
that back logical rows [0, n*ps) of one lane, in order (`gather_pages`,
`scatter_pages`, `paged_view`, `lane_views`). Every function here takes
either kind of leaf.

Slab lanes keep each lane's rows in a slab [L, B, KH, S + pad, hd] and
share prefixes through the pool by copies (`pages_to_rows`: a pool page
list into a lane's rows, the JAX engine's ``kv_adopt`` program;
`rows_to_pages`: a lane's rows into pool pages, its ``kv_publish``). The
JAX engine computes these copies in jnp, outside any Pallas kernel; here
they are torch index copies, in place, of every layer at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantKV(NamedTuple):
    """An int8 cache leaf: ``q`` int8 [..., S, hd], ``s`` f32 [..., S, 1]
    (the trailing singleton keeps both leaves of one rank, so every row
    write and page index applies to both). ``shape`` and ``dtype`` are the
    values', as in the JAX package. Index a layer with `kv_layer`, never
    with ``[]`` (a tuple's index picks a field)."""

    q: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype


def new_kv_leaf(shape, dtype, device):
    """A fresh cache or pool leaf of value shape ``shape``: zeros in
    ``dtype``, or for ``torch.int8`` a QuantKV of zero values and scales of
    ones (the JAX package's initial int8 cache)."""
    if dtype == torch.int8:
        return QuantKV(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.ones(tuple(shape[:-1]) + (1,), dtype=torch.float32, device=device))
    return torch.zeros(shape, dtype=dtype, device=device)


def reset_kv_leaf(leaf) -> None:
    """Back to `new_kv_leaf`'s state, in place (a captured graph keeps the
    leaf's addresses)."""
    if isinstance(leaf, QuantKV):
        leaf.q.zero_()
        leaf.s.fill_(1.0)
    else:
        leaf.zero_()


def kv_layer(leaf, l: int):
    """Layer ``l`` of a cache or pool leaf (a view: writes land in the leaf)."""
    if isinstance(leaf, QuantKV):
        return QuantKV(leaf.q[l], leaf.s[l])
    return leaf[l]


def kv_tensors(leaf) -> tuple:
    """The tensors that hold a leaf: (values, scales) or (tensor,)."""
    return tuple(leaf) if isinstance(leaf, QuantKV) else (leaf,)


def quantize_kv_rows(val: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., T, hd] -> (int8 values, f32 [..., T, 1] scales): the grouped
    symmetric quantizer of the int8 matmuls (`int8_matmul.quantize_acts`)
    with one group a cache row, as in the JAX package."""
    from .int8_matmul import quantize_acts

    return quantize_acts(val.float(), val.shape[-1])


def dequant_kv(leaf, dtype):
    """Dense view of a leaf: QuantKV -> values * scales in f32, then
    ``dtype``; a dense leaf passes through."""
    if isinstance(leaf, QuantKV):
        return (leaf.q.float() * leaf.s).to(dtype)
    return leaf


def slice_kv(leaf, w: int):
    """The first ``w`` rows of a [B, KH, S, hd] leaf (w == 0: all of them)."""
    if not w:
        return leaf
    if isinstance(leaf, QuantKV):
        return QuantKV(leaf.q[:, :, :w], leaf.s[:, :, :w])
    return leaf[:, :, :w]


def kv_rows(leaf, rows):
    """Rows ``rows`` (a slice or an index tensor) of a [B, KH, S, hd] leaf as
    a contiguous copy, both planes of a QuantKV: a sequence shard's rows,
    which the ring sends on."""
    if isinstance(leaf, QuantKV):
        return QuantKV(leaf.q[:, :, rows].contiguous(), leaf.s[:, :, rows].contiguous())
    return leaf[:, :, rows].contiguous()


def gather_pages(pool_l, page_ids: torch.Tensor):
    """Rows of ``page_ids`` [n] from ``pool_l`` [P, KH, ps, hd] as one
    head-major [KH, n*ps, hd] leaf, in page order."""
    if isinstance(pool_l, QuantKV):
        return QuantKV(gather_pages(pool_l.q, page_ids), gather_pages(pool_l.s, page_ids))
    pages = pool_l[page_ids.long()]  # [n, KH, ps, hd]
    n, kh, ps, last = pages.shape
    return pages.transpose(0, 1).reshape(kh, n * ps, last)


def scatter_pages(pool_l, page_ids: torch.Tensor, rows):
    """The inverse of `gather_pages`: ``rows`` [KH, n*ps, hd] written into
    the pages ``page_ids`` [n] of a copy of ``pool_l`` (the JAX function
    returns a new pool; so does this one)."""
    if isinstance(pool_l, QuantKV):
        return QuantKV(scatter_pages(pool_l.q, page_ids, rows.q),
                       scatter_pages(pool_l.s, page_ids, rows.s))
    kh, _, last = rows.shape
    ps = pool_l.shape[2]
    n = page_ids.shape[0]
    out = pool_l.clone()
    out[page_ids.long()] = rows.reshape(kh, n, ps, last).transpose(0, 1).to(pool_l.dtype)
    return out


def paged_view(pool_l, page_ids: torch.Tensor, dtype) -> torch.Tensor:
    """Dense [KH, n*ps, hd] view of the given pages in ``dtype``,
    dequantized when the pool is int8."""
    return dequant_kv(gather_pages(pool_l, page_ids), dtype).to(dtype)


def lane_views(pool_l, page_table: torch.Tensor):
    """Every lane's rows through its page-table row: ``page_table`` [B, nb]
    -> [B, KH, nb*ps, hd] (a QuantKV for an int8 pool), the slab layout the
    attention functions take."""
    if isinstance(pool_l, QuantKV):
        return QuantKV(lane_views(pool_l.q, page_table), lane_views(pool_l.s, page_table))
    pages = pool_l[page_table.long()]  # [B, nb, KH, ps, hd]
    b, nb, kh, ps, last = pages.shape
    return pages.transpose(1, 2).reshape(b, kh, nb * ps, last)


def kv_lane(leaf, lane: int):
    """Lane ``lane`` of an [L, B, ...] slab leaf as an [L, 1, ...] view
    (writes land in the slab; each layer of it is contiguous)."""
    if isinstance(leaf, QuantKV):
        return QuantKV(leaf.q[:, lane : lane + 1], leaf.s[:, lane : lane + 1])
    return leaf[:, lane : lane + 1]


def pages_to_rows(slab, pool, lane: int, row0: int, page_ids: torch.Tensor) -> None:
    """Copy the pool pages ``page_ids`` [n] ([L, P, KH, ps, hd] leaves)
    into ``lane``'s slab rows [row0, row0 + n*ps) ([L, B, KH, S, hd]), in
    page order, in every layer: values and an int8 leaf's scales alike."""
    ids = page_ids.long()
    for dst, src in zip(kv_tensors(slab), kv_tensors(pool)):
        pages = src[:, ids]  # [L, n, KH, ps, last]
        nl, n, kh, ps, last = pages.shape
        dst[:, lane, :, row0 : row0 + n * ps] = pages.transpose(1, 2).reshape(nl, kh, n * ps, last)


def rows_to_pages(slab, pool, lane: int, row0: int, page_ids: torch.Tensor) -> None:
    """The inverse of `pages_to_rows`: ``lane``'s slab rows [row0, row0 +
    n*ps) written into the pool pages ``page_ids`` [n], in place."""
    ids = page_ids.long()
    n = ids.shape[0]
    for src, dst in zip(kv_tensors(slab), kv_tensors(pool)):
        nl, _, kh, ps, last = dst.shape
        rows = src[:, lane, :, row0 : row0 + n * ps]  # [L, KH, n*ps, last]
        dst[:, ids] = rows.reshape(nl, kh, n, ps, last).transpose(1, 2)
