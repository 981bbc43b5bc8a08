"""Paged KV pool helpers: contiguous views of pool pages and their inverse.

Counterpart of the dense half of dllama_tpu/ops/kv_cache.py
(``gather_pages``, ``scatter_pages``, ``paged_view``). A pool leaf is one
layer's pages, [P, KH, ps, hd]; a page list [n] names the pages that back
logical rows [0, n*ps) of one lane, in order. The int8 ``QuantKV`` pool is
not ported yet (ROADMAP A.10), so every leaf here is a dense tensor.
"""

from __future__ import annotations

import torch


def gather_pages(pool_l: torch.Tensor, page_ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``page_ids`` [n] from ``pool_l`` [P, KH, ps, hd] as one
    head-major [KH, n*ps, hd] tensor, in page order."""
    pages = pool_l[page_ids.long()]  # [n, KH, ps, hd]
    n, kh, ps, last = pages.shape
    return pages.transpose(0, 1).reshape(kh, n * ps, last)


def scatter_pages(pool_l: torch.Tensor, page_ids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The inverse of `gather_pages`: ``rows`` [KH, n*ps, hd] written into
    the pages ``page_ids`` [n] of a copy of ``pool_l`` (the JAX function
    returns a new pool; so does this one)."""
    kh, _, last = rows.shape
    ps = pool_l.shape[2]
    n = page_ids.shape[0]
    out = pool_l.clone()
    out[page_ids.long()] = rows.reshape(kh, n, ps, last).transpose(0, 1).to(pool_l.dtype)
    return out


def paged_view(pool_l: torch.Tensor, page_ids: torch.Tensor, dtype) -> torch.Tensor:
    """Dense [KH, n*ps, hd] view of the given pages in ``dtype``."""
    return gather_pages(pool_l, page_ids).to(dtype)


def lane_views(pool_l: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Every lane's rows through its page-table row: ``page_table`` [B, nb]
    -> [B, KH, nb*ps, hd], the slab layout the attention functions take."""
    pages = pool_l[page_table.long()]  # [B, nb, KH, ps, hd]
    b, nb, kh, ps, last = pages.shape
    return pages.transpose(1, 2).reshape(b, kh, nb * ps, last)
