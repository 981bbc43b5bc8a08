"""Paged KV subsystem: fixed-size page pool + radix prefix tree.

``pool``   — host-side page accounting (refcounts, free list, COW forks).
``radix``  — prefix tree over token IDs mapping shared prefixes to page slots.
``manager``— glue between the pool/tree, the engine's device page pool, and
             the lane scheduler (adopt at admission, publish at finish).
"""

from .pool import PagePool, PoolStats
from .radix import MatchResult, RadixTree

__all__ = ["PagePool", "PoolStats", "RadixTree", "MatchResult"]
