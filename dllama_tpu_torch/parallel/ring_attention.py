"""Ring attention: causal attention with the KV sequence sharded over sp ranks.

Counterpart of dllama_tpu/parallel/ring_attention.py. Every sp rank holds
one query shard and one KV shard; in sp steps each rank computes the
online-softmax partial state (acc, m, l) of its queries against the KV
shard it holds, merges it into its running state, and passes the shard
one hop along the ring (rank i to i + 1, `collectives.ring_shift`), so the
shard owned by rank ``idx - step`` arrives next. Causality follows from
absolute positions: a shard from the queries' future contributes nothing,
so the merge is exact. sp - 1 compute-and-shift steps, then one last
compute with no shift (that hop's shard would be dropped).

The local step is `ops.flash_attention.flash_attention_stats` with the
shard's stride: the CUDA kernel on the card, its plain version on the CPU.
A shard of the int8 cache (`QuantKV`) stays int8 on the ring: each hop
sends its int8 values and its f32 row scales (the JAX ring's int8-sized
``ppermute`` payloads, both counted in `collectives.STATS`), and the local
step reads them as they are (the strided stats kernel's ``_q8`` entry).
``cyclic``: the shards hold the cyclic sequence layout (rank i's row j is
global position j * sp + i: ``s_pos0`` = owner, stride sp), else the
contiguous one (``s_pos0`` = owner * shard rows, stride 1).

The merge of two states is the standard log-sum-exp one:
    m' = max(m1, m2); l' = e^{m1-m'} l1 + e^{m2-m'} l2
    acc' = e^{m1-m'} acc1 + e^{m2-m'} acc2
"""

from __future__ import annotations

import torch

from ..ops.flash_attention import flash_attention_stats, flash_attention_stats_ref
from ..ops.kv_cache import QuantKV, kv_rows
from .collectives import all_gather, ring_shift
from .mesh import Axis

_NEG_INF = -1e30


def merge_stats(acc1, m1, l1, acc2, m2, l2):
    """Log-sum-exp merge of two online-softmax partial states; a fully
    masked state (m = -1e30) contributes nothing."""
    m = torch.maximum(m1, m2)
    a1 = torch.where(m1 <= _NEG_INF / 2, torch.zeros_like(m1), torch.exp(m1 - m))
    a2 = torch.where(m2 <= _NEG_INF / 2, torch.zeros_like(m2), torch.exp(m2 - m))
    return acc1 * a1[..., None] + acc2 * a2[..., None], m, l1 * a1 + l2 * a2


def _shift(leaf, axis: Axis):
    """The previous rank's KV shard: a dense one, or a QuantKV's values and
    scales, each by one `ring_shift`."""
    if isinstance(leaf, QuantKV):
        return QuantKV(ring_shift(leaf.q, axis), ring_shift(leaf.s, axis))
    return ring_shift(leaf, axis)


def ring_attention_local(
    q: torch.Tensor,  # [B, Tq, H, hd] this rank's query shard
    k,  # [B, KH, Ss, hd] this rank's KV shard (head-major), contiguous; or a QuantKV
    v,
    q_pos0: int,  # absolute position of this rank's first query
    shard_size: int,  # sequence rows a rank holds in the global layout
    axis: Axis,
    cyclic: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """This rank's ring attention output [B, Tq, H, hd] in q's dtype (every
    rank of the axis calls it together). ``k``/``v`` may hold fewer rows
    than ``shard_size`` (a live prefix: rows past it are in every query's
    future); every rank must pass the same number. ``plain`` takes the
    stats kernel's plain version on any device."""
    sp, idx = axis.size, axis.index
    stride = sp if cyclic else 1
    b, tq, h, hd = q.shape
    g = h // k.shape[1]
    acc = torch.zeros((b, k.shape[1], g, tq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, k.shape[1], g, tq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    owner = idx
    for step in range(sp):
        s_pos0 = owner if cyclic else owner * shard_size
        stats = flash_attention_stats_ref if plain else flash_attention_stats
        acc2, m2, l2 = stats(q, k, v, q_pos0, s_pos0, s_stride=stride)
        acc, m, l = merge_stats(acc, m, l, acc2, m2, l2)
        if step < sp - 1:
            k, v = _shift(k, axis), _shift(v, axis)
            owner = (owner - 1) % sp
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = acc / l_safe[..., None]  # [b, kh, g, tq, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, h, hd).to(q.dtype)


def ring_attention(
    q: torch.Tensor,  # [B, T, H, hd] global queries
    k,  # [B, KH, S, hd] global keys, or a QuantKV
    v,
    axis: Axis,
    q_pos0: int = 0,
    cyclic: bool = False,
) -> torch.Tensor:
    """Driver over whole tensors: this rank's query shard (contiguous, T/sp
    rows) and KV shard (contiguous or cyclic) go through the ring, and the
    outputs come back gathered over the axis, [B, T, H, hd] (JAX's
    ``ring_attention``). Needs T % sp == 0 and S % sp == 0."""
    sp, idx = axis.size, axis.index
    t, s = q.shape[1], k.shape[2]
    if t % sp or s % sp:
        raise ValueError(f"T={t} and S={s} must divide by sp={sp}")
    tq, shard = t // sp, s // sp
    rows = torch.arange(idx, s, sp) if cyclic else torch.arange(idx * shard, (idx + 1) * shard)
    kk, vv = kv_rows(k, rows.to(q.device)), kv_rows(v, rows.to(q.device))
    out = ring_attention_local(q[:, idx * tq:(idx + 1) * tq].contiguous(), kk, vv,
                               q_pos0 + idx * tq, shard, axis, cyclic)
    return all_gather(out, axis, dim=1)
