"""Tensor-parallel slices of the params and the sequence shards of the KV cache.

Counterpart of dllama_tpu/parallel/sharding.py (``param_spec_tree``,
``cache_specs``), restated for the port's ``[out, in]`` weight layouts.
It is the reference's tensor-parallel design (src/llm.cpp:168-176):

| reference mechanism                       | the port's slice on tp rank r          |
|-------------------------------------------|----------------------------------------|
| sliceRowMatmul on q/k/v, w1/w3, wcls       | ``row``: out rows [r n/tp, (r+1) n/tp)  |
| sliceColMatmul on wo, w2 (partial sums)    | ``col``: in columns [r k/tp, ...), the  |
|                                            | partials all-reduced in f32             |
| sliceKvCache, sliceMultiHeadAtt            | KV heads and query heads of rank r      |
| the embedding (root-only in the reference) | ``vocab``: rows [r V/tp, ...), a masked |
|                                            | lookup summed over tp (JAX's P("tp"))   |
| norms, q_norm/k_norm, RoPE tables          | replicated                              |

A quantized weight slices its parts alike along the same axis: the Q40
scales ``[out, in/32]``, the q40i4 packed nibbles ``[out, in/2]`` and an
int8 weight's group scales ``[out, in/G]`` follow the in axis (the engine
checks that every contraction dim divides by 32 tp, so a column slice
keeps whole blocks). Weights are replicated over sp.

The KV cache of a rank is ``[L/pp, B, KH/tp, S/sp, hd]``, the lanes' slab
``[L/pp, B/dp, KH/tp, (S + pad)/sp, hd]``: a pipeline stage holds its
layers' rows alone, a dp group its own lanes. Under sp their rows are in the JAX
engine's cyclic order: global row g sits on sp shard g % sp at local row
g // sp (dllama_tpu/models/transformer.py ``_attention_sp_merge`` explains
why: a live prefix spreads evenly over the shards). The page pool is
``[L/pp, P, KH/tp, ps, hd]`` on every rank: its pages are not split over
dp, as the JAX pool is replicated over dp.
"""

from __future__ import annotations

from typing import Any

import torch

from ..formats.model_file import LlmHeader
from ..ops.int8_matmul import Int8Weight
from ..ops.quant_matmul import PackedQuantWeight, QuantWeight

# layer weight -> its split (everything not listed is replicated)
LAYER_ROLES = {"wq": "row", "wk": "row", "wv": "row", "w1": "row", "w3": "row",
               "wo": "col", "w2": "col"}
TOP_ROLES = {"wcls": "row", "embed": "vocab"}


def role_of(name: str) -> str | None:
    """The split of a params key (``row``, ``col``, ``vocab``) or None."""
    return TOP_ROLES.get(name) or LAYER_ROLES.get(name)


def _narrow(x: torch.Tensor, dim: int, tp: int, r: int) -> torch.Tensor:
    n = x.shape[dim]
    if n % tp:
        raise ValueError(f"axis {dim} of {tuple(x.shape)} not divisible by tp={tp}")
    return x.narrow(dim, r * (n // tp), n // tp).contiguous()


def shard_tensor(w, role: str | None, tp: int, r: int):
    """Rank r's slice of one leaf: a dense [out, in] (or [V, D]) tensor, or a
    quantized weight whose parts each slice along the role's axis."""
    if role is None or tp == 1:
        return w
    dim = -1 if role == "col" else -2
    if isinstance(w, (QuantWeight, PackedQuantWeight, Int8Weight)):
        return type(w)(*(_narrow(part, dim, tp, r) for part in w))
    return _narrow(w, dim, tp, r)


def shard_params(params: dict, header: LlmHeader, mesh, r: int | None = None) -> dict:
    """A tp rank's params from a whole params dict (`models.loader.load_params`
    or ``params_from_jax``): every leaf sliced by its `role_of`. ``mesh`` is
    the rank's `Mesh` (its tp axis), or the tp size with the rank ``r``."""
    del header  # the roles do not depend on the model beyond its keys
    tp, r = (mesh, r) if isinstance(mesh, int) else (mesh.tp.size, mesh.tp.index)
    out: dict[str, Any] = {k: shard_tensor(v, role_of(k), tp, r)
                           for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: shard_tensor(v, role_of(k), tp, r) for k, v in lp.items()}
                     for lp in params["layers"]]
    return out


def kv_shard_shape(h: LlmHeader, tp: int, sp: int, batch: int = 1, pp: int = 1) -> tuple:
    """A rank's KV cache shape [L/pp, B, KH/tp, S/sp, hd]."""
    return (h.n_layers // pp, batch, h.n_kv_heads // tp, h.seq_len // sp, h.head_dim)


def lane_shard_shape(h: LlmHeader, tp: int, sp: int, batch: int, pad: int, pp: int = 1,
                     dp: int = 1) -> tuple:
    """A rank's shard of the lanes' slab [L/pp, B/dp, KH/tp, (S + pad)/sp,
    hd]: its stage's layers, its dp group's lanes, rows in the cyclic order
    under sp, so ``pad`` (the padding rows parked lanes write, the JAX
    engine's ``_lane_pad``) must divide by sp."""
    if (h.seq_len + pad) % sp:
        raise ValueError(f"the lanes' slab of {h.seq_len} + {pad} rows does not divide by sp={sp}")
    return (h.n_layers // pp, batch // dp, h.n_kv_heads // tp, (h.seq_len + pad) // sp,
            h.head_dim)


def pool_shard_shape(h: LlmHeader, tp: int, n_pages: int, page_size: int, pp: int = 1) -> tuple:
    """A rank's share of the KV page pool [L/pp, P, KH/tp, ps, hd]: its
    stage's layers, the head axis split over tp, the pages whole on every
    rank (the JAX pool's ``P(lead, None, "tp", None, None)``), replicated
    over sp and over dp."""
    return (h.n_layers // pp, n_pages, h.n_kv_heads // tp, page_size, h.head_dim)


def cyclic_rows(pos: int, t: int, sp: int, idx: int) -> tuple[list[int], list[int]]:
    """The rows of a chunk [pos, pos + t) that sp shard ``idx`` owns in the
    cyclic layout: (their chunk indices j, their local rows (pos + j) // sp).
    Any ``pos``: a chunk whose start is not a multiple of sp writes unevenly
    across the shards."""
    first = (idx - pos) % sp
    js = list(range(first, t, sp))
    return js, [(pos + j) // sp for j in js]

