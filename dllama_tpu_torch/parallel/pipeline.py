"""Pipeline parallelism: the decoder's layers split into stages over a ``pp`` axis.

Counterpart of dllama_tpu/parallel/pipeline.py. The reference cannot scale
past ``nNodes <= nKvHeads`` (its only cross-node strategy is tensor
parallelism, bounded by the KV-head count; src/app.cpp:236-240). Pipeline
stages lift that ceiling: stage s holds the contiguous layers
`stage_range` gives it, their weights and their rows of the KV cache, and
hands its ``[B, T, D]`` activation to stage s + 1 (the smallest payload
between ranks of the whole model), so a stage's memory shrinks by pp. A
stage is a tp x sp group of ranks (parallel/mesh.py): each of its ranks
sends its copy of the activation to the rank at the same tp, sp and dp
indices of the next stage.

`forward_pp` follows `models.forward`'s contract. Each rank runs the
stage it holds:

* stage 0 embeds the tokens (the vocab-split lookup summed over tp, as
  `_embed` does); every later stage receives the previous stage's rows;
* each stage runs its layers (``models.transformer._forward_rank`` with
  the stage's params and cache, which hold that range alone) through the
  same slab, slab-lane, tp and sp paths as the flat forward, and sends its
  rows on;
* the last stage's rows reach every stage by a broadcast over pp, and
  every stage computes the logits head (the final ``psum`` over ``pp`` of
  dllama_tpu's body, pipeline.py:300-306), so every rank returns the same
  logits and the same tokens.

Sequence waves (``n_micro`` > 1, the JAX engine's ``_pp_micro``): the
chunk's T rows split into n_micro waves of T / n_micro rows, wave c at
``pos + c T / n_micro``. A stage runs wave c only after it has run (and so
written the KV rows of) waves < c, and its sends do not wait for the next
stage: stage 0 goes on to wave 1 while stage 1 computes wave 0. Sends and
receives between two stages pair in the order they are issued, and every
send is waited on before the forward returns. The kernels see the JAX
engine's shapes: each wave is a chunk of T / n_micro rows.

Left out, because a process runs only the ticks that are valid: the SPMD
bubble (the JAX program runs every stage's layers on every one of its pp +
n_micro - 1 ticks, on pass-through data where the tick is not the stage's,
and select-merges or parks what those ticks write) and ``park_pos`` (where
those invalid ticks write). Here a stage computes its own waves and nothing
else, so neither exists, and the values do not depend on them. Paged
lanes (pool-native mode) raise, as the JAX engine refuses them at pp > 1.
"""

from __future__ import annotations

import torch

from ..formats.model_file import LlmHeader
from ..ops.int8_matmul import quantize_acts
from .collectives import broadcast, stage_recv, stage_send
from .mesh import validate_pp

__all__ = ["forward_pp", "stage_range", "validate_pp"]


def stage_range(h: LlmHeader, pp: int, idx: int) -> range:
    """The layers of stage ``idx`` of ``pp``: the contiguous L / pp from
    ``idx * L / pp`` (`validate_pp` holds L % pp == 0)."""
    validate_pp(h, pp)
    n = h.n_layers // pp
    return range(idx * n, (idx + 1) * n)


def forward_pp(params, h: LlmHeader, tokens: torch.Tensor, pos, cache, mesh,
               logits_mode: str = "all", n_micro: int = 1, plain: bool = False,
               act_quant=quantize_acts, page_table=None, **kw):
    """This rank's stage of a pipeline-parallel forward (module docstring):
    ``params`` and ``cache`` hold the stage's layers alone; ``kw`` are
    `models.forward`'s others (``park``, ``moe_dedup``, ``sync_quant``).
    Returns (logits, or None for ``logits_mode="none"``,
    and the cache), the same logits on every stage."""
    from ..models.transformer import _finish, _forward_rank

    if page_table is not None:
        raise ValueError("kv_native requires pp == 1 and sp == 1")
    if logits_mode not in ("all", "last", "none"):
        raise ValueError(f"unknown logits_mode: {logits_mode!r}")
    pp = mesh.pp
    b, t = tokens.shape
    if n_micro < 1 or t % n_micro:
        raise ValueError(f"T={t} not divisible by n_micro={n_micro}")
    tc = t // n_micro
    first, last = pp.index == 0, pp.index == pp.size - 1
    dtype, device = params["embed"].dtype, tokens.device
    sends, done = [], []
    try:
        for c in range(n_micro):
            x = None if first else stage_recv((b, tc, h.dim), dtype, device, pp)
            # wave c at pos + c tc (an int, or a [1] / [B] tensor): a lane
            # parked at -T stays parked, at or below minus the wave's width
            x, _ = _forward_rank(params, h, tokens[:, c * tc:(c + 1) * tc], pos + c * tc,
                                 cache, logits_mode="hidden", plain=plain, act_quant=act_quant,
                                 mesh=mesh, x_in=x, **kw)
            if not last:
                sends.append(stage_send(x, pp))
            elif logits_mode == "all" or c == n_micro - 1:
                done.append(x)
    finally:
        for s in sends:
            s.wait()
    if logits_mode == "none":
        return None, cache
    # the last stage's rows (the last one for "last") on every stage
    rows = t if logits_mode == "all" else 1
    if last:
        x = torch.cat(done, dim=1) if len(done) > 1 else done[0]
        x = x[:, -rows:].contiguous()
    else:
        x = torch.empty((b, rows, h.dim), dtype=dtype, device=device)
    x = broadcast(x, pp, pp.size - 1)
    return _finish(x, params, h, logits_mode, plain, act_quant, mesh.tp), cache
