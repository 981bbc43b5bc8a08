"""Qwen3-MoE expert FFN: routing, the plain version and the CUDA kernel wrappers.

Counterpart of dllama_tpu/ops/moe_kernel.py and of the routing in
dllama_tpu/models/transformer.py (``_moe_route``). Each token's FFN output
is a routing-weighted sum over its k selected experts of a SwiGLU:

    out[t] = sum_j w[t, j] * W2[e] (silu(W1[e] x[t]) * (W3[e] x[t])),  e = top_i[t, j]

Expert layout: the `.m` file's own rows, stacked over experts, so a row of
a GEMV is contiguous as in `q40_matmul`:

    Q40   w1, w3: QuantWeight(q int8 [E, F, D], d f16 [E, F, D/32])
          w2:     QuantWeight(q int8 [E, D, F], d f16 [E, D, F/32])
    dense w1, w3 [E, F, D] and w2 [E, D, F] in the activation dtype

Four kernels, one function: ``moe_active_experts`` / ``_q40``
(csrc/moe_active.cu) serve decode-sized batches (B*T <= 16,
`MOE_KERNEL_MAX_TOKENS`), one pass per (token, choice);
``moe_grouped_experts`` / ``_q40`` (csrc/moe_grouped.cu) serve prefill,
with the assignments sorted by expert into row tiles (`grouped_schedule`)
so that each expert's weights stream once per tile, not once per token.
`moe_experts_ref` is the plain version of all four.

Numerics, for kernels and plain version alike (the rules of `qmatmul`):
the activation dtype decides the roundings. W is formed exactly in f32 and
rounded to x's dtype; products and sums are f32; the SwiGLU hidden is
rounded to x's dtype before the down projection (the TPU kernels'
``hidden.astype(x.dtype)``); the routing weight is applied in f32 and the
output is f32. So bfloat16 runs round where the TPU kernels round, and
float32 runs round nowhere, as the JAX package's CPU paths (``_moe_ffn``,
``_moe_ffn_gather``) do. The grouped TPU kernels cast x to bf16 even for
f32 inputs; the port deliberately does not, so that f32 stays the
exactness oracle for the kernels.

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise. Each wrapper counts its launches in ``.launches``. The wrappers
check dtypes and shapes; the expert ids in ``top_i`` must lie in [0, E),
which the card does not check (that would read them back to the host;
``moe_route`` yields only such ids).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .quant_matmul import Q_BLOCK, QuantWeight, dequant

# Largest B*T routed through the active-experts kernels (the JAX
# transformer's MOE_PALLAS_MAX_TOKENS); larger batches take the grouped ones.
MOE_KERNEL_MAX_TOKENS = 16
GROUP_ROWS = 32  # row tile of the grouped kernels (csrc/moe_grouped.cu R)


def moe_route(x: torch.Tensor, gate: torch.Tensor, n_active: int):
    """Gate routing: f32 logits x @ gate^T over all E experts, softmax,
    top-k, weights renormalized to sum 1 (reference:
    src/nn/nn-cpu-ops.cpp:1462-1492, normTopk = 1). ``x`` [..., D], ``gate``
    [E, D]; returns (top_i int32 [..., k], weights f32 [..., k])."""
    logits = torch.matmul(x.float(), gate.float().transpose(-1, -2))
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, n_active, dim=-1)
    return top_i.to(torch.int32), top_p / top_p.sum(dim=-1, keepdim=True)


def _expert(w, e: int, dtype) -> torch.Tensor:
    """Expert ``e`` of a stacked weight as f32 [rows, cols], its values
    rounded to ``dtype``."""
    if isinstance(w, QuantWeight):
        dense = dequant(QuantWeight(w.q[e], w.d[e]), torch.float32)
    else:
        dense = w[e].float()
    return dense.to(dtype).float()


def moe_experts_ref(x, w1, w2, w3, top_i, weights) -> torch.Tensor:
    """Plain version of the four kernels: x [n, D] -> f32 [n, D]. Loops over
    the experts present and runs dense products on the rows routed to each
    (never one expert's weights per assignment)."""
    n, d = x.shape
    k = top_i.shape[1]
    xf = x.float()
    out = torch.zeros((n, k, d), dtype=torch.float32, device=x.device)
    flat = top_i.reshape(-1).long()
    for e in torch.unique(flat).tolist():
        rows = (flat == e).nonzero().squeeze(1)
        t, j = rows // k, rows % k
        xe = xf[t]
        h1 = xe @ _expert(w1, e, x.dtype).t()
        h3 = xe @ _expert(w3, e, x.dtype).t()
        hidden = ((h1 / (1.0 + torch.exp(-h1))) * h3).to(x.dtype).float()
        out[t, j] = (hidden @ _expert(w2, e, x.dtype).t()) * weights[t, j].float()[:, None]
    return out.sum(dim=1)


def _check(name: str, quant: bool, x, w1, w2, w3, top_i, weights) -> tuple[int, int, int]:
    """Validate the operands of a wrapper; returns (E, F, k)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: takes float32 or bfloat16 activations, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [n, D], got {tuple(x.shape)}")
    n, d = x.shape
    ws = (w1, w2, w3)
    if quant:
        if not all(isinstance(w, QuantWeight) for w in ws):
            raise TypeError(f"{name}: experts must be QuantWeight")
        if any(w.q.dtype != torch.int8 or w.d.dtype != torch.float16 for w in ws):
            raise TypeError(f"{name}: Q40 experts are int8 values + f16 scales")
        shapes = [w.q.shape for w in ws]
    else:
        if any(isinstance(w, QuantWeight) or w.dtype != x.dtype for w in ws):
            raise TypeError(f"{name}: dense experts must be tensors in x's dtype {x.dtype}")
        shapes = [w.shape for w in ws]
    if any(len(s) != 3 for s in shapes):
        raise ValueError(f"{name}: experts must be stacked [E, rows, cols]")
    e, f, d1 = shapes[0]
    if shapes[2] != (e, f, d) or d1 != d or shapes[1] != (e, d, f):
        raise ValueError(
            f"{name}: experts {[tuple(s) for s in shapes]} do not take x {tuple(x.shape)}"
            " (w1/w3 [E, F, D], w2 [E, D, F])"
        )
    if quant and (
        w1.d.shape != (e, f, d // Q_BLOCK)
        or w3.d.shape != (e, f, d // Q_BLOCK)
        or w2.d.shape != (e, d, f // Q_BLOCK)
    ):
        raise ValueError(f"{name}: Q40 scales must be [E, rows, cols / 32]")
    if d % Q_BLOCK or f % Q_BLOCK:
        raise ValueError(f"{name}: D {d} and F {f} must be multiples of {Q_BLOCK}")
    if top_i.dim() != 2 or top_i.shape[0] != n or weights.shape != top_i.shape:
        raise ValueError(f"{name}: top_i and weights must both be [n, k] for n = {n}")
    if top_i.dtype not in (torch.int32, torch.int64) or not weights.dtype.is_floating_point:
        raise TypeError(f"{name}: top_i must be int32/int64 and weights floating")
    if top_i.device != x.device or weights.device != x.device:
        raise ValueError(f"{name}: top_i and weights must be on x's device {x.device}")
    return e, f, top_i.shape[1]


def _pointers(quant: bool, *ws) -> list:
    """(values, scales) pointers of each expert weight; no scales for dense."""
    out = []
    for w in ws:
        ts = (w.q, w.d) if quant else (w,)
        for t in ts:
            if not t.is_cuda or not t.is_contiguous():
                raise ValueError("MoE experts must be contiguous CUDA tensors")
        out += [w.q.data_ptr(), w.d.data_ptr()] if quant else [w.data_ptr(), None]
    return out


def _active(fn, quant: bool, x, w1, w2, w3, top_i, weights) -> torch.Tensor:
    """Shared body of the two active-experts wrappers (``fn`` counts)."""
    _, f, k = _check(fn.__name__, quant, x, w1, w2, w3, top_i, weights)
    if x.device.type == "cpu":
        return moe_experts_ref(x, w1, w2, w3, top_i, weights)
    n, d = x.shape
    x = x.contiguous()
    ti = top_i.to(torch.int32).contiguous()
    wt = weights.float().contiguous()
    hidden = torch.empty((n, k, f), dtype=torch.float32, device=x.device)
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    if n:
        code = _build.load("moe_active")(
            x.data_ptr(), *_pointers(quant, w1, w3, w2), ti.data_ptr(), wt.data_ptr(),
            hidden.data_ptr(), out.data_ptr(), n, k, d, f,
            int(x.dtype == torch.bfloat16), int(quant), _build.stream(x.device),
        )
        _build.check(code, fn.__name__)
        fn.launches += 1
    return out


def moe_active_experts(x, w1, w2, w3, top_i, weights) -> torch.Tensor:
    """Decode MoE over dense experts; x [n, D] (n <= 16 on the main path),
    top_i/weights [n, k] -> f32 [n, D]. CUDA: csrc/moe_active.cu."""
    return _active(moe_active_experts, False, x, w1, w2, w3, top_i, weights)


def moe_active_experts_q40(x, w1, w2, w3, top_i, weights) -> torch.Tensor:
    """`moe_active_experts` over Q40 experts (QuantWeight)."""
    return _active(moe_active_experts_q40, True, x, w1, w2, w3, top_i, weights)


moe_active_experts.launches = 0
moe_active_experts_q40.launches = 0


class GroupedSchedule(NamedTuple):
    """Assignments (token t, choice j) sorted by expert into row tiles of
    `GROUP_ROWS`; each expert's segment starts on a tile boundary, so every
    tile belongs to one expert. Sizes depend on the shapes alone: at most
    ceil(A/R) + min(E, A) tiles for A = n * k assignments."""

    row_token: torch.Tensor  # int32 [max_tiles * R]: token of each row, -1 = padding
    row_weight: torch.Tensor  # f32 [max_tiles * R]: routing weight, 0 for padding
    tile_expert: torch.Tensor  # int32 [max_tiles]: expert of each tile (E past the end)
    n_tiles: torch.Tensor  # int32 [1]: tiles in use, on the device
    inv: torch.Tensor  # int64 [A]: row of assignment t * k + j


def grouped_schedule(top_i: torch.Tensor, weights: torch.Tensor, n_experts: int) -> GroupedSchedule:
    """The grouped kernels' schedule, in torch ops on top_i's device and with
    no host readback (the JAX ``_grouped_schedule`` is jnp outside the
    kernel too). Counts use ``scatter_add_``: ``bincount`` on CUDA reads
    the largest id back to the host."""
    n, k = top_i.shape
    a, rows = n * k, GROUP_ROWS
    dev = top_i.device
    flat_e = top_i.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    tiles = (counts + rows - 1) // rows
    tile_end = torch.cumsum(tiles, 0)
    e_sorted = flat_e[order]
    rank = torch.arange(a, device=dev) - (torch.cumsum(counts, 0) - counts)[e_sorted]
    row_sorted = (tile_end - tiles)[e_sorted] * rows + rank
    max_tiles = -(-a // rows) + min(n_experts, a)
    row_token = torch.full((max_tiles * rows,), -1, dtype=torch.int32, device=dev)
    row_token[row_sorted] = (order // k).to(torch.int32)
    row_weight = torch.zeros(max_tiles * rows, dtype=torch.float32, device=dev)
    row_weight[row_sorted] = weights.reshape(-1).float()[order]
    inv = torch.empty(a, dtype=torch.int64, device=dev)
    inv[order] = row_sorted
    tile_expert = torch.searchsorted(
        tile_end, torch.arange(max_tiles, device=dev), right=True
    ).to(torch.int32)
    return GroupedSchedule(row_token, row_weight, tile_expert, tile_end[-1:].to(torch.int32), inv)


def _grouped(fn, quant: bool, x, w1, w2, w3, top_i, weights) -> torch.Tensor:
    """Shared body of the two grouped wrappers (``fn`` counts)."""
    e, f, k = _check(fn.__name__, quant, x, w1, w2, w3, top_i, weights)
    if x.device.type == "cpu":
        return moe_experts_ref(x, w1, w2, w3, top_i, weights)
    n, d = x.shape
    if not n:
        return torch.zeros((0, d), dtype=torch.float32, device=x.device)
    x = x.contiguous()
    s = grouped_schedule(top_i, weights, e)
    max_tiles = s.tile_expert.shape[0]
    hidden = torch.empty((max_tiles * GROUP_ROWS, f), dtype=torch.float32, device=x.device)
    out_rows = torch.empty((max_tiles * GROUP_ROWS, d), dtype=torch.float32, device=x.device)
    code = _build.load("moe_grouped")(
        x.data_ptr(), *_pointers(quant, w1, w3, w2), s.row_token.data_ptr(),
        s.row_weight.data_ptr(), s.tile_expert.data_ptr(), s.n_tiles.data_ptr(),
        hidden.data_ptr(), out_rows.data_ptr(), max_tiles, d, f,
        int(x.dtype == torch.bfloat16), int(quant), _build.stream(x.device),
    )
    _build.check(code, fn.__name__)
    fn.launches += 1
    # the combine back to tokens, outside the kernel as in JAX (.at[t].add),
    # by the inverse permutation: deterministic, where index_add_ is not
    return out_rows[s.inv].view(n, k, d).sum(dim=1)


def moe_grouped_experts(x, w1, w2, w3, top_i, weights) -> torch.Tensor:
    """Prefill MoE over dense experts; x [n, D], top_i/weights [n, k] ->
    f32 [n, D]. CUDA: csrc/moe_grouped.cu over `grouped_schedule`."""
    return _grouped(moe_grouped_experts, False, x, w1, w2, w3, top_i, weights)


def moe_grouped_experts_q40(x, w1, w2, w3, top_i, weights) -> torch.Tensor:
    """`moe_grouped_experts` over Q40 experts (QuantWeight)."""
    return _grouped(moe_grouped_experts_q40, True, x, w1, w2, w3, top_i, weights)


moe_grouped_experts.launches = 0
moe_grouped_experts_q40.launches = 0
