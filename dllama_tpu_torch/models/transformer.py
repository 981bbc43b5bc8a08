"""Decoder forward pass for Llama / Qwen3 / Qwen3-MoE in PyTorch.

Counterpart of dllama_tpu/models/transformer.py for one device. The layer
walk is the same (reference: src/llm.cpp:263-557):

    x += wo(attn(rope(q), rope(k), v))  over rms_norm(x), [qk-norm for Qwen3]
    x += w2(act(w1(y)) * w3(y))          over y = rms_norm(x)
    logits = rms_norm(x) @ wcls

with a Python loop over layers in place of ``lax.scan``. Params are a dict:
``embed`` [V, D], ``wcls``, ``final_norm``, ``rope_cos``/``rope_sin``
[S, hd/2] f32, and ``layers``, a list of per-layer dicts. Matmul weights
are ``QuantWeight`` (q40), ``PackedQuantWeight`` (q40i4) or ``Int8Weight``
(q40i8), each with its CUDA kernel on the card, or dense [out, in]
tensors. The KV cache is head-major, [L, B, KH, S, hd], and is updated in
place (JAX returns a new cache; the port writes the rows where they go).
With ``torch.int8`` (``--kv-dtype int8``) each leaf is a `QuantKV`: int8
values and one f32 scale a row [L, B, KH, S, 1]. A chunk's new rows are
quantized once (`quantize_kv_rows`) and values and scales written by the
same index ops; the attention kernels read the int8 planes and the scales
as they are stored (ops/flash_attention.py).
Qwen3-MoE layers hold ``moe_gate`` [E, D] f32 and stacked experts
``w1``/``w3`` [E, F, D] and ``w2`` [E, D, F] in place of the dense FFN.

A Qwen3-MoE layer's FFN routes each row of y to its top-k experts
(``moe_route``, plain torch as in JAX) and sums their SwiGLUs: batches of
B*T <= 16 rows (decode, and the 8-row prefill bucket) through the
active-experts kernel, larger ones through the grouped kernel, Q40 or
dense by the expert leaves' type (ops/moe.py). With ``moe_dedup`` a batch
of 2..16 rows runs the two-tier decode: the grouped kernel under a cap of
(n * k) // 2 expert segments when the rows share that few experts, the
active-experts kernel otherwise, chosen on the device (`moe_decode_tiers`).

Attention: chunks of T > 1 go through the prefill stats kernel, T = 1
through the decode kernel, which reads rows 0..pos only — so the port
needs no attention windows. ``plain=True`` runs the plain PyTorch version
of every kernel instead, on any device: the on-card reference the kernel
path is held against; the engine never sets it.

Pipeline stages (``mesh`` with pp > 1): `forward` hands the call to
parallel/pipeline.forward_pp, which runs this rank's stage, a contiguous
range of the layers whose params and cache are all the rank holds, through
`_forward_rank` on each sequence wave with ``x_in`` (the previous stage's
hidden rows in place of the embedding) and ``logits_mode="hidden"`` (the
stage's hidden rows in place of the logits).

Tensor and sequence parallelism (``mesh``: one rank of a tp x sp mesh,
parallel/mesh.py): the rank's weight slices, the tp all-reduces in f32
before any downcast, the logits gathered over tp. Under tp alone
every path below runs on the rank's KV heads. Under sp the single stream's
slab (and one lane's prefill chunk at a host position) runs
`forward_parallel`: its KV shard's rows in the cyclic order, ring attention
for a prefill chunk and merged stats for a decode step (the two kernel
options ``s_stride`` and `flash_decode_stats`, dense or int8); slab lanes run
`_forward_sp_lanes` (merged stats a lane); the page pool raises, as the JAX
engine's does. A Qwen3-MoE layer runs `moe_ffn` on the rank's F/tp expert
slices in every path, its f32 partials all-reduced over tp.

``pos`` is an int or a device tensor: ``[1]`` int32 on the slab path,
``[B]`` int32 in paged mode and for slab lanes. An int is bounds-checked on
the host and then filled into a tensor, so both forms run the same device
code and give the same bits; a tensor is not checked (a CUDA graph replays
with whatever position its static buffer holds, so the engine checks before
a replay). RoPE rows are gathered by index and the slab K/V rows written by
``index_copy_`` along the row axis, so no position is baked into the
launches.

Slab lanes (``park`` given): the cache is the lanes' slab [L, B, KH, S +
pad, hd] and ``pos`` is [B], a position a lane. Lane b's RoPE rows and its
K/V rows are its own (pos[b] + i); a parked lane (pos < 0) writes its T rows
into the padding rows ``park + i`` (``park`` = seq_len, the first padding
row, as the JAX engine's ``_park``), which no live lane reads (every live
row is < seq_len), and reads nothing at a position <= -T (-1 for a decode
step). The slab attention entries take the per-lane positions as they are.

Paged mode (``page_table`` given): the cache is the shared page pool,
``k``/``v`` [L, P, KH, ps, hd], and lane b's logical row r lives in pool
page ``page_table[b, r // ps]`` at page row ``r % ps``. RoPE rows are
gathered per lane,
the new K/V rows are written by device index ops at their pages, and
attention reads through the page table: the paged decode kernel at T = 1,
the paged stats kernel for chunks. A lane at a negative position is
parked: all T of its rows land on the scratch page 0, and at a position
<= -T (-1 for a decode step) it reads nothing either, so a
fixed batch of lanes runs whatever number of them is live (every row of a
batch goes through the same shapes, so a lane's values do not depend on
the others). The JAX engine gathers the pages into a slab view instead
(dllama_tpu/runtime/engine.py ``_paged_gather``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..device import resolve_device
from ..formats.model_file import HiddenAct, LlmArch, LlmHeader, RopeType
from ..ops.flash_attention import (
    flash_attention,
    flash_attention_ref,
    flash_attention_stats,
    flash_attention_stats_ref,
    flash_decode,
    flash_decode_ref,
    flash_decode_stats,
    flash_decode_stats_ref,
    paged_flash_attention,
    paged_flash_attention_ref,
    paged_flash_decode,
    paged_flash_decode_ref,
)
from ..ops.moe import (
    MOE_KERNEL_MAX_TOKENS,
    dedup_cap,
    moe_active_experts,
    moe_active_experts_q40,
    moe_decode_tiers,
    moe_experts_ref,
    moe_grouped_experts,
    moe_grouped_experts_q40,
    moe_route,
)
from ..ops.int8_matmul import Int8Weight, i8matmul, i8matmul_ref, quantize_acts
from ..ops.kv_cache import QuantKV, kv_layer, kv_rows, new_kv_leaf, quantize_kv_rows
from ..ops.quant_matmul import PackedQuantWeight, QuantWeight, qmatmul, qmatmul_i4, qmatmul_ref
from ..ops.torch_ops import apply_rope, gelu, qk_rms_norm, rms_norm, silu
from ..parallel.collectives import all_gather, all_reduce, all_reduce_max
from ..parallel.ring_attention import ring_attention_local
from ..parallel.sharding import cyclic_rows

Params = Dict[str, Any]
KvCache = Dict[str, torch.Tensor]


def init_kv_cache(
    h: LlmHeader, batch_size: int, dtype=torch.float32, seq_len: int | None = None, device=None
) -> KvCache:
    """Zeroed head-major KV cache [L, B, KH, S, hd] on ``device`` (default
    ``cuda``; reference: per-layer k/v buffers, src/llm.cpp:260-261).
    ``torch.int8`` gives QuantKV leaves with scales of ones."""
    device = resolve_device(device)
    shape = (h.n_layers, batch_size, h.n_kv_heads, seq_len or h.seq_len, h.head_dim)
    return {name: new_kv_leaf(shape, dtype, device) for name in ("k", "v")}


def _append(cache_l, val: torch.Tensor, write) -> None:
    """Write a chunk's rows ``val`` into a cache leaf through ``write(dst,
    rows)``: an int8 leaf quantizes them once (one scale a row) and takes
    values and scales through the same writer (JAX's ``_cache_append``)."""
    if isinstance(cache_l, QuantKV):
        qv, sv = quantize_kv_rows(val)
        write(cache_l.q, qv)
        write(cache_l.s, sv)
    else:
        write(cache_l, val.to(cache_l.dtype))


# Q40 weight type -> (kernel wrapper, plain version), both -> f32
_Q40_MATMULS = {
    QuantWeight: (qmatmul, qmatmul_ref),
    PackedQuantWeight: (qmatmul_i4, qmatmul_ref),
}


def _quant_mm(x: torch.Tensor, w, plain: bool, act_quant) -> torch.Tensor | None:
    """f32 x @ W^T through the weight type's kernel (or its plain version),
    None for a dense weight. An Int8Weight's activations come from
    ``act_quant`` (see `forward`)."""
    if isinstance(w, Int8Weight):
        return (i8matmul_ref if plain else i8matmul)(x, w, act_quant)
    pair = _Q40_MATMULS.get(type(w))
    if pair is None:
        return None
    kernel, ref = pair
    return (ref if plain else kernel)(x, w)


def _dense_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ W^T -> f32 for a dense [out, in] weight. A bf16 or f16
    pair on the card is one product with an f32 output (cuBLAS accumulates
    in f32), so no f32 copy of the weight is made; otherwise both operands
    in f32."""
    if x.is_cuda and x.dtype == w.dtype and w.dtype in (torch.bfloat16, torch.float16):
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[0])
    return torch.matmul(x.float(), w.float().transpose(-1, -2))


def _mm(x: torch.Tensor, w, plain: bool, act_quant) -> torch.Tensor:
    """x [..., in] @ W -> [..., out] in x's dtype: the weight type's kernel
    for a quantized leaf, a dense product for an [out, in] tensor."""
    out = _quant_mm(x, w, plain, act_quant)
    if out is not None:
        return out.to(x.dtype)
    return torch.matmul(x, w.transpose(-1, -2))


def moe_ffn(y: torch.Tensor, lp: Params, h: LlmHeader, plain: bool,
            dedup: bool = False, tp=None, sync_quant: bool = False) -> torch.Tensor:
    """Qwen3-MoE FFN of y [B, T, D] -> [B, T, D] in y's dtype (reference:
    src/llm.cpp:425-499; JAX: transformer.py _moe_ffn_pallas /
    _moe_ffn_grouped). With ``dedup`` a decode-sized batch of more than one
    row runs the two tiers (ops/moe.py `moe_decode_tiers`, cap (n * k) // 2).

    Under tp (``tp`` the mesh's axis) the experts are the rank's F/tp
    slices (models/loader.py): every rank routes the same rows once, runs
    the kernel the one-card path picks on its slices, and the f32 partial
    outputs are summed over tp (in q80 with ``sync_quant``) before the cast
    to y's dtype, as JAX's ``psum_maybe_quantized(run(...)).astype(x.dtype)``
    in its ``shard_map`` branches. Every rank routes alike, so every rank
    takes the same tier and launches the same kernels."""
    b, t, d = y.shape
    n = b * t
    yf = y.reshape(n, d)
    top_i, weights = moe_route(yf, lp["moe_gate"], h.n_active_experts)
    quant = isinstance(lp["w1"], QuantWeight)
    args = (yf, lp["w1"], lp["w2"], lp["w3"], top_i, weights)
    cap = dedup_cap(n, h.n_active_experts, dedup)
    if plain:
        out = moe_experts_ref(*args)
    elif n <= MOE_KERNEL_MAX_TOKENS:
        out = (moe_decode_tiers(*args, cap) if cap else
               (moe_active_experts_q40 if quant else moe_active_experts)(*args))
    else:
        out = (moe_grouped_experts_q40 if quant else moe_grouped_experts)(*args)
    if tp is not None and tp.size > 1:
        out = all_reduce(out, tp, sync_quant)
    return out.reshape(b, t, d).to(y.dtype)


def logits_head(x: torch.Tensor, params: Params, h: LlmHeader, logits_mode: str, plain=False,
                act_quant=quantize_acts):
    """Final norm + vocab matmul, f32 logits (reference: src/llm.cpp:560-599).
    ``logits_mode="last"`` computes the last chunk row only, ``"none"``
    nothing (a prefill chunk that only fills the cache)."""
    if logits_mode not in ("all", "last", "none"):
        raise ValueError(f"unknown logits_mode: {logits_mode!r}")
    if logits_mode == "none":
        return None
    if logits_mode == "last":
        x = x[:, -1:, :]
    y = rms_norm(x, params["final_norm"], h.norm_epsilon)
    wcls = params["wcls"]
    out = _quant_mm(y, wcls, plain, act_quant)
    return out if out is not None else _dense_f32(y, wcls)


def _layers(params: Params, h: LlmHeader, x: torch.Tensor, cos, sin, cache: KvCache, attend,
            mm, mm_out, ffn=None) -> torch.Tensor:
    """The decoder layers on x [B, T, D] (reference: src/llm.cpp:330-559),
    shared by `forward` and `forward_parallel`, which differ in what they
    pass: ``attend(k_cache, v_cache, q, k, v) -> z [B, T, H, hd]`` writes
    the chunk's k/v rows into one layer's cache leaves and attends over
    them; ``mm_out`` computes the wo and w2 products (their tp all-reduce);
    ``ffn(y, lp)``, when given, replaces the dense SwiGLU (Qwen3-MoE). The
    head counts are the weights' own (the rank's under tp)."""
    b, t = x.shape[:2]
    hd = h.head_dim
    interleaved = h.rope_type in (RopeType.LLAMA, RopeType.LLAMA3_1)
    act = silu if h.hidden_act == HiddenAct.SILU else gelu
    is_qwen3 = h.arch in (LlmArch.QWEN3, LlmArch.QWEN3_MOE)
    for l, lp in enumerate(params["layers"]):
        y = rms_norm(x, lp["att_norm"], h.norm_epsilon)
        q = mm(y, lp["wq"]).reshape(b, t, -1, hd)
        k = mm(y, lp["wk"]).reshape(b, t, -1, hd)
        v = mm(y, lp["wv"]).reshape(b, t, -1, hd)
        if is_qwen3:
            q = qk_rms_norm(q, lp["q_norm"], h.norm_epsilon)
            k = qk_rms_norm(k, lp["k_norm"], h.norm_epsilon)
        q = apply_rope(q, cos, sin, interleaved)
        k = apply_rope(k, cos, sin, interleaved)
        # [B, KH, S, hd] or [P, KH, ps, hd] (values and scales for int8)
        z = attend(kv_layer(cache["k"], l), kv_layer(cache["v"], l), q, k, v)
        x = x + mm_out(z.reshape(b, t, -1), lp["wo"]).to(x.dtype)

        y = rms_norm(x, lp["ffn_norm"], h.norm_epsilon)
        if ffn is not None:
            f = ffn(y, lp)
        else:
            d = act(mm(y, lp["w1"]))
            u = mm(y, lp["w3"])
            f = mm_out(d * u.to(d.dtype), lp["w2"])
        x = x + f.to(x.dtype)
    return x


def _paged_rows(pos, b: int, t: int, ps: int, page_table: torch.Tensor):
    """Positions [B] int32 and, for each chunk row, its RoPE row and the
    pool page and page row it is written to ([B, T] each). Every row of a
    parked lane (pos < 0) writes to page 0, row 0: at T > 1 a lane parked
    at -1 would otherwise write its rows 0..T-2 into the pages its
    page-table row names (at T = 1 the two rules agree)."""
    dev = page_table.device
    if isinstance(pos, int):
        n_rows = page_table.shape[1] * ps
        if pos < 0 or pos + t > n_rows:
            raise ValueError(f"chunk [{pos}, {pos + t}) outside the page table's {n_rows} rows")
        posv = torch.full((b,), pos, dtype=torch.int32, device=dev)
    else:
        posv = pos.to(device=dev, dtype=torch.int32).reshape(b)
    rows = posv[:, None].long() + torch.arange(t, device=dev)[None, :]
    live = posv[:, None] >= 0
    rows = rows.clamp(min=0)
    page = torch.where(live, page_table.long().gather(1, rows // ps), 0)
    prow = torch.where(live, rows % ps, 0)
    return posv, rows, page, prow


def _lane_slab_rows(pos, b: int, t: int, park: int, device):
    """Slab lanes: positions [B] int32, each chunk row's RoPE row and the
    slab row it is written to ([B, T] each). A parked lane (pos < 0) writes
    to the padding rows park .. park + T - 1; its RoPE rows are row 0's."""
    if isinstance(pos, int):
        if pos < 0 or pos + t > park:
            raise ValueError(f"chunk [{pos}, {pos + t}) outside the lanes' {park} rows")
        posv = torch.full((b,), pos, dtype=torch.int32, device=device)
    else:
        posv = pos.to(device=device, dtype=torch.int32).reshape(b)
    step = torch.arange(t, device=device)[None, :]
    rows = posv[:, None].long() + step
    live = posv[:, None] >= 0
    return posv, rows.clamp(min=0), torch.where(live, rows, park + step)


def _slab_pos(pos, t: int, s: int, device) -> torch.Tensor:
    """The slab path's position as int32 [1] on ``device``; an int is
    bounds-checked first (a write past the cache would drop rows)."""
    if not torch.is_tensor(pos):
        pos = int(pos)
        if pos < 0 or pos + t > s:
            raise ValueError(f"chunk [{pos}, {pos + t}) outside the cache of {s} rows")
        return torch.full((1,), pos, dtype=torch.int32, device=device)
    return pos.to(device=device, dtype=torch.int32).reshape(1)


def forward(
    params: Params,
    h: LlmHeader,
    tokens: torch.Tensor,  # [B, T] int
    pos,  # absolute position of tokens[:, 0]: an int, or int32 [1] (slab) / [B] (paged)
    cache: KvCache,
    logits_mode: str = "all",
    plain: bool = False,
    act_quant=quantize_acts,
    page_table: torch.Tensor | None = None,  # [B, n_blocks] int32: paged mode
    park: int | None = None,  # slab lanes: the first padding row (seq_len)
    moe_dedup: bool = False,  # Qwen3-MoE: the two-tier decode (`moe_ffn`)
    mesh=None,  # parallel.mesh.Mesh: this rank's slices under tp and sp, its stage under pp
    sync_quant: bool = False,  # with mesh: the tp all-reduces in q80
    n_micro: int = 1,  # with a mesh of pp > 1: the sequence waves of the chunk
):
    """Run the decoder on T tokens at ``pos``; the cache rows [pos, pos+T)
    are written in place. Returns (logits [B, T or 1, V] f32, or None for
    ``logits_mode="none"``, and the cache). Under pp > 1 this rank's stage
    (parallel/pipeline.forward_pp); otherwise `_forward_rank`."""
    kw = dict(logits_mode=logits_mode, plain=plain, act_quant=act_quant, page_table=page_table,
              park=park, moe_dedup=moe_dedup, mesh=mesh, sync_quant=sync_quant)
    if mesh is not None and mesh.pp.size > 1:
        from ..parallel.pipeline import forward_pp

        return forward_pp(params, h, tokens, pos, cache, n_micro=n_micro, **kw)
    return _forward_rank(params, h, tokens, pos, cache, **kw)


def _forward_rank(
    params: Params,
    h: LlmHeader,
    tokens: torch.Tensor,
    pos,
    cache: KvCache,
    logits_mode: str = "all",
    plain: bool = False,
    act_quant=quantize_acts,
    page_table: torch.Tensor | None = None,
    park: int | None = None,
    moe_dedup: bool = False,
    mesh=None,
    sync_quant: bool = False,
    x_in: torch.Tensor | None = None,
):
    """`forward` on this rank's layers (all of them, or its pipeline
    stage's). ``x_in`` [B, T, D]: the hidden rows to start from in place of
    the tokens' embedding (a later stage); ``logits_mode="hidden"`` returns
    the last layer's hidden rows [B, T, D] in place of the logits (`_finish`).

    ``act_quant(x [n, k], group) -> (xq, sx)`` quantizes the activations of
    every int8 matmul (q40i8), in the order of the calls. The default is
    `quantize_acts`; a caller that holds one run to another can hand both
    the same int8 activations (chip_smoke.py's parity check).

    With ``page_table`` the cache is the page pool, with ``park`` the
    lanes' slab (module docstring); the caller keeps every live row inside
    the lane's page-table row or below ``park`` (the card checks neither).
    With ``mesh`` the params and the cache are this rank's slices
    (`forward_parallel`)."""
    tp = None
    if mesh is not None:
        if mesh.sp.size > 1:
            if page_table is not None:
                raise ValueError("kv_native requires pp == 1 and sp == 1")
            if park is None or not torch.is_tensor(pos):
                # the single stream, or one lane's chunk on its own rows at
                # a host position: the ring
                return forward_parallel(params, h, tokens, pos, cache, mesh, logits_mode, plain,
                                        act_quant, sync_quant, x_in, moe_dedup)
            return _forward_sp_lanes(params, h, tokens, pos, cache, park, mesh, logits_mode,
                                     plain, act_quant, sync_quant, x_in, moe_dedup)
        tp = mesh.tp
    b, t = tokens.shape
    paged = page_table is not None
    lanes = park is not None
    if paged:
        posv, rows, page, prow = _paged_rows(pos, b, t, cache["k"].shape[3], page_table)
        attn = (paged_flash_decode_ref if plain else paged_flash_decode) if t == 1 else (
            paged_flash_attention_ref if plain else paged_flash_attention
        )
        extra = (page_table, posv)

        def write(dst, x):  # x [B, T, KH, hd or 1] rows at their pages
            dst[page, :, prow] = x
    else:
        attn = (flash_decode_ref if plain else flash_decode) if t == 1 else (
            flash_attention_ref if plain else flash_attention
        )
        if lanes:
            posv, rows, wrows = _lane_slab_rows(pos, b, t, park, tokens.device)
            lane_idx = torch.arange(b, device=tokens.device)[:, None]

            def write(dst, x):  # x [B, T, KH, hd or 1] rows at each lane's rows
                dst[lane_idx, :, wrows] = x
        else:
            posv = _slab_pos(pos, t, cache["k"].shape[3], tokens.device)
            rows = posv.long() + torch.arange(t, device=tokens.device)  # [T] cache rows

            def write(dst, x):  # x [B, KH, T, hd or 1]
                dst.index_copy_(2, rows, x)
        extra = (posv,)
    head_major = not (paged or lanes)  # the slab's write takes [B, KH, T, hd]

    def attend(k_cache, v_cache, q, k, v):
        if head_major:
            k, v = k.transpose(1, 2), v.transpose(1, 2)
        _append(k_cache, k, write)
        _append(v_cache, v, write)
        return attn(q, k_cache, v_cache, *extra)

    def mm(x, w):
        return _mm(x, w, plain, act_quant)

    x = _start(params, tokens, tp, x_in)  # [B, T, D] (reference: OP_EMBEDDING)
    # [B, T, hd/2] with each lane at its own position (paged, slab lanes),
    # else [T, hd/2]
    cos, sin = params["rope_cos"][rows], params["rope_sin"][rows]
    x = _layers(params, h, x, cos, sin, cache, attend, mm,
                _mm_col(tp, plain, act_quant, sync_quant),
                _moe_hook(h, plain, moe_dedup, tp, sync_quant))
    return _finish(x, params, h, logits_mode, plain, act_quant, tp), cache


def _moe_hook(h: LlmHeader, plain: bool, dedup: bool, tp, sync_quant: bool):
    """`_layers`' ``ffn`` for a Qwen3-MoE model (`moe_ffn` on the rank's
    expert slices, its partials summed over tp), None for a dense FFN.
    Under sp every rank computes the FFN of every row (the JAX token spec
    is replicated over sp)."""
    if h.arch != LlmArch.QWEN3_MOE:
        return None
    if h.hidden_act != HiddenAct.SILU:
        raise ValueError("Qwen3-MoE experts are SwiGLU: hidden_act must be SILU")
    return lambda y, lp: moe_ffn(y, lp, h, plain, dedup, tp, sync_quant)


def _start(params: Params, tokens: torch.Tensor, tp, x_in) -> torch.Tensor:
    """A forward's first hidden rows: ``x_in`` (a later pipeline stage's
    input), else the tokens' embedding."""
    return x_in if x_in is not None else _embed(params, tokens, tp)


def _finish(x: torch.Tensor, params: Params, h: LlmHeader, logits_mode: str, plain: bool,
            act_quant, tp):
    """A forward's output from its last hidden rows: the rows themselves for
    ``logits_mode="hidden"`` (a pipeline stage's hand-off), else the logits
    (`logits_head`) gathered over tp."""
    if logits_mode == "hidden":
        return x
    return _gather_logits(logits_head(x, params, h, logits_mode, plain, act_quant), tp)


def _embed(params: Params, tokens: torch.Tensor, tp) -> torch.Tensor:
    """The embedding rows of ``tokens``; under tp (``tp`` the mesh's axis)
    each rank holds a vocab slice: a masked lookup summed over tp."""
    emb = params["embed"]  # [V/tp, D]
    if tp is None or tp.size == 1:
        return emb[tokens]
    local = tokens - tp.index * emb.shape[0]
    hit = (local >= 0) & (local < emb.shape[0])
    x = emb[local.clamp(0, emb.shape[0] - 1)] * hit[..., None].to(emb.dtype)
    return all_reduce(x, tp).to(emb.dtype)


def _mm_col(tp, plain: bool, act_quant, sync_quant: bool):
    """The wo and w2 product: `_mm`, or under tp an in-split matmul whose
    partial sum is reduced over tp in f32 (in q80 with ``sync_quant``)."""
    if tp is None or tp.size == 1:
        return lambda x, w: _mm(x, w, plain, act_quant)

    def mm_col(x, w):
        out = _quant_mm(x, w, plain, act_quant)
        return all_reduce(out if out is not None else _dense_f32(x, w), tp, sync_quant)

    return mm_col


def _gather_logits(out, tp):
    """The logits of the ``wcls`` row slices, gathered over tp in vocab
    order (None stays None)."""
    if out is None or tp is None:
        return out
    return all_gather(out, tp, dim=-1)


def _sp_decode(q, k_cache, v_cache, pos: int, sp, plain: bool) -> torch.Tensor:
    """Sequence-parallel decode attention (JAX ``_attention_sp_merge``):
    the stats of this shard's rows (the decode kernel emitting its state,
    cyclic: ``s_pos0`` = shard index, stride sp), merged over the sp axis
    by a log-sum-exp max and one sum. [B, 1, H, hd] in q's dtype."""
    stats = flash_decode_stats_ref if plain else flash_decode_stats
    return _merge_sp(*stats(q, k_cache, v_cache, pos, sp.index, sp.size), sp, q.dtype)


def _merge_sp(acc, m, l, sp, dtype) -> torch.Tensor:
    """The shards' (acc, m, l) merged over the sp axis by a log-sum-exp max
    and one sum, normalized: [B, T, H, hd] in ``dtype``. A state that saw
    no key (m = -1e30, l = 0) adds nothing; a row no shard saw is 0."""
    m_g = all_reduce_max(m, sp)
    scale = torch.where(m <= -1e30 / 2, torch.zeros_like(m), torch.exp(m - m_g))
    parts = torch.cat([(l * scale).reshape(-1), (acc * scale[..., None]).reshape(-1)])
    summed = all_reduce(parts, sp)
    l_g = summed[: l.numel()].reshape(l.shape)
    acc_g = summed[l.numel():].reshape(acc.shape)
    l_safe = torch.where(l_g == 0.0, torch.ones_like(l_g), l_g)
    out = acc_g / l_safe[..., None]  # [b, kh, g, 1, hd]
    b, kh, g, t, hd = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, kh * g, hd).to(dtype)


def _forward_sp_lanes(params: Params, h: LlmHeader, tokens: torch.Tensor, pos, cache: KvCache,
                      park: int, mesh, logits_mode: str, plain: bool, act_quant,
                      sync_quant: bool, x_in=None, moe_dedup: bool = False):
    """Slab lanes on one rank of a tp x sp mesh (the JAX engine's lanes
    under its sp mesh): the cache is this rank's shard of the lanes' slab,
    [L, B, KH/tp, (S + pad)/sp, hd], rows in the cyclic order (global row g
    on shard g % sp at local row g // sp; ``pad`` divides by sp, so the
    padding rows ``park + i`` of a parked lane land in every shard's
    padding). ``pos`` [B] is a position a lane (< 0: parked). Every sp rank
    computes every lane's rows; the owner of each row writes it, and the
    others send it to their first padding row (local ``park // sp``),
    which no live lane reads. Attention is the merged stats of the shards:
    the decode kernel's stats at T = 1, the strided stats kernel for T > 1
    (a verify row), each lane at its own position, so a parked lane (at -1,
    or -T) reads nothing on any shard (m = -1e30, l = 0) and gets zeros.
    An int8 cache writes its values and scales through the same writer
    and attends through the strided entries' ``_q8`` instantiations."""
    tp, sp = mesh.tp, mesh.sp
    b, t = tokens.shape
    dev = tokens.device
    posv = _lane_pos_vec(pos, b, dev)
    step = torch.arange(t, device=dev)[None, :]
    live = posv[:, None] >= 0
    rows = posv[:, None].long() + step
    g = torch.where(live, rows, park + step)
    local = torch.where(g % sp.size == sp.index, g // sp.size, park // sp.size)
    lane_idx = torch.arange(b, device=dev)[:, None]

    def write(dst, x):  # x [B, T, KH/tp, hd] at each lane's owned rows
        dst[lane_idx, :, local] = x

    if t == 1:
        stats = flash_decode_stats_ref if plain else flash_decode_stats
    else:
        stats = flash_attention_stats_ref if plain else flash_attention_stats

    def attend(k_cache, v_cache, q, k, v):
        _append(k_cache, k, write)
        _append(v_cache, v, write)
        return _merge_sp(*stats(q, k_cache, v_cache, posv, sp.index, sp.size), sp, q.dtype)

    def mm(x, w):
        return _mm(x, w, plain, act_quant)

    cos, sin = params["rope_cos"][rows.clamp(min=0)], params["rope_sin"][rows.clamp(min=0)]
    x = _layers(params, h, _start(params, tokens, tp, x_in), cos, sin, cache, attend, mm,
                _mm_col(tp, plain, act_quant, sync_quant),
                _moe_hook(h, plain, moe_dedup, tp, sync_quant))
    return _finish(x, params, h, logits_mode, plain, act_quant, tp), cache


def _lane_pos_vec(pos, b: int, device) -> torch.Tensor:
    """A position a lane as int32 [B] on ``device`` (an int: every lane)."""
    if torch.is_tensor(pos):
        return pos.to(device=device, dtype=torch.int32).reshape(b)
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def forward_parallel(params: Params, h: LlmHeader, tokens: torch.Tensor, pos, cache: KvCache,
                     mesh, logits_mode: str = "all", plain: bool = False,
                     act_quant=quantize_acts, sync_quant: bool = False, x_in=None,
                     moe_dedup: bool = False):
    """`forward` of one stream on one rank of a tp x sp mesh with sp > 1
    (dllama_tpu's ``run_layers`` under its mesh): the params are the rank's
    tp slices (parallel/sharding.py) and the cache its [L, 1, KH/tp, S/sp,
    hd] shard, rows in the cyclic order. ``pos`` is a host int (the engine
    runs world > 1 eagerly).

    * The embedding, the ``wo``/``w2`` all-reduces and the logits are the tp
      hooks of `forward` (`_embed`, `_mm_col`, `_gather_logits`).
    * Every rank computes the chunk's projections; the rank that owns a row
      (global row g on shard g % sp) writes it at local row g // sp. Decode
      attends by `_sp_decode`; a prefill chunk (T % sp == 0) splits its
      queries contiguously over sp (rank i's start is pos + i T/sp), runs
      the ring over the shards' live prefix (the rows below ceil((pos + T)
      / sp): every row past it is in every query's future), and all-gathers
      the outputs over sp before ``wo``. An int8 cache's shard rides the
      ring as its int8 values and f32 scales.
    * A Qwen3-MoE FFN is `moe_ffn` on the rank's expert slices: every rank
      computes every row's FFN, the partials summed over tp.
    Every rank returns the same logits. ``x_in`` and ``logits_mode="hidden"``
    as in `_forward_rank`."""
    if logits_mode not in ("all", "last", "none", "hidden"):
        raise ValueError(f"unknown logits_mode: {logits_mode!r}")
    tp, sp = mesh.tp, mesh.sp
    t = tokens.shape[1]
    pos = int(pos)
    s_local = cache["k"].shape[3]
    if pos < 0 or pos + t > s_local * sp.size:
        raise ValueError(f"chunk [{pos}, {pos + t}) outside the cache of {s_local * sp.size} rows")
    if t > 1 and t % sp.size:
        raise ValueError(f"a prefill chunk under sp={sp.size} needs T % sp == 0, got T={t}")
    dev = tokens.device

    def mm(x, w):
        return _mm(x, w, plain, act_quant)

    x = _start(params, tokens, tp, x_in)
    rows = torch.arange(pos, pos + t, device=dev)
    cos, sin = params["rope_cos"][rows], params["rope_sin"][rows]
    js, local_rows = cyclic_rows(pos, t, sp.size, sp.index)
    mine = torch.tensor(js, dtype=torch.long, device=dev)
    write_rows = torch.tensor(local_rows, dtype=torch.long, device=dev)
    n_live = -(-(pos + t) // sp.size)
    tq = t // sp.size

    def write(dst, x):  # x [B, KH/tp, rows this rank owns, hd or 1]
        dst.index_copy_(2, write_rows, x)

    def attend(k_cache, v_cache, q, k, v):
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)  # [B, KH/tp, T, hd]
        kt, vt = kt[:, :, mine], vt[:, :, mine]
        if write_rows.numel():
            _append(k_cache, kt, write)
            _append(v_cache, vt, write)
        if t == 1:
            return _sp_decode(q, k_cache, v_cache, pos, sp, plain)
        qs = q[:, sp.index * tq:(sp.index + 1) * tq].contiguous()
        live = slice(0, n_live)
        zl = ring_attention_local(qs, kv_rows(k_cache, live), kv_rows(v_cache, live),
                                  pos + sp.index * tq, s_local, sp, cyclic=True, plain=plain)
        return all_gather(zl, sp, dim=1)

    x = _layers(params, h, x, cos, sin, cache, attend, mm,
                _mm_col(tp, plain, act_quant, sync_quant),
                _moe_hook(h, plain, moe_dedup, tp, sync_quant))
    return _finish(x, params, h, logits_mode, plain, act_quant, tp), cache
