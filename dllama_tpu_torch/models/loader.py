"""Load `.m` weights into the port's params (one device, no mesh).

Counterpart of dllama_tpu/models/loader.py ``load_params``. Tensors are
read one at a time off the file's memmap (reference: loadLlmNetWeight,
src/llm.cpp:614-669). For ``weight_format="q40"`` the packed Q40 bytes go
to the device as they are and are unpacked there with torch ops
(`q40_unpack`), so the host never expands the ~7.5 G weights of an 8B
model; the unpack is held against the numpy ``q40_to_planar``. For
``weight_format="q40i4"`` the bytes are split on the device into the
packed-nibble values and the scales (`q40_split`): the file's blocks are
already that layout, so nothing is unpacked. Like the JAX loader, the file
is consumed as-is (the converter pre-permutes llama q/k rows for
interleaved RoPE). ``q40i8`` is q40 requantized afterwards
(ops/int8_matmul.requantize_params, called by the engine).

With ``shard=(tp, r)`` (tensor parallelism, parallel/sharding.py) each
tensor that splits is read as rank r's slice alone: its rows or its
columns (whole 32-element blocks of a Q40 file) are cut from the file's
memmap before anything is copied, so neither the host nor the card of a
rank holds the whole model (`_slice_raw`). With ``layers`` (a pipeline
stage's range, parallel/pipeline.stage_range) only those layers' tensors
are read, beside the embedding, the final norm and the classifier, which
every stage holds.

Qwen3-MoE experts are stacked per layer (``w1``/``w3`` [E, F, D], ``w2``
[E, D, F]; 18,432 tensors at Qwen3-30B-A3B). One layer's experts are
contiguous in the file, so a Q40 file sends them to the device in one
copy per layer and unpacks them there. Under q40i4 they stay in this int8
``QuantWeight`` layout, the one the MoE kernels take (as in JAX). Under tp
rank r holds F/tp hidden units of every expert (the JAX ``row_q`` /
``col_q`` specs): rows [r F/tp, (r+1) F/tp) of ``w1``/``w3`` and the same
columns of ``w2``, a Q40 ``w2``'s columns in whole 32-value blocks, so
F/tp must be a multiple of 32 in a Q40 file. The slices are cut from the
memmap into one host buffer a layer, so a rank's host and card hold 1/tp
of every expert's bytes and never the whole experts; ``moe_gate`` is
whole on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..formats.model_file import LlmArch, ModelReader
from ..formats.quants import (
    Q40_BLOCK_BYTES, Q40_BLOCK_SIZE, Q80_BLOCK_BYTES, Q80_BLOCK_SIZE, FloatType,
)
from ..ops.quant_matmul import PackedQuantWeight, QuantWeight, dequant
from ..ops.torch_ops import rope_cache
from ..parallel.sharding import role_of
from .transformer import Params

_MATMULS = {"wq": "q", "wk": "k", "wv": "v", "wo": "wo", "w1": "w1", "w2": "w2", "w3": "w3"}
# float type -> (elements, bytes) of its smallest unit along a row
_UNITS = {FloatType.F32: (1, 4), FloatType.F16: (1, 2), FloatType.Q40: (Q40_BLOCK_SIZE,
          Q40_BLOCK_BYTES), FloatType.Q80: (Q80_BLOCK_SIZE, Q80_BLOCK_BYTES)}


def _slice_raw(reader: ModelReader, name: str, role: str | None, tp: int, r: int):
    """(bytes, rows, cols) of rank r's slice of a 2-D tensor, copied out of
    the memmap: its rows for ``row``/``vocab``, its columns for ``col``
    (whole units of the file's type), the whole tensor otherwise."""
    spec = reader.by_name[name]
    rows, cols = spec.shape
    raw = reader.raw(name)
    if role is None or tp == 1:
        return np.array(raw), rows, cols
    elems, nbytes = _UNITS[spec.float_type]
    grid = raw.reshape(rows, cols // elems, nbytes)
    if role == "col":
        if (cols // elems) % tp:
            raise ValueError(f"{name}: {cols} columns do not split into {tp} slices of whole "
                             f"{elems}-element blocks")
        n = cols // elems // tp
        return np.array(grid[:, r * n:(r + 1) * n]).reshape(-1), rows, cols // tp
    n = rows // tp
    return np.array(grid[r * n:(r + 1) * n]).reshape(-1), n, cols


def q40_unpack(raw: torch.Tensor, out_dim: int, in_dim: int) -> QuantWeight:
    """Packed Q40 bytes (uint8, any device) of an [out, in] tensor ->
    QuantWeight(q int8 [out, in] in [-8, 7], d f16 [out, in/32]), on the
    bytes' device. Block layout: f16 scale, then 16 bytes whose low nibble
    is element j and high nibble element j + 16 (formats/quants.py)."""
    blocks = raw.reshape(-1, Q40_BLOCK_BYTES)
    d = blocks[:, :2].contiguous().view(torch.float16).reshape(out_dim, in_dim // Q40_BLOCK_SIZE)
    packed = blocks[:, 2:]
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    q = torch.cat([lo, hi], dim=1).reshape(out_dim, in_dim)
    return QuantWeight(q.contiguous(), d.contiguous())


def q40_split(raw: torch.Tensor, out_dim: int, in_dim: int) -> PackedQuantWeight:
    """Packed Q40 bytes (uint8, any device) of an [out, in] tensor ->
    PackedQuantWeight(qp uint8 [out, in/2], d f16 [out, in/32]) on the bytes'
    device: each 18-byte block split into its f16 scale and its 16 nibble
    bytes, which stay as they are."""
    blocks = raw.reshape(-1, Q40_BLOCK_BYTES)
    d = blocks[:, :2].contiguous().view(torch.float16).reshape(out_dim, in_dim // Q40_BLOCK_SIZE)
    qp = blocks[:, 2:].reshape(out_dim, in_dim // 2)
    return PackedQuantWeight(qp.contiguous(), d.contiguous())


def load_params(
    reader: ModelReader,
    dtype=torch.float32,
    device=None,
    weight_format: str = "dense",
    shard: tuple[int, int] | None = None,
    layers: range | None = None,
) -> Params:
    """Params for `models.transformer.forward`. ``dtype`` is the activation
    dtype (embedding and dense weights); norm weights and the rope tables
    stay f32. ``weight_format="q40"`` keeps matmul weights Q40 on the device
    (needs a Q40 file), ``"q40i4"`` keeps the non-expert ones as packed
    nibbles (experts stay ``"q40"``); ``"dense"`` dequantizes them to
    ``dtype``. The device defaults to ``cuda``. ``shard=(tp, r)`` loads tp
    rank r's slices (module docstring; not for Qwen3-MoE); ``layers`` the
    layers of a pipeline stage alone (default: all)."""
    device = resolve_device(device)
    h = reader.header
    if weight_format not in ("dense", "q40", "q40i4"):
        raise ValueError(f"weight_format must be 'dense', 'q40' or 'q40i4', got {weight_format!r}")
    quant = weight_format != "dense"
    if quant and h.weight_type != FloatType.Q40:
        raise ValueError(
            f"weight_format={weight_format!r} needs a Q40 model file, got {h.weight_type.name}"
        )

    tp, rank = shard or (1, 0)
    if tp > 1 and h.arch == LlmArch.QWEN3_MOE and h.weight_type == FloatType.Q40 and (
            h.ff_dim % (Q40_BLOCK_SIZE * tp)):
        raise ValueError(
            f"Qwen3-MoE under tp={tp}: an expert's F/tp = {h.ff_dim / tp:g} hidden units is not a "
            f"multiple of {Q40_BLOCK_SIZE}, so its Q40 w2 does not slice into whole blocks (the "
            "JAX package leaves such a shard to its dense path, which the port does not have "
            "on the card)")

    def f32(name: str) -> torch.Tensor:
        return torch.from_numpy(reader.dense_f32(name)).to(device)

    def matmul_weight(name: str, key: str):
        raw, out_dim, in_dim = _slice_raw(reader, name, role_of(key), tp, rank)
        if quant:
            split = q40_split if weight_format == "q40i4" else q40_unpack
            return split(torch.from_numpy(raw).to(device), out_dim, in_dim)
        dense = reader.dense_f32(name, raw, (out_dim, in_dim))
        return torch.from_numpy(dense).to(device=device, dtype=dtype)  # [out, in]

    def experts(l: int) -> dict:
        """Layer l's experts stacked [E, rows, cols] (w1/w3 [E, F/tp, D], w2
        [E, D, F/tp]): a Q40 file's slices are cut from the memmap into one
        host buffer, go to the device in one copy and unpack there."""
        e_n, d = h.n_experts, h.dim
        f = h.ff_dim // tp
        shapes = {"w1": (f, d), "w2": (d, f), "w3": (f, d)}
        if h.weight_type != FloatType.Q40:
            out = {}
            for w, (rows, cols) in shapes.items():
                names = [f"layers.{l}.experts.{e}.{w}" for e in range(e_n)]
                out[w] = torch.from_numpy(np.stack([
                    reader.dense_f32(n, _slice_raw(reader, n, role_of(w), tp, rank)[0],
                                     (rows, cols)) for n in names
                ])).to(device=device, dtype=dtype)
            return out
        span = reader.raw_span(f"layers.{l}.experts.0.w1", f"layers.{l}.experts.{e_n - 1}.w3")
        grid = span.reshape(e_n, 3, -1)  # w1, w2, w3 bytes of each expert (a view)
        blocks = f // Q40_BLOCK_SIZE  # a slice's 32-value blocks along F
        # each part's slice of every expert: w1/w3 rows of D/32 blocks,
        # w2's D rows cut to their blocks [r F/tp / 32, (r+1) F/tp / 32)
        views = {
            "w1": grid[:, 0].reshape(e_n, tp * f, -1)[:, rank * f:(rank + 1) * f],
            "w2": grid[:, 1].reshape(e_n, d, tp * blocks, Q40_BLOCK_BYTES)[
                :, :, rank * blocks:(rank + 1) * blocks],
            "w3": grid[:, 2].reshape(e_n, tp * f, -1)[:, rank * f:(rank + 1) * f],
        }
        size = views["w1"].size
        host = np.empty(3 * size, dtype=np.uint8)
        for i, part in enumerate(views.values()):
            host[i * size:(i + 1) * size].reshape(part.shape)[...] = part
        raw = torch.from_numpy(host).to(device).reshape(3, -1)
        out = {}
        for i, (w, (rows, cols)) in enumerate(shapes.items()):
            u = q40_unpack(raw[i], e_n * rows, cols)
            qw = QuantWeight(u.q.view(e_n, rows, cols), u.d.view(e_n, rows, cols // Q40_BLOCK_SIZE))
            out[w] = qw if quant else dequant(qw, dtype)
        return out

    moe = h.arch == LlmArch.QWEN3_MOE
    stage = []
    for l in layers if layers is not None else range(h.n_layers):
        parts = {k: v for k, v in _MATMULS.items() if not (moe and k in ("w1", "w2", "w3"))}
        lp = {key: matmul_weight(f"layers.{l}.{part}", key) for key, part in parts.items()}
        if moe:
            lp["moe_gate"] = f32(f"layers.{l}.moe_gate")  # [E, D]
            lp.update(experts(l))
        lp["att_norm"] = f32(f"layers.{l}.att_norm")
        lp["ffn_norm"] = f32(f"layers.{l}.ffn_norm")
        if h.arch in (LlmArch.QWEN3, LlmArch.QWEN3_MOE):
            lp["q_norm"] = f32(f"layers.{l}.q_norm")
            lp["k_norm"] = f32(f"layers.{l}.k_norm")
        stage.append(lp)
    cos, sin = rope_cache(h, device=device)
    raw, n_vocab, dim = _slice_raw(reader, "embed", role_of("embed"), tp, rank)
    return {
        "embed": torch.from_numpy(reader.dense_f32("embed", raw, (n_vocab, dim))).to(
            device=device, dtype=dtype),
        "wcls": matmul_weight("wcls", "wcls"),
        "final_norm": f32("final_norm"),
        "rope_cos": cos,
        "rope_sin": sin,
        "layers": stage,
    }
