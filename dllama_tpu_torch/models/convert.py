"""Carry the JAX package's params across into the port's layout.

``params_from_jax(np_params, header, device)`` takes dllama_tpu's
``load_params`` output (after ``jax.tree.map(np.asarray, ...)``, or
requantized by its ``requantize_params``) and returns params for
`models.transformer.forward`. It duck-types on attributes and never
imports the JAX classes. A quantized leaf is a pair of arrays in the JAX
``[.., in-ish, out]`` layout, swapped on their last two axes to the port's
``[.., out, in-ish]``, checked in this order:

* ``.q/.s`` — Int8Weight: int8 ``[.., in, out]`` + f32 scales
  ``[.., in/G, out]`` -> `Int8Weight` (ints and scales exact);
* ``.qp/.d`` — PackedQuantWeight: int8 nibble pairs ``[.., in/2, out]`` +
  f16 scales -> `PackedQuantWeight` with the same bytes as uint8 (the
  pairing runs along the in axis, so the swap keeps it);
* ``.q/.d`` — QuantWeight: int8 ``[.., in, out]`` + f32 scales
  ``[.., in/32, out]`` -> `QuantWeight` with f16 scales (exact: the f32
  values came from the file's f16);
* ``.weight/.fuse/.dims`` — FusedQuantWeight (``wqkv``, ``w13``) around any
  of the three: the out axis holds ``fuse`` shard-major chunks of
  [a_s | b_s | ...] (loader._interleave_concat; a plain concatenation for
  fuse = 1), split back by ``dims``;
* an array — a dense ``[.., in, out]`` weight, transposed.

Qwen3-MoE leaves need nothing more: the gate ``[D, E]`` and the stacked
experts (``[E, D, F]`` / ``[E, F, D]`` values and ``[E, in/32, out]``
scales, Q40 under every format) take the same last-two-axes swap to the
port's ``[E, D]`` and ``[E, out, in]``.

Layers arrive stacked ``[L, ...]`` and leave as a list of per-layer dicts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..formats.model_file import LlmHeader
from ..ops.int8_matmul import Int8Weight
from ..ops.quant_matmul import PackedQuantWeight, QuantWeight

# kind -> the JAX class's two fields, in the order they are checked
_FIELDS = {"i8": ("q", "s"), "i4": ("qp", "d"), "q40": ("q", "d")}


def _quant(x):
    """(kind, [values, scales]) of a quantized JAX leaf, or None."""
    for kind, fields in _FIELDS.items():
        if all(hasattr(x, f) for f in fields):
            return kind, [np.asarray(getattr(x, f)) for f in fields]
    return None


def _unfuse(fw) -> list:
    """Constituents of a fused weight, each (kind, [values, scales]) in the
    JAX [.., rows, out] layout, in `dims` order."""
    kind, arrs = _quant(fw.weight)
    fuse, dims = int(fw.fuse), tuple(int(x) for x in fw.dims)
    locs = [x // fuse for x in dims]
    split = [a.reshape(*a.shape[:-1], fuse, sum(locs)) for a in arrs]
    parts, off = [], 0
    for dl, dg in zip(locs, dims):
        parts.append((kind, [
            s[..., off : off + dl].reshape(*a.shape[:-1], dg) for a, s in zip(arrs, split)
        ]))
        off += dl
    return parts


def _port_leaf(kind: str, values: np.ndarray, scales: np.ndarray, device):
    """The port's leaf from JAX-layout arrays (last two axes swapped)."""
    def swap(a, dtype=None):
        a = np.ascontiguousarray(np.swapaxes(a, -1, -2))
        return torch.from_numpy(a if dtype is None else a.astype(dtype)).to(device)

    if kind == "i8":
        return Int8Weight(swap(values), swap(scales, np.float32))
    if kind == "i4":
        return PackedQuantWeight(swap(values.view(np.uint8)), swap(scales, np.float16))
    return QuantWeight(swap(values), swap(scales, np.float16))


def _leaf(x, device):
    quant = _quant(x)
    if quant is not None:
        return _port_leaf(quant[0], *quant[1], device)
    a = np.ascontiguousarray(np.swapaxes(np.asarray(x), -1, -2))
    return torch.from_numpy(a).to(device)


def params_from_jax(np_params: dict, header: LlmHeader, device=None) -> dict:
    """The port's params from the JAX package's (numpy-leaved) params, on
    ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    jl = {}
    for key, val in np_params["layers"].items():
        if key in ("wqkv", "w13"):
            names = ("wq", "wk", "wv") if key == "wqkv" else ("w1", "w3")
            jl.update(zip(names, _unfuse(val)))
        else:
            jl[key] = _quant(val) or np.asarray(val)
    layers = []
    for l in range(header.n_layers):
        lp = {}
        for key, val in jl.items():
            if isinstance(val, tuple):
                kind, (values, scales) = val
                lp[key] = _port_leaf(kind, values[l], scales[l], device)
            elif key in ("att_norm", "ffn_norm", "q_norm", "k_norm"):
                lp[key] = torch.from_numpy(np.array(val[l])).to(device)
            else:
                lp[key] = _leaf(val[l], device)
        layers.append(lp)
    return {
        "embed": torch.from_numpy(np.array(np_params["embed"])).to(device),
        "wcls": _leaf(np_params["wcls"], device),
        "final_norm": torch.from_numpy(np.array(np_params["final_norm"])).to(device),
        "rope_cos": torch.from_numpy(np.array(np_params["rope_cos"])).to(device),
        "rope_sin": torch.from_numpy(np.array(np_params["rope_sin"])).to(device),
        "layers": layers,
    }
