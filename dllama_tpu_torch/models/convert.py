"""Carry the JAX package's params across into the port's layout.

``params_from_jax(np_params, header, device)`` takes dllama_tpu's
``load_params`` output after ``jax.tree.map(np.asarray, ...)`` and returns
params for `models.transformer.forward`. It duck-types on attributes and
never imports the JAX classes:

* ``.weight/.fuse/.dims`` — FusedQuantWeight (``wqkv``, ``w13``): the out
  axis holds ``fuse`` shard-major chunks of [a_s | b_s | ...]
  (loader._interleave_concat; a plain concatenation for fuse = 1), split
  back by ``dims``;
* ``.q/.d`` — QuantWeight ``[.., in, out]`` int8 + f32 scales
  ``[.., in/32, out]``, transposed to the port's ``[.., out, in]`` with
  f16 scales (exact: the f32 values came from the file's f16);
* an array — a dense ``[.., in, out]`` weight, transposed.

Qwen3-MoE leaves need nothing more: the gate ``[D, E]`` and the stacked
experts (``[E, D, F]`` / ``[E, F, D]`` values and ``[E, in/32, out]``
scales) take the same last-two-axes swap to the port's ``[E, D]`` and
``[E, out, in]``.

Layers arrive stacked ``[L, ...]`` and leave as a list of per-layer dicts.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..device import resolve_device
from ..formats.model_file import LlmHeader
from ..ops.quant_matmul import QuantWeight


def _quant(q: np.ndarray, d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    q = np.ascontiguousarray(np.swapaxes(np.asarray(q), -1, -2))
    d = np.ascontiguousarray(np.swapaxes(np.asarray(d), -1, -2)).astype(np.float16)
    return q, d


def _unfuse(fw) -> list:
    """Constituents of a fused weight, each (q, d) in the JAX [.., in, out]
    layout, in `dims` order."""
    q, d = np.asarray(fw.weight.q), np.asarray(fw.weight.d)
    fuse, dims = int(fw.fuse), tuple(int(x) for x in fw.dims)
    locs = [x // fuse for x in dims]
    lead = q.shape[:-1]
    qs = q.reshape(*lead, fuse, sum(locs))
    ds = d.reshape(*d.shape[:-1], fuse, sum(locs))
    parts, off = [], 0
    for dl, dg in zip(locs, dims):
        parts.append(
            (
                qs[..., off : off + dl].reshape(*lead, dg),
                ds[..., off : off + dl].reshape(*d.shape[:-1], dg),
            )
        )
        off += dl
    return parts


def _leaf(x, device):
    if hasattr(x, "q") and hasattr(x, "d"):
        q, d = _quant(x.q, x.d)
        return QuantWeight(torch.from_numpy(q).to(device), torch.from_numpy(d).to(device))
    a = np.ascontiguousarray(np.swapaxes(np.asarray(x), -1, -2))
    return torch.from_numpy(a).to(device)


def params_from_jax(np_params: dict, header: LlmHeader, device=None) -> dict:
    """The port's params from the JAX package's (numpy-leaved) params, on
    ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    jl = dict(np_params["layers"])
    if "wqkv" in jl:
        fq, fk, fv = _unfuse(jl.pop("wqkv"))
        for key, (q, d) in zip(("wq", "wk", "wv"), (fq, fk, fv)):
            jl[key] = SimpleNamespace(q=q, d=d)
    if "w13" in jl:
        (q1, d1), (q3, d3) = _unfuse(jl.pop("w13"))
        jl["w1"], jl["w3"] = SimpleNamespace(q=q1, d=d1), SimpleNamespace(q=q3, d=d3)
    layers = []
    for l in range(header.n_layers):
        lp = {}
        for key, val in jl.items():
            if key in ("att_norm", "ffn_norm", "q_norm", "k_norm"):
                lp[key] = torch.from_numpy(np.array(np.asarray(val)[l])).to(device)
            elif hasattr(val, "q"):
                lp[key] = _leaf(SimpleNamespace(q=np.asarray(val.q)[l], d=np.asarray(val.d)[l]), device)
            else:
                lp[key] = _leaf(np.asarray(val)[l], device)
        layers.append(lp)
    return {
        "embed": torch.from_numpy(np.array(np_params["embed"])).to(device),
        "wcls": _leaf(np_params["wcls"], device),
        "final_norm": torch.from_numpy(np.array(np_params["final_norm"])).to(device),
        "rope_cos": torch.from_numpy(np.array(np_params["rope_cos"])).to(device),
        "rope_sin": torch.from_numpy(np.array(np_params["rope_sin"])).to(device),
        "layers": layers,
    }
