"""Q40 weight-only matmul: the CUDA kernel's wrapper and its plain version.

Counterpart of dllama_tpu/ops/quant_matmul.py. The TPU package stores
weights transposed, ``[in, out]`` with f32 scales, for Mosaic's sublane
tiling; the port keeps the ``.m`` file's own rows instead:

    q int8 [..., out, in] in [-8, 7],  d f16 [..., out, in // 32]
    W[o, i] = q[o, i] * d[o, i // 32]

(1.0625 B per weight; f16 holds the wire scale exactly), which lets each
output column of the GEMV read one contiguous row.

Numerics of ``qmatmul`` (kernel and plain version alike): W is formed
exactly in f32, rounded to x's dtype, multiplied by x and summed in f32.
For bfloat16 x these are the TPU kernel's roundings (x and the dequantized
tile in bf16, ``qmatmul_2d``); for float32 x nothing is rounded, which is
the JAX package's ``qmatmul_ref``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

Q_BLOCK = 32


class QuantWeight(NamedTuple):
    """Planar Q40 tensor in the port's device layout (see module doc)."""

    q: torch.Tensor  # int8 [..., out, in]
    d: torch.Tensor  # f16 [..., out, in // 32]

    @property
    def in_dim(self) -> int:
        return self.q.shape[-1]

    @property
    def out_dim(self) -> int:
        return self.q.shape[-2]


def dequant(w: QuantWeight, dtype=torch.float32) -> torch.Tensor:
    """Dense [..., out, in] tensor (reference: nn-quants.cpp:229-246)."""
    *lead, out, inner = w.q.shape
    q = w.q.float().reshape(*lead, out, inner // Q_BLOCK, Q_BLOCK)
    return (q * w.d.float()[..., None]).reshape(*lead, out, inner).to(dtype)


def _check_x(x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qmatmul takes float32 or bfloat16 activations, got {x.dtype}")


def qmatmul_ref(x: torch.Tensor, w: QuantWeight) -> torch.Tensor:
    """Plain version: x [..., in] -> [..., out] f32 with the kernel's
    roundings (W rounded to x's dtype, f32 products and sums)."""
    _check_x(x)
    dense = dequant(w, torch.float32)
    if x.dtype == torch.bfloat16:
        dense = dense.to(torch.bfloat16).float()
    return torch.matmul(x.float(), dense.transpose(-1, -2))


def qmatmul(x: torch.Tensor, w: QuantWeight) -> torch.Tensor:
    """x [..., in] @ W^T -> [..., out] f32.

    CPU tensors take the plain version; CUDA tensors launch
    csrc/q40_matmul.cu (GEMV for up to 8 rows, a tiled product above) or
    raise. ``qmatmul.launches`` counts kernel launches."""
    _check_x(x)
    if x.device.type == "cpu":
        return qmatmul_ref(x, w)
    *lead, k = x.shape
    n = w.out_dim
    if w.q.dim() != 2 or w.q.shape[1] != k or k % Q_BLOCK:
        raise ValueError(f"qmatmul: weight {tuple(w.q.shape)} does not take x {tuple(x.shape)}")
    if w.q.dtype != torch.int8 or w.d.dtype != torch.float16 or w.d.shape != (n, k // Q_BLOCK):
        raise TypeError("qmatmul: weight must be int8 values [out, in] + f16 scales [out, in/32]")
    if not (w.q.is_cuda and w.d.is_cuda and w.q.is_contiguous() and w.d.is_contiguous()):
        raise ValueError("qmatmul: CUDA weight tensors must be contiguous on the card")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m:
        code = _build.load("q40_matmul")(
            x2.data_ptr(), w.q.data_ptr(), w.d.data_ptr(), out.data_ptr(),
            m, n, k, int(x2.dtype == torch.bfloat16), _build.stream(x.device),
        )
        _build.check(code, "q40_matmul")
        qmatmul.launches += 1
    return out.reshape(*lead, n)


qmatmul.launches = 0
