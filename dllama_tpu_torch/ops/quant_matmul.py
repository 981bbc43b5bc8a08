"""Q40 weight-only matmuls: the CUDA kernels' wrappers and their plain version.

Counterpart of dllama_tpu/ops/quant_matmul.py. The TPU package stores
weights transposed, ``[in, out]`` with f32 scales, for Mosaic's sublane
tiling; the port keeps the ``.m`` file's own rows instead, in two layouts:

* ``QuantWeight`` (weight_format q40), one int8 value a weight:

      q int8 [..., out, in] in [-8, 7],  d f16 [..., out, in // 32]
      W[o, i] = q[o, i] * d[o, i // 32]

  (1.0625 B per weight; f16 holds the wire scale exactly);
* ``PackedQuantWeight`` (weight_format q40i4), two values a byte:
  ``qp`` uint8 [..., out, in // 2], where byte j of each 16-byte run holds
  element j of its 32-value block in the low nibble and element j + 16 in
  the high one, each as value + 8, and the same ``d``. That is the ``.m``
  file's own Q40 block without its interleaved scale (0.5625 B per weight),
  so the loader copies bytes and unpacks nothing.

Both let each output column of the GEMV read one contiguous row.

Numerics of ``qmatmul`` and ``qmatmul_i4`` (kernels and plain version
alike): W is formed exactly in f32, rounded to x's dtype, multiplied by x
and summed in f32. For bfloat16 x these are the TPU kernels' roundings (x
and the dequantized tile in bf16, ``qmatmul_2d`` / ``qmatmul_i4_2d``); for
float32 x nothing is rounded, which is the JAX package's ``qmatmul_ref``.
The two kernels share their code (csrc/q40_gemm.cuh) but for the weight
fetch, so on the same values they give the same bits.
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


class PackedQuantWeight(NamedTuple):
    """Packed-nibble Q40 tensor in the port's device layout (see module doc)."""

    qp: torch.Tensor  # uint8 [..., out, in // 2]
    d: torch.Tensor  # f16 [..., out, in // 32]

    @property
    def in_dim(self) -> int:
        return self.qp.shape[-1] * 2

    @property
    def out_dim(self) -> int:
        return self.qp.shape[-2]


def dequant(w: QuantWeight, dtype=torch.float32) -> torch.Tensor:
    """Dense [..., out, in] tensor (reference: nn-quants.cpp:229-246)."""
    *lead, out, inner = w.q.shape
    q = w.q.float().reshape(*lead, out, inner // Q_BLOCK, Q_BLOCK)
    return (q * w.d.float()[..., None]).reshape(*lead, out, inner).to(dtype)


def pack_nibbles(w: QuantWeight) -> PackedQuantWeight:
    """QuantWeight -> PackedQuantWeight (values must lie in [-8, 7])."""
    *lead, out, inner = w.q.shape
    blk = w.q.to(torch.int16).reshape(*lead, out, inner // Q_BLOCK, Q_BLOCK) + 8
    half = Q_BLOCK // 2
    qp = (blk[..., :half] | (blk[..., half:] << 4)).to(torch.uint8)
    return PackedQuantWeight(qp.reshape(*lead, out, inner // 2), w.d.to(torch.float16))


def unpack_nibbles(qp: torch.Tensor) -> torch.Tensor:
    """Packed bytes [..., out, in // 2] -> int8 values [..., out, in] in
    [-8, 7], restoring the (j, j + 16) pairing of each block."""
    *lead, out, half = qp.shape
    u = qp.reshape(*lead, out, half // (Q_BLOCK // 2), Q_BLOCK // 2)
    lo = (u & 0xF).to(torch.int8) - 8
    hi = (u >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=-1).reshape(*lead, out, half * 2)


def dequant_packed(w: PackedQuantWeight, dtype=torch.float32) -> torch.Tensor:
    """Dense [..., out, in] tensor: what `dequant` gives on the unpacked twin."""
    return dequant(QuantWeight(unpack_nibbles(w.qp), w.d), dtype)


def _check_x(x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qmatmul takes float32 or bfloat16 activations, got {x.dtype}")


def qmatmul_ref(x: torch.Tensor, w: QuantWeight | PackedQuantWeight) -> torch.Tensor:
    """Plain version of both kernels: x [..., in] -> [..., out] f32 with
    their roundings (W rounded to x's dtype, f32 products and sums)."""
    _check_x(x)
    if isinstance(w, PackedQuantWeight):
        dense = dequant_packed(w, torch.float32)
    else:
        dense = dequant(w, torch.float32)
    if x.dtype == torch.bfloat16:
        dense = dense.to(torch.bfloat16).float()
    return torch.matmul(x.float(), dense.transpose(-1, -2))


def _launch(kernel, x: torch.Tensor, values: torch.Tensor, d: torch.Tensor, row_bytes: int):
    """Checks common to both Q40 kernels, then one launch of csrc/<kernel>.cu
    on x [..., k] and a weight of values [n, row_bytes] + f16 scales."""
    *lead, k = x.shape
    n = values.shape[0]
    if values.dim() != 2 or k % Q_BLOCK or values.shape[1] != row_bytes:
        raise ValueError(f"{kernel}: weight {tuple(values.shape)} does not take x {tuple(x.shape)}")
    if d.dtype != torch.float16 or d.shape != (n, k // Q_BLOCK):
        raise TypeError(f"{kernel}: scales must be f16 [out, in/32], got {d.dtype} {tuple(d.shape)}")
    if not (values.is_cuda and d.is_cuda and values.is_contiguous() and d.is_contiguous()):
        raise ValueError(f"{kernel}: CUDA weight tensors must be contiguous on the card")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m:
        code = _build.load(kernel)(
            x2.data_ptr(), values.data_ptr(), d.data_ptr(), out.data_ptr(),
            m, n, k, int(x2.dtype == torch.bfloat16), _build.stream(x.device),
        )
        _build.check(code, kernel)
    return out.reshape(*lead, n), bool(m)


def qmatmul(x: torch.Tensor, w: QuantWeight) -> torch.Tensor:
    """x [..., in] @ W^T -> [..., out] f32.

    CPU tensors take the plain version; CUDA tensors launch
    csrc/q40_matmul.cu (GEMV for up to 8 rows, a tiled product above) or
    raise. ``qmatmul.launches`` counts kernel launches."""
    _check_x(x)
    if x.device.type == "cpu":
        return qmatmul_ref(x, w)
    if w.q.dtype != torch.int8:
        raise TypeError(f"qmatmul: values must be int8 [out, in], got {w.q.dtype}")
    out, launched = _launch("q40_matmul", x, w.q, w.d, x.shape[-1])
    qmatmul.launches += launched
    return out


def qmatmul_i4(x: torch.Tensor, w: PackedQuantWeight) -> torch.Tensor:
    """x [..., in] @ W^T -> [..., out] f32 from packed nibbles.

    CPU tensors take the plain version; CUDA tensors launch
    csrc/q40i4_matmul.cu (the Q40 kernel's two paths with a 16-byte load a
    32-value block) or raise. ``qmatmul_i4.launches`` counts launches."""
    _check_x(x)
    if x.device.type == "cpu":
        return qmatmul_ref(x, w)
    if w.qp.dtype != torch.uint8:
        raise TypeError(f"qmatmul_i4: packed values must be uint8 [out, in/2], got {w.qp.dtype}")
    out, launched = _launch("q40i4_matmul", x, w.qp, w.d, x.shape[-1] // 2)
    qmatmul_i4.launches += launched
    return out


qmatmul.launches = 0
qmatmul_i4.launches = 0
