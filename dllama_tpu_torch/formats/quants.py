"""Q40 / Q80 block quantization formats.

Wire-compatible with distributed-llama's `.m` tensors
(reference: src/nn/nn-quants.hpp:53-72, converter/writer.py:29-74):

* **Q40** — 32-element blocks; per block an fp16 scale ``d`` followed by 16
  bytes of packed nibbles. Nibble ``j`` low half holds element ``j``, high
  half holds element ``j + 16``; dequantized value is ``(nibble - 8) * d``
  (reference: src/nn/nn-quants.cpp:229-246).
* **Q80** — 32-element blocks; fp16 scale ``d`` followed by 32 int8 values;
  value is ``q * d``.

Quantization rounding matches converter/writer.py exactly (asymmetric
``x/d + 8.5`` then clip to [0,15] for Q40; ``round(x/d)`` for Q80) so that
tensors we write are byte-identical with the reference converter's output.

These host-side codecs are numpy-vectorized (the port's own copy of
dllama_tpu/formats/quants.py). On the GPU the loader unpacks the packed
layout with torch ops on the device (models/loader.q40_unpack), and that
unpack is held against `q40_to_planar` here; its q40i4 split
(models/loader.q40_split) is held against `pack_q40_device`.
"""

from __future__ import annotations

import enum

import numpy as np

Q40_BLOCK_SIZE = 32
Q80_BLOCK_SIZE = 32

Q40_BLOCK_BYTES = 2 + Q40_BLOCK_SIZE // 2  # fp16 scale + 16 packed bytes
Q80_BLOCK_BYTES = 2 + Q80_BLOCK_SIZE  # fp16 scale + 32 int8


class FloatType(enum.IntEnum):
    """Tensor storage types (reference: src/nn/nn-quants.hpp:56-62)."""

    F32 = 0
    F16 = 1
    Q40 = 2
    Q80 = 3


def tensor_bytes(ft: FloatType, n_elements: int) -> int:
    """Bytes of an n-element tensor stored as `ft` (reference: nn-core.cpp size math)."""
    ft = FloatType(ft)
    if ft == FloatType.F32:
        return 4 * n_elements
    if ft == FloatType.F16:
        return 2 * n_elements
    if ft == FloatType.Q40:
        assert n_elements % Q40_BLOCK_SIZE == 0
        return (n_elements // Q40_BLOCK_SIZE) * Q40_BLOCK_BYTES
    if ft == FloatType.Q80:
        assert n_elements % Q80_BLOCK_SIZE == 0
        return (n_elements // Q80_BLOCK_SIZE) * Q80_BLOCK_BYTES
    raise ValueError(f"unsupported float type: {ft}")


def _q40_scales(groups: np.ndarray) -> np.ndarray:
    """Per-block scale = extremum / -8, as in converter/writer.py:35-38."""
    gmax = groups.max(axis=1)
    gmin = groups.min(axis=1)
    return np.where(-gmin > gmax, gmin, gmax) / -8.0


def _safe_inverse(deltas: np.ndarray) -> np.ndarray:
    """1/deltas with 0 -> 0 (all-zero blocks, e.g. padded vocab rows)."""
    return np.divide(
        1.0, deltas, out=np.zeros_like(deltas), where=deltas != 0
    )


def quantize_q40(x: np.ndarray) -> np.ndarray:
    """Quantize a flat f32 array to packed Q40 bytes (uint8 array).

    Byte-identical with converter/writer.py:29-53.
    """
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if x.size % Q40_BLOCK_SIZE != 0:
        raise ValueError(f"Q40 tensor size {x.size} not a multiple of {Q40_BLOCK_SIZE}")
    groups = x.reshape(-1, Q40_BLOCK_SIZE)
    deltas = _q40_scales(groups)
    deltas16 = deltas.astype(np.float16)
    inv = _safe_inverse(deltas)
    q = np.clip(groups * inv[:, None] + 8.5, 0, 15).astype(np.int64)
    half = Q40_BLOCK_SIZE // 2
    packed = (q[:, :half] & 0xF) | ((q[:, half:] & 0xF) << 4)

    out = np.empty((len(groups), Q40_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = deltas16.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = packed.astype(np.uint8)
    return out.reshape(-1)


def quantize_q80(x: np.ndarray) -> np.ndarray:
    """Quantize a flat f32 array to packed Q80 bytes (uint8 array).

    Byte-identical with converter/writer.py:55-74.
    """
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if x.size % Q80_BLOCK_SIZE != 0:
        raise ValueError(f"Q80 tensor size {x.size} not a multiple of {Q80_BLOCK_SIZE}")
    groups = x.reshape(-1, Q80_BLOCK_SIZE)
    gmax = groups.max(axis=1)
    gmin = groups.min(axis=1)
    absmax = np.where(-gmin > gmax, -gmin, gmax)
    deltas = absmax / 127.0
    deltas16 = deltas.astype(np.float16)
    inv = _safe_inverse(deltas)
    q = np.round(groups * inv[:, None]).astype(np.int8)

    out = np.empty((len(groups), Q80_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = deltas16.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def q40_to_planar(raw: np.ndarray, n_elements: int) -> tuple[np.ndarray, np.ndarray]:
    """Unpack packed Q40 bytes into planar (values int8 in [-8,7], scales f16).

    Returns ``(q, d)`` with ``q.shape == (n_elements,)`` and
    ``d.shape == (n_elements // 32,)`` such that
    ``dequant[i] = q[i] * d[i // 32]``.
    """
    n_blocks = n_elements // Q40_BLOCK_SIZE
    raw = np.frombuffer(raw, dtype=np.uint8, count=n_blocks * Q40_BLOCK_BYTES).reshape(
        n_blocks, Q40_BLOCK_BYTES
    )
    d = raw[:, :2].copy().view(np.float16).reshape(-1)
    packed = raw[:, 2:]
    half = Q40_BLOCK_SIZE // 2
    q = np.empty((n_blocks, Q40_BLOCK_SIZE), dtype=np.int8)
    q[:, :half] = (packed & 0xF).astype(np.int8) - 8
    q[:, half:] = (packed >> 4).astype(np.int8) - 8
    return q.reshape(-1), d


def pack_q40_device(q: np.ndarray, d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Planar Q40 in the port's rows -> the packed-nibble device format
    (weight_format q40i4; ops.quant_matmul.PackedQuantWeight).

    ``q`` int8 [..., out, in] values in [-8, 7], ``d`` [..., out, in // 32]
    scales -> (``qp`` uint8 [..., out, in // 2], ``d`` f16). Byte j of each
    block's 16 holds element j in its low nibble and element j + 16 in its
    high one, each plus 8: the wire's own pairing, so the bytes are the
    file's Q40 block without its scale."""
    *lead, inner = q.shape
    if inner % Q40_BLOCK_SIZE:
        raise ValueError(f"in dim {inner} not a multiple of {Q40_BLOCK_SIZE}")
    half = Q40_BLOCK_SIZE // 2
    blk = q.reshape(*lead, inner // Q40_BLOCK_SIZE, Q40_BLOCK_SIZE).astype(np.int16) + 8
    qp = (blk[..., :half] | (blk[..., half:] << 4)).astype(np.uint8)
    return qp.reshape(*lead, inner // 2), d.astype(np.float16)


def q80_to_planar(raw: np.ndarray, n_elements: int) -> tuple[np.ndarray, np.ndarray]:
    """Unpack packed Q80 bytes into planar (values int8, scales f16)."""
    n_blocks = n_elements // Q80_BLOCK_SIZE
    raw = np.frombuffer(raw, dtype=np.uint8, count=n_blocks * Q80_BLOCK_BYTES).reshape(
        n_blocks, Q80_BLOCK_BYTES
    )
    d = raw[:, :2].copy().view(np.float16).reshape(-1)
    q = raw[:, 2:].copy().view(np.int8)
    return q.reshape(-1), d


def dequantize_q40(raw: np.ndarray, n_elements: int, dtype=np.float32) -> np.ndarray:
    """Dequantize packed Q40 bytes to floats (reference: nn-quants.cpp:229-246)."""
    q, d = q40_to_planar(raw, n_elements)
    return (
        q.reshape(-1, Q40_BLOCK_SIZE).astype(np.float32) * d.astype(np.float32)[:, None]
    ).reshape(-1).astype(dtype)


def dequantize_q80(raw: np.ndarray, n_elements: int, dtype=np.float32) -> np.ndarray:
    """Dequantize packed Q80 bytes to floats (reference: nn-quants.cpp:180-191)."""
    q, d = q80_to_planar(raw, n_elements)
    return (
        q.reshape(-1, Q80_BLOCK_SIZE).astype(np.float32) * d.astype(np.float32)[:, None]
    ).reshape(-1).astype(dtype)
