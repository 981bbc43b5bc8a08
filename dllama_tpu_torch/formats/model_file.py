"""Reader for distributed-llama's `.m` model file format.

Format (reference: src/llm.cpp:36-116, converter/writer.py:109-148):

    int32 magic = 0xA00ABCD
    int32 headerSize          # bytes, counting magic+headerSize themselves
    int32 key, int32 value    # repeated; keys from LlmHeaderKey (src/llm.hpp:8-31)
    ...tensor data...         # fixed order, see `tensor_plan`

Quirks faithfully reproduced:
  * float-valued header fields (rope theta, rope scaling factors) are stored
    as ints and cast (src/llm.cpp:86-91) — only integer values survive;
  * norm epsilon is an enum: 5 -> 1e-5, 6 -> 1e-6 (src/llm.cpp:30-34);
  * ``head_dim`` defaults to dim/nHeads when absent (src/llm.cpp:106-108);
  * Qwen3 / Qwen3-MoE force Falcon (half-rotation) RoPE (src/llm.cpp:113-114).

The tensor section is walked lazily via a single ``np.memmap``; per-tensor
views are zero-copy, so a 40 GB 70B file never materializes on host. The
tensor order matches the converter exactly (converter/convert-hf.py:59-104)
which is the same order `loadLlmNetWeight` consumes (src/llm.cpp:614-669).
"""

from __future__ import annotations

import dataclasses
import enum
import struct
from typing import Iterator

import numpy as np

from .quants import (
    FloatType,
    dequantize_q40,
    dequantize_q80,
    q40_to_planar,
    tensor_bytes,
)

MODEL_MAGIC = 0x0A00ABCD
_OLD_MAGICS = (0xABCD00, 0xABCD01)


class LlmArch(enum.IntEnum):
    """Model architectures (reference: src/llm.hpp:38-42)."""

    LLAMA = 0xABCD00
    QWEN3 = 0xABCD01
    QWEN3_MOE = 0xABCD02


class RopeType(enum.IntEnum):
    """RoPE variants (reference: src/nn/nn-core.hpp:125-129)."""

    LLAMA = 0  # interleaved pairs (x[2i], x[2i+1])
    FALCON = 1  # half-rotation (x[j], x[j + headDim/2])
    LLAMA3_1 = 2  # interleaved + llama-3.1 frequency scaling


class HiddenAct(enum.IntEnum):
    """FFN activation (reference: src/llm.hpp:33-36)."""

    GELU = 0
    SILU = 1


class HeaderKey(enum.IntEnum):
    """`.m` header keys (reference: src/llm.hpp:8-31)."""

    VERSION = 0
    ARCH_TYPE = 1
    DIM = 2
    HIDDEN_DIM = 3
    N_LAYERS = 4
    N_HEADS = 5
    N_KV_HEADS = 6
    N_EXPERTS = 7
    N_ACTIVE_EXPERTS = 8
    VOCAB_SIZE = 9
    SEQ_LEN = 10
    HIDDEN_ACT = 11
    ROPE_THETA = 12
    WEIGHT_FLOAT_TYPE = 13
    ROPE_SCALING_FACTOR = 14
    ROPE_SCALING_LOW_FREQ_FACTOR = 15
    ROPE_SCALING_HIGH_FREQ_FACTORY = 16
    ROPE_SCALING_ORIG_MAX_SEQ_LEN = 17
    ROPE_TYPE = 18
    HEAD_DIM = 19
    NORM_EPSILON = 20
    MOE_HIDDEN_DIM = 21


@dataclasses.dataclass
class LlmHeader:
    """Parsed `.m` header (mirror of reference LlmHeader, src/llm.hpp:44-74)."""

    version: int = 0
    arch: LlmArch = LlmArch.LLAMA
    dim: int = 0
    hidden_dim: int = 0
    n_layers: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    n_experts: int = 0
    n_active_experts: int = 0
    vocab_size: int = 0
    orig_seq_len: int = 0
    seq_len: int = 0
    hidden_act: HiddenAct = HiddenAct.SILU
    rope_theta: float = 10000.0
    weight_type: FloatType = FloatType.Q40
    rope_scaling_factor: float = 1.0
    rope_scaling_low_freq_factor: float = 0.0
    rope_scaling_high_freq_factor: float = 0.0
    rope_scaling_orig_max_seq_len: int = 0
    rope_type: RopeType = RopeType.LLAMA
    head_dim: int = 0
    norm_epsilon: float = 1e-5
    moe_hidden_dim: int = 0
    header_bytes: int = 0
    file_size: int = 0
    sync_type: FloatType = FloatType.Q80

    @property
    def q_dim(self) -> int:
        return self.head_dim * self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.head_dim * self.n_kv_heads

    @property
    def ff_dim(self) -> int:
        """Per-expert (MoE) or dense FFN intermediate dim (src/llm.cpp:152-157)."""
        if self.arch == LlmArch.QWEN3_MOE:
            return self.moe_hidden_dim
        return self.hidden_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


def _norm_epsilon(value: int) -> float:
    if value == 5:
        return 1e-5
    if value == 6:
        return 1e-6
    raise ValueError(f"unsupported norm epsilon enum: {value}")


def read_llm_header(
    path: str, max_seq_len: int = 0, sync_type: FloatType = FloatType.Q80
) -> LlmHeader:
    """Parse the `.m` header (reference: src/llm.cpp:36-116)."""
    h = LlmHeader()
    with open(path, "rb") as f:
        (magic,) = struct.unpack("<i", f.read(4))
        if magic in _OLD_MAGICS:
            raise ValueError("old model format is not supported")
        if magic != MODEL_MAGIC:
            raise ValueError(f"unsupported magic number: {magic:#x}")
        (header_size,) = struct.unpack("<i", f.read(4))
        n_kv_bytes = header_size - 8
        buf = f.read(n_kv_bytes)
        values = struct.unpack(f"<{n_kv_bytes // 4}i", buf)
        weight_type = None
        for key, value in zip(values[0::2], values[1::2]):
            key = HeaderKey(key)
            if key == HeaderKey.VERSION:
                h.version = value
            elif key == HeaderKey.ARCH_TYPE:
                h.arch = LlmArch(value)
            elif key == HeaderKey.DIM:
                h.dim = value
            elif key == HeaderKey.HIDDEN_DIM:
                h.hidden_dim = value
            elif key == HeaderKey.N_LAYERS:
                h.n_layers = value
            elif key == HeaderKey.N_HEADS:
                h.n_heads = value
            elif key == HeaderKey.N_KV_HEADS:
                h.n_kv_heads = value
            elif key == HeaderKey.N_EXPERTS:
                h.n_experts = value
            elif key == HeaderKey.N_ACTIVE_EXPERTS:
                h.n_active_experts = value
            elif key == HeaderKey.VOCAB_SIZE:
                h.vocab_size = value
            elif key == HeaderKey.SEQ_LEN:
                h.seq_len = value
            elif key == HeaderKey.HIDDEN_ACT:
                h.hidden_act = HiddenAct(value)
            elif key == HeaderKey.ROPE_THETA:
                h.rope_theta = float(value)
            elif key == HeaderKey.WEIGHT_FLOAT_TYPE:
                weight_type = FloatType(value)
            elif key == HeaderKey.ROPE_SCALING_FACTOR:
                h.rope_scaling_factor = float(value)
            elif key == HeaderKey.ROPE_SCALING_LOW_FREQ_FACTOR:
                h.rope_scaling_low_freq_factor = float(value)
            elif key == HeaderKey.ROPE_SCALING_HIGH_FREQ_FACTORY:
                h.rope_scaling_high_freq_factor = float(value)
            elif key == HeaderKey.ROPE_SCALING_ORIG_MAX_SEQ_LEN:
                h.rope_scaling_orig_max_seq_len = value
            elif key == HeaderKey.ROPE_TYPE:
                h.rope_type = RopeType(value)
            elif key == HeaderKey.HEAD_DIM:
                h.head_dim = value
            elif key == HeaderKey.NORM_EPSILON:
                h.norm_epsilon = _norm_epsilon(value)
            elif key == HeaderKey.MOE_HIDDEN_DIM:
                h.moe_hidden_dim = value

        if weight_type is None:
            raise ValueError("model does not specify weight type")
        h.weight_type = weight_type
        h.header_bytes = header_size
        f.seek(0, 2)
        h.file_size = f.tell()

    h.orig_seq_len = h.seq_len
    if max_seq_len > 0 and h.seq_len > max_seq_len:
        h.seq_len = max_seq_len
    if h.head_dim == 0:
        h.head_dim = h.dim // h.n_heads
    h.sync_type = sync_type
    if h.arch in (LlmArch.QWEN3, LlmArch.QWEN3_MOE):
        h.rope_type = RopeType.FALCON
    return h


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """One tensor's location inside the `.m` file."""

    name: str
    float_type: FloatType
    shape: tuple[int, ...]  # row-major, HF convention: (out_features, in_features)
    offset: int  # absolute byte offset in the file
    nbytes: int

    @property
    def n_elements(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def tensor_plan(h: LlmHeader) -> list[TensorSpec]:
    """The fixed tensor order of a `.m` file.

    Mirrors converter/convert-hf.py:59-104 (writer side) and
    src/llm.cpp:614-669 (reader side). Shapes are (out, in) row-major as
    exported from HF safetensors.
    """
    specs: list[TensorSpec] = []
    offset = h.header_bytes  # header_bytes counts magic+headerSize+kv data
    wt = h.weight_type

    def add(name: str, ft: FloatType, shape: tuple[int, ...]) -> None:
        nonlocal offset
        n = 1
        for s in shape:
            n *= s
        nbytes = tensor_bytes(ft, n)
        specs.append(TensorSpec(name, ft, shape, offset, nbytes))
        offset += nbytes

    add("embed", FloatType.F32, (h.vocab_size, h.dim))
    for l in range(h.n_layers):
        add(f"layers.{l}.q", wt, (h.q_dim, h.dim))
        add(f"layers.{l}.k", wt, (h.kv_dim, h.dim))
        add(f"layers.{l}.v", wt, (h.kv_dim, h.dim))
        add(f"layers.{l}.wo", wt, (h.dim, h.q_dim))
        if h.n_experts > 0:
            add(f"layers.{l}.moe_gate", FloatType.F32, (h.n_experts, h.dim))
            for e in range(h.n_experts):
                add(f"layers.{l}.experts.{e}.w1", wt, (h.ff_dim, h.dim))
                add(f"layers.{l}.experts.{e}.w2", wt, (h.dim, h.ff_dim))
                add(f"layers.{l}.experts.{e}.w3", wt, (h.ff_dim, h.dim))
        else:
            add(f"layers.{l}.w1", wt, (h.ff_dim, h.dim))
            add(f"layers.{l}.w2", wt, (h.dim, h.ff_dim))
            add(f"layers.{l}.w3", wt, (h.ff_dim, h.dim))
        if h.arch in (LlmArch.QWEN3, LlmArch.QWEN3_MOE):
            add(f"layers.{l}.q_norm", FloatType.F32, (h.head_dim,))
            add(f"layers.{l}.k_norm", FloatType.F32, (h.head_dim,))
        add(f"layers.{l}.att_norm", FloatType.F32, (h.dim,))
        add(f"layers.{l}.ffn_norm", FloatType.F32, (h.dim,))
    add("final_norm", FloatType.F32, (h.dim,))
    add("wcls", wt, (h.vocab_size, h.dim))
    return specs


class ModelReader:
    """Lazy reader over a `.m` file's tensor section.

    Uses a read-only memmap (the reference's mmap weight loader,
    src/mmap.hpp + src/llm.cpp:614-669): tensors are materialized one at a
    time, so peak host memory stays at one tensor regardless of model size.
    """

    def __init__(self, path: str, max_seq_len: int = 0):
        self.path = path
        self.header = read_llm_header(path, max_seq_len=max_seq_len)
        self.specs = tensor_plan(self.header)
        self.by_name = {s.name: s for s in self.specs}
        expected_end = self.specs[-1].offset + self.specs[-1].nbytes
        if expected_end != self.header.file_size:
            raise ValueError(
                f"model file size mismatch: expected {expected_end} bytes, "
                f"file has {self.header.file_size} (wrong arch/config?)"
            )
        self._mmap = np.memmap(path, dtype=np.uint8, mode="r")

    def raw(self, name: str) -> np.ndarray:
        """Zero-copy packed bytes of a tensor."""
        s = self.by_name[name]
        return self._mmap[s.offset : s.offset + s.nbytes]

    def raw_span(self, first: str, last: str) -> np.ndarray:
        """Zero-copy bytes from tensor ``first`` through tensor ``last``
        (contiguous in plan order, e.g. one layer's experts)."""
        a, b = self.by_name[first], self.by_name[last]
        return self._mmap[a.offset : b.offset + b.nbytes]

    def dense_f32(self, name: str) -> np.ndarray:
        """Tensor dequantized to f32, in its file shape."""
        s = self.by_name[name]
        raw = self.raw(name)
        if s.float_type == FloatType.F32:
            out = raw.view(np.float32).copy()
        elif s.float_type == FloatType.F16:
            out = raw.view(np.float16).astype(np.float32)
        elif s.float_type == FloatType.Q40:
            out = dequantize_q40(raw, s.n_elements)
        elif s.float_type == FloatType.Q80:
            out = dequantize_q80(raw, s.n_elements)
        else:
            raise ValueError(f"unsupported float type: {s.float_type}")
        return out.reshape(s.shape)

    def planar_q40(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        """Tensor as planar int8 values [out, in] + f16 scales [out, in//32]:
        the port's device layout for the Q40 matmul kernel, unpacked on host
        (the loader unpacks on the device; this is its numpy oracle)."""
        s = self.by_name[name]
        if s.float_type != FloatType.Q40:
            raise ValueError(f"{name} is {s.float_type}, not Q40")
        q, d = q40_to_planar(self.raw(name), s.n_elements)
        out, inner = s.shape[-2], s.shape[-1]
        lead = s.shape[:-2]
        return (
            q.reshape(*lead, out, inner),
            d.reshape(*lead, out, inner // 32),
        )

    def __iter__(self) -> Iterator[TensorSpec]:
        return iter(self.specs)
