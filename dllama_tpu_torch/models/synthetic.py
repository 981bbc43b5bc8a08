"""Synthetic models: real-shape headers and random Q40 `.m` files.

Counterpart of dllama_tpu/models/synthetic.py (`PRESETS`, `make_header`,
`write_synth_model`), numpy only. The JAX package's writer tiles one random
row per width, so every output column of a matrix is the same and greedy
decoding of such a file is degenerate (all logits equal). This writer
draws every Q40 block independently instead — random nibbles and random
f16 scales, streamed in chunks — so logits differ across the vocabulary
and a greedy stream exercises the model, at the same O(chunk) host memory.
"""

from __future__ import annotations

import numpy as np

from ..formats.model_file import HiddenAct, LlmArch, LlmHeader, RopeType, tensor_plan
from ..formats.quants import Q40_BLOCK_BYTES, Q40_BLOCK_SIZE, FloatType
from ..formats.writer import write_header

# Real-model shape presets (reference model zoo, launch.py:17-73).
PRESETS = {
    "llama-1b": dict(
        dim=2048, hidden_dim=8192, n_layers=16, n_heads=32, n_kv_heads=8,
        head_dim=64, vocab_size=128256, seq_len=131072, rope_theta=500000.0,
    ),
    "llama-8b": dict(
        dim=4096, hidden_dim=14336, n_layers=32, n_heads=32, n_kv_heads=8,
        head_dim=128, vocab_size=128256, seq_len=131072, rope_theta=500000.0,
    ),
    "llama-70b": dict(
        dim=8192, hidden_dim=28672, n_layers=80, n_heads=64, n_kv_heads=8,
        head_dim=128, vocab_size=128256, seq_len=131072, rope_theta=500000.0,
    ),
    "qwen3-14b": dict(
        dim=5120, hidden_dim=17408, n_layers=40, n_heads=40, n_kv_heads=8,
        head_dim=128, vocab_size=151936, seq_len=40960, rope_theta=1000000.0,
        arch=LlmArch.QWEN3,
    ),
    "qwen3-30b-a3b": dict(
        dim=2048, hidden_dim=6144, moe_hidden_dim=768, n_layers=48,
        n_heads=32, n_kv_heads=4, head_dim=128, vocab_size=151936,
        seq_len=40960, rope_theta=1000000.0, arch=LlmArch.QWEN3_MOE,
        n_experts=128, n_active_experts=8,
    ),
    "tiny": dict(
        dim=64, hidden_dim=160, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=16, vocab_size=256, seq_len=64,
    ),
}

# Q40 weights from uniform nibbles (values -8..7, std ~4.61) and scales in
# [0.75, 1.25] x this, for a weight std near 0.02 like the JAX writer's rows
_SCALE = 0.02 / 4.61


def make_header(preset: str | dict, max_seq_len: int = 0) -> LlmHeader:
    cfg = dict(PRESETS[preset]) if isinstance(preset, str) else dict(preset)
    h = LlmHeader()
    h.arch = cfg.pop("arch", LlmArch.LLAMA)
    h.n_experts = cfg.pop("n_experts", 0)
    h.n_active_experts = cfg.pop("n_active_experts", 0)
    h.moe_hidden_dim = cfg.pop("moe_hidden_dim", 0)
    h.rope_theta = cfg.pop("rope_theta", 10000.0)
    for k, v in cfg.items():
        setattr(h, k, v)
    h.orig_seq_len = h.seq_len
    if max_seq_len and h.seq_len > max_seq_len:
        h.seq_len = max_seq_len
    if h.head_dim == 0:
        h.head_dim = h.dim // h.n_heads
    h.hidden_act = HiddenAct.SILU
    h.weight_type = FloatType.Q40
    # Qwen3 and Qwen3-MoE force falcon RoPE, as the file reader does
    h.rope_type = (
        RopeType.FALCON if h.arch in (LlmArch.QWEN3, LlmArch.QWEN3_MOE) else RopeType.LLAMA
    )
    h.norm_epsilon = 1e-5
    return h


def write_synth_model(
    path,
    preset: str | dict = "llama-8b",
    seed: int = 0,
    max_seq_len: int = 4096,
    n_layers: int | None = None,
    chunk_blocks: int = 1 << 20,
) -> LlmHeader:
    """Write a random Q40 `.m` of real widths to ``path`` (norms 1.0, other
    f32 tensors uniform with std 0.02, every Q40 block drawn from ``seed``);
    ``n_layers`` cuts depth. Returns the header describing the file."""
    cfg = dict(PRESETS[preset]) if isinstance(preset, str) else dict(preset)
    if n_layers is not None:
        cfg["n_layers"] = n_layers
    h = make_header(cfg, max_seq_len=max_seq_len)
    params = {
        "version": 0,
        "arch_type": int(h.arch),
        "dim": h.dim,
        "hidden_dim": h.hidden_dim,
        "n_layers": h.n_layers,
        "n_heads": h.n_heads,
        "n_kv_heads": h.n_kv_heads,
        "n_experts": h.n_experts,
        "n_active_experts": h.n_active_experts,
        "vocab_size": h.vocab_size,
        "max_seq_len": h.seq_len,
        "hidden_act": int(h.hidden_act),
        "rope_theta": int(h.rope_theta),
        "weights_float_type": int(FloatType.Q40),
        "head_dim": h.head_dim,
        "norm_epsilon": 5,  # header quirk: eps rides as an enum (5 = 1e-5)
    }
    if h.arch == LlmArch.QWEN3_MOE:
        params["moe_hidden_dim"] = h.moe_hidden_dim
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        write_header(f, params)
        for spec in tensor_plan(h):
            n = spec.n_elements
            if spec.float_type == FloatType.F32:
                if "norm" in spec.name:
                    f.write(np.ones(n, np.float32).tobytes())
                    continue
                for i in range(0, n, chunk_blocks * Q40_BLOCK_SIZE):
                    m = min(chunk_blocks * Q40_BLOCK_SIZE, n - i)
                    u = rng.random(m, dtype=np.float32) - np.float32(0.5)
                    f.write((u * np.float32(0.02 * 12**0.5)).tobytes())
            elif spec.float_type == FloatType.Q40:
                n_blocks = n // Q40_BLOCK_SIZE
                for i in range(0, n_blocks, chunk_blocks):
                    m = min(chunk_blocks, n_blocks - i)
                    blk = np.empty((m, Q40_BLOCK_BYTES), np.uint8)
                    scale = (rng.random(m, dtype=np.float32) * 0.5 + 0.75) * _SCALE
                    scale[rng.random(m) < 0.5] *= -1  # a Q40 scale takes the extremum's sign
                    blk[:, :2] = scale.astype(np.float16).view(np.uint8).reshape(m, 2)
                    blk[:, 2:] = rng.bit_generator.random_raw(m * 2).view(np.uint8).reshape(m, 16)
                    f.write(blk.tobytes())
            else:  # pragma: no cover - synth files are Q40 + F32 only
                raise ValueError(f"unsupported synth type {spec.float_type}")
    return h
