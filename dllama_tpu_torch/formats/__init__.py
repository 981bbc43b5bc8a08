from .quants import (
    Q40_BLOCK_SIZE,
    Q80_BLOCK_SIZE,
    FloatType,
    quantize_q40,
    quantize_q80,
    dequantize_q40,
    dequantize_q80,
    q40_to_planar,
    q80_to_planar,
    tensor_bytes,
)
from .model_file import LlmArch, LlmHeader, RopeType, read_llm_header, ModelReader
from .tokenizer_file import TokenizerData, read_tokenizer, write_tokenizer

__all__ = [
    "Q40_BLOCK_SIZE",
    "Q80_BLOCK_SIZE",
    "FloatType",
    "quantize_q40",
    "quantize_q80",
    "dequantize_q40",
    "dequantize_q80",
    "q40_to_planar",
    "q80_to_planar",
    "tensor_bytes",
    "LlmArch",
    "LlmHeader",
    "RopeType",
    "read_llm_header",
    "ModelReader",
    "TokenizerData",
    "read_tokenizer",
    "write_tokenizer",
]
