"""Model ops: plain torch (torch_ops) and the CUDA kernel wrappers.

`KERNELS` lists the wrappers whose ``.launches`` counts show that a run went
through the hand-written kernels (the int8-KV instantiations of the
attention kernels count apart, as ``*_kv8``, and their mixed-type entries,
a float cache type unlike q's, as ``*_mixed``; sequence parallelism's
strided stats entry as ``flash_attention_stats_strided``, and the int8
instantiations of the two strided entries as ``flash_attention_stats_strided_kv8``
and ``flash_decode_stats_kv8``)."""

from .flash_attention import (
    flash_attention_stats,
    flash_attention_stats_kv8,
    flash_attention_stats_mixed,
    flash_attention_stats_strided,
    flash_attention_stats_strided_kv8,
    flash_decode,
    flash_decode_kv8,
    flash_decode_mixed,
    flash_decode_stats,
    flash_decode_stats_kv8,
    paged_flash_decode,
    paged_flash_decode_kv8,
    paged_flash_decode_mixed,
)
from .int8_matmul import i8matmul_2d
from .moe import (
    moe_active_experts,
    moe_active_experts_q40,
    moe_grouped_experts,
    moe_grouped_experts_q40,
)
from .quant_matmul import qmatmul, qmatmul_i4

KERNELS = {
    "q40_matmul": qmatmul,
    "q40i4_matmul": qmatmul_i4,
    "i8_matmul": i8matmul_2d,
    "flash_attention_stats": flash_attention_stats,
    "flash_decode": flash_decode,
    "paged_flash_decode": paged_flash_decode,
    "flash_attention_stats_kv8": flash_attention_stats_kv8,
    "flash_decode_kv8": flash_decode_kv8,
    "paged_flash_decode_kv8": paged_flash_decode_kv8,
    "flash_attention_stats_mixed": flash_attention_stats_mixed,
    "flash_decode_mixed": flash_decode_mixed,
    "paged_flash_decode_mixed": paged_flash_decode_mixed,
    "flash_attention_stats_strided": flash_attention_stats_strided,
    "flash_decode_stats": flash_decode_stats,
    "flash_attention_stats_strided_kv8": flash_attention_stats_strided_kv8,
    "flash_decode_stats_kv8": flash_decode_stats_kv8,
    "moe_active_experts": moe_active_experts,
    "moe_active_experts_q40": moe_active_experts_q40,
    "moe_grouped_experts": moe_grouped_experts,
    "moe_grouped_experts_q40": moe_grouped_experts_q40,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
