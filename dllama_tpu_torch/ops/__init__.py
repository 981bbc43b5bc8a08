"""Model ops: plain torch (torch_ops) and the CUDA kernel wrappers.

`KERNELS` lists the wrappers whose ``.launches`` counts show that a run went
through the hand-written kernels."""

from .flash_attention import flash_attention_stats, flash_decode
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
