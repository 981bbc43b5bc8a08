"""dllama_tpu_torch: the PyTorch/CUDA port of dllama_tpu for NVIDIA Hopper.

A package of its own beside the JAX one: it imports torch and numpy, never
jax and nothing of dllama_tpu, and keeps its own copies of the formats,
tokenizer and sampler. The Q40 matmul and the prefill and decode attention
run as hand-written CUDA kernels (csrc/) on the card; on CPU tensors the
same wrappers run their plain PyTorch versions.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
