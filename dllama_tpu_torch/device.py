"""Device pick for the port: CUDA unless the caller asks for the CPU.

Entry points take an explicit ``device``. ``None`` means ``cuda``; a CUDA
request on a machine without a card raises instead of running elsewhere.
The CPU is for tests and the plain PyTorch versions of the kernels.

TF32 is switched off for float32 matrix products and convolutions when
this module is imported: the float32 paths are the port's exactness
oracles, and TF32 keeps only about three decimal digits.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` by default; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
