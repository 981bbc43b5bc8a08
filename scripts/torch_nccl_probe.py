#!/usr/bin/env python3
"""Whether NCCL runs two ranks on one card (the port's backend rule says no).

    python3 scripts/torch_nccl_probe.py        # from the repository root, on a machine with a card

Starts two ranks on ``cuda:0`` with the NCCL backend (parallel/launch.py,
the backend forced past `mesh.pick_backend`'s rule) and runs one f32
all-reduce. NCCL is expected to refuse at that collective ("Duplicate GPU
detected"); the script prints the card, then either the result or the tail
of the refusal, and exits 0 either way (a probe, not a gate).
"""

from __future__ import annotations

import os
import subprocess
import sys


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    import torch

    from dllama_tpu_torch.parallel.launch import collective_target, spawn

    if not torch.cuda.is_available():
        print("torch_nccl_probe: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    x = np.ones((2, 1, 64), np.float32)
    try:
        out = spawn(collective_target, 2, "cuda:0", "nccl", args=([("all_reduce", 2, False, x)],),
                    timeout_s=90, pg_timeout_s=30)
        print("NCCL two ranks on cuda:0 ran:", out[0][0].ravel()[:4])
    except (RuntimeError, TimeoutError) as e:
        print("NCCL two ranks on cuda:0 refused:", str(e)[-1500:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
