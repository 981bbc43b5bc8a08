"""Runtime analysis helpers of the port: `lockwatch` (lock-order tracking
and deterministic interleaving), a copy of dllama_tpu/analysis/lockwatch.py."""
