from .loader import load_params
from .transformer import forward, init_kv_cache

__all__ = ["forward", "init_kv_cache", "load_params"]
