"""Tensor and sequence parallelism of the port on ``torch.distributed``
(counterpart of dllama_tpu/parallel/): the rank mesh and its checks
(`mesh`), the collectives with the q80 sync buffer (`collectives`), the
weight slices and KV shards (`sharding`), ring attention (`ring_attention`)
and the launcher of a host's ranks (`launch`)."""

from .mesh import Axis, Mesh, auto_tp, init_distributed, make_mesh, validate_sp, validate_tp
from .sharding import kv_shard_shape, shard_params

__all__ = [
    "Axis",
    "Mesh",
    "auto_tp",
    "init_distributed",
    "make_mesh",
    "validate_sp",
    "validate_tp",
    "kv_shard_shape",
    "shard_params",
]
