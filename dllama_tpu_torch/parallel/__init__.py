"""Tensor and sequence parallelism of the port on ``torch.distributed``
(counterpart of dllama_tpu/parallel/): the rank mesh and its checks
(`mesh`), the collectives with the q80 sync buffer (`collectives`), the
weight slices and KV shards (`sharding`), ring attention (`ring_attention`),
the launcher of a host's ranks (`launch`) and the control plane of serving,
rank 0 controlling and the other ranks following (`control`)."""

from .mesh import Axis, Mesh, auto_tp, init_distributed, make_mesh, validate_sp, validate_tp
from .sharding import kv_shard_shape, lane_shard_shape, pool_shard_shape, shard_params

__all__ = [
    "Axis",
    "Mesh",
    "auto_tp",
    "init_distributed",
    "make_mesh",
    "validate_sp",
    "validate_tp",
    "kv_shard_shape",
    "lane_shard_shape",
    "pool_shard_shape",
    "shard_params",
]
