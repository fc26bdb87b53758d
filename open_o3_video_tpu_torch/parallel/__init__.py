"""Meshes of processes, the sharding rules, and the multi-process bootstrap
(counterpart of ``open_o3_video_tpu/parallel``): torch.distributed, one
process per rank; context parallelism (``context.py``, with
``ops/ring_attention.py``) and the pipeline (``pipeline.py``)."""

from . import distributed
from .mesh import (Mesh, gather_params, make_mesh, param_sharding_rules, replicate,
                   replicate_scalars, shard_params)

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_params",
    "gather_params",
    "param_sharding_rules",
    "replicate",
    "replicate_scalars",
    "distributed",
]
