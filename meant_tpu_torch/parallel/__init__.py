"""Parallel layouts over torch.distributed (counterpart of
meant_tpu/parallel/, less the pipeline): the mesh and batch placement,
megatron tensor-parallel rules and FSDP shardings."""

from .mesh import (batch_sharding, make_hybrid_mesh, make_mesh,
                   replicate_tree, replicated, shard_batch)
from .sharding_rules import (DEFAULT_TP_RULES, param_shardings,
                             shard_params)
from .fsdp import fsdp_shard, fsdp_shardings, fsdp_spec

__all__ = ["batch_sharding", "make_hybrid_mesh", "make_mesh",
           "replicate_tree", "replicated",
           "shard_batch", "DEFAULT_TP_RULES", "param_shardings",
           "shard_params", "fsdp_shard", "fsdp_shardings", "fsdp_spec"]
