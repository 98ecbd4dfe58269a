"""Parallel layouts over torch.distributed (counterpart of
meant_tpu/parallel/): the mesh and batch placement, megatron
tensor-parallel rules with their differentiable collectives, FSDP
shardings and the GPipe pipeline."""

from .mesh import (batch_sharding, make_hybrid_mesh, make_mesh,
                   replicate_tree, replicated, shard_batch)
from .sharding_rules import (DEFAULT_TP_RULES, param_shardings,
                             parallelize_model, shard_params)
from .fsdp import fsdp_shard, fsdp_shardings, fsdp_spec
from .pipeline import (pipeline_apply, pipeline_stage_shardings,
                       stack_layer_params)

__all__ = ["batch_sharding", "make_hybrid_mesh", "make_mesh",
           "replicate_tree", "replicated",
           "shard_batch", "DEFAULT_TP_RULES", "param_shardings",
           "parallelize_model", "shard_params", "fsdp_shard",
           "fsdp_shardings", "fsdp_spec", "pipeline_apply",
           "pipeline_stage_shardings", "stack_layer_params"]
