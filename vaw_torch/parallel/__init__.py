"""Training on more than one GPU (counterpart of vaw_tpu/parallel): process
setup, device meshes, tensor parallelism and FSDP, ring attention, the
GPipe pipeline and the pipelined and sequence-parallel DiT."""

from .mesh import (
    batch_sharding,
    local_device_count,
    make_mesh,
    make_pp_mesh,
    replicated_sharding,
    shard_batch,
)
from .pipeline import pipeline, stack_stage_params
from .dit_pipeline import pipelined_dit_apply, stage_block_params
from .sp_dit import sequence_parallel_dit_apply
from .partition import (
    fsdp_param_shardings,
    fsdp_partition_specs,
    param_shardings,
    partition_specs,
    pp_param_shardings,
    shard_params,
    transformer_partition_rules,
    tree_shardings_like,
)

__all__ = [
    "make_mesh", "make_pp_mesh", "batch_sharding", "replicated_sharding",
    "shard_batch", "local_device_count",
    "partition_specs", "param_shardings", "shard_params",
    "transformer_partition_rules",
    "fsdp_partition_specs", "fsdp_param_shardings", "pp_param_shardings",
    "tree_shardings_like",
    "pipeline", "stack_stage_params",
    "pipelined_dit_apply", "stage_block_params",
    "sequence_parallel_dit_apply",
]
