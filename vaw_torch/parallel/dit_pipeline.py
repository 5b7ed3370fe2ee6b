"""Pipeline-parallel DiT: the blocks over a "stage" mesh axis (counterpart
of vaw_tpu/parallel/dit_pipeline.py).

Stage s holds blocks [s L / S, (s + 1) L / S) of ``blocks.{i}``
(``stage_block_params``); the patch, position, t and y embeddings and the
final layer are small and run replicated on every stage, and only the
depth-proportional block stack goes through the GPipe schedule
(parallel/pipeline.py). The returned function stands in for the model's
forward in the Trainer; the gradients of the replicated parameters equal
the plain model's (the pipeline sums x's and aux's gradients over the
stages).
"""

from __future__ import annotations

from typing import List, Optional

from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from .partition import pp_param_shardings
from .pipeline import pipeline, stack_stage_params

__all__ = ["pipelined_dit_apply", "stage_block_params", "BLOCK_STACK_KEY"]

BLOCK_STACK_KEY = "blocks"


def stage_block_params(model: nn.Module, num_stages: int) -> List[List[nn.Module]]:
    """``blocks.{i}`` grouped by stage: [S lists of L / S blocks]."""
    return stack_stage_params(list(getattr(model, BLOCK_STACK_KEY)), num_stages)


def _stage(mesh: DeviceMesh, stage_axis: str):
    return mesh.get_local_rank(stage_axis), mesh.size(mesh.mesh_dim_names.index(stage_axis))


def pipelined_dit_apply(model: nn.Module, mesh: DeviceMesh, num_microbatches: int,
                        stage_axis: str = "stage", batch_axis: Optional[str] = None):
    """An apply function running `model`'s blocks pipelined; its signature
    is the model's forward: apply_fn(x, t, y=None, train=False,
    force_drop_ids=None, generator=None) -> out. Needs depth % stages ==
    0 and no REPA tap."""
    if getattr(model, "projectors", None) is not None:
        raise ValueError("the pipelined DiT does not support the REPA tap")
    stage, num_stages = _stage(mesh, stage_axis)
    owned = pp_param_shardings(len(model.blocks), num_stages, stage)
    blocks = stage_block_params(model, num_stages)[stage]  # blocks[i] for i in owned

    def block_fn(block, x, c):
        return model.run_block(block)(x, c)

    pp = pipeline(block_fn, mesh, num_microbatches, stage_axis=stage_axis,
                  batch_axis=batch_axis)

    def apply_fn(x, t, y=None, train: bool = False, force_drop_ids=None,
                 generator=None):
        h, c = model.embed(x, t, y, train, force_drop_ids, generator)
        h = pp(blocks, h, c)
        return model.head(h, c)

    apply_fn.owned_blocks = owned
    return apply_fn
