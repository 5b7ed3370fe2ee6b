"""Sequence-parallel DiT: image rows split over an "sp" mesh axis
(counterpart of vaw_tpu/parallel/sp_dit.py).

Each rank of the sp group takes its rows of the (data-local) image; the
patch conv is stride == kernel, so it embeds its own token rows with no
halo; the frozen position table is sliced to those rows; adaLN, LayerNorm,
MLP, final layer and unpatchify are per token and stay local; attention
runs as the ring (parallel/ring_attention.py), so no rank holds the whole
K/V. The output rows are then gathered, so the loss runs on every rank of
the group; the gather's backward keeps the rank's own rows, and the
parameters' gradients, each rank's share, are summed over the sp group by
the Trainer (the transpose of JAX's replicated shard_map inputs).
Composes with data parallelism on a ("data", "sp") mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["sequence_parallel_dit_apply", "SeqShard"]


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """This rank's place in a sequence-parallel group."""
    group: object
    index: int
    size: int


class _GatherRows(torch.autograd.Function):
    """[N, H / S, W, C] on each rank of the group -> [N, H, W, C] on every
    rank; the backward keeps this rank's rows of the gradient."""

    @staticmethod
    def forward(ctx, x, seq: SeqShard):
        ctx.seq, ctx.rows = seq, x.shape[1]
        parts = [torch.empty_like(x) for _ in range(seq.size)]
        dist.all_gather(parts, x.contiguous(), group=seq.group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        i, rows = ctx.seq.index, ctx.rows
        return grad[:, i * rows:(i + 1) * rows], None


def sequence_parallel_dit_apply(model: nn.Module, mesh: DeviceMesh, seq_axis: str = "sp",
                                batch_axis: Optional[str] = None):
    """An apply function running `model` sequence-parallel over `mesh`'s
    `seq_axis`, with the model's forward signature, returning the whole
    image of this rank's batch (its share of `batch_axis`). Needs
    (image_size // patch_size) % sp == 0 and no REPA tap."""
    if getattr(model, "projectors", None) is not None:
        raise ValueError("sequence-parallel DiT does not support the REPA tap")
    n_sp = mesh.size(mesh.mesh_dim_names.index(seq_axis))
    if model.grid % n_sp:
        raise ValueError(f"{model.grid} token rows do not split over {n_sp} sp ranks")
    seq = SeqShard(mesh.get_group(seq_axis), mesh.get_local_rank(seq_axis), n_sp)
    del batch_axis  # each rank already holds its data row's batch

    def apply_fn(x, t, y=None, train: bool = False, force_drop_ids=None,
                 generator=None):
        rows = x.shape[1] // n_sp
        local = x[:, seq.index * rows:(seq.index + 1) * rows]
        out = model(local, t, y, train=train, force_drop_ids=force_drop_ids,
                    generator=generator, seq=seq)
        return _GatherRows.apply(out, seq)

    return apply_fn
