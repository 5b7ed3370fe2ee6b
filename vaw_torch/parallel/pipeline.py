"""GPipe pipeline parallelism over a "stage" mesh axis (counterpart of
vaw_tpu/parallel/pipeline.py).

The blocks are grouped by stage (``stack_stage_params``), each stage holds
its own, and micro-batches flow stage to stage: M micro-batches over S
stages take M + S - 1 ticks; at tick t stage s runs micro-batch t - s, if
there is one, with the conditioning ``aux`` of that micro-batch (the
per-stage delay of vaw_tpu/parallel/pipeline.py:98-102), and passes the
result to stage s + 1. The last stage's outputs then go to every stage
(the psum of :121-124), so what follows the pipeline runs on every stage.

The schedule is written by hand, not with ``torch.distributed.pipelining``:
the JAX function is a drop-in apply whose output, aux and embeddings
stay in the caller's autograd graph, and the gradients must equal the
unpipelined model's. One ``torch.autograd.Function`` runs the whole
schedule: the forward keeps each micro-batch's local graph, the backward
replays the ticks in reverse (receive the output's gradient from stage
s + 1, back-propagate the stage's blocks, send the input's gradient to
stage s - 1), and sums the gradients of the pipeline's replicated inputs
(x and aux) over the stages, as the transpose of JAX's replicated
shard_map inputs does. Only the last stage's output gradient is used:
what follows the pipeline runs identically on every stage.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["pipeline", "stack_stage_params"]


def stack_stage_params(params_per_block: Sequence, num_stages: int) -> List[list]:
    """[L blocks] -> S lists of L / S consecutive blocks (each a module or
    a tree of tensors), stage s's at index s."""
    n = len(params_per_block)
    if n % num_stages:
        raise ValueError(f"{n} blocks do not split over {num_stages} stages")
    per = n // num_stages
    return [list(params_per_block[s * per:(s + 1) * per]) for s in range(num_stages)]


def _leaves(block) -> List[torch.Tensor]:
    if isinstance(block, nn.Module):
        return [p for p in block.parameters() if p.requires_grad]
    if isinstance(block, dict):
        return [t for t in block.values() if t.requires_grad]
    return [t for t in block if t.requires_grad]


def _p2p(op, tensor, peer, group):
    """One point-to-point transfer through batch_isend_irecv (the ring's
    route too); returns its work handle."""
    return dist.batch_isend_irecv([dist.P2POp(op, tensor, peer, group)])[0]


class _Schedule:
    """The fill-drain ticks of one stage."""

    def __init__(self, block_fn, mesh: DeviceMesh, m: int, stage_axis: str):
        self.block_fn = block_fn
        self.m = m
        self.group = mesh.get_group(stage_axis)
        self.ranks = dist.get_process_group_ranks(self.group)
        self.s = dist.get_rank(self.group)
        self.n = len(self.ranks)

    def ticks(self):
        """(tick, micro-batch) for the ticks where this stage has one."""
        for t in range(self.m + self.n - 1):
            if 0 <= t - self.s < self.m:
                yield t, t - self.s

    def run_blocks(self, blocks, x, aux):
        for block in blocks:
            x = self.block_fn(block, x, aux)
        return x

    def forward(self, blocks, x, aux, keep: Optional[list]):
        """Run the ticks; `keep`, when given, gathers each micro-batch's
        (input, aux, output) with their graphs. Returns the last stage's
        outputs, on every stage."""
        mbs, aux_mbs = x.chunk(self.m), aux.chunk(self.m)
        outputs, pending = [None] * self.m, []
        for _, i in self.ticks():
            cur = mbs[i]
            if self.s > 0:
                cur = torch.empty_like(mbs[i])
                _p2p(dist.irecv, cur, self.ranks[self.s - 1], self.group).wait()
            if keep is None:
                y = self.run_blocks(blocks, cur, aux_mbs[i])
            else:
                with torch.enable_grad():
                    x_in = cur.detach().requires_grad_()
                    a_in = aux_mbs[i].detach().requires_grad_()
                    y = self.run_blocks(blocks, x_in, a_in)
                keep.append((x_in, a_in, y))
                y = y.detach()
            if self.s < self.n - 1:
                y = y.contiguous()
                pending.append((_p2p(dist.isend, y, self.ranks[self.s + 1], self.group), y))
            else:
                outputs[i] = y
        for work, _ in pending:
            work.wait()
        out = torch.cat(outputs) if self.s == self.n - 1 else torch.empty_like(x)
        dist.broadcast(out, self.ranks[-1], group=self.group)
        return out

    def backward(self, kept, params, grad_out):
        g_mbs = grad_out.chunk(self.m)
        grad_x = [torch.zeros_like(k[0]) for k in kept]
        grad_aux = [torch.zeros_like(k[1]) for k in kept]
        grad_p = [None] * len(params)
        pending = []
        ticks = list(self.ticks())
        for j in reversed(range(len(ticks))):
            _, i = ticks[j]
            x_in, a_in, y = kept[j]
            if self.s == self.n - 1:
                gy = g_mbs[i]
            else:
                gy = torch.empty_like(y)
                _p2p(dist.irecv, gy, self.ranks[self.s + 1], self.group).wait()
            grads = torch.autograd.grad(y, [x_in, a_in] + params, gy, allow_unused=True)
            gx = grads[0] if grads[0] is not None else torch.zeros_like(x_in)
            if self.s > 0:
                gx = gx.contiguous()
                pending.append((_p2p(dist.isend, gx, self.ranks[self.s - 1], self.group), gx))
            else:
                grad_x[j] = gx
            if grads[1] is not None:
                grad_aux[j] = grads[1]
            for k, g in enumerate(grads[2:]):
                if g is not None:
                    grad_p[k] = g if grad_p[k] is None else grad_p[k] + g
        for work, _ in pending:
            work.wait()
        # Stage 0 alone back-propagates into x, every stage into aux: the
        # sums over the stages are the replicated inputs' gradients.
        gx = torch.cat(grad_x) if self.s == 0 else torch.zeros_like(grad_out)
        gaux = torch.cat(grad_aux)
        dist.all_reduce(gx, group=self.group)
        dist.all_reduce(gaux, group=self.group)
        return gx, gaux, grad_p


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, schedule, blocks, x, aux, *params):
        kept = []
        out = schedule.forward(blocks, x, aux, kept)
        ctx.schedule, ctx.kept, ctx.params = schedule, kept, list(params)
        ctx.x_dtype, ctx.aux_dtype = x.dtype, aux.dtype
        return out

    @staticmethod
    def backward(ctx, grad_out):
        gx, gaux, gp = ctx.schedule.backward(ctx.kept, ctx.params, grad_out.contiguous())
        ctx.kept = None
        gp = [torch.zeros_like(p) if g is None else g for p, g in zip(ctx.params, gp)]
        return (None, None, gx.to(ctx.x_dtype), gaux.to(ctx.aux_dtype), *gp)


def pipeline(block_fn: Callable, mesh: DeviceMesh, num_microbatches: int,
             stage_axis: str = "stage", batch_axis: Optional[str] = None):
    """A pipelined apply over `mesh`'s `stage_axis`.

    block_fn(block, x, aux) -> x applies one block. The returned function
    takes (this stage's blocks, x [b, ...], aux [b, ...]) and returns the
    whole stack's output y [b, ...] on every stage; b is this rank's batch,
    its share of the data axis `batch_axis` when data parallelism composes
    with the pipeline (each data row runs its own schedule)."""
    schedule = _Schedule(block_fn, mesh, num_microbatches, stage_axis)

    def pipelined(stage_blocks, x, aux):
        if x.shape[0] % num_microbatches:
            where = f" of data axis {batch_axis!r}" if batch_axis else ""
            raise ValueError(f"local batch {x.shape[0]}{where} does not split "
                             f"into {num_microbatches} micro-batches")
        params = [p for block in stage_blocks for p in _leaves(block)]
        if torch.is_grad_enabled() and (x.requires_grad or aux.requires_grad or params):
            return _Pipeline.apply(schedule, stage_blocks, x, aux, *params)
        return schedule.forward(stage_blocks, x, aux, None)

    return pipelined
