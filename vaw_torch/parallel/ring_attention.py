"""Ring attention: attention with the sequence split over the ranks of a
group (counterpart of vaw_tpu/parallel/ring_attention.py).

Each rank holds a contiguous token shard of q, k and v. Over S steps it
attends its queries to the K/V chunk it holds, accumulating in f32 with a
running (online) log-sum-exp softmax, the numerics of
vaw_tpu/parallel/ring_attention.py:37-50, in plain torch as JAX computes
it in plain jnp; between steps K and V move on to rank (r + 1) % S
(``batch_isend_irecv``). After S steps every rank has attended its queries
to the whole sequence, and no rank ever held the whole K/V. The move is a
``torch.autograd.Function`` whose backward sends the gradient the other
way, the transpose of JAX's ppermute; K and V move in one Function, so
every rank runs the backward's exchanges in the same order.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["ring_attention", "ring_attention_local"]


def _shift(group, step: int, *tensors):
    """Send each tensor to the rank `step` places on in the group's ring and
    receive the same shapes from the rank `step` places back."""
    ranks = dist.get_process_group_ranks(group)
    i, n = dist.get_rank(group), len(ranks)
    dst, src = ranks[(i + step) % n], ranks[(i - step) % n]
    sends = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in sends]
    ops = []
    for t, o in zip(sends, outs):
        ops.append(dist.P2POp(dist.isend, t, dst, group))
        ops.append(dist.P2POp(dist.irecv, o, src, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


class _RingShift(torch.autograd.Function):
    """(k, v) -> the (k, v) of the rank before on the ring; the backward
    returns the gradients to that rank."""

    @staticmethod
    def forward(ctx, group, k, v):
        ctx.group = group
        return tuple(_shift(group, 1, k, v))

    @staticmethod
    def backward(ctx, gk, gv):
        gk, gv = (torch.zeros_like(g) if g is None else g for g in (gk, gv))
        return (None, *_shift(ctx.group, -1, gk, gv))


def _chunk_attention(q, k, v, m_i, l_i, acc, scale):
    """One online-softmax step over a K/V chunk (vaw_tpu/parallel/
    ring_attention.py:37-50). q: [B, H, Tq, D] f32, k/v: [B, H, Tc, D];
    m_i/l_i: [B, H, Tq], acc like q."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.float()) * scale
    m_new = torch.maximum(m_i, s.amax(dim=-1))
    alpha = torch.exp(m_i - m_new)
    p = torch.exp(s - m_new[..., None])
    acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    l_i = l_i * alpha + p.sum(dim=-1)
    return m_new, l_i, acc


def ring_attention_local(q, k, v, group, scale: Optional[float] = None):
    """This rank's token shard q/k/v [B, T/S, H, D] -> its output shard,
    attending to the whole sequence of the ranks of `group` (in rank order,
    rank i holding tokens [i T/S, (i + 1) T/S)). f32 accumulation; the
    output in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n = dist.get_world_size(group)
    ql = q.transpose(1, 2).float()
    kl, vl = k.transpose(1, 2), v.transpose(1, 2)
    m_i = torch.full(ql.shape[:-1], -1e30, dtype=torch.float32, device=q.device)
    l_i = torch.zeros_like(m_i)
    acc = torch.zeros_like(ql)
    for step in range(n):
        m_i, l_i, acc = _chunk_attention(ql, kl, vl, m_i, l_i, acc, scale)
        if step + 1 < n:  # the chunk a last move would bring back is this rank's own
            kl, vl = _RingShift.apply(group, kl, vl)
    out = acc / l_i[..., None]
    return out.transpose(1, 2).to(q.dtype)


def ring_attention(q, k, v, mesh: DeviceMesh, axis: str = "sp",
                   scale: Optional[float] = None):
    """Sequence-parallel MHA over `mesh`'s `axis`: q/k/v are this rank's
    [B, T/S, H, D] shards (rank i of the axis holds tokens
    [i T/S, (i + 1) T/S)); returns its [B, T/S, H, D] output shard."""
    return ring_attention_local(q, k, v, mesh.get_group(axis), scale)
