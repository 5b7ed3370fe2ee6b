"""Attention entries of the port (counterpart of vaw_tpu/ops/attention.py).

- ``multi_head_attention_fused``: the DiT's self-attention. It hands the raw
  fused projection ``[B, T, 3*H*D]`` to ``flash_attention_fused`` (the
  ``_flash_p6`` kernels).
- ``multi_head_attention`` (q, k and v ``[B, T, H, D]``) and
  ``multi_head_attention_packed`` (one ``[B, T, 3, H, D]`` projection): every
  other model's attention, through the general-T kernels of ``_flash``, or,
  for the packed entry at T = 256 (the UNet's 16x16 level), the d-major
  ``_flash_p5`` kernels, where ``flash_attention_packed`` takes them as the
  JAX package does.

Routing of the last two. A shape the kernel takes (``_flash_eligible``:
D % 8 == 0, D <= 256, at most 4096 keys, the JAX package's gate) goes to the
kernel entry: on a CUDA tensor the hand-written kernel, on a CPU tensor its
plain version. Any other shape goes to that plain version's f32-softmax
math (``flash_attention_reference``, differentiable by autograd), as the
JAX package sends it to XLA.

The JAX package also requires T >= 256 (``_FLASH_MIN_SEQ``) before it takes
its kernel. That was a TPU v5e heuristic: below 256 tokens the Pallas grid's
per-step overhead cost more than XLA's unfused attention saved. It does not
carry over: the CUDA kernel launches one block per 64-query tile with no
sequential grid, and it skips the [B, H, T, T] round trip of the
probabilities at any T, so on the card every shape the kernel takes goes to
it.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .flash_attention import (
    flash_attention,
    flash_attention_fused,
    flash_attention_packed,
    flash_attention_reference,
)

__all__ = ["multi_head_attention", "multi_head_attention_fused",
           "multi_head_attention_packed", "packed_qkv_enabled"]


def packed_qkv_enabled() -> bool:
    """Whether a model with a fused projection hands it to the packed entry
    (vaw_tpu/ops/attention.py:90-99, the same switch): on unless
    VAW_PACKED_QKV=0, which sends ViT's attention through
    ``multi_head_attention`` on q, k and v split from the projection."""
    return os.environ.get("VAW_PACKED_QKV", "1") == "1"


def _flash_eligible(seq_k: int, d: int) -> bool:
    """Shapes the general kernel takes (vaw_tpu/ops/attention.py:32-38)."""
    return d % 8 == 0 and d <= 256 and seq_k <= 4096


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Batched MHA over q [B, Tq, H, D], k and v [B, Tk, H, D] ->
    [B, Tq, H, D]. Softmax in f32 whatever the input dtype."""
    if _flash_eligible(k.shape[1], q.shape[-1]):
        return flash_attention(q, k, v, scale)
    return flash_attention_reference(q, k, v, scale)[0]


def multi_head_attention_packed(qkv: torch.Tensor, scale: Optional[float] = None,
                                d_major_out: bool = False) -> torch.Tensor:
    """Fused-projection MHA: qkv [B, T, 3, H, D] -> [B, T, H, D], or d-major
    [B, H*D, T] with `d_major_out`, with the routing of
    ``multi_head_attention``; the kernel entry writes one packed gradient."""
    if _flash_eligible(qkv.shape[1], qkv.shape[-1]):
        return flash_attention_packed(qkv, scale, d_major_out=d_major_out)
    out = flash_attention_reference(*qkv.unbind(2), scale)[0]
    if d_major_out:
        b, t, _, h, d = qkv.shape
        return out.permute(0, 2, 3, 1).reshape(b, h * d, t)
    return out


def multi_head_attention_fused(qkv2d: torch.Tensor, num_heads: int,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Fully t-major fused-projection MHA: qkv2d [B, T, 3*H*D] (raw Linear
    output, last-axis layout (3, H, D)) -> [B, T, H*D]. Softmax in f32."""
    out, _ = flash_attention_fused(qkv2d, num_heads, scale)
    return out
