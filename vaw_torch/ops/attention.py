"""Attention entry of the port (counterpart of vaw_tpu/ops/attention.py).

The DiT's self-attention reaches one entry, ``multi_head_attention_fused``,
which hands the raw fused projection to ``flash_attention_fused``: the
hand-written CUDA kernel on the card, its plain f32-softmax version on the
CPU. The JAX package's other routes (split q/k/v, the packed 5-D layout,
the general-T kernel) serve other models and are ported with them.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention_fused

__all__ = ["multi_head_attention_fused"]


def multi_head_attention_fused(qkv2d: torch.Tensor, num_heads: int,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Fully t-major fused-projection MHA: qkv2d [B, T, 3*H*D] (raw Linear
    output, last-axis layout (3, H, D)) -> [B, T, H*D]. Softmax in f32."""
    out, _ = flash_attention_fused(qkv2d, num_heads, scale)
    return out
