"""Attention entries of the port (counterpart of vaw_tpu/ops/attention.py).

- ``self_attention_qkv2d``: the DiT's self-attention on the raw fused
  projection ``[B, T, 3*H*D]`` (vaw_tpu/models/layers.py:246-281 with
  vaw_tpu/ops/attention.py:117-144). It goes to ``flash_attention_fused``
  (the ``_flash_p6`` kernels) when ``fused_tmajor_enabled()``, the flash
  kernels are not disabled and the fused kernel takes the head dim
  (``fused_supported``); otherwise to the packed entry, or, under
  VAW_PACKED_QKV=0, to ``multi_head_attention`` on the split q, k and v.
- ``multi_head_attention`` (q, k and v ``[B, T, H, D]``) and
  ``multi_head_attention_packed`` (one ``[B, T, 3, H, D]`` projection): every
  other model's attention, through the general-T kernels of ``_flash``, or,
  for the packed entry at T = 256 (the UNet's 16x16 level), the d-major
  ``_flash_p5`` kernels, where ``flash_attention_packed`` takes them as the
  JAX package does.

Routing of the last two. A shape the kernel takes (``_flash_eligible``:
D % 8 == 0, D <= 256, at most 4096 keys, the JAX package's gate) goes to the
kernel entry unless ``flash_disabled()``: on a CUDA tensor the hand-written
kernel, on a CPU tensor its plain version. Any other shape, and every shape
under VAW_DISABLE_FLASH, goes to ``xla_attention``, the plain math of the
JAX package's XLA path, differentiable by autograd.

The switches are read at each call (the JAX modules read them when they are
traced), with the JAX package's semantics: VAW_FUSED_TMAJOR and
VAW_PACKED_QKV are on unset or at "1" and off at any other value;
VAW_DISABLE_FLASH disables the flash kernels at any non-empty value, "0"
included, as ``os.environ.get`` does there.

The JAX package also requires T >= 256 (``_FLASH_MIN_SEQ``) before it takes
its kernel, and its fused kernel takes T = 256 only (``_packed6_supported``).
Those were TPU v5e limits: below 256 tokens the Pallas grid's per-step
overhead cost more than XLA's unfused attention saved. They do not carry
over: the CUDA kernels launch one block per 64-query tile with no sequential
grid, and skip the [B, H, T, T] round trip of the probabilities at any T, so
on the card every shape a kernel takes goes to it, the fused one at any T
with D % 8 == 0 and D <= 128.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from .flash_attention import (
    flash_attention,
    flash_attention_fused,
    flash_attention_packed,
    fused_supported,
)

__all__ = ["flash_disabled", "fused_tmajor_enabled", "multi_head_attention",
           "multi_head_attention_packed", "packed_qkv_enabled", "self_attention_qkv2d",
           "xla_attention"]


def packed_qkv_enabled() -> bool:
    """Whether a model with a fused projection hands it to the packed entry
    (vaw_tpu/ops/attention.py:90-99, the same switch): on unless
    VAW_PACKED_QKV is set to anything but "1", which sends the DiT, U-ViT,
    ViT and UNet attention through ``multi_head_attention`` on q, k and v
    split from the projection."""
    return os.environ.get("VAW_PACKED_QKV", "1") == "1"


def fused_tmajor_enabled() -> bool:
    """Whether the DiT's attention may take the fused t-major kernel
    (vaw_tpu/ops/attention.py:102-114, the same switch): on unless
    VAW_FUSED_TMAJOR is set to anything but "1", which sends it to the
    packed or split entry."""
    return os.environ.get("VAW_FUSED_TMAJOR", "1") == "1"


def flash_disabled() -> bool:
    """The kill-switch of every flash kernel (vaw_tpu/ops/attention.py:82,
    129, 171): any non-empty VAW_DISABLE_FLASH, "0" included, sends all
    attention to ``xla_attention``."""
    return bool(os.environ.get("VAW_DISABLE_FLASH"))


def _flash_eligible(seq_k: int, d: int) -> bool:
    """Shapes the general kernel takes (vaw_tpu/ops/attention.py:32-38)."""
    return d % 8 == 0 and d <= 256 and seq_k <= 4096


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: Optional[float] = None) -> torch.Tensor:
    """The JAX package's plain attention (vaw_tpu/ops/attention.py:41-54):
    q [B, Tq, H, D], k and v [B, Tk, H, D] -> [B, Tq, H, D] in the input
    dtype. Scores of the input-dtype q and k summed in f32, then the scale
    and an f32 softmax; P rounded to the input dtype before P.V, summed in
    f32. Differentiable by autograd; it materialises the [B, H, Tq, Tk]
    scores."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    weights = torch.softmax(logits * scale, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Batched MHA over q [B, Tq, H, D], k and v [B, Tk, H, D] ->
    [B, Tq, H, D]. Softmax in f32 whatever the input dtype."""
    if not flash_disabled() and _flash_eligible(k.shape[1], q.shape[-1]):
        return flash_attention(q, k, v, scale)
    return xla_attention(q, k, v, scale)


def multi_head_attention_packed(qkv: torch.Tensor, scale: Optional[float] = None,
                                d_major_out: bool = False) -> torch.Tensor:
    """Fused-projection MHA: qkv [B, T, 3, H, D] -> [B, T, H, D], or d-major
    [B, H*D, T] with `d_major_out`, with the routing of
    ``multi_head_attention``; the kernel entry writes one packed gradient."""
    if not flash_disabled() and _flash_eligible(qkv.shape[1], qkv.shape[-1]):
        return flash_attention_packed(qkv, scale, d_major_out=d_major_out)
    out = xla_attention(*qkv.unbind(2), scale)
    if d_major_out:
        b, t, _, h, d = qkv.shape
        return out.permute(0, 2, 3, 1).reshape(b, h * d, t)
    return out


def self_attention_qkv2d(qkv2d: torch.Tensor, num_heads: int,
                         scale: Optional[float] = None) -> torch.Tensor:
    """The DiT's self-attention on its raw qkv Linear output [B, T, 3*H*D]
    (last-axis layout (3, H, D)) -> [B, T, H*D]. Softmax in f32."""
    b, t, hd3 = qkv2d.shape
    d = hd3 // (3 * num_heads)
    if fused_tmajor_enabled() and not flash_disabled() and fused_supported(d):
        return flash_attention_fused(qkv2d, num_heads, scale)[0]
    if packed_qkv_enabled():
        out = multi_head_attention_packed(qkv2d.reshape(b, t, 3, num_heads, d), scale)
    else:
        q, k, v = (a.reshape(b, t, num_heads, d) for a in qkv2d.chunk(3, dim=-1))
        out = multi_head_attention(q, k, v, scale)
    return out.reshape(b, t, num_heads * d)
