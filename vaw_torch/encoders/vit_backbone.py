"""One frozen ViT feature extractor for every REPA teacher family
(counterpart of vaw_tpu/encoders/vit_backbone.py; reference:
encoders/mocov3_vit.py, mae_vit.py, jepa.py, clip_vit.py and DINOv1/v2 via
torch.hub, tools/encoders.py:56-257).

  family      patch  deltas
  dinov2      14     LayerScale, cls token, final LayerNorm
  dinov2reg   14     dinov2 + 4 register tokens, inserted after the
                     pos-embed add (they have no pos rows of their own)
  dinov1      16     cls token, final LayerNorm
  mae         16     cls token, no final norm (the reference's
                     forward_features returns the pre-norm tokens)
  mocov3      16     cls token; pos embed initialised to MoCo-v3's 2D
                     sin-cos table, replaced by the checkpoint's at load
  jepa        14/16  no cls token, final LayerNorm
  clip        14/16  ln_pre after the embedding with a bias-free patch conv,
                     quick GELU, no final norm, eps 1e-5

Tokens are [N, T, D] and images NHWC; ``forward`` returns the full token
sequence [N, extra + T, D] in f32 and the align glue slices it per family
(``vaw_torch.encoders.align``). The attention is the DiT's fused-projection
``MultiHeadSelfAttention``: on the card the fused forward kernel
(``flash_fused_fwd.cu``), which takes any T with D <= 128 (T = 257 for
DINOv2-B/14 at 224 px). The state dict uses timm's names (``patch_embed.
proj``, ``blocks.{i}.attn.qkv``, ``mlp.fc1``, ``norm``), with the layer
scales as ``blocks.{i}.ls1`` and ``ls2``; ``vaw_torch.encoders.loaders``
converts timm and CLIP checkpoints to it. The position table is sized for
``image_size // patch_size`` squared patches, the grid the teacher runs at.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import LayerNorm, Mlp, MultiHeadSelfAttention, PatchEmbed, trunc_normal_

__all__ = ["FeatureViT", "TeacherBlock", "FAMILY_CONFIGS", "make_teacher",
           "mocov3_sincos_pos_embed"]


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _gelu_exact(x):
    # torch's GELU default, the exact erf form (timm blocks,
    # encoders/jepa.py:155-170).
    return F.gelu(x)


def mocov3_sincos_pos_embed(embed_dim: int, grid: int,
                            temperature: float = 10000.0) -> np.ndarray:
    """MoCo-v3's fixed 2D sin-cos table with its zero cls row, as
    build_2d_sincos_position_embedding makes it (reference:
    encoders/mocov3_vit.py:79-97): meshgrid(w, h) 'ij' order, [sin w,
    cos w, sin h, cos h]. Returns [1, 1 + grid*grid, D]."""
    if embed_dim % 4:
        raise ValueError(f"embed_dim {embed_dim} is not a multiple of 4")
    grid_w, grid_h = np.meshgrid(np.arange(grid, dtype=np.float32),
                                 np.arange(grid, dtype=np.float32), indexing="ij")
    pos_dim = embed_dim // 4
    omega = 1.0 / temperature ** (np.arange(pos_dim, dtype=np.float32) / pos_dim)
    out_w = np.einsum("m,d->md", grid_w.flatten(), omega)
    out_h = np.einsum("m,d->md", grid_h.flatten(), omega)
    table = np.concatenate(
        [np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1)[None]
    pe_token = np.zeros((1, 1, embed_dim), np.float32)
    return np.concatenate([pe_token, table], axis=1)


class TeacherBlock(nn.Module):
    """Pre-norm ViT block with optional LayerScale (vaw_tpu/encoders/
    vit_backbone.py:91-118). The norms run in f32; the layer scales are f32
    parameters that multiply the branch, as in the JAX block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 layer_scale: bool = False, quick_gelu: bool = False,
                 norm_eps: float = 1e-6):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=norm_eps)
        self.attn = MultiHeadSelfAttention(dim, num_heads, qkv_bias=True)
        self.norm2 = LayerNorm(dim, eps=norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), approximate="none",
                       act=_quick_gelu if quick_gelu else _gelu_exact)
        self.ls1 = nn.Parameter(torch.ones(dim)) if layer_scale else None
        self.ls2 = nn.Parameter(torch.ones(dim)) if layer_scale else None

    def forward(self, x, dtype: torch.dtype):
        h = self.attn(self.norm1(x).to(dtype))
        if self.ls1 is not None:
            h = self.ls1 * h
        x = x + h
        h = self.mlp(self.norm2(x).to(dtype))
        if self.ls2 is not None:
            h = self.ls2 * h
        return x + h


class FeatureViT(nn.Module):
    """forward(x [N, H, W, 3] preprocessed pixels) -> tokens [N, extra + T,
    D] f32 (vaw_tpu/encoders/vit_backbone.py:121-224). compute_dtype: the
    dtype of activations and products (the teacher runs in f32); None
    computes in the weights' dtype."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, use_cls_token: bool = True,
                 fixed_sincos_pos: bool = False, num_register_tokens: int = 0,
                 layer_scale: bool = False, pre_norm: bool = False,
                 final_norm: bool = True, quick_gelu: bool = False,
                 norm_eps: float = 1e-6, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.patch_size = patch_size
        self.depth = depth
        grid = image_size // patch_size
        extra = int(use_cls_token)
        self.patch_embed = PatchEmbed(3, patch_size, embed_dim, bias=not pre_norm)
        self.cls_token = (nn.Parameter(torch.zeros(1, 1, embed_dim))
                          if use_cls_token else None)
        if fixed_sincos_pos:
            # A loadable table, overwritten by the checkpoint's at load
            # (tools/encoders.py:32-35); the sin-cos table is its init.
            table = mocov3_sincos_pos_embed(embed_dim, grid)[:, 1 - extra:]
            self.pos_embed = nn.Parameter(torch.from_numpy(np.ascontiguousarray(table)))
        else:
            self.pos_embed = nn.Parameter(torch.zeros(1, extra + grid * grid, embed_dim))
            trunc_normal_(self.pos_embed, 0.02)
        self.register_tokens = (
            nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim))
            if num_register_tokens else None)
        self.ln_pre = LayerNorm(embed_dim, eps=norm_eps) if pre_norm else None
        self.blocks = nn.ModuleList(
            TeacherBlock(embed_dim, num_heads, mlp_ratio, layer_scale, quick_gelu,
                         norm_eps) for _ in range(depth))
        self.norm = LayerNorm(embed_dim, eps=norm_eps) if final_norm else None
        for p in (self.cls_token, self.register_tokens):
            if p is not None:
                trunc_normal_(p, 0.02)

    def forward(self, x):
        dtype = self.compute_dtype or self.patch_embed.proj.weight.dtype
        n = x.shape[0]
        tokens = self.patch_embed(x.to(dtype))
        extra = 0
        if self.cls_token is not None:
            tokens = torch.cat([self.cls_token.to(dtype).expand(n, -1, -1), tokens], 1)
            extra = 1
        if tokens.shape[1] != self.pos_embed.shape[1]:
            raise ValueError(f"{tokens.shape[1] - extra} patches do not match the "
                             f"{self.pos_embed.shape[1] - extra}-patch position table")
        tokens = tokens + self.pos_embed.to(dtype)
        if self.register_tokens is not None:
            reg = self.register_tokens.to(dtype).expand(n, -1, -1)
            tokens = torch.cat([tokens[:, :extra], reg, tokens[:, extra:]], 1)
        if self.ln_pre is not None:
            tokens = self.ln_pre(tokens).to(dtype)
        for block in self.blocks:
            tokens = block(tokens, dtype)
        if self.norm is not None:
            tokens = self.norm(tokens.float())
        return tokens.float()


# Sizes: (embed_dim, depth, num_heads).
_SIZES = {
    "s": (384, 12, 6),
    "b": (768, 12, 12),
    "l": (1024, 24, 16),
    "h": (1280, 32, 16),
    "g": (1536, 40, 24),
}

FAMILY_CONFIGS = {
    "dinov2": dict(patch_size=14, layer_scale=True),
    "dinov2reg": dict(patch_size=14, layer_scale=True, num_register_tokens=4),
    "dinov1": dict(patch_size=16),
    "mae": dict(patch_size=16, final_norm=False),
    "mocov3": dict(patch_size=16, fixed_sincos_pos=True),
    "jepa": dict(patch_size=14, use_cls_token=False),
    "clip": dict(patch_size=14, pre_norm=True, final_norm=False, quick_gelu=True,
                 norm_eps=1e-5),
}


def make_teacher(family: str, size: str, image_size: int = 224,
                 dtype: torch.dtype = torch.float32) -> FeatureViT:
    """The teacher of a ``family-vit-size`` spec (reference spec strings,
    tools/encoders.py:56-257) with its position table for `image_size`
    pixels, computing in `dtype`. CLIP's B is /16, its L /14
    (vaw_tpu/encoders/vit_backbone.py:236-240)."""
    if family not in FAMILY_CONFIGS:
        raise ValueError(f"unknown encoder family {family!r}")
    if size not in _SIZES:
        raise ValueError(f"unknown encoder size {size!r}")
    embed_dim, depth, num_heads = _SIZES[size]
    cfg = dict(FAMILY_CONFIGS[family])
    if family == "clip" and size != "l":
        cfg["patch_size"] = 16
    return FeatureViT(image_size=image_size, embed_dim=embed_dim, depth=depth,
                      num_heads=num_heads, compute_dtype=dtype, **cfg)
