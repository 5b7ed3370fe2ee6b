"""U-ViT in PyTorch (counterpart of vaw_tpu/models/uvit.py; reference:
models/uvit.py:139-284): a ViT over [label, time, patch] tokens with long
skip connections. depth // 2 in-blocks, a mid block and depth // 2
out-blocks, each out-block fusing the matching in-block's output through
``skip_linear(cat([x, skip]))``, then an f32 head: LayerNorm, the
``decoder_pred`` Linear, unpatchify and a 3x3 ``final_layer`` conv.

Tokens stay [N, T, D]; images are NHWC at the interface. The model computes
in its ``compute_dtype`` (default: the dtype of its weights), casting f32
weights per call as the JAX model's ``dtype=cfg.compute_dtype`` does: the
residual stream stays in that dtype, the LayerNorms normalise in f32, and
the head runs in f32 whatever the compute dtype, as in the JAX package
(vaw_tpu/models/uvit.py:148-162). ``keep_f32`` names that head, which
``cast_for_compute`` leaves in f32 when it makes a model's sampling copy.
Attention goes through ``multi_head_attention_packed``: the general-T
kernels on the card (T = 258 for U-ViT-L/2 on 32x32 latents).

Submodule names are the reference's (those vaw_tpu/models/convert.py
``convert_uvit`` maps from). ``use_checkpoint`` recomputes every block's
activations in the backward under ``remat_policy`` (vaw_tpu/models/
uvit.py:85-87, 132-133).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention_packed
from .layers import (
    LayerNorm,
    Linear,
    Mlp,
    PatchEmbed,
    check_remat_policy,
    remat_with_policy,
    timestep_embedding,
    trunc_normal_,
)

__all__ = ["UViT", "UViT_S", "UViT_S_D", "UViT_M", "UViT_L", "UViT_H",
           "UViT_models"]


class Attention(nn.Module):
    """Self-attention of a U-ViT block (reference: models/uvit.py:67-93):
    the qkv Linear's output (no bias, as every registered size has it),
    viewed as [N, T, 3, H, D], goes to the packed attention entry with no
    copy."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bias=False)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        n, t, d = x.shape
        qkv = self.qkv(x).reshape(n, t, 3, self.num_heads, d // self.num_heads)
        return self.proj(multi_head_attention_packed(qkv).reshape(n, t, d))


class UViTBlock(nn.Module):
    """Pre-norm transformer block with an optional long-skip fusion
    (reference: models/uvit.py:97-121; vaw_tpu/models/uvit.py:27-69)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 skip: bool = False):
        super().__init__()
        self.skip_linear = Linear(2 * dim, dim) if skip else None
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        # exact (erf) GELU, as the reference's nn.GELU()
        self.mlp = Mlp(dim, int(dim * mlp_ratio), approximate="none")

    def forward(self, x, skip=None):
        if self.skip_linear is not None:
            x = self.skip_linear(torch.cat([x, skip], dim=-1))
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


def _lecun_normal_(w: torch.Tensor, fan_in: int):
    """Flax's default kernel init: a truncated normal of variance 1/fan_in."""
    trunc_normal_(w, math.sqrt(1.0 / fan_in) / 0.87962566103423978)


class UViT(nn.Module):
    """forward(x [N, H, W, C], t [N], y [N] int) -> [N, H, W, C] f32.

    compute_dtype: the dtype of activations and products (bf16 for the
    trainer's f32 masters under --amp); None computes in the weights' dtype.
    """

    keep_f32 = ("norm", "decoder_pred", "final_layer")

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 in_channels: int = 3, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 mlp_time_embed: bool = False,
                 num_classes: int = -1, class_dropout_prob: float = 0.0,
                 use_checkpoint: bool = False, remat_policy: str = "full",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.use_checkpoint = use_checkpoint
        self.remat_policy = check_remat_policy(remat_policy)
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.embed_dim = embed_dim
        self.num_classes = num_classes
        self.class_dropout_prob = class_dropout_prob
        # Token order [label, time, patches] (vaw_tpu/models/uvit.py:104-125).
        self.extras = 1 + int(num_classes > 0)
        num_patches = (image_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(in_channels, patch_size, embed_dim)
        self.time_embed = nn.Sequential(
            Linear(embed_dim, 4 * embed_dim), nn.SiLU(),
            Linear(4 * embed_dim, embed_dim)) if mlp_time_embed else None
        # A null row at index num_classes when trained with label dropout.
        self.label_emb = nn.Embedding(
            num_classes + int(class_dropout_prob > 0), embed_dim
        ) if num_classes > 0 else None
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.extras + num_patches, embed_dim))
        block = dict(dim=embed_dim, num_heads=num_heads, mlp_ratio=mlp_ratio)
        self.in_blocks = nn.ModuleList(UViTBlock(**block) for _ in range(depth // 2))
        self.mid_block = UViTBlock(**block)
        self.out_blocks = nn.ModuleList(
            UViTBlock(**block, skip=True) for _ in range(depth // 2))
        self.norm = LayerNorm(embed_dim)
        self.decoder_pred = Linear(embed_dim, patch_size ** 2 * in_channels)
        self.final_layer = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.initialize_weights()

    def initialize_weights(self):
        """The JAX model's initialisers: truncated normal(0.02) for the
        block Linears, the decoder, the label table and pos_embed;
        xavier-uniform for the MLPs and the patch conv; Flax's default
        (LeCun normal) for the time MLP and the final conv; zero biases."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                trunc_normal_(module.weight, 0.02)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
        for blk in [*self.in_blocks, self.mid_block, *self.out_blocks]:
            for lin in (blk.mlp.fc1, blk.mlp.fc2):
                nn.init.xavier_uniform_(lin.weight)
        w = self.patch_embed.proj.weight
        nn.init.xavier_uniform_(w.view(w.shape[0], -1))
        nn.init.zeros_(self.patch_embed.proj.bias)
        if self.time_embed is not None:
            for i in (0, 2):
                _lecun_normal_(self.time_embed[i].weight, self.time_embed[i].in_features)
        if self.label_emb is not None:
            trunc_normal_(self.label_emb.weight, 0.02)
        trunc_normal_(self.pos_embed, 0.02)
        _lecun_normal_(self.final_layer.weight, 9 * self.in_channels)
        nn.init.zeros_(self.final_layer.bias)

    @property
    def has_null_label(self) -> bool:
        """Whether label num_classes, the unconditional label of CFG, exists."""
        return self.label_emb is not None and self.class_dropout_prob > 0

    def forward(self, x, t, y=None, train: bool = False, force_drop_ids=None,
                generator: Optional[torch.Generator] = None):
        """train turns on label dropout (drawn from `generator`);
        force_drop_ids (1 = drop to the null label) replaces the draw, in
        training too. (The JAX U-ViT ignores force_drop_ids in training and
        draws its own ids; the port's trainer draws them, with the same
        distribution.)"""
        dtype = self.compute_dtype or self.patch_embed.proj.weight.dtype
        x = self.patch_embed(x.to(dtype))
        n, num_patches, _ = x.shape
        t_emb = timestep_embedding(t, self.embed_dim)
        if self.time_embed is not None:
            t_emb = self.time_embed(t_emb.to(dtype))
        tokens = [t_emb[:, None].to(dtype)]
        if self.label_emb is not None:
            if y is None:
                raise ValueError("a class-conditional U-ViT needs labels y")
            if (train and self.class_dropout_prob > 0) or force_drop_ids is not None:
                if force_drop_ids is None:
                    drop = torch.rand(n, generator=generator,
                                      device=y.device) < self.class_dropout_prob
                else:
                    drop = force_drop_ids == 1
                y = torch.where(drop, self.num_classes, y)
            tokens.insert(0, self.label_emb(y)[:, None].to(dtype))
        x = torch.cat(tokens + [x], dim=1) + self.pos_embed.to(dtype)

        def run(blk):
            return (remat_with_policy(blk, self.remat_policy)
                    if self.use_checkpoint else blk)

        skips = []
        for blk in self.in_blocks:
            x = run(blk)(x)
            skips.append(x)
        x = run(self.mid_block)(x)
        for blk in self.out_blocks:
            x = run(blk)(x, skips.pop())

        # The head in f32 (vaw_tpu/models/uvit.py:148-162).
        x = self.decoder_pred(self.norm(x.float()))[:, self.extras:]
        p, c = self.patch_size, self.in_channels
        h = w = int(math.isqrt(num_patches))
        x = x.reshape(n, h, w, p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(n, h * p, w * p, c).permute(0, 3, 1, 2)
        conv = self.final_layer
        x = F.conv2d(x, conv.weight.float(), conv.bias.float(), padding=1)
        return x.permute(0, 2, 3, 1)


def _make_uvit(embed_dim, depth, num_heads):
    def ctor(image_size, patch_size, in_channels, num_classes,
             class_dropout_prob=0.0, **kwargs):
        return UViT(
            image_size=image_size, patch_size=patch_size or 16,
            in_channels=in_channels, embed_dim=embed_dim, depth=depth,
            num_heads=num_heads, mlp_ratio=4, num_classes=num_classes,
            class_dropout_prob=class_dropout_prob, **kwargs,
        )

    return ctor


# Sizes (reference: models/uvit.py:258-284).
UViT_S = _make_uvit(512, 13, 8)
UViT_S_D = _make_uvit(512, 17, 8)
UViT_M = _make_uvit(768, 17, 12)
UViT_L = _make_uvit(1024, 21, 16)
UViT_H = _make_uvit(1152, 29, 16)

UViT_models = {
    "U-ViT-S": UViT_S,
    "U-ViT-S-D": UViT_S_D,
    "U-ViT-M": UViT_M,
    "U-ViT-L": UViT_L,
    "U-ViT-H": UViT_H,
}
