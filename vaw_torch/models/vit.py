"""Time/class-token ViT in PyTorch (counterpart of vaw_tpu/models/vit.py;
reference: models/vit.py:300-565): a learned timestep-embedding table, a
class token for conditioning, an optional shared relative position bias,
BEiT layer scale (``gamma_1``/``gamma_2``), stochastic depth, depth-scaled
init and an init_scale-damped f32 projection head, with an optional 3x3
``to_pixel`` conv. Sizes S/B/L/XL match models/vit.py:551-565.

Tokens are [N, T, D] and images NHWC at the interface. The model computes
in its ``compute_dtype`` (default: the dtype of its weights), casting f32
weights per call as the JAX model's ``dtype=cfg.compute_dtype`` does; the
LayerNorms normalise in f32, and the head and ``to_pixel`` run in f32 whatever
the compute dtype (``keep_f32``), as in the JAX package. With ``init_values``
the f32 layer-scale weights promote the residual stream to f32 after the
first block, as jnp's promotion does there; the sampling copy keeps them in
f32 too (``keep_f32_leaves``).

Attention (vaw_tpu/models/vit.py:103-131) goes three ways: without a
relative-position bias, the fused projection viewed as [N, T, 3, H, D] goes
to ``multi_head_attention_packed`` (the general-T kernels on the card:
T = 258 for ViT-B/2 on 32x32 latents), or, under VAW_PACKED_QKV=0, its q, k
and v go to ``multi_head_attention``; with the bias, an f32-softmax product
in plain PyTorch, which has no Pallas kernel in the JAX package either.

The time token is ``time_embedding(clip(int32(t), 0, num_steps - 1))``, a
table lookup: under flow matching, where t lies in [0, 1], every t reads row
0 (row 1 at t = 1), so the ViT does not see the time. That is the JAX
model's behaviour, kept here (ROADMAP C8).

Submodule names are the reference's (those vaw_tpu/models/convert.py
``convert_vit`` maps from), but for the qkv bias: the JAX module has one
fused, trainable [3D] bias, k part included, which the port keeps as
``attn.qkv.bias`` (the reference's ``q_bias``/``v_bias`` cannot hold the k
part; models/convert.py says more).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (
    multi_head_attention,
    multi_head_attention_packed,
    packed_qkv_enabled,
)
from .layers import (
    DropPath,
    LayerNorm,
    Linear,
    Mlp,
    PatchEmbed,
    check_remat_policy,
    remat_with_policy,
    trunc_normal_,
)

__all__ = ["ViT", "ViT_S", "ViT_B", "ViT_L", "ViT_XL", "ViT_models",
           "RelativePositionBias", "vit_forward_with_cfg"]


def _rel_pos_index(window, num_extra_tokens=1):
    """BEiT relative-position index table for an (h, w) window plus 0, 1 or
    2 extra tokens with their own learned entries per extra-token relation
    (reference: models/vit.py:243-290; vaw_tpu/models/vit.py:36-69)."""
    h, w = window
    if num_extra_tokens not in (0, 1, 2):
        raise ValueError(f"num_extra_tokens {num_extra_tokens} not in (0, 1, 2)")
    extra = num_extra_tokens * (num_extra_tokens + 2)
    num_rel = (2 * h - 1) * (2 * w - 1) + extra
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    e = num_extra_tokens
    index = np.zeros((h * w + e, h * w + e), dtype=np.int64)
    index[e:, e:] = rel.sum(-1)
    if e == 1:
        index[0, 0:] = num_rel - 3
        index[0:, 0] = num_rel - 2
        index[0, 0] = num_rel - 1
    elif e == 2:
        index[1, 1] = num_rel - 8
        index[1, 0] = num_rel - 7
        index[0, 1] = num_rel - 6
        index[0, 2:] = num_rel - 5
        index[2:, 0] = num_rel - 4
        index[1, 2:] = num_rel - 3
        index[2:, 1] = num_rel - 2
        index[0, 0] = num_rel - 1
    return index, num_rel


class RelativePositionBias(nn.Module):
    """Relative position bias shared by every block (reference:
    models/vit.py:243-297): forward() -> [H, T, T] f32."""

    def __init__(self, window, num_heads: int, num_extra_tokens: int = 1):
        super().__init__()
        index, num_rel = _rel_pos_index(window, num_extra_tokens)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(num_rel, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(index), persistent=False)

    def forward(self):
        t = self.relative_position_index.shape[0]
        bias = self.relative_position_bias_table.float()[
            self.relative_position_index.reshape(-1)]
        return bias.reshape(t, t, -1).permute(2, 0, 1)


class ViTAttention(nn.Module):
    """Fused-qkv MHA with an optional additive relative position bias
    (vaw_tpu/models/vit.py:94-132)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x, rel_pos_bias=None):
        n, t, _ = x.shape
        qkv = self.qkv(x)
        # The heads this module holds: all of them, or a tensor-parallel
        # rank's share (parallel/partition.py), whose qkv is narrower.
        hd = qkv.shape[-1] // (3 * self.num_heads)
        qkv = qkv.reshape(n, t, 3, self.num_heads, hd)
        if rel_pos_bias is None and packed_qkv_enabled():
            out = multi_head_attention_packed(qkv)
        elif rel_pos_bias is None:
            out = multi_head_attention(*qkv.unbind(2))
        else:
            # f32 products of the compute-dtype values, as the JAX einsum's
            # preferred_element_type=float32; the softmax in f32.
            q, k, v = qkv.unbind(2)
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            logits = logits * (1.0 / math.sqrt(hd)) + rel_pos_bias[None]
            weights = torch.softmax(logits, dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.proj(out.reshape(n, t, -1))


class ViTBlock(nn.Module):
    """Pre-norm block with optional layer scale and stochastic depth
    (vaw_tpu/models/vit.py:135-174; exact erf GELU)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop_rate: float = 0.0,
                 drop_path: float = 0.0, init_values: Optional[float] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = ViTAttention(dim, num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), approximate="none",
                       dropout=drop_rate)
        self.drop_path = DropPath(drop_path)
        if init_values is not None:
            self.gamma_1 = nn.Parameter(torch.full((dim,), float(init_values)))
            self.gamma_2 = nn.Parameter(torch.full((dim,), float(init_values)))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x, rel_pos_bias=None, train: bool = False, dtype=None):
        """dtype: the compute dtype the normalised stream is cast to (x's by
        default; x is f32 after a layer-scaled block whatever it is)."""
        dtype = dtype or x.dtype
        h = self.attn(self.norm1(x).to(dtype), rel_pos_bias)
        if self.gamma_1 is not None:
            h = self.gamma_1 * h
        x = x + self.drop_path(h, train)
        h = self.mlp(self.norm2(x).to(dtype), train)
        if self.gamma_2 is not None:
            h = self.gamma_2 * h
        return x + self.drop_path(h, train)


class ViT(nn.Module):
    """forward(x [N, H, W, C], t [N], y [N] int) -> [N, H, W, C_out] f32.

    compute_dtype: the dtype of activations and products (bf16 for the
    trainer's f32 masters under --amp); None computes in the weights' dtype.
    use_checkpoint / remat_policy: remat of every block ("full" or "dots").
    """

    keep_f32 = ("linear_projection", "to_pixel")
    keep_f32_leaves = ("gamma_1", "gamma_2")

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 in_channels: int = 3, num_classes: int = 1000,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 init_values: Optional[float] = None, use_abs_pos_emb: bool = True,
                 use_shared_rel_pos_bias: bool = False,
                 use_mean_pooling: bool = True, use_checkpoint: bool = False,
                 remat_policy: str = "full", init_scale: float = 0.001,
                 use_conv_last: bool = False, num_steps: int = 4000,
                 learn_sigma: bool = False, drop_label_prob: float = 0.0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.use_checkpoint = use_checkpoint
        self.remat_policy = check_remat_policy(remat_policy)
        self.patch_size = patch_size
        self.num_classes = num_classes
        self.num_steps = num_steps
        self.drop_rate = drop_rate
        self.drop_label_prob = drop_label_prob
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        # Token order [time, class, patches]; the class token only for a
        # class-conditional model (vaw_tpu/models/vit.py:212-241).
        self.extras = 1 + int(num_classes > 0)
        grid = image_size // patch_size
        self.patch_embed = PatchEmbed(in_channels, patch_size, embed_dim)
        self.time_embedding = nn.Embedding(num_steps, embed_dim)
        self.class_embedding = nn.Embedding(
            num_classes + int(drop_label_prob > 0), embed_dim
        ) if num_classes > 0 else None
        self.pos_embed = nn.Parameter(
            torch.zeros(1, grid * grid + self.extras, embed_dim)
        ) if use_abs_pos_emb else None
        self.rel_pos_bias = RelativePositionBias(
            (grid, grid), num_heads, self.extras) if use_shared_rel_pos_bias else None
        dpr = np.linspace(0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, drop_rate,
                     float(dpr[i]), init_values) for i in range(depth))
        self.norm = None if use_mean_pooling else LayerNorm(embed_dim)
        self.linear_projection = Linear(embed_dim,
                                        self.out_channels * patch_size ** 2)
        self.to_pixel = nn.Conv2d(self.out_channels, self.out_channels, 3,
                                  padding=1) if use_conv_last else None
        self.initialize_weights(init_scale)

    def initialize_weights(self, init_scale: float):
        """The JAX model's initialisers: truncated normal(0.02) for the
        Linears, the patch conv, the tables and pos_embed, with the attention
        and MLP output projections of block i scaled by 1/sqrt(2(i+1))
        (reference fix_init_weight) and the head by init_scale; zero
        biases and relative-position table; Flax's LeCun normal for
        to_pixel."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                trunc_normal_(module.weight, 0.02)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
        for i, blk in enumerate(self.blocks):
            scale = 1.0 / math.sqrt(2.0 * (i + 1))
            trunc_normal_(blk.attn.proj.weight, 0.02 * scale)
            trunc_normal_(blk.mlp.fc2.weight, 0.02 * scale)
        trunc_normal_(self.linear_projection.weight, 0.02 * init_scale)
        w = self.patch_embed.proj.weight
        trunc_normal_(w, 0.02)
        nn.init.zeros_(self.patch_embed.proj.bias)
        trunc_normal_(self.time_embedding.weight, 0.02)
        if self.class_embedding is not None:
            trunc_normal_(self.class_embedding.weight, 0.02)
        if self.pos_embed is not None:
            trunc_normal_(self.pos_embed, 0.02)
        if self.to_pixel is not None:
            fan_in = 9 * self.out_channels
            trunc_normal_(self.to_pixel.weight,
                          math.sqrt(1.0 / fan_in) / 0.87962566103423978)
            nn.init.zeros_(self.to_pixel.bias)

    @property
    def has_null_label(self) -> bool:
        """Whether label num_classes, the unconditional label of CFG, exists."""
        return self.class_embedding is not None and self.drop_label_prob > 0

    def forward(self, x, t, y=None, train: bool = False, force_drop_ids=None,
                generator: Optional[torch.Generator] = None):
        """train turns on label dropout (drawn from `generator`), dropout and
        stochastic depth; force_drop_ids (1 = drop to the null label)
        replaces the label draw (vaw_tpu/models/vit.py:205-281)."""
        dtype = self.compute_dtype or self.patch_embed.proj.weight.dtype
        x = self.patch_embed(x.to(dtype))
        n, num_patches, _ = x.shape
        t_idx = torch.clamp(t.to(torch.int32), 0, self.num_steps - 1)
        tokens = [self.time_embedding(t_idx)[:, None].to(dtype)]
        if self.class_embedding is not None:
            if y is None:
                raise ValueError("a class-conditional ViT needs labels y")
            if (train and self.drop_label_prob > 0) or force_drop_ids is not None:
                if force_drop_ids is None:
                    drop = torch.rand(n, generator=generator,
                                      device=y.device) < self.drop_label_prob
                else:
                    drop = force_drop_ids == 1
                y = torch.where(drop, self.num_classes, y)
            tokens.append(self.class_embedding(y)[:, None].to(dtype))
        x = torch.cat(tokens + [x], dim=1)
        if self.pos_embed is not None:
            x = x + self.pos_embed.to(dtype)
        if train and self.drop_rate > 0:
            x = F.dropout(x, self.drop_rate)
        rel_pos_bias = self.rel_pos_bias() if self.rel_pos_bias is not None else None
        for blk in self.blocks:
            run = (remat_with_policy(blk, self.remat_policy)
                   if self.use_checkpoint else blk)
            x = run(x, rel_pos_bias, train, dtype)
        if self.norm is not None:
            x = self.norm(x).to(dtype)
        # The head in f32 (vaw_tpu/models/vit.py:265-270).
        x = self.linear_projection(x[:, self.extras:].float())
        p, c = self.patch_size, self.out_channels
        h = w = math.isqrt(num_patches)
        if h * w != num_patches:
            raise ValueError(f"{num_patches} tokens do not form a square grid")
        x = x.reshape(n, h, w, p, p, c).permute(0, 1, 3, 2, 4, 5)
        imgs = x.reshape(n, h * p, w * p, c)
        if self.to_pixel is not None:
            conv = self.to_pixel
            imgs = F.conv2d(imgs.permute(0, 3, 1, 2), conv.weight.float(),
                            conv.bias.float(), padding=1).permute(0, 2, 3, 1)
        return imgs


def vit_forward_with_cfg(model: ViT, x, t, y, classifier_free_scale: float = 1.0):
    """Batched-uncond CFG forward (reference: models/vit.py:494-522;
    vaw_tpu/models/vit.py:296-308): the first half of `x` runs twice, against
    the labels of both halves of `y`; the guided half is returned twice."""
    half = x[: x.shape[0] // 2]
    imgs = model(torch.cat([half, half]), t, y)
    cond, uncond = imgs.chunk(2)
    guided = uncond + classifier_free_scale * (cond - uncond)
    return torch.cat([guided, guided])


def _make_vit(embed_dim, depth, num_heads):
    def ctor(image_size, patch_size, num_classes, in_channels, learn_sigma,
             drop_rate=0.0, drop_label_prob=0.0, **kwargs):
        return ViT(
            image_size=image_size, patch_size=patch_size or 16,
            embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            mlp_ratio=4, num_classes=num_classes, in_channels=in_channels,
            learn_sigma=learn_sigma, drop_rate=drop_rate,
            drop_label_prob=drop_label_prob, **kwargs,
        )

    return ctor


# Sizes (reference: models/vit.py:551-565).
ViT_S = _make_vit(512, 13, 4)
ViT_B = _make_vit(768, 12, 12)
ViT_L = _make_vit(1024, 21, 16)
ViT_XL = _make_vit(1152, 28, 16)

ViT_models = {"ViT-S": ViT_S, "ViT-B": ViT_B, "ViT-L": ViT_L, "ViT-XL": ViT_XL}
