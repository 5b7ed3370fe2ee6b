"""The models' layer kit in PyTorch (counterpart of vaw_tpu/models/layers.py).

Tokens are [N, T, D] and images NHWC [N, H, W, C] at every interface, as in
the JAX package. Submodule names follow the reference models (reference:
models/dit.py:41-155, models/uvit.py:67-121), so a state dict carries the
reference names that vaw_tpu/models/convert.py maps from.

Precision: a Linear or the patch conv computes in the dtype of its input and
casts its weights to it on each call, as the JAX modules' ``Dense(dtype=...)``
over f32 params do. The model picks that dtype (its ``compute_dtype``); the
trainer keeps f32 master weights and computes in bf16, while the sampler
makes one bf16 copy of the EMA weights at load time, for which the casts are
no-ops. Timestep embeddings stay f32 until the first Linear, and label
embeddings are gathered from the f32 table, as in the JAX package.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.attention import self_attention_qkv2d
from ..ops.upsample_conv import (
    fused_upsample_conv_enabled,
    nearest2x_conv3x3,
    nearest2x_conv3x3_reference,
)

__all__ = [
    "Conv2d",
    "FusedUpsampleConv",
    "GroupNorm32",
    "LayerNorm",
    "Linear",
    "timestep_embedding",
    "get_2d_sincos_pos_embed",
    "PatchEmbed",
    "TimestepEmbedder",
    "LabelEmbedder",
    "Mlp",
    "DropPath",
    "trunc_normal_",
    "MultiHeadSelfAttention",
    "modulate",
    "REMAT_POLICIES",
    "check_remat_policy",
    "remat_with_policy",
]


class Linear(nn.Linear):
    """nn.Linear computing in the dtype of its input: weight and bias are
    cast to it on each call (Flax ``Dense(dtype=x.dtype)`` over f32
    params; the gradient reaches the f32 weights through the cast)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding in f32, [cos | sin] ordering
    (reference: tools/nn.py:103-121, models/dit.py:55-74)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int,
                            cls_token: bool = False, extra_tokens: int = 0):
    """Fixed 2D sin-cos positional table (reference: models/dit.py:307-354),
    host-side numpy, bit-equal to the JAX package's."""
    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)  # w first
    grid = grid.reshape([2, 1, grid_size, grid_size])
    emb_h = _1d(embed_dim // 2, grid[0])
    emb_w = _1d(embed_dim // 2, grid[1])
    pos = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token and extra_tokens > 0:
        pos = np.concatenate([np.zeros([extra_tokens, embed_dim]), pos], axis=0)
    return pos.astype(np.float32)


class PatchEmbed(nn.Module):
    """Conv patchify, NHWC [N, H, W, C] -> tokens [N, T, D], row-major over
    the patch grid (timm PatchEmbed as used at models/dit.py:192)."""

    def __init__(self, in_chans: int, patch_size: int, embed_dim: int,
                 bias: bool = True):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size,
                              bias=bias)

    def forward(self, x):
        """Computes in x's dtype, casting the conv weights to it."""
        proj = self.proj
        bias = None if proj.bias is None else proj.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), proj.weight.to(x.dtype), bias,
                     stride=proj.stride)
        return y.flatten(2).transpose(1, 2)


class TimestepEmbedder(nn.Module):
    """Sinusoidal frequency embedding + 2-layer MLP
    (reference: models/dit.py:41-79)."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(
            Linear(frequency_embedding_size, hidden_size),
            nn.SiLU(),
            Linear(hidden_size, hidden_size),
        )

    def forward(self, t, dtype=None):
        """f32 frequencies, then the MLP in `dtype` (default: the weights')."""
        t_freq = timestep_embedding(t, self.frequency_embedding_size)
        return self.mlp(t_freq.to(dtype or self.mlp[0].weight.dtype))


class LabelEmbedder(nn.Module):
    """Class-label table with classifier-free-guidance label dropout
    (reference: models/dit.py:82-110; vaw_tpu/models/layers.py:195-220).
    When dropout_prob > 0 it has an extra null row at index num_classes,
    which label dropout and CFG's unconditional half feed."""

    def __init__(self, num_classes: int, hidden_size: int,
                 dropout_prob: float = 0.0):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_prob = dropout_prob
        self.has_null_row = dropout_prob > 0
        self.embedding_table = nn.Embedding(
            num_classes + int(self.has_null_row), hidden_size)

    def forward(self, labels, train: bool = False, force_drop_ids=None,
                generator=None):
        """In training (with a null row) each label becomes num_classes with
        probability dropout_prob, drawn from `generator`; force_drop_ids
        (1 = drop) replaces the draw, in training or not."""
        if (train and self.has_null_row) or force_drop_ids is not None:
            if force_drop_ids is None:
                drop = torch.rand(labels.shape[0], generator=generator,
                                  device=labels.device) < self.dropout_prob
            else:
                drop = force_drop_ids == 1
            labels = torch.where(drop, self.num_classes, labels)
        return self.embedding_table(labels)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with f32 affine weights that normalises in f32 and casts
    back to the input's dtype: Flax ``LayerNorm(dtype=float32)`` followed by
    ``.astype(dtype)`` (vaw_tpu/models/uvit.py:46, 63)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm over the last (channel) axis of [N, ..., C] with f32 affine
    parameters, eps 1e-5 and min(32, C) groups lowered until they divide C
    (vaw_tpu/models/layers.py:81-105); the SD-VAE's norm passes eps 1e-6
    (vaw_tpu/models/vae.py:25-34). It normalises in f32 and rounds once
    to the input's dtype, which is what Flax's GroupNorm does there on bf16
    input (its docstring says the normalisation stays in the activation
    dtype; the computed values are those of f32 math and one cast)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        groups = min(num_groups, channels)
        while channels % groups:
            groups -= 1
        super().__init__(groups, channels, eps=eps)

    def forward(self, x):
        y = F.group_norm(x.float().movedim(-1, 1), self.num_groups,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.movedim(1, -1).to(x.dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d over NHWC images [N, H, W, C], padded kernel // 2 on every
    side (the JAX UNet's explicit symmetric padding) unless `padding` says
    otherwise, computing in the dtype of its input: weight and bias are cast
    to it on each call. The NHWC input is a channels-last NCHW view for
    cuDNN, with no copy."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: Optional[int] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=kernel_size // 2 if padding is None else padding)

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                     self.bias.to(x.dtype), self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class FusedUpsampleConv(Conv2d):
    """Nearest-2x upsample then a SAME 3x3 conv (vaw_tpu/models/layers.py:
    316-351): unfused by default, the four-phase form under
    VAW_FUSED_UPSAMPLE=1 (tap sums in f32, then cast to the compute dtype).
    Its parameters are those of the 3x3 conv it stands for."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3)

    def forward(self, x):
        w3 = self.weight.permute(2, 3, 1, 0)  # HWIO, f32
        if fused_upsample_conv_enabled():
            y = nearest2x_conv3x3(x, w3, kernel_dtype=x.dtype)
        else:
            y = nearest2x_conv3x3_reference(x, w3.to(x.dtype))
        return y + self.bias.to(y.dtype)


def trunc_normal_(w: torch.Tensor, std: float):
    """Flax truncated_normal(std, lower=-2, upper=2) as the JAX models use it
    (vaw_tpu/models/layers.py:39-41): N(0, std) cut at 2 std."""
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


class Mlp(nn.Module):
    """Transformer MLP (reference: tools/timm.py:84-113;
    vaw_tpu/models/layers.py:108-132). approximate is GELU's: "tanh" for the
    DiT (vaw_tpu/models/dit.py:63-66), "none", the exact erf GELU, for U-ViT
    and ViT (vaw_tpu/models/uvit.py:64-68, vit.py:160-162); `act`, when
    given, replaces GELU (CLIP's quick GELU). dropout follows the activation
    and fc2 in training (ViT's drop_rate)."""

    def __init__(self, in_features: int, hidden_features: int,
                 approximate: str = "tanh", dropout: float = 0.0,
                 act: Optional[Callable] = None):
        super().__init__()
        self.approximate = approximate
        self.dropout = dropout
        self.act = act
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, in_features)

    def forward(self, x, train: bool = False):
        x = self.fc1(x)
        x = self.act(x) if self.act is not None else F.gelu(x, approximate=self.approximate)
        if train and self.dropout > 0:
            return F.dropout(self.fc2(F.dropout(x, self.dropout)), self.dropout)
        return self.fc2(x)


class DropPath(nn.Module):
    """Stochastic depth (reference: tools/timm.py:43-63;
    vaw_tpu/models/layers.py:135-148): in training each sample's branch is
    kept with probability 1 - rate and scaled by 1 / (1 - rate). The mask
    comes from the default generator, which remat replays."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, train: bool = False):
        if self.rate == 0.0 or not train:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1),
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class MultiHeadSelfAttention(nn.Module):
    """Fused-QKV self-attention over [N, T, D] tokens with f32 softmax. The
    qkv Linear's raw [N, T, 3D] output goes to ``self_attention_qkv2d``: the
    fused attention kernel with no reshuffle (the JAX package's fused
    t-major route), or the packed or split entry under the switches. Under
    tensor parallelism the module holds a rank's heads (num_heads is its
    share); under sequence parallelism (`seq`) x is a token shard and
    q, k and v, split, go round the ring (vaw_tpu/models/layers.py:231-280)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x, seq=None):
        qkv = self.qkv(x)
        if seq is None:
            return self.proj(self_attention_qkv2d(qkv, self.num_heads))
        from ..parallel.ring_attention import ring_attention_local

        n, t, width = qkv.shape
        q, k, v = (a.reshape(n, t, self.num_heads, width // (3 * self.num_heads))
                   for a in qkv.chunk(3, dim=-1))
        return self.proj(ring_attention_local(q, k, v, seq.group).reshape(n, t, -1))


def modulate(x, shift, scale):
    """adaLN modulation (reference: models/dit.py:24-25)."""
    return x * (1 + scale[:, None]) + shift[:, None]


_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_with_no_batch_dims(ctx, op, *args, **kwargs):
    """Save the outputs of the unbatched matrix products (every Linear's:
    F.linear reaches aten.mm or aten.addmm, on 2-D and folded 3-D inputs
    alike) and recompute everything else: batched products, convolutions,
    norms, elementwise work and the attention kernels, whose custom
    autograd Functions the policy cannot see into. This is what
    jax.checkpoint_policies.dots_with_no_batch_dims_saveable saves in the
    JAX models (dot_general outputs without batch dimensions; convolutions
    are not dots)."""
    del ctx, args, kwargs
    if op in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


#: Remat policies for `use_checkpoint` backbones (the JAX package's names,
#: vaw_tpu/models/layers.py:291-313): "full" recomputes the whole block in
#: the backward (the reference's CheckpointFunction, tools/nn.py:124-170);
#: "dots" keeps the Linear products and recomputes the rest. A policy
#: changes what is kept for the backward, never the values.
REMAT_POLICIES = {
    "full": None,
    "dots": _dots_with_no_batch_dims,
}


def check_remat_policy(policy_name: str) -> str:
    """`policy_name` if REMAT_POLICIES has it; ValueError otherwise."""
    if policy_name not in REMAT_POLICIES:
        raise ValueError(f"Unknown remat_policy {policy_name!r}; "
                         f"expected one of {sorted(REMAT_POLICIES)}")
    return policy_name


def remat_with_policy(fn: Callable, policy_name: str) -> Callable:
    """`fn` (a block) wrapped so that its activations are recomputed in the
    backward under the named policy: non-reentrant
    torch.utils.checkpoint.checkpoint, which replays the CPU and CUDA
    default generators (dropout draws the same mask again; a generator
    passed explicitly is not replayed)."""
    policy = REMAT_POLICIES[check_remat_policy(policy_name)]
    kwargs = {"use_reentrant": False, "preserve_rng_state": True}
    if policy is not None:
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)

    def rematted(*args):
        if not torch.is_grad_enabled():  # nothing is kept for a backward
            return fn(*args)
        return checkpoint(fn, *args, **kwargs)

    return rematted
