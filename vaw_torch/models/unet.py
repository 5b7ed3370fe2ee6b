"""The ADM UNet in PyTorch (counterpart of vaw_tpu/models/unet.py:32-375 and
:542-690; reference: models/unet.py:397-687 and :921-1032).

Images are NHWC at the interface and between blocks, as in the JAX package;
each conv sees a channels-last NCHW view, so cuDNN runs its NHWC kernels
with no copy. The model computes in its ``compute_dtype`` (default: the
dtype of its weights), casting f32 weights per call as the JAX model's
``dtype=cfg.compute_dtype`` does; every GroupNorm normalises in f32 and
rounds once to that dtype, and the final conv runs in f32 whatever the
compute dtype (vaw_tpu/models/unet.py:372-375). ``keep_f32`` names that
head and ``GroupNorm32`` keeps its parameters f32, so ``cast_for_compute``
leaves both in f32 when it makes a model's sampling copy.

Attention goes through ``multi_head_attention_packed``: at T = 256 (the
16x16 level) the d-major p5 kernels where the JAX gate takes them, at other
T the general-T kernels. Submodule names are the reference's
(``input_blocks.i.j``, ``middle_block.j``, ``output_blocks.i.j``,
``time_embed``, ``label_emb``, ``out``), those vaw_tpu/models/convert.py
``convert_unet`` maps from, with one difference: an attention block's qkv
and proj_out are Linears ([3C, C] and [C, C], not the reference's 1x1
conv1d), and the qkv rows are in the Flax Dense's (3, H, D) order, not the
reference's per-head interleave (``_legacy_qkv_perm`` undoes that for a
reference checkpoint).

Under ``VAW_PALLAS_CONV=1`` (read when the model is built) every stride-1
3x3 conv is a ``PallasConv3x3``, the counterpart of
vaw_tpu/models/unet.py:53-92: where the JAX gate ``conv3x3_supported``
admits the shape it runs ``ops.conv2d.conv3x3``, the hand-written
implicit-GEMM kernels (forward, dgrad and wgrad), and elsewhere the cuDNN
conv that ``lax.conv`` stands for. Its parameters are those of the
``Conv2d`` it replaces, so the state dict is the same in both modes.

``use_checkpoint`` recomputes every ResBlock's and AttentionBlock's
activations in the backward under ``remat_policy``, as the JAX UNet remats
those two kinds (vaw_tpu/models/unet.py:289-294); dropout draws the same
mask again in the recompute (the default generators are replayed). Not
ported: EncoderUNetModel, SuperResModel and AttentionPool2d belong to
classifier guidance and super-resolution (A15).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention_packed
from ..ops.conv2d import conv3x3, conv3x3_supported, use_pallas_conv
from ..ops.upsample_conv import upsample_nearest2x
from .layers import (
    Conv2d,
    FusedUpsampleConv,
    GroupNorm32,
    Linear,
    check_remat_policy,
    remat_with_policy,
    timestep_embedding,
)

__all__ = ["UNetModel", "PallasConv3x3", "create_unet_model", "UNet_32", "ADM_32",
           "ADM_64", "ADM_128", "ADM_256", "ADM_512", "UNet_64", "LDM", "UNet_models"]


class PallasConv3x3(Conv2d):
    """The stride-1 3x3 conv on the hand-written kernels
    (vaw_tpu/models/unet.py:53-84): the same ``weight`` (OIHW, f32) and
    ``bias`` as the Conv2d it stands for. It computes in x's dtype, with the
    weight cast and permuted to HWIO on each call. A shape the JAX gate
    admits goes to ``conv3x3`` (as a dense NHWC tensor: a GroupNorm's output
    may be a strided view); any other to cuDNN, as the JAX module sends it
    to ``lax.conv``. The bias is added after the conv is rounded."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3)

    def forward(self, x):
        w = self.weight.to(x.dtype)
        if conv3x3_supported(x.shape, self.out_channels, itemsize=x.element_size()):
            y = conv3x3(x.contiguous(), w.permute(2, 3, 1, 0))
        else:
            y = F.conv2d(x.permute(0, 3, 1, 2), w, None, 1, 1).permute(0, 2, 3, 1)
        return y + self.bias.to(y.dtype)


def _conv(in_channels: int, out_channels: int, kernel: int = 3,
          stride: int = 1) -> Conv2d:
    """The UNet's conv (vaw_tpu/models/unet.py:32-50): under
    VAW_PALLAS_CONV=1 every stride-1 3x3 conv is a PallasConv3x3."""
    if kernel == 3 and stride == 1 and use_pallas_conv():
        return PallasConv3x3(in_channels, out_channels)
    return Conv2d(in_channels, out_channels, kernel, stride)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool of NHWC x."""
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


class Upsample(nn.Module):
    """Nearest 2x upsample with an optional conv (reference:
    models/unet.py:81-110)."""

    def __init__(self, channels: int, use_conv: bool, out_channels: Optional[int] = None):
        super().__init__()
        self.conv = FusedUpsampleConv(channels, out_channels or channels) if use_conv else None

    def forward(self, x):
        return upsample_nearest2x(x) if self.conv is None else self.conv(x)


class Downsample(nn.Module):
    """Stride-2 conv or 2x2 average pool (reference: models/unet.py:113-140)."""

    def __init__(self, channels: int, use_conv: bool, out_channels: Optional[int] = None):
        super().__init__()
        self.op = _conv(channels, out_channels or channels, stride=2) if use_conv else None

    def forward(self, x):
        return _avg_pool2(x) if self.op is None else self.op(x)


class ResBlock(nn.Module):
    """FiLM residual block with scale-shift norm and fused up/downsampling
    (reference: models/unet.py:143-256; vaw_tpu/models/unet.py:135-183).
    ``in_layers`` = (GroupNorm, SiLU, conv), ``emb_layers`` = (SiLU,
    Linear), ``out_layers`` = (GroupNorm, SiLU, Dropout, zero conv) and a
    1x1 ``skip_connection`` when the width changes. With `up` the first
    conv is a nearest-2x upsample + conv and x is upsampled too; with
    `down` h and x are average-pooled before it."""

    def __init__(self, channels: int, emb_channels: int, out_channels: Optional[int] = None,
                 dropout: float = 0.0, use_scale_shift_norm: bool = True,
                 up: bool = False, down: bool = False):
        super().__init__()
        out_ch = out_channels or channels
        self.up, self.down = up, down
        self.dropout = dropout
        self.use_scale_shift_norm = use_scale_shift_norm
        first = FusedUpsampleConv(channels, out_ch) if up else _conv(channels, out_ch)
        self.in_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(), first)
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(emb_channels, 2 * out_ch if use_scale_shift_norm else out_ch))
        self.out_layers = nn.Sequential(GroupNorm32(out_ch), nn.SiLU(),
                                        nn.Dropout(dropout), _conv(out_ch, out_ch))
        self.skip_connection = (_conv(channels, out_ch, kernel=1) if channels != out_ch
                                else nn.Identity())

    def forward(self, x, emb, train: bool = False):
        h = F.silu(self.in_layers[0](x))
        if self.up:
            x = upsample_nearest2x(x)
        elif self.down:
            h, x = _avg_pool2(h), _avg_pool2(x)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers(emb)[:, None, None]
        norm, conv = self.out_layers[0], self.out_layers[3]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = norm(h) * (1 + scale) + shift
        else:
            h = norm(h + emb_out)
        # Dropout draws from torch's global generator (the JAX model from its
        # "dropout" rng); LDM and the other sizes default to 0, which skips it.
        h = conv(F.dropout(F.silu(h), self.dropout, training=train and self.dropout > 0))
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """Spatial self-attention with a zero-initialised projection
    (reference: models/unet.py:259-307; vaw_tpu/models/unet.py:186-224):
    GroupNorm, the qkv Linear viewed as [N, T, 3, H, D], the packed
    attention entry, proj_out and the residual."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1):
        super().__init__()
        self.num_heads = (num_heads if num_head_channels == -1
                          else channels // num_head_channels)
        if channels % self.num_heads:
            raise ValueError(f"{channels} channels do not split into {self.num_heads} heads")
        self.norm = GroupNorm32(channels)
        self.qkv = Linear(channels, 3 * channels)  # rows (3, H, D): q | k | v
        self.proj_out = Linear(channels, channels)

    def forward(self, x):
        n, h, w, c = x.shape
        tokens = x.reshape(n, h * w, c)
        qkv = self.qkv(self.norm(tokens)).reshape(n, h * w, 3, self.num_heads,
                                                 c // self.num_heads)
        out = self.proj_out(multi_head_attention_packed(qkv).reshape(n, h * w, c))
        return (tokens + out).reshape(n, h, w, c)


class TimestepEmbedSequential(nn.Sequential):
    """A block of the UNet: ResBlocks take the embedding, the rest do not
    (reference: models/unet.py:54-78). With ``remat`` set to a policy name
    (the UNet sets it under use_checkpoint) its ResBlocks and
    AttentionBlocks are rematted."""

    remat: Optional[str] = None

    def forward(self, x, emb, train: bool = False):
        for layer in self:
            run = layer
            if self.remat is not None and isinstance(layer, (ResBlock, AttentionBlock)):
                run = remat_with_policy(layer, self.remat)
            x = run(x, emb, train) if isinstance(layer, ResBlock) else run(x)
        return x


def _lecun_normal_(w: torch.Tensor, fan_in: int):
    """Flax's default kernel init: a truncated normal of variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


class UNetModel(nn.Module):
    """The full ADM UNet, forward(x [N, H, W, C], t [N], y [N] int) ->
    [N, H, W, out_channels] f32.

    compute_dtype: the dtype of activations and products (bf16 for the
    trainer's f32 masters under --amp); None computes in the weights' dtype.
    """

    keep_f32 = ("out",)

    def __init__(self, image_size: int, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int,
                 attention_resolutions: Sequence[int], dropout: float = 0.0,
                 channel_mult: Sequence[float] = (1, 2, 4, 8), conv_resample: bool = True,
                 num_classes: int = 0, num_heads: int = 1, num_head_channels: int = -1,
                 num_heads_upsample: int = -1, use_scale_shift_norm: bool = True,
                 resblock_updown: bool = True, drop_label_prob: float = 0.0,
                 use_checkpoint: bool = False, remat_policy: str = "full",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        self.remat_policy = check_remat_policy(remat_policy)
        self.image_size = image_size
        self.in_channels = in_channels
        self.model_channels = model_channels
        self.num_classes = num_classes
        self.drop_label_prob = drop_label_prob
        self.compute_dtype = compute_dtype
        if num_heads_upsample == -1:
            num_heads_upsample = num_heads
        # Latent UNets use a fixed 512-wide time embedding
        # (reference: models/unet.py:473-477).
        ted = 512 if in_channels == 4 else model_channels * 4
        self.time_embed = nn.Sequential(Linear(model_channels, ted), nn.SiLU(),
                                        Linear(ted, ted))
        # A null row at index num_classes when trained with label dropout.
        self.label_emb = (nn.Embedding(num_classes + int(drop_label_prob > 0), ted)
                          if num_classes > 0 else None)

        res = dict(emb_channels=ted, dropout=dropout,
                   use_scale_shift_norm=use_scale_shift_norm)
        ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList(
            [TimestepEmbedSequential(_conv(in_channels, ch))])
        chans = [ch]
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, out_channels=int(mult * model_channels), **res)]
                ch = int(mult * model_channels)
                if ds in attention_resolutions:
                    layers.append(AttentionBlock(ch, num_heads, num_head_channels))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepEmbedSequential(
                    ResBlock(ch, out_channels=ch, down=True, **res) if resblock_updown
                    else Downsample(ch, conv_resample, out_channels=ch)))
                chans.append(ch)
                ds *= 2
        self.middle_block = TimestepEmbedSequential(
            ResBlock(ch, **res), AttentionBlock(ch, num_heads, num_head_channels),
            ResBlock(ch, **res))
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), out_channels=int(model_channels * mult),
                                   **res)]
                ch = int(model_channels * mult)
                if ds in attention_resolutions:
                    layers.append(AttentionBlock(ch, num_heads_upsample, num_head_channels))
                if level and i == num_res_blocks:
                    layers.append(ResBlock(ch, out_channels=ch, up=True, **res)
                                  if resblock_updown
                                  else Upsample(ch, conv_resample, out_channels=ch))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(*layers))
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), _conv(ch, out_channels))
        if use_checkpoint:
            for block in [*self.input_blocks, self.middle_block, *self.output_blocks]:
                block.remat = remat_policy
        self.initialize_weights()

    def initialize_weights(self):
        """The JAX model's initialisers: LeCun normal for every conv and
        Linear with zero biases, except the zero-initialised ResBlock output
        convs, attention projections and final conv (reference:
        tools/nn.py:68-76); Flax's Embed init (normal, variance 1/rows) for
        the label table."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv2d)):
                _lecun_normal_(module.weight, module.weight[0].numel())
                nn.init.zeros_(module.bias)
        zero = [self.out[2]] + [m.proj_out for m in self.modules()
                                if isinstance(m, AttentionBlock)] + [
            m.out_layers[3] for m in self.modules() if isinstance(m, ResBlock)]
        for module in zero:
            nn.init.zeros_(module.weight)
        if self.label_emb is not None:
            nn.init.normal_(self.label_emb.weight, std=self.label_emb.num_embeddings ** -0.5)

    @property
    def has_null_label(self) -> bool:
        """Whether label num_classes, the unconditional label of CFG, exists."""
        return self.label_emb is not None and self.drop_label_prob > 0

    def flax_scopes(self) -> Dict[str, str]:
        """Each block's Flax scope by its torch prefix, in call order: Flax
        numbers ResBlock_N, AttentionBlock_N, Upsample_N and Downsample_N
        by kind in the order they are called, which is this module order
        (the inverse of vaw_tpu/models/convert.py:_walk_unet_blocks)."""
        counts: Dict[str, int] = {}
        scopes = {}
        blocks = [(f"input_blocks.{i}", b) for i, b in enumerate(self.input_blocks)]
        blocks += [("middle_block", self.middle_block)]
        blocks += [(f"output_blocks.{i}", b) for i, b in enumerate(self.output_blocks)]
        for prefix, block in blocks:
            for j, layer in enumerate(block):
                kind = type(layer).__name__
                if kind not in ("ResBlock", "AttentionBlock", "Upsample", "Downsample"):
                    continue  # the stem conv, the top-level Conv_0
                scopes[f"{prefix}.{j}"] = f"{kind}_{counts.get(kind, 0)}"
                counts[kind] = counts.get(kind, 0) + 1
        return scopes

    def forward(self, x, t, y=None, train: bool = False, force_drop_ids=None,
                generator: Optional[torch.Generator] = None):
        """train turns on label dropout (drawn from `generator`) and
        dropout; force_drop_ids (1 = drop to the null label) replaces the
        label draw, in training or not (vaw_tpu/models/unet.py:272-287)."""
        if (y is not None) != (self.num_classes > 0):
            raise ValueError("must specify y iff the model is class-conditional")
        # The stem's dtype: the f32 head stays f32 in a sampling copy.
        dtype = self.compute_dtype or self.input_blocks[0][0].weight.dtype
        emb = self.time_embed(timestep_embedding(t, self.model_channels).to(dtype))
        if self.label_emb is not None:
            if (train and self.drop_label_prob > 0) or force_drop_ids is not None:
                if force_drop_ids is None:
                    drop = torch.rand(y.shape[0], generator=generator,
                                      device=y.device) < self.drop_label_prob
                else:
                    drop = force_drop_ids == 1
                y = torch.where(drop, self.num_classes, y)
            emb = emb + self.label_emb(y).to(emb.dtype)

        h = x.to(dtype)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb, train)
            hs.append(h)
        h = self.middle_block(h, emb, train)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=-1), emb, train)
        # The head in f32 (vaw_tpu/models/unet.py:372-375).
        return self.out[2](F.silu(self.out[0](h)).float())


def create_unet_model(image_size, num_channels, num_res_blocks, channel_mult="",
                      in_channels=3, num_classes=10, learn_sigma=False, class_cond=True,
                      use_checkpoint=False, remat_policy="full", attention_resolutions="16",
                      num_heads=1, num_head_channels=-1, num_heads_upsample=-1,
                      use_scale_shift_norm=True, dropout=0, resblock_updown=True,
                      drop_label_prob=0.0, compute_dtype=None) -> UNetModel:
    """(vaw_tpu/models/unet.py:542-598; reference: models/unet.py:921-960)"""
    if channel_mult == "":
        channel_mult = {
            512: (0.5, 1, 1, 2, 2, 4, 4),
            256: (1, 1, 2, 2, 4, 4),
            128: (1, 1, 2, 3, 4),
            64: (1, 2, 3, 4),
            32: (1, 2, 2, 2),
        }.get(image_size)
        if channel_mult is None:
            raise ValueError(f"unsupported image size: {image_size}")
    else:
        channel_mult = tuple(int(m) for m in channel_mult.split(","))
    attention_ds = tuple(image_size // int(r) for r in attention_resolutions.split(","))
    return UNetModel(
        image_size=image_size, in_channels=in_channels, model_channels=num_channels,
        out_channels=in_channels if not learn_sigma else 2 * in_channels,
        num_res_blocks=num_res_blocks, attention_resolutions=attention_ds,
        dropout=dropout, channel_mult=channel_mult,
        num_classes=num_classes if class_cond else 0, num_heads=num_heads,
        num_head_channels=num_head_channels, num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm, resblock_updown=resblock_updown,
        drop_label_prob=drop_label_prob, use_checkpoint=use_checkpoint,
        remat_policy=remat_policy, compute_dtype=compute_dtype)


def _size(image_size: int, num_channels: int, num_res_blocks: int,
          attention_resolutions: str, num_heads: int, num_head_channels: int,
          in_channels: int = 3, channel_mult: str = ""):
    """A registered size (vaw_tpu/models/unet.py:601-678)."""
    def ctor(num_classes=10, in_channels=in_channels, dropout=0, learn_sigma=False,
             class_cond=True, drop_label_prob=0.0, **kwargs):
        return create_unet_model(
            image_size=image_size, num_channels=num_channels,
            num_res_blocks=num_res_blocks, channel_mult=channel_mult,
            attention_resolutions=attention_resolutions, num_heads=num_heads,
            num_head_channels=num_head_channels, num_classes=num_classes,
            dropout=dropout, in_channels=in_channels, learn_sigma=learn_sigma,
            class_cond=class_cond, drop_label_prob=drop_label_prob, **kwargs)

    return ctor


UNet_32 = _size(32, 128, 2, "16,8", 4, -1)
ADM_32 = _size(32, 128, 3, "16,8", 1, 32)
ADM_64 = _size(64, 192, 3, "32,16,8", 1, 64)
ADM_128 = _size(128, 256, 2, "32,16,8", 1, 64)
ADM_256 = _size(256, 256, 2, "32,16,8", 1, 64)
ADM_512 = _size(512, 256, 2, "32,16,8", 1, 64)
UNet_64 = _size(64, 192, 3, "16,8", 4, -1, channel_mult="1,2,2,2")
LDM = _size(32, 256, 2, "32,16,8", 1, 32, in_channels=4, channel_mult="1,2,4")

UNet_models = {
    "UNet-32": UNet_32,
    "ADM-32": ADM_32,
    "ADM-64": ADM_64,
    "ADM-128": ADM_128,
    "ADM-256": ADM_256,
    "ADM-512": ADM_512,
    "UNet-64": UNet_64,
    "LDM": LDM,
}
