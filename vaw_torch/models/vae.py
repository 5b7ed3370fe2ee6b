"""AutoencoderKL, the SD-VAE of latent training, in PyTorch (counterpart of
vaw_tpu/models/vae.py; reference: diffusers ``AutoencoderKL`` as used at
tools/sampler.py:104 and preprocessing/encode_latent.py).

Images and latents are NHWC at the interface. The encoder emits
``[mean | logvar]`` moments; the HDF5 storage keeps ``[mean | std]``
(``moments_to_mean_std``) and the 0.18215 latent scale lives in the caller,
as in the JAX package. Submodule names are diffusers', so a diffusers state
dict loads with only its attention projections reshaped
(``vaw_torch.data.vae.convert_diffusers_vae``); ``quant_conv`` and
``post_quant_conv`` sit at the top level, as there.

Precision: the weights stay f32 and every layer computes in the model's
``compute_dtype`` (bf16 for the sampler's decode under --amp), casting its
weights per call as Flax's ``Conv(dtype=...)`` over f32 params does. The
norms are GroupNorm with 32 groups and eps 1e-6, normalising in f32
(``GroupNorm32``); the mid-block attention is single-head over all C
channels with f32 logits and softmax, a plain product as in the JAX
module (no Pallas kernel there either); the decoder's ``conv_out`` runs in
f32 under any compute dtype. Downsampling pads (0, 1) on H and W before a
stride-2 VALID conv; upsampling is nearest-2x then a 3x3 conv
(``FusedUpsampleConv``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, FusedUpsampleConv, GroupNorm32, Linear

__all__ = ["AutoencoderKL", "Encoder", "Decoder"]

_GN_EPS = 1e-6


def _gn(channels: int) -> GroupNorm32:
    """32 groups, eps 1e-6, f32 statistics and parameters
    (vaw_tpu/models/vae.py:25-34)."""
    return GroupNorm32(channels, eps=_GN_EPS)


class ResnetBlock(nn.Module):
    """(vaw_tpu/models/vae.py:37-52)"""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = _gn(in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3)
        self.norm2 = _gn(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the H*W positions
    (vaw_tpu/models/vae.py:55-73): logits of the compute-dtype q and k
    summed in f32, f32 softmax, then P (cast back) times v."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = _gn(channels)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x):
        n, h, w, c = x.shape
        y = self.group_norm(x)
        q, k, v = (proj(y).reshape(n, h * w, c)
                   for proj in (self.to_q, self.to_k, self.to_v))
        logits = torch.matmul(q.float(), k.float().transpose(1, 2))
        weights = torch.softmax(logits * (c ** -0.5), dim=-1)
        out = self.to_out[0](torch.matmul(weights.to(v.dtype), v))
        return x + out.reshape(n, h, w, c)


class Downsample(nn.Module):
    """Pad (0, 1) on H and W, then a stride-2 VALID 3x3 conv
    (vaw_tpu/models/vae.py:76-84)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest-2x then a SAME 3x3 conv (vaw_tpu/models/vae.py:87-97)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = FusedUpsampleConv(channels, channels)

    def forward(self, x):
        return self.conv(x)


class _Level(nn.Module):
    """One resolution of the encoder or decoder: its ResnetBlocks, then an
    optional resampler (diffusers' ``down_blocks.i`` / ``up_blocks.i``)."""

    def __init__(self, channels: Sequence[int], resample: Optional[nn.Module],
                 kind: str):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock(a, b)
                                     for a, b in zip(channels, channels[1:]))
        if resample is not None:
            setattr(self, kind, nn.ModuleList([resample]))
        self.kind = kind

    def forward(self, x):
        for block in self.resnets:
            x = block(x)
        for resample in getattr(self, self.kind, ()):
            x = resample(x)
        return x


class _MidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(channels, channels),
                                      ResnetBlock(channels, channels)])
        self.attentions = nn.ModuleList([AttnBlock(channels)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    """x [N, H, W, 3] -> [N, H/2^(L-1), W/2^(L-1), 2*latent] pre-quant
    moments, in x's dtype (vaw_tpu/models/vae.py:100-126, without
    ``quant_conv``, which is the autoencoder's)."""

    def __init__(self, base_channels: int = 128,
                 channel_mults: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, latent_channels: int = 4):
        super().__init__()
        self.conv_in = Conv2d(3, base_channels, 3)
        self.down_blocks = nn.ModuleList()
        ch = base_channels
        for i, mult in enumerate(channel_mults):
            out = base_channels * mult
            last = i == len(channel_mults) - 1
            self.down_blocks.append(_Level(
                [ch] + [out] * num_res_blocks, None if last else Downsample(out),
                "downsamplers"))
            ch = out
        self.mid_block = _MidBlock(ch)
        self.conv_norm_out = _gn(ch)
        self.conv_out = Conv2d(ch, 2 * latent_channels, 3)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down_blocks:
            h = level(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    """z [N, h, w, latent] (after ``post_quant_conv``) -> images
    [N, h*2^(L-1), w*2^(L-1), 3] in f32 (vaw_tpu/models/vae.py:129-156)."""

    def __init__(self, base_channels: int = 128,
                 channel_mults: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, latent_channels: int = 4,
                 out_channels: int = 3):
        super().__init__()
        ch = base_channels * channel_mults[-1]
        self.conv_in = Conv2d(latent_channels, ch, 3)
        self.mid_block = _MidBlock(ch)
        self.up_blocks = nn.ModuleList()
        for i, mult in enumerate(reversed(channel_mults)):
            out = base_channels * mult
            last = i == len(channel_mults) - 1
            self.up_blocks.append(_Level(
                [ch] + [out] * (num_res_blocks + 1), None if last else Upsample(out),
                "upsamplers"))
            ch = out
        self.conv_norm_out = _gn(ch)
        self.conv_out = Conv2d(ch, out_channels, 3)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for level in self.up_blocks:
            h = level(h)
        h = F.silu(self.conv_norm_out(h))
        return self.conv_out(h.float())


class AutoencoderKL(nn.Module):
    """encode(x) -> [mean | logvar] moments; decode(z) -> images; forward(x)
    -> (decode(sample_latent(moments)), moments)
    (vaw_tpu/models/vae.py:159-204).

    compute_dtype: the dtype of activations and products; None computes in
    the weights' dtype. The base width must be a multiple of 32, the norms'
    group count, as Flax's GroupNorm requires.
    """

    def __init__(self, base_channels: int = 128,
                 channel_mults: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, latent_channels: int = 4,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if base_channels % 32:
            raise ValueError(f"base_channels {base_channels} is not a multiple of "
                             "the 32 norm groups")
        self.compute_dtype = compute_dtype
        args = (base_channels, tuple(channel_mults), num_res_blocks, latent_channels)
        self.encoder = Encoder(*args)
        self.decoder = Decoder(*args)
        self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = Conv2d(latent_channels, latent_channels, 1)

    def _dtype(self) -> torch.dtype:
        return self.compute_dtype or self.quant_conv.weight.dtype

    def encode(self, x):
        """x [N, H, W, 3] in [-1, 1] -> moments [N, H/8, W/8, 2*latent] for
        the full-size VAE, in the compute dtype."""
        return self.quant_conv(self.encoder(x.to(self._dtype())))

    def decode(self, z):
        """z [N, h, w, latent] (already divided by the latent scale) ->
        images [N, 8h, 8w, 3] in f32 for the full-size VAE."""
        return self.decoder(self.post_quant_conv(z.to(self._dtype())))

    def forward(self, x, generator: Optional[torch.Generator] = None, noise=None):
        moments = self.encode(x)
        z = self.sample_latent(moments, generator, noise)
        return self.decode(z), moments

    @staticmethod
    def sample_latent(moments, generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None):
        """mean + std * eps, logvar clipped to [-30, 20]; eps is `noise` when
        given, else a normal draw from `generator` on the moments' device."""
        mean, logvar = moments.chunk(2, dim=-1)
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                                dtype=mean.dtype)
        return mean + std * noise

    @staticmethod
    def moments_to_mean_std(moments):
        """[mean | logvar] -> [mean | std], the HDF5 storage layout
        (reference: preprocessing/encode_latent.py:95-100)."""
        mean, logvar = moments.chunk(2, dim=-1)
        return torch.cat([mean, torch.exp(0.5 * logvar.clamp(-30.0, 20.0))], dim=-1)
