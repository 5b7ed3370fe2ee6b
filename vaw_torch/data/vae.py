"""SD-VAE weight loading and the encode/decode closures (counterpart of
vaw_tpu/data/vae.py; reference: diffusers
``AutoencoderKL.from_pretrained("stabilityai/sd-vae-ft-{ema,mse}")``,
tools/sampler.py:104, preprocessing/encode_latent.py).

Weights come from a diffusers checkpoint already on the machine: the file
``VAW_VAE_PATH`` names, else ``pretrained/sd-vae-ft-{name}/`` (nothing is
downloaded). A ``.bin`` is read through ``torch.load(weights_only=True)``;
a ``.safetensors`` file only where the safetensors package imports. The
port's ``AutoencoderKL`` uses diffusers' names, so the conversion keeps
every tensor as it is but the attention projections, whose 1x1-conv form
becomes a Linear weight.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..models.vae import AutoencoderKL

__all__ = ["find_vae_checkpoint", "load_weights_file", "convert_diffusers_vae",
           "load_vae", "load_vae_decoder", "load_vae_encoder"]


def find_vae_checkpoint(name: str = "ema") -> Optional[str]:
    """The first of ``$VAW_VAE_PATH`` and the ``pretrained/`` locations of
    vaw_tpu/data/vae.py:27-37 that exists, or None."""
    candidates = [
        os.environ.get("VAW_VAE_PATH", ""),
        f"pretrained/sd-vae-ft-{name}/diffusion_pytorch_model.safetensors",
        f"pretrained/sd-vae-ft-{name}/diffusion_pytorch_model.bin",
        f"pretrained/sd-vae-ft-{name}.safetensors",
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


def load_weights_file(path: str):
    """What a weights file holds: a ``.safetensors`` file as a dict of numpy
    arrays, anything else through ``torch.load(weights_only=True)`` on the
    CPU. Raises ImportError, naming the file, where a safetensors file meets
    a machine without the package."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.numpy import load_file
        except ImportError as e:
            raise ImportError(
                f"{path} is a safetensors file and the safetensors package does "
                f"not import here ({e}); save the state dict with torch.save as "
                "a .bin instead") from e
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def _to_numpy(v) -> np.ndarray:
    """A tensor (bf16 through f32, exactly) or an array -> numpy."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _load_torch_state(path: str) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in load_weights_file(path).items()}


def _take(sd: Mapping, out: Dict[str, torch.Tensor], prefix: str, linear=False):
    """Copy ``prefix.weight`` and ``prefix.bias`` (KeyError when absent); a
    1x1-conv weight becomes a Linear one when `linear`."""
    w = np.asarray(sd[f"{prefix}.weight"])
    if linear and w.ndim == 4:
        w = w[:, :, 0, 0]
    out[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
    out[f"{prefix}.bias"] = torch.from_numpy(np.ascontiguousarray(sd[f"{prefix}.bias"]))


def _resnet(sd, out, prefix, has_shortcut):
    for name in ("norm1", "conv1", "norm2", "conv2") + (
            ("conv_shortcut",) if has_shortcut else ()):
        _take(sd, out, f"{prefix}.{name}")


def _mid(sd, out, prefix):
    _resnet(sd, out, f"{prefix}.resnets.0", False)
    attn = f"{prefix}.attentions.0"
    _take(sd, out, f"{attn}.group_norm")
    for name in ("to_q", "to_k", "to_v", "to_out.0"):
        _take(sd, out, f"{attn}.{name}", linear=True)
    _resnet(sd, out, f"{prefix}.resnets.1", False)


def convert_diffusers_vae(sd: Mapping, channel_mults=(1, 2, 4, 4),
                          num_res_blocks: int = 2, base: int = 128
                          ) -> Dict[str, torch.Tensor]:
    """A diffusers AutoencoderKL state dict (numpy arrays or tensors) -> the
    state dict of the port's AutoencoderKL of that configuration: the
    tensors vaw_tpu/data/vae.py:91-140 reads, under the same names, with
    the attention projections as Linear weights. KeyError names a tensor
    the state dict lacks."""
    sd = {k: _to_numpy(v) for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}
    _take(sd, out, "encoder.conv_in")
    ch = base
    for i, mult in enumerate(channel_mults):
        out_ch = base * mult
        for j in range(num_res_blocks):
            _resnet(sd, out, f"encoder.down_blocks.{i}.resnets.{j}",
                    j == 0 and ch != out_ch)
        ch = out_ch
        if i != len(channel_mults) - 1:
            _take(sd, out, f"encoder.down_blocks.{i}.downsamplers.0.conv")
    _mid(sd, out, "encoder.mid_block")
    _take(sd, out, "encoder.conv_norm_out")
    _take(sd, out, "encoder.conv_out")
    _take(sd, out, "quant_conv")
    _take(sd, out, "post_quant_conv")
    _take(sd, out, "decoder.conv_in")
    _mid(sd, out, "decoder.mid_block")
    ch = base * channel_mults[-1]
    for i, mult in enumerate(reversed(channel_mults)):
        out_ch = base * mult
        for j in range(num_res_blocks + 1):
            _resnet(sd, out, f"decoder.up_blocks.{i}.resnets.{j}",
                    j == 0 and ch != out_ch)
        ch = out_ch
        if i != len(channel_mults) - 1:
            _take(sd, out, f"decoder.up_blocks.{i}.upsamplers.0.conv")
    _take(sd, out, "decoder.conv_norm_out")
    _take(sd, out, "decoder.conv_out")
    return out


def load_vae(name: str = "ema", dtype: torch.dtype = torch.float32,
             device="cuda") -> AutoencoderKL:
    """The full-size SD-VAE (ch 128, mults (1, 2, 4, 4), 2 res blocks, 4
    latent channels) from the local checkpoint, with f32 weights on
    `device`, computing in `dtype`, frozen and in eval mode. Raises
    FileNotFoundError when no checkpoint is on the machine."""
    path = find_vae_checkpoint(name)
    if path is None:
        raise FileNotFoundError(
            f"sd-vae-ft-{name} checkpoint not found; set VAW_VAE_PATH or "
            f"place it under pretrained/sd-vae-ft-{name}/")
    model = AutoencoderKL(compute_dtype=dtype)
    model.load_state_dict(convert_diffusers_vae(_load_torch_state(path)), strict=True)
    return model.to(device).eval().requires_grad_(False)


def load_vae_decoder(name: str = "ema", dtype: torch.dtype = torch.float32,
                     device="cuda") -> Callable:
    """latents [N, h, w, 4] (already divided by the latent scale by the
    caller, reference: tools/sampler.py:249-255) -> images [N, 8h, 8w, 3]
    in [-1, 1], f32."""
    model = load_vae(name, dtype, device)

    @torch.inference_mode()
    def decode(z):
        return model.decode(z)

    return decode


def load_vae_encoder(name: str = "ema", dtype: torch.dtype = torch.float32,
                     device="cuda") -> Callable:
    """images [N, H, W, 3] in [-1, 1] -> [mean | std] moments
    [N, H/8, W/8, 8], the HDF5 layout (reference:
    preprocessing/encode_latent.py:95-100)."""
    model = load_vae(name, dtype, device)

    @torch.no_grad()
    def encode(x):
        return model.moments_to_mean_std(model.encode(x))

    return encode
