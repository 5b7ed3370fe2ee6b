"""REPA align glue: the teacher, its per-family pixel preprocessing, and the
frozen features (counterpart of vaw_tpu/encoders/align.py; reference:
tools/align_utils.py).

Preprocessing runs on the pixels' device: /255, the channel normalisation,
and the bicubic resize to the teacher's input size, which is torch's
antialiased bicubic (``F.interpolate(..., antialias=True)``). That is the
kernel ``jax.image.resize(..., "bicubic")`` uses (Keys a = -0.5, the
support stretched on downscaling, renormalised at the borders), so the two
agree to rounding at 256 -> 224 and 32 -> 224 alike. ``get_feature`` runs
the teacher without gradients and keeps the per-family token slicing.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .loaders import load_encoders, runtime_image_size

__all__ = ["initialize_encoders", "preprocess_raw_image", "get_feature"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _first_spec(enc_type: str) -> str:
    """The spec of teacher 0, the only one used (reference:
    tools/align_utils.py:15), so that preprocessing is keyed on it alone
    (vaw_tpu/encoders/align.py:29-36)."""
    return enc_type.split(",")[0].strip()


def initialize_encoders(enc_type: str, image_size: int,
                        dtype: torch.dtype = torch.float32, device="cuda"):
    """(teacher, family) at pixel resolution image_size * 8, the pre-VAE
    resolution of latent training (reference: tools/align_utils.py:12-16)."""
    encoders, _, families = load_encoders(_first_spec(enc_type), image_size * 8,
                                          dtype=dtype, device=device)
    return encoders[0], families[0]


def _resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """Antialiased bicubic resize of NHWC images to size x size."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bicubic",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def _normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def preprocess_raw_image(x: torch.Tensor, enc_type: str) -> torch.Tensor:
    """NHWC pixels in [0, 255] -> the teacher's normalised input
    (vaw_tpu/encoders/align.py:50-73): CLIP resizes, then normalises with
    its statistics; the others normalise with ImageNet's, then resize where
    ``runtime_image_size`` asks for another size."""
    enc_type = _first_spec(enc_type)
    resolution = x.shape[1]
    target = runtime_image_size(enc_type.split("-")[0], resolution)
    x = x.float() / 255.0
    if "clip" in enc_type:
        if target != resolution:
            x = _resize(x, target)
        return _normalize(x, CLIP_MEAN, CLIP_STD)
    x = _normalize(x, IMAGENET_MEAN, IMAGENET_STD)
    if target != resolution:  # dinov2/jepa resize after the normalisation
        x = _resize(x, target)
    return x


@torch.no_grad()
def get_feature(enc_type: str, pixels: torch.Tensor, encoder_fn: Callable) -> torch.Tensor:
    """Frozen-teacher patch tokens [N, T, D] for the REPA loss (reference:
    tools/align_utils.py:43-50): cls and the 4 registers dropped for
    dinov2reg, nothing for jepa, the cls token for the rest."""
    enc_type = _first_spec(enc_type)
    feats = encoder_fn(preprocess_raw_image(pixels, enc_type))
    if "dinov2reg" in enc_type:
        return feats[:, 5:]
    if "jepa" not in enc_type:
        return feats[:, 1:]
    return feats
