"""Variance-aware MSE loss weighting, the paper's contribution (counterpart
of vaw_tpu/core/weighting.py:30-103; reference:
tools/gaussian_diffusion.py:1092-1148).

Every weight_type x mean_type cell of the reference's weight library as one
vectorized function on tensors. The loss-aware timestep resamplers of the
JAX module come with ROADMAP A11.
"""

from __future__ import annotations

import torch

from .types import ModelMeanType

__all__ = ["compute_mse_loss_weight"]


def compute_mse_loss_weight(
    model_mean_type: ModelMeanType,
    weight_type: str,
    t: torch.Tensor,
    alpha: torch.Tensor,
    sigma: torch.Tensor,
    p2_k: float = 1.0,
    p2_gamma: float = 1.0,
) -> torch.Tensor:
    """Per-sample f32 MSE weight.

    alpha = sqrt(alpha_bar_t), sigma = sqrt(1 - alpha_bar_t) for discrete
    diffusion. snr = (alpha/sigma)^2. Weights with snr == 0 are forced to
    1.0 (reference :1147). An invalid cell raises ValueError.
    """
    alpha = alpha.float()
    sigma = sigma.float()
    snr = (alpha / sigma) ** 2
    ones = torch.ones_like(snr)

    if weight_type == "constant":
        return torch.ones(t.shape, dtype=torch.float32, device=t.device)

    w = None
    name = model_mean_type.name
    if name == "EPSILON":
        if weight_type.startswith("min_snr_"):
            k = float(weight_type.split("min_snr_")[-1])
            w = torch.clamp(snr, max=k) / snr
        elif weight_type.startswith("max_snr_"):
            k = float(weight_type.split("max_snr_")[-1])
            w = torch.clamp(snr, min=k) / snr
        elif weight_type == "lambda":
            w = sigma
        elif weight_type == "debias":
            w = sigma / alpha
        elif weight_type == "p2":
            w = 1.0 / (p2_k + snr) ** p2_gamma
        elif weight_type == "min_debias":
            w = torch.minimum(sigma / alpha, ones)
        elif weight_type == "max_debias":
            w = torch.maximum(sigma / alpha, ones)
    elif name == "START_X":
        if weight_type == "trunc_snr":
            w = torch.maximum(snr, ones)
        elif weight_type == "snr":
            w = snr
        elif weight_type == "inv_snr":
            w = 1.0 / snr
        elif weight_type.startswith("min_snr_"):
            k = float(weight_type.split("min_snr_")[-1])
            w = torch.clamp(snr, max=k)
        elif weight_type.startswith("max_snr_"):
            k = float(weight_type.split("max_snr_")[-1])
            w = torch.clamp(snr, min=k)
        elif weight_type == "lambda":
            w = alpha
    elif name == "VECTOR":
        if weight_type == "lambda":
            w = ones
    elif name == "VELOCITY":
        if weight_type.startswith("min_snr_"):
            k = float(weight_type.split("min_snr_")[-1])
            w = torch.clamp(snr, max=k) / (snr + 1)
        elif weight_type == "lambda":
            w = alpha * sigma

    if w is None:
        raise ValueError(
            f"Invalid weight_type {weight_type!r} for mean type {name}")
    # snr == 0 guard (reference :1147).
    return torch.where(snr == 0, torch.ones_like(w), w)
