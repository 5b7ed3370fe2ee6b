"""Likelihood losses (counterpart of vaw_tpu/core/losses.py:25-73;
reference: tools/losses.py:12-77, tools/nn.py:86-90).

The representation-alignment (REPA) losses of the JAX module come with
ROADMAP A13.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "mean_flat",
    "normal_kl",
    "approx_standard_normal_cdf",
    "discretized_gaussian_log_likelihood",
]


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes (reference: tools/nn.py:86-90)."""
    return x.mean(dim=tuple(range(1, x.dim())))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two Gaussians, broadcasting all args; scalars may be
    Python numbers (reference: tools/losses.py:12-39)."""
    ref = next(x for x in (mean1, logvar1, mean2, logvar2)
               if isinstance(x, torch.Tensor))
    mean1, logvar1, mean2, logvar2 = (
        torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
        for x in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (
        -1.0
        + logvar2
        - logvar1
        + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x):
    """Tanh approximation of the standard normal CDF
    (reference: tools/losses.py:42-47)."""
    return 0.5 * (
        1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of uint8 images (scaled to [-1,1]) under a Gaussian
    discretized to 256 buckets (reference: tools/losses.py:50-77)."""
    means = torch.broadcast_to(means, x.shape)
    log_scales = torch.broadcast_to(log_scales, x.shape)
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(
        x < -0.999, log_cdf_plus,
        torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))
