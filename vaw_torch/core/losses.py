"""Likelihood and representation-alignment losses (counterpart of
vaw_tpu/core/losses.py; reference: tools/losses.py:12-77,
tools/nn.py:86-90, tools/gaussian_diffusion.py:1007-1052).
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "mean_flat",
    "normal_kl",
    "approx_standard_normal_cdf",
    "discretized_gaussian_log_likelihood",
    "compute_align_loss",
    "projection_loss",
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


def _l2_normalize(x, dim=-1, eps=1e-12):
    """x / sqrt(max(sum x^2, eps)) (vaw_tpu/core/losses.py:75-78)."""
    return x / torch.sqrt(torch.clamp((x * x).sum(dim=dim, keepdim=True), min=eps))


def compute_align_loss(target, output, align_type: str, temperature: float = 0.1):
    """REPA alignment loss between the frozen teacher's features `target`
    and the projector's `output`, both [N, T, D] (reference:
    tools/gaussian_diffusion.py:1007-1046): negative mean cosine, MSE, MSE
    of the unit vectors, or the symmetric InfoNCE over all N*T tokens, whose
    [N*T, N*T] logits it forms whole."""
    if align_type == "cosine":
        return -(_l2_normalize(target) * _l2_normalize(output)).sum(-1).mean()
    if align_type == "mse":
        return ((output - target) ** 2).mean()
    if align_type == "mse_l2":
        return ((_l2_normalize(output) - _l2_normalize(target)) ** 2).mean()
    if align_type == "nt_xent":
        if temperature <= 0:
            raise ValueError("temperature must be > 0")
        n, t_len, d = target.shape
        tgt = _l2_normalize(target.reshape(n * t_len, d), dim=1)
        out = _l2_normalize(output.reshape(n * t_len, d), dim=1)
        logits = (out @ tgt.T) / temperature
        loss_i = -torch.log_softmax(logits, dim=-1).diagonal().mean()
        loss_j = -torch.log_softmax(logits.T, dim=-1).diagonal().mean()
        return 0.5 * (loss_i + loss_j)
    raise ValueError(f"Unknown align loss type: {align_type}.")


def projection_loss(z, z_tilde):
    """Negative mean cosine similarity (reference:
    tools/gaussian_diffusion.py:1048-1052)."""
    return -(_l2_normalize(z) * _l2_normalize(z_tilde)).sum(-1).mean()
