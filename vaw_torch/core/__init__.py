"""Enums, host-side f64 schedule tables, loss weighting, likelihood losses
and the Gaussian diffusion training loss."""

from .diffusion import GaussianDiffusion, unpack_model_output
from .losses import (
    approx_standard_normal_cdf,
    discretized_gaussian_log_likelihood,
    mean_flat,
    normal_kl,
)
from .schedules import (
    Schedule,
    get_named_beta_schedule,
    make_schedule,
    respace_schedule,
    space_timesteps,
)
from .types import LossType, ModelMeanType, ModelVarType
from .weighting import compute_mse_loss_weight

__all__ = [
    "GaussianDiffusion", "unpack_model_output",
    "approx_standard_normal_cdf", "discretized_gaussian_log_likelihood",
    "mean_flat", "normal_kl",
    "Schedule", "get_named_beta_schedule", "make_schedule",
    "respace_schedule", "space_timesteps",
    "LossType", "ModelMeanType", "ModelVarType",
    "compute_mse_loss_weight",
]
