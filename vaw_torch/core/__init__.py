"""Enums, host-side f64 schedule tables, loss weighting and the timestep
resamplers, likelihood losses, the Gaussian diffusion process and flow
matching."""

from .diffusion import GaussianDiffusion, unpack_model_output
from .flow import FlowMatching, interpolant
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
from .weighting import (
    LossSecondMomentResampler,
    ResamplerState,
    UniformSampler,
    compute_mse_loss_weight,
    create_named_schedule_sampler,
)

__all__ = [
    "GaussianDiffusion", "unpack_model_output",
    "FlowMatching", "interpolant",
    "approx_standard_normal_cdf", "discretized_gaussian_log_likelihood",
    "mean_flat", "normal_kl",
    "Schedule", "get_named_beta_schedule", "make_schedule",
    "respace_schedule", "space_timesteps",
    "LossType", "ModelMeanType", "ModelVarType",
    "LossSecondMomentResampler", "ResamplerState", "UniformSampler",
    "compute_mse_loss_weight", "create_named_schedule_sampler",
]
