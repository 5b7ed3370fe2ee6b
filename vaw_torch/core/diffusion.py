"""Discrete-time Gaussian diffusion for training (counterpart of
vaw_tpu/core/diffusion.py; reference: tools/gaussian_diffusion.py:126-1005).

The coefficient tables are the host-side f64 numpy tables of
``core/schedules.py``, gathered as f32 (``_extract``, as the JAX module's
:58). Each table is copied to a device once and cached there, so a train
step makes no host-to-device copy. Randomness is explicit: the caller
passes ``t`` and ``noise`` (``sample_t`` draws t from a torch.Generator).
Arrays are NHWC.

Ported so far: the training loss for MSE and RESCALED_MSE with a fixed
variance, for all four mean types. Learned variance (the vb term, which
needs p_mean_variance) and the KL losses raise, naming ROADMAP A3; the
ancestral and DDIM loops are A15; the REPA align loss is A13.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .losses import mean_flat
from .schedules import Schedule
from .types import LossType, ModelMeanType, ModelVarType
from .weighting import compute_mse_loss_weight

__all__ = ["GaussianDiffusion", "unpack_model_output"]


def unpack_model_output(raw_output):
    """Models may return (pred, aux_features); returns (pred, aux)
    (vaw_tpu/core/diffusion.py:50-55)."""
    if isinstance(raw_output, tuple):
        return raw_output[0], (raw_output[1] if len(raw_output) > 1 else None)
    return raw_output, None


class GaussianDiffusion:
    """Training utilities for DDPM-family models. `model_fn(x_t, t_model,
    **model_kwargs)` is any callable on tensors (typically the model with
    its training flags bound)."""

    def __init__(self, schedule: Schedule,
                 model_mean_type: ModelMeanType = ModelMeanType.EPSILON,
                 model_var_type: ModelVarType = ModelVarType.FIXED_LARGE,
                 loss_type: LossType = LossType.MSE,
                 weight_type: str = "constant", p2_k: float = 1.0,
                 p2_gamma: float = 1.0, learn_align: bool = False):
        self.schedule = schedule
        self.model_mean_type = model_mean_type
        self.model_var_type = model_var_type
        self.loss_type = loss_type
        self.weight_type = weight_type
        self.p2_k, self.p2_gamma = p2_k, p2_gamma
        self.learn_align = learn_align
        self._tables: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    @property
    def num_timesteps(self) -> int:
        return self.schedule.num_timesteps

    def _table(self, name: str, device: torch.device) -> torch.Tensor:
        """The schedule's f64 table `name` as f32 on `device`, made once."""
        key = (name, device)
        if key not in self._tables:
            dtype = torch.int64 if name == "timestep_map" else torch.float32
            self._tables[key] = torch.as_tensor(
                np.asarray(getattr(self.schedule, name)), dtype=dtype,
                device=device)
        return self._tables[key]

    def _extract(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """Table `name` at timesteps t as f32, shaped [N, 1, ...]
        (reference: tools/gaussian_diffusion.py:1059-1072)."""
        out = self._table(name, t.device)[t]
        return out.reshape(out.shape[0], *([1] * (ndim - 1)))

    def _model_t(self, t: torch.Tensor) -> torch.Tensor:
        """Timestep as seen by the model: respaced indices mapped back to
        the original ones, then rescaled to 0..1000, as every caller of
        the JAX class asks (rescale_timesteps=True; reference:
        tools/respace.py:125-130, gaussian_diffusion.py:417-420)."""
        mapped = self._table("timestep_map", t.device)[t]
        return mapped.float() * (1000.0 / self.schedule.original_num_steps)

    def q_sample(self, x_start, t, noise):
        """Sample from q(x_t | x_0) (reference: tools/gaussian_diffusion.py:234-252)."""
        return (self._extract("sqrt_alphas_cumprod", t, x_start.dim()) * x_start
                + self._extract("sqrt_one_minus_alphas_cumprod", t, x_start.dim())
                * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        """q(x_{t-1} | x_t, x_0) (reference: tools/gaussian_diffusion.py:254-276)."""
        n = x_t.dim()
        mean = (self._extract("posterior_mean_coef1", t, n) * x_start
                + self._extract("posterior_mean_coef2", t, n) * x_t)
        return (mean, self._extract("posterior_variance", t, n),
                self._extract("posterior_log_variance_clipped", t, n))

    def sample_t(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """Uniform discrete t on the generator's device
        (reference: tools/gaussian_diffusion.py:810-816)."""
        return torch.randint(0, self.num_timesteps, (batch_size,),
                             generator=generator, device=generator.device)

    def compute_target(self, x_start, noise, t, x_t=None):
        """Regression target per mean type
        (reference: tools/gaussian_diffusion.py:818-832)."""
        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            if x_t is None:
                x_t = self.q_sample(x_start, t, noise)
            return self.q_posterior_mean_variance(x_start, x_t, t)[0]
        if self.model_mean_type == ModelMeanType.START_X:
            return x_start
        if self.model_mean_type == ModelMeanType.EPSILON:
            return noise
        if self.model_mean_type == ModelMeanType.VELOCITY:
            n = x_start.dim()
            return (self._extract("sqrt_alphas_cumprod", t, n) * noise
                    - self._extract("sqrt_one_minus_alphas_cumprod", t, n) * x_start)
        raise NotImplementedError(self.model_mean_type)

    def training_losses(self, model_fn, x_start, t, noise, model_kwargs=None
                        ) -> Dict[str, torch.Tensor]:
        """Weighted training loss for one batch, per-sample [N] terms
        (reference: tools/gaussian_diffusion.py:834-930;
        vaw_tpu/core/diffusion.py:437-510)."""
        if self.loss_type in (LossType.KL, LossType.RESCALED_KL):
            raise NotImplementedError(
                "the KL training losses (vb terms) are not ported yet: ROADMAP A3")
        if self.loss_type not in (LossType.MSE, LossType.RESCALED_MSE):
            raise NotImplementedError(self.loss_type)
        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            raise NotImplementedError(
                "learned variance (the vb term) is not ported yet: ROADMAP A3")
        if self.learn_align:
            raise NotImplementedError(
                "the REPA align loss is not ported yet: ROADMAP A13")
        x_t = self.q_sample(x_start, t, noise)
        alpha = self._table("sqrt_alphas_cumprod", t.device)[t]
        sigma = self._table("sqrt_one_minus_alphas_cumprod", t.device)[t]
        weight = compute_mse_loss_weight(self.model_mean_type, self.weight_type,
                                         t, alpha, sigma, self.p2_k, self.p2_gamma)
        model_output, _ = unpack_model_output(
            model_fn(x_t, self._model_t(t), **(model_kwargs or {})))
        target = self.compute_target(x_start, noise, t, x_t=x_t)
        if not model_output.shape == target.shape == x_start.shape:
            raise ValueError(f"model output {tuple(model_output.shape)} does not "
                             f"match the target {tuple(target.shape)}")
        mse = weight * mean_flat((target - model_output.float()) ** 2)
        return {"mse": mse, "loss": mse}
