"""Discrete-time Gaussian diffusion for training (counterpart of
vaw_tpu/core/diffusion.py; reference: tools/gaussian_diffusion.py:126-1005).

The coefficient tables are the host-side f64 numpy tables of
``core/schedules.py``, gathered as f32 (``_extract``, as the JAX module's
:58). Each table is copied to a device once and cached there, so a train
step makes no host-to-device copy. Randomness is explicit: the caller
passes ``t`` and ``noise`` (``sample_t`` draws t from a torch.Generator).
Arrays are NHWC.

Ported: q(x_t | x_0) and its posterior, the x_0 predictions, p(x_{t-1} |
x_t) for the four variance types (the learned ones split the model output
on the last, NHWC channel axis), the variational-bound term, the training
loss for MSE and RESCALED_MSE (with the learned-variance vb term, which
cannot move the mean, and the REPA align term) and for KL and RESCALED_KL,
and the bits-per-dim evaluation ``calc_bpd_loop``. The ancestral and DDIM
loops are ROADMAP A15.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .losses import (
    compute_align_loss,
    discretized_gaussian_log_likelihood,
    mean_flat,
    normal_kl,
)
from .schedules import Schedule
from .types import LossType, ModelMeanType, ModelVarType
from .weighting import compute_mse_loss_weight

__all__ = ["GaussianDiffusion", "unpack_model_output"]


def _check_gamma(gamma: float):
    """The align term needs a positive weight (vaw_tpu/core/diffusion.py:494,
    flow.py:187)."""
    if not gamma > 0:
        raise ValueError("gamma must be > 0 for align loss")


def unpack_model_output(raw_output):
    """Models may return (pred, aux_features); returns (pred, aux)
    (vaw_tpu/core/diffusion.py:50-55)."""
    if isinstance(raw_output, tuple):
        return raw_output[0], (raw_output[1] if len(raw_output) > 1 else None)
    return raw_output, None


# Tables the JAX module derives from the schedule's in f64 before its f32
# gather (vaw_tpu/core/diffusion.py:110, 157-161, 194-206).
_DERIVED: Dict[str, Callable[[Schedule], np.ndarray]] = {
    "one_minus_alphas_cumprod": lambda s: 1.0 - s.alphas_cumprod,
    "log_betas": lambda s: np.log(s.betas),
    "log_fixed_large_variance": lambda s: np.log(s.fixed_large_variance),
    "recip_posterior_mean_coef1": lambda s: 1.0 / s.posterior_mean_coef1,
    "posterior_coef2_over_coef1":
        lambda s: s.posterior_mean_coef2 / s.posterior_mean_coef1,
}
_LOG2 = math.log(2.0)


class GaussianDiffusion:
    """Training utilities for DDPM-family models. `model_fn(x_t, t_model,
    **model_kwargs)` is any callable on tensors (typically the model with
    its training flags bound)."""

    def __init__(self, schedule: Schedule,
                 model_mean_type: ModelMeanType = ModelMeanType.EPSILON,
                 model_var_type: ModelVarType = ModelVarType.FIXED_LARGE,
                 loss_type: LossType = LossType.MSE,
                 weight_type: str = "constant", p2_k: float = 1.0,
                 p2_gamma: float = 1.0, gamma: float = 0.0,
                 learn_align: bool = False, align_type: str = "mse"):
        self.schedule = schedule
        self.model_mean_type = model_mean_type
        self.model_var_type = model_var_type
        self.loss_type = loss_type
        self.weight_type = weight_type
        self.p2_k, self.p2_gamma = p2_k, p2_gamma
        self.gamma = gamma
        self.learn_align = learn_align
        self.align_type = align_type
        self._tables: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    @property
    def num_timesteps(self) -> int:
        return self.schedule.num_timesteps

    def _table(self, name: str, device: torch.device) -> torch.Tensor:
        """The schedule's f64 table `name` (or one of ``_DERIVED``, computed
        in f64 first) as f32 on `device`, made once."""
        key = (name, device)
        if key not in self._tables:
            dtype = torch.int64 if name == "timestep_map" else torch.float32
            derive = _DERIVED.get(name)
            table = (derive(self.schedule) if derive is not None
                     else getattr(self.schedule, name))
            self._tables[key] = torch.as_tensor(np.asarray(table), dtype=dtype,
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

    def q_mean_variance(self, x_start, t):
        """q(x_t | x_0) (reference: tools/gaussian_diffusion.py:217-232)."""
        n = x_start.dim()
        return (self._extract("sqrt_alphas_cumprod", t, n) * x_start,
                self._extract("one_minus_alphas_cumprod", t, n),
                self._extract("log_one_minus_alphas_cumprod", t, n))

    def _predict_xstart_from_eps(self, x_t, t, eps):
        n = x_t.dim()
        return (self._extract("sqrt_recip_alphas_cumprod", t, n) * x_t
                - self._extract("sqrt_recipm1_alphas_cumprod", t, n) * eps)

    def _predict_xstart_from_v(self, x_t, t, v):
        """x0 = alpha x_t - sigma v, with x_t-shaped coefficients (the JAX
        module's repair of the reference's t.shape broadcast,
        gaussian_diffusion.py:394-399)."""
        n = x_t.dim()
        return (self._extract("sqrt_alphas_cumprod", t, n) * x_t
                - self._extract("sqrt_one_minus_alphas_cumprod", t, n) * v)

    def _predict_xstart_from_xprev(self, x_t, t, xprev):
        n = x_t.dim()
        return (self._extract("recip_posterior_mean_coef1", t, n) * xprev
                - self._extract("posterior_coef2_over_coef1", t, n) * x_t)

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        n = x_t.dim()
        return ((self._extract("sqrt_recip_alphas_cumprod", t, n) * x_t - pred_xstart)
                / self._extract("sqrt_recipm1_alphas_cumprod", t, n))

    def p_mean_variance(self, model_fn, x, t, clip_denoised: bool = True,
                        denoised_fn=None, model_kwargs: Optional[Dict] = None
                        ) -> Dict[str, torch.Tensor]:
        """The model's mean, variance, log variance and x_0 prediction
        (reference: tools/gaussian_diffusion.py:278-384). A learned variance
        takes the second half of the last (channel) axis: its log variance
        (LEARNED) or, in [-1, 1], the fraction between the posterior's and
        beta_t's log variance (LEARNED_RANGE)."""
        c, n = x.shape[-1], x.dim()
        model_output, _ = unpack_model_output(
            model_fn(x, self._model_t(t), **(model_kwargs or {})))
        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            if model_output.shape != (*x.shape[:-1], 2 * c):
                raise ValueError(f"a learned variance needs {2 * c} output channels, "
                                 f"got {tuple(model_output.shape)}")
            model_output, model_var_values = model_output.split(c, dim=-1)
            if self.model_var_type == ModelVarType.LEARNED:
                model_log_variance = model_var_values
            else:
                min_log = self._extract("posterior_log_variance_clipped", t, n)
                max_log = self._extract("log_betas", t, n)
                frac = (model_var_values + 1) / 2
                model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        else:
            var, log_var = {
                ModelVarType.FIXED_LARGE: ("fixed_large_variance",
                                           "log_fixed_large_variance"),
                ModelVarType.FIXED_SMALL: ("posterior_variance",
                                           "posterior_log_variance_clipped"),
            }[self.model_var_type]
            model_variance = self._extract(var, t, n)
            model_log_variance = self._extract(log_var, t, n)

        def process_xstart(x0):
            if denoised_fn is not None:
                x0 = denoised_fn(x0)
            return torch.clamp(x0, -1.0, 1.0) if clip_denoised else x0

        mt = self.model_mean_type
        if mt == ModelMeanType.PREVIOUS_X:
            pred_xstart = process_xstart(
                self._predict_xstart_from_xprev(x, t, model_output))
            model_mean = model_output
        elif mt in (ModelMeanType.START_X, ModelMeanType.EPSILON,
                    ModelMeanType.VELOCITY):
            if mt == ModelMeanType.START_X:
                pred_xstart = process_xstart(model_output)
            elif mt == ModelMeanType.EPSILON:
                pred_xstart = process_xstart(
                    self._predict_xstart_from_eps(x, t, model_output))
            else:
                pred_xstart = process_xstart(
                    self._predict_xstart_from_v(x, t, model_output))
            model_mean = self.q_posterior_mean_variance(pred_xstart, x, t)[0]
        else:
            raise NotImplementedError(mt)
        return {"mean": model_mean, "variance": model_variance,
                "log_variance": model_log_variance, "pred_xstart": pred_xstart}

    def _vb_terms_bpd(self, model_fn, x_start, x_t, t, clip_denoised=True,
                      model_kwargs=None) -> Dict[str, torch.Tensor]:
        """The variational-bound term in bits: the posterior KL, or the
        decoder NLL at t = 0 (reference: tools/gaussian_diffusion.py:775-808)."""
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model_fn, x_t, t, clip_denoised=clip_denoised,
                                   model_kwargs=model_kwargs)
        kl = mean_flat(normal_kl(true_mean, true_log_var, out["mean"],
                                 out["log_variance"])) / _LOG2
        decoder_nll = mean_flat(-discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])) / _LOG2
        return {"output": torch.where(t == 0, decoder_nll, kl),
                "pred_xstart": out["pred_xstart"]}

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

    def training_losses(self, model_fn, x_start, t, noise, features=None,
                        model_kwargs=None) -> Dict[str, torch.Tensor]:
        """Weighted training loss for one batch, per-sample [N] terms
        (reference: tools/gaussian_diffusion.py:834-930;
        vaw_tpu/core/diffusion.py:437-513). KL and RESCALED_KL return the
        variational bound alone; MSE and RESCALED_MSE with a learned
        variance add its vb term, which sees the mean half of the output
        detached, so that only the variance channels learn from it. Under
        learn_align the model's projector output (the second element of its
        output) is aligned with the teacher's `features`: "align" is
        reported, and added to the loss times gamma unless a vb term is
        present, where the reference reports it and adds nothing
        (gaussian_diffusion.py:921-926)."""
        model_kwargs = model_kwargs or {}
        x_t = self.q_sample(x_start, t, noise)
        if self.loss_type in (LossType.KL, LossType.RESCALED_KL):
            loss = self._vb_terms_bpd(model_fn, x_start, x_t, t, clip_denoised=False,
                                      model_kwargs=model_kwargs)["output"]
            if self.loss_type == LossType.RESCALED_KL:
                loss = loss * self.num_timesteps
            return {"loss": loss}
        if self.loss_type not in (LossType.MSE, LossType.RESCALED_MSE):
            raise NotImplementedError(self.loss_type)
        alpha = self._table("sqrt_alphas_cumprod", t.device)[t]
        sigma = self._table("sqrt_one_minus_alphas_cumprod", t.device)[t]
        weight = compute_mse_loss_weight(self.model_mean_type, self.weight_type,
                                         t, alpha, sigma, self.p2_k, self.p2_gamma)
        model_output, sec_out = unpack_model_output(
            model_fn(x_t, self._model_t(t), **model_kwargs))
        terms: Dict[str, torch.Tensor] = {}
        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            c = x_t.shape[-1]
            if model_output.shape != (*x_t.shape[:-1], 2 * c):
                raise ValueError(f"a learned variance needs {2 * c} output channels, "
                                 f"got {tuple(model_output.shape)}")
            model_output, model_var_values = model_output.split(c, dim=-1)
            frozen_out = torch.cat([model_output.detach(), model_var_values], dim=-1)
            terms["vb"] = self._vb_terms_bpd(lambda *_a, **_k: frozen_out, x_start,
                                             x_t, t, clip_denoised=False)["output"]
            if self.loss_type == LossType.RESCALED_MSE:
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)
        target = self.compute_target(x_start, noise, t, x_t=x_t)
        if not model_output.shape == target.shape == x_start.shape:
            raise ValueError(f"model output {tuple(model_output.shape)} does not "
                             f"match the target {tuple(target.shape)}")
        terms["mse"] = weight * mean_flat((target - model_output.float()) ** 2)
        if self.learn_align:
            _check_gamma(self.gamma)
            terms["align"] = compute_align_loss(features, sec_out, self.align_type)
        if "vb" in terms:
            terms["loss"] = terms["mse"] + terms["vb"]
        elif self.learn_align:
            terms["loss"] = terms["mse"] + self.gamma * terms["align"]
        else:
            terms["loss"] = terms["mse"]
        return terms

    def _prior_bpd(self, x_start):
        """The prior KL in bits per dim (reference:
        tools/gaussian_diffusion.py:932-948)."""
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1,
                       dtype=torch.int64, device=x_start.device)
        qt_mean, _, qt_log_variance = self.q_mean_variance(x_start, t)
        return mean_flat(normal_kl(qt_mean, qt_log_variance, 0.0, 0.0)) / _LOG2

    @torch.no_grad()
    def calc_bpd_loop(self, model_fn, generator: Optional[torch.Generator],
                      x_start, clip_denoised: bool = True, model_kwargs=None,
                      noise_fn: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
        """The whole variational bound in bits per dim over every t
        (reference: tools/gaussian_diffusion.py:950-1005): [N, T] terms with
        the time axis ordered t = T-1 .. 0. Each t's noise is
        ``noise_fn(t, shape)`` when given, else a normal draw from
        `generator` on x_start's device."""
        n = x_start.shape[0]
        if noise_fn is None:
            def noise_fn(i, shape):
                return torch.randn(shape, generator=generator, device=x_start.device)
        vb, xstart_mse, mse = [], [], []
        for i in range(self.num_timesteps - 1, -1, -1):
            t = torch.full((n,), i, dtype=torch.int64, device=x_start.device)
            noise = noise_fn(i, x_start.shape)
            x_t = self.q_sample(x_start, t, noise)
            out = self._vb_terms_bpd(model_fn, x_start, x_t, t, clip_denoised,
                                     model_kwargs)
            eps = self._predict_eps_from_xstart(x_t, t, out["pred_xstart"])
            vb.append(out["output"])
            xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
            mse.append(mean_flat((eps - noise) ** 2))
        vb, xstart_mse, mse = (torch.stack(v, dim=1) for v in (vb, xstart_mse, mse))
        prior_bpd = self._prior_bpd(x_start)
        return {"total_bpd": vb.sum(dim=1) + prior_bpd, "prior_bpd": prior_bpd,
                "vb": vb, "xstart_mse": xstart_mse, "mse": mse}
