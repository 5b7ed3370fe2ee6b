"""Continuous-time flow matching, stochastic interpolants (counterpart of
vaw_tpu/core/flow.py; reference: tools/gaussian_diffusion.py:1151-1419):
the interpolants, the conversions of a model output to the vector field and
to the score, t-sampling, targets, the weighted training loss, and the ODE
(Euler, Heun, adaptive Dormand-Prince) and SDE (Euler, Heun) samplers.

The JAX module runs its samplers as ``lax.scan`` and ``lax.while_loop``;
here they are eager loops. The fixed-step grids are planned on the host in
f32 (no device read a step). ``_dopri5`` keeps the JAX loop's f32 step-size
arithmetic on the device and reads one value back a step: whether the step
was accepted, with the time after it. Randomness is explicit: ``sample_t``
draws from a ``torch.Generator``, and ``sde_sample`` draws each step's noise
from one, or takes it from ``noise_fn(i, shape)`` (tests pass the JAX
sampler's own draws there). Under ``learn_align`` the loss adds gamma times
the REPA align loss (``core.losses.compute_align_loss``).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .diffusion import _check_gamma, unpack_model_output
from .losses import compute_align_loss, mean_flat
from .types import ModelMeanType
from .weighting import compute_mse_loss_weight

__all__ = ["FlowMatching", "interpolant"]


def interpolant(path_type: str, t: torch.Tensor):
    """(alpha_t, sigma_t, d_alpha_t, d_sigma_t) with t = 0 data, t = 1
    noise (reference: tools/gaussian_diffusion.py:1182-1203)."""
    if path_type == "linear":
        return 1 - t, t, torch.full_like(t, -1.0), torch.full_like(t, 1.0)
    if path_type == "cosine":
        half_pi = math.pi / 2
        return (torch.cos(t * half_pi), torch.sin(t * half_pi),
                -half_pi * torch.sin(t * half_pi), half_pi * torch.cos(t * half_pi))
    if path_type == "linear_logsnr":
        lam = 10.0 + t * (-10.0 - 10.0)
        alpha_t = torch.sigmoid(0.5 * lam)
        sigma_t = torch.sigmoid(-0.5 * lam)
        d_alpha_t = -10.0 * alpha_t * sigma_t
        return alpha_t, sigma_t, d_alpha_t, -d_alpha_t
    raise NotImplementedError(f"unknown path type: {path_type}")


def _expand_t(t, x: torch.Tensor) -> torch.Tensor:
    """A [N] (or scalar) time broadcast onto x's rank, in x's dtype
    (reference: tools/gaussian_diffusion.py:1173-1177)."""
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    if t.dim() == 0:
        t = t.expand(x.shape[0])
    return t.reshape(t.shape[0], *([1] * (x.dim() - 1)))


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """jnp.linspace(start, stop, num) in f32 by its own formula,
    start * (1 - s) + stop * s with s = i / (num - 1), and stop last."""
    f32 = np.float32
    step = np.arange(num - 1, dtype=f32) / f32(num - 1)
    out = f32(start) * (f32(1) - step) + f32(stop) * step
    return np.concatenate([out, [f32(stop)]]).astype(f32)


# Dormand-Prince 5(4) tableau (vaw_tpu/core/flow.py:265-279). The JAX loop
# multiplies f32 scalars by c, b5 and b4 as f32 arrays; they are kept here
# as the Python floats of those f32 values.
def _f32(values):
    return [float(np.float32(v)) for v in values]


_DP_C = _f32((0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0))
_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DP_B5 = _f32((35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0))
_DP_B4 = _f32((5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
               187 / 2100, 1 / 40))


@dataclasses.dataclass(frozen=True)
class FlowMatching:
    """Trainer + sampler for stochastic-interpolant flow models
    (vaw_tpu/core/flow.py:66-400)."""

    model_mean_type: ModelMeanType = ModelMeanType.VECTOR
    path_type: str = "linear"
    sampler_type: str = "sde"
    weight_type: str = "constant"
    p2_k: float = 1.0
    p2_gamma: float = 1.0
    gamma: float = 0.0
    learn_align: bool = False
    align_type: str = "mse"
    time_dist: tuple = ("uniform",)

    # conversions ------------------------------------------------------ #

    def convert_model_output_to_vector(self, model_output, x_t, t):
        """The model's prediction as the flow vector field
        (reference: tools/gaussian_diffusion.py:1205-1228)."""
        alpha_t, sigma_t, d_alpha_t, d_sigma_t = interpolant(self.path_type, t)
        mt = self.model_mean_type
        if mt == ModelMeanType.START_X:
            start_x = model_output
            noise = (x_t - alpha_t * start_x) / sigma_t
        elif mt == ModelMeanType.EPSILON:
            noise = model_output
            start_x = (x_t - sigma_t * noise) / alpha_t
        elif mt == ModelMeanType.VELOCITY:
            denom = alpha_t ** 2 + sigma_t ** 2
            start_x = (alpha_t * x_t - sigma_t * model_output) / denom
            noise = (sigma_t * x_t + alpha_t * model_output) / denom
        elif mt == ModelMeanType.VECTOR:
            return model_output
        else:
            raise NotImplementedError("Unsupported model_mean_type for vector")
        return d_alpha_t * start_x + d_sigma_t * noise

    def convert_model_output_to_score(self, model_output, x_t, t):
        """The model's prediction as the score
        (reference: tools/gaussian_diffusion.py:1230-1257)."""
        alpha_t, sigma_t, d_alpha_t, d_sigma_t = interpolant(self.path_type, t)
        mt = self.model_mean_type
        if mt == ModelMeanType.START_X:
            return -(x_t - alpha_t * model_output) / (sigma_t ** 2)
        if mt == ModelMeanType.EPSILON:
            return -model_output / sigma_t
        if mt == ModelMeanType.VELOCITY:
            denom = alpha_t ** 2 + sigma_t ** 2
            noise = (sigma_t * x_t + alpha_t * model_output) / denom
            return -noise / sigma_t
        if mt == ModelMeanType.VECTOR:
            noise = (d_alpha_t * x_t - alpha_t * model_output) / (
                sigma_t * d_alpha_t - alpha_t * d_sigma_t)
            return -noise / sigma_t
        if mt == ModelMeanType.SCORE:
            return model_output
        raise NotImplementedError("Unsupported model_mean_type for score")

    # training --------------------------------------------------------- #

    def sample_t(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """Uniform or logit-normal t on the generator's device
        (reference: tools/gaussian_diffusion.py:1259-1270)."""
        kind = self.time_dist[0]
        device = generator.device
        if kind == "uniform":
            return torch.rand(batch_size, generator=generator, device=device)
        if kind == "lognorm":
            mu, sigma = float(self.time_dist[-2]), float(self.time_dist[-1])
            z = torch.randn(batch_size, generator=generator, device=device)
            return torch.sigmoid(z * sigma + mu)
        raise NotImplementedError(f"Unknown time_dist: {self.time_dist}")

    def q_sample(self, x_start, noise, t):
        """x_t = alpha_t x_0 + sigma_t eps
        (reference: tools/gaussian_diffusion.py:1272-1276)."""
        alpha_t, sigma_t, _, _ = interpolant(self.path_type, _expand_t(t, x_start))
        return alpha_t * x_start + sigma_t * noise

    def compute_target(self, x_start, noise, t):
        """Regression target per mean type
        (reference: tools/gaussian_diffusion.py:1279-1294)."""
        alpha, sigma, d_alpha, d_sigma = interpolant(self.path_type,
                                                     _expand_t(t, x_start))
        mt = self.model_mean_type
        if mt == ModelMeanType.START_X:
            return x_start
        if mt == ModelMeanType.EPSILON:
            return noise
        if mt == ModelMeanType.VELOCITY:
            return alpha * noise - sigma * x_start
        if mt == ModelMeanType.VECTOR:
            return d_alpha * x_start + d_sigma * noise
        if mt == ModelMeanType.SCORE:
            return -noise / sigma
        raise NotImplementedError(mt)

    def training_losses(self, model_fn, x_start, t, noise, features=None,
                        model_kwargs=None) -> Dict[str, torch.Tensor]:
        """Weighted flow-matching loss, per-sample [N] terms
        (reference: tools/gaussian_diffusion.py:1297-1340); under
        learn_align plus gamma times the REPA align loss between the
        teacher's `features` and the model's projector output
        (vaw_tpu/core/flow.py:186-189)."""
        alpha_t, sigma_t, _, _ = interpolant(self.path_type, t)
        x_t = self.q_sample(x_start, noise, t)
        weight = compute_mse_loss_weight(self.model_mean_type, self.weight_type, t,
                                         alpha_t, sigma_t, self.p2_k, self.p2_gamma)
        target = self.compute_target(x_start, noise, t)
        model_output, sec_out = unpack_model_output(
            model_fn(x_t, t, **(model_kwargs or {})))
        if not model_output.shape == target.shape == x_start.shape:
            raise ValueError(f"model output {tuple(model_output.shape)} does not "
                             f"match the target {tuple(target.shape)}")
        mse = weight * mean_flat((target - model_output.float()) ** 2)
        if not self.learn_align:
            return {"mse": mse, "loss": mse}
        _check_gamma(self.gamma)
        align = compute_align_loss(features, sec_out, self.align_type)
        return {"mse": mse, "align": align, "loss": mse + self.gamma * align}

    # sampling --------------------------------------------------------- #

    def _model_output(self, model_fn, x, t_scalar, model_kwargs):
        """The model's prediction with one time (a float or a 0-d tensor)
        for the whole batch."""
        t_vec = torch.as_tensor(t_scalar, dtype=x.dtype, device=x.device)
        out, _ = unpack_model_output(model_fn(x, t_vec.expand(x.shape[0]),
                                              **model_kwargs))
        return out

    def _drift(self, model_fn, x, t_scalar, model_kwargs):
        out = self._model_output(model_fn, x, t_scalar, model_kwargs)
        return self.convert_model_output_to_vector(out, x, _expand_t(t_scalar, x))

    def compute_diffusion(self, te):
        """SDE diffusion coefficient g(t)^2 = 2 sigma_t d_sigma_t
        (reference: tools/gaussian_diffusion.py:1366-1368)."""
        _, sigma_t, _, d_sigma_t = interpolant(self.path_type, te)
        return 2 * sigma_t * d_sigma_t

    def _check_sampleable(self, ode: bool):
        """Refuse the mean types whose conversions divide by zero at a path
        endpoint the sampler evaluates (vaw_tpu/core/flow.py:186-204): the
        reference returns all-NaN batches there."""
        mt = self.model_mean_type
        if mt == ModelMeanType.EPSILON:
            raise ValueError(
                "flow sampling with mean_type EPSILON is singular at t=1 "
                "(alpha_t=0 -> NaN on the first drift eval; the reference "
                "NaNs identically). Train/sample flow models with "
                "--mean_type VECTOR (or VELOCITY/START_X for SDE).")
        if ode and mt == ModelMeanType.START_X:
            raise ValueError(
                "flow ODE sampling with mean_type START_X is singular at "
                "t=0 (sigma_t=0 on the final drift eval). Use the SDE "
                "sampler (its last eval is at t=0.04) or VECTOR/VELOCITY.")

    def ode_sample(self, model_fn, noise, num_steps=50, solver="heun",
                   model_kwargs=None, rtol=1e-3, atol=1e-6, max_steps=512,
                   info: Optional[dict] = None):
        """Probability-flow ODE from t = 1 to t = 0: fixed-step Euler or
        Heun on linspace(1, 0, num_steps), or adaptive "dopri5" at explicit
        rtol/atol (the reference's ode_sample reads undefined
        self.rtol/self.atol, gaussian_diffusion.py:1362). `info`, when given,
        receives dopri5's accepted and rejected steps and final t."""
        model_kwargs = model_kwargs or {}
        self._check_sampleable(ode=True)
        if solver == "dopri5":
            return self._dopri5(model_fn, noise, model_kwargs, rtol, atol,
                                max_steps, info)
        if solver not in ("euler", "heun"):
            raise ValueError(f"Unknown solver: {solver}")
        ts = _linspace_f32(1.0, 0.0, num_steps)
        x = noise
        for t_cur, t_next in zip(ts[:-1], ts[1:]):
            h = float(t_next - t_cur)
            d_cur = self._drift(model_fn, x, t_cur, model_kwargs)
            if solver == "euler":
                x = x + h * d_cur
                continue
            x_pred = x + h * d_cur
            d_next = self._drift(model_fn, x_pred, t_next, model_kwargs)
            x = x + 0.5 * h * (d_cur + d_next)
        return x

    def _dopri5(self, model_fn, noise, model_kwargs, rtol, atol,
                max_steps: int = 512, info: Optional[dict] = None):
        """Adaptive Dormand-Prince 5(4) with FSAL and a PI step-size
        controller, integrating t: 1 -> 0 (vaw_tpu/core/flow.py:260-337):
        h starts at 0.05, is floored at 1e-5 and capped at t; at most
        `max_steps` attempts, with a warning when t has not reached 0. t and
        h are f32 device scalars, as in the JAX loop; each attempt reads
        back its accept flag and t."""
        dev = noise.device

        def scalar(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        def f(x, t):
            return self._drift(model_fn, x, t, model_kwargs)

        t, h = scalar(1.0), scalar(0.05)
        x = noise
        k1 = f(x, t)
        accepted = rejected = 0
        t_host = 1.0
        while t_host > 1e-6 and accepted + rejected < max_steps:
            h = torch.minimum(torch.clamp(h, min=1e-5), t)
            dt = -h
            ks = [k1]
            for i in range(1, 7):
                xi = x
                for j, aij in enumerate(_DP_A[i]):
                    xi = xi + dt * aij * ks[j]
                ks.append(f(xi, t + dt * _DP_C[i]))
            x5, x4 = x, x
            for i in range(7):
                x5 = x5 + dt * _DP_B5[i] * ks[i]
                x4 = x4 + dt * _DP_B4[i] * ks[i]
            scale = atol + rtol * torch.maximum(x.abs(), x5.abs())
            err_norm = torch.sqrt(torch.mean(((x5 - x4) / scale) ** 2))
            accept = err_norm <= 1.0
            factor = torch.clamp(
                0.9 * (1.0 / torch.clamp(err_norm, min=1e-10)) ** 0.2, 0.2, 5.0)
            t_new = torch.where(accept, t - h, t)
            flag, t_host = torch.stack([accept.float(), t_new]).tolist()
            if flag:
                x, t, k1 = x5, t_new, ks[6]
                accepted += 1
            else:
                rejected += 1
            h = h * factor
        if info is not None:
            info.update(accepted=accepted, rejected=rejected, t=t_host)
        if t_host > 1e-6:
            warnings.warn(
                f"[flow] dopri5 budget exhausted at t={t_host:.4g} after "
                f"{accepted + rejected} steps (max_steps={max_steps}); result is "
                "UNCONVERGED: raise max_steps or loosen rtol/atol",
                RuntimeWarning, stacklevel=3)
        return x

    def sde_sample(self, model_fn, generator: Optional[torch.Generator], noise,
                   num_steps=50, solver="heun", model_kwargs=None,
                   noise_fn: Optional[Callable] = None):
        """Euler or Heun SDE sampler from t = 1 to 0.04, then one drift-only
        step to t = 0 (reference: tools/gaussian_diffusion.py:1371-1409).
        Step i's noise is ``noise_fn(i, shape)`` when given, else a normal
        draw from `generator` on x's device."""
        model_kwargs = model_kwargs or {}
        self._check_sampleable(ode=False)
        if solver not in ("euler", "heun"):
            raise ValueError(f"Unknown solver: {solver}")
        if noise_fn is None:
            def noise_fn(i, shape):
                return torch.randn(shape, generator=generator, dtype=noise.dtype,
                                   device=noise.device)
        ts = np.concatenate([_linspace_f32(1.0, 0.04, num_steps),
                             np.zeros(1, np.float32)])

        def drift_fn(x, t_scalar, diffusion):
            out = self._model_output(model_fn, x, t_scalar, model_kwargs)
            te = _expand_t(t_scalar, x)
            score = self.convert_model_output_to_score(out, x, te)
            vector = self.convert_model_output_to_vector(out, x, te)
            return vector - 0.5 * diffusion * score

        x = noise
        for i in range(num_steps - 1):
            t_cur, t_next = ts[i], ts[i + 1]
            h = float(t_next - t_cur)
            diffusion = self.compute_diffusion(_expand_t(t_cur, x))
            d_cur = drift_fn(x, t_cur, diffusion)
            eps = noise_fn(i, x.shape)
            noise_term = torch.sqrt(diffusion) * eps * math.sqrt(abs(h))
            if solver == "euler":
                x = x + d_cur * h + noise_term
                continue
            x_pred = x + d_cur * h + noise_term
            diffusion_next = self.compute_diffusion(_expand_t(t_next, x))
            d_next = drift_fn(x_pred, t_next, diffusion_next)
            x = x + 0.5 * (d_cur + d_next) * h + noise_term
        t_cur, t_next = ts[-2], ts[-1]
        d_cur = drift_fn(x, t_cur, self.compute_diffusion(_expand_t(t_cur, x)))
        return x + d_cur * float(t_next - t_cur)

    def sample(self, model_fn, generator, noise, num_steps=50, solver="heun",
               model_kwargs=None, rtol=1e-3, atol=1e-6, info=None):
        """Dispatch on sampler_type (reference: tools/gaussian_diffusion.py:
        1412-1419)."""
        if self.sampler_type == "ode":
            return self.ode_sample(model_fn, noise, num_steps, solver, model_kwargs,
                                   rtol=rtol, atol=atol, info=info)
        if self.sampler_type == "sde":
            return self.sde_sample(model_fn, generator, noise, num_steps, solver,
                                   model_kwargs)
        raise NotImplementedError(f"Unsupported sampler_type: {self.sampler_type}")
