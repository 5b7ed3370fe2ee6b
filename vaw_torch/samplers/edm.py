"""EDM preconditioning + the ablation sampler in PyTorch (counterpart of
vaw_tpu/samplers/edm.py; reference: tools/cfg_edm.py).

* ``build_edm_plan`` is the JAX package's host-side float64 plan, copied as
  it is: the iDDPM sigma ladder, the ``round_sigma`` lookup and every
  per-step scalar of the sampler (t_steps, churn, c_in/c_noise/c_skip/c_out
  and the ODE coefficients) are computed once in f64 numpy.
* ``ablation_sampler`` is a Python loop over the plan. The per-step scalars
  are the plan's f64 values rounded to f32, as the JAX sampler casts its
  columns (vaw_tpu/samplers/edm.py:290-302), and only the model evaluations
  and f32 updates run on the device. The last step is Euler-only
  (reference: tools/cfg_edm.py:202), so Heun costs 2*num_steps - 1 model
  evaluations.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core.schedules import edm_sigma_ladder

__all__ = ["EDMPlan", "build_edm_plan", "ablation_sampler", "round_sigma_index"]


def round_sigma_index(u: np.ndarray, sigma) -> np.ndarray:
    """Nearest-ladder-index lookup (reference: tools/cfg_edm.py:102-106),
    host-side."""
    sigma = np.atleast_1d(np.asarray(sigma, np.float64))
    return np.abs(sigma[:, None] - u[None, :]).argmin(axis=1)


def _round_sigma(u, sigma):
    return u[round_sigma_index(u, sigma)]


@dataclasses.dataclass(frozen=True)
class EDMPlan:
    """Per-step constants of the sampler, all host f64 numpy."""

    # churn + step geometry
    ratio: np.ndarray          # s(t_hat)/s(t_cur)
    noise_scale: np.ndarray    # sqrt(max(sig_hat^2-sig_cur^2,0))*s_hat*S_noise
    h: np.ndarray              # t_next - t_hat
    # first (t_hat) model eval constants
    inv_s_hat: np.ndarray
    c_in_hat: np.ndarray
    c_noise_hat: np.ndarray
    c_skip_hat: np.ndarray
    c_out_hat: np.ndarray
    d_a_hat: np.ndarray        # sigma'/sigma + s'/s     at t_hat
    d_b_hat: np.ndarray        # sigma' * s / sigma      at t_hat
    # second (t_prime) model eval constants (Heun)
    inv_s_prime: np.ndarray
    c_in_prime: np.ndarray
    c_noise_prime: np.ndarray
    c_skip_prime: np.ndarray
    c_out_prime: np.ndarray
    d_a_prime: np.ndarray
    d_b_prime: np.ndarray
    # init
    x0_scale: float            # sigma(t_0) * s(t_0)
    alpha: float
    num_steps: int
    solver: str
    pred_type: str


def _precond_coeffs(sigma, pred_type):
    """c_in/c_skip/c_out of the iDDPM-style Net wrapper per prediction type
    (reference: tools/cfg_edm.py:50-80)."""
    c_in = 1.0 / np.sqrt(sigma ** 2 + 1.0)
    if pred_type == "EPSILON":
        c_skip = np.ones_like(sigma)
        c_out = -sigma
    elif pred_type == "START_X":
        c_skip = np.zeros_like(sigma)
        c_out = np.ones_like(sigma)
    elif pred_type == "VELOCITY":
        c_skip = c_in ** 2
        c_out = -sigma * c_in
    else:
        raise ValueError(f"Unsupported pred_type: {pred_type}")
    return c_in, c_skip, c_out


def build_edm_plan(
    num_steps: int = 18,
    sigma_min: Optional[float] = None,
    sigma_max: Optional[float] = None,
    rho: float = 7,
    solver: str = "heun",
    discretization: str = "edm",
    schedule: str = "linear",
    scaling: str = "none",
    epsilon_s: float = 1e-3,
    C_1: float = 0.001,
    C_2: float = 0.008,
    M: int = 1000,
    alpha: float = 1.0,
    S_churn: float = 0,
    S_min: float = 0,
    S_max: float = float("inf"),
    S_noise: float = 1,
    noise_schedule: str = "linear",
    pred_type: str = "EPSILON",
) -> EDMPlan:
    """Host-side f64 reconstruction of ablation_sampler's ladder
    (reference: tools/cfg_edm.py:109-208, all four discretizations, three
    schedules, two scalings)."""
    assert solver in ("euler", "heun")
    assert discretization in ("vp", "ve", "iddpm", "edm")
    assert schedule in ("vp", "ve", "linear")
    assert scaling in ("vp", "none")

    u = edm_sigma_ladder(noise_schedule, M=M, C_1=C_1, C_2=C_2)
    net_sigma_min = float(u[M - 1])
    net_sigma_max = float(u[0])

    def vp_sigma(beta_d, beta_min):
        return lambda t: np.sqrt(np.exp(0.5 * beta_d * t ** 2 + beta_min * t) - 1)

    def vp_sigma_deriv(beta_d, beta_min, sig):
        return lambda t: 0.5 * (beta_min + beta_d * t) * (sig(t) + 1 / sig(t))

    def vp_sigma_inv(beta_d, beta_min):
        return lambda s: (
            np.sqrt(beta_min ** 2 + 2 * beta_d * np.log(s ** 2 + 1)) - beta_min
        ) / beta_d

    if sigma_min is None:
        vp_def = vp_sigma(19.9, 0.1)(epsilon_s)
        sigma_min = {"vp": vp_def, "ve": 0.02, "iddpm": 0.002, "edm": 0.002}[
            discretization]
    if sigma_max is None:
        vp_def = vp_sigma(19.9, 0.1)(1.0)
        sigma_max = {"vp": vp_def, "ve": 100, "iddpm": 81, "edm": 80}[
            discretization]
    sigma_min = max(sigma_min, net_sigma_min)
    sigma_max = min(sigma_max, net_sigma_max)

    vp_beta_d = (
        2 * (np.log(sigma_min ** 2 + 1) / epsilon_s
             - np.log(sigma_max ** 2 + 1)) / (epsilon_s - 1)
    )
    vp_beta_min = np.log(sigma_max ** 2 + 1) - 0.5 * vp_beta_d

    idx = np.arange(num_steps, dtype=np.float64)
    if discretization == "vp":
        orig_t = 1 + idx / (num_steps - 1) * (epsilon_s - 1)
        sigma_steps = vp_sigma(vp_beta_d, vp_beta_min)(orig_t)
    elif discretization == "ve":
        orig_t = sigma_max ** 2 * (
            (sigma_min ** 2 / sigma_max ** 2) ** (idx / (num_steps - 1))
        )
        sigma_steps = np.sqrt(orig_t)
    elif discretization == "iddpm":
        # The reference rebuilds this ladder with the COSINE alpha_bar
        # regardless of the Net's noise_schedule (tools/cfg_edm.py:150-155);
        # only round_sigma/c_noise use the schedule-dependent `u`.
        u_iddpm = edm_sigma_ladder("cosine", M=M, C_1=C_1, C_2=C_2)
        u_filtered = u_iddpm[(u_iddpm >= sigma_min) & (u_iddpm <= sigma_max)]
        pick = np.rint(
            (len(u_filtered) - 1) / (num_steps - 1) * idx
        ).astype(np.int64)
        sigma_steps = u_filtered[pick]
    else:  # edm
        sigma_steps = (
            sigma_max ** (1 / rho)
            + idx / (num_steps - 1)
            * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))
        ) ** rho

    if schedule == "vp":
        sigma = vp_sigma(vp_beta_d, vp_beta_min)
        sigma_deriv = vp_sigma_deriv(vp_beta_d, vp_beta_min, sigma)
        sigma_inv = vp_sigma_inv(vp_beta_d, vp_beta_min)
    elif schedule == "ve":
        sigma = lambda t: np.sqrt(t)
        sigma_deriv = lambda t: 0.5 / np.sqrt(t)
        sigma_inv = lambda s: s ** 2
    else:  # linear
        sigma = lambda t: np.asarray(t, np.float64)
        sigma_deriv = lambda t: np.ones_like(np.asarray(t, np.float64))
        sigma_inv = lambda s: np.asarray(s, np.float64)

    if scaling == "vp":
        s_fn = lambda t: 1 / np.sqrt(1 + sigma(t) ** 2)
        s_deriv = lambda t: -sigma(t) * sigma_deriv(t) * s_fn(t) ** 3
    else:
        s_fn = lambda t: np.ones_like(np.asarray(t, np.float64))
        s_deriv = lambda t: np.zeros_like(np.asarray(t, np.float64))

    t_steps = sigma_inv(_round_sigma(u, sigma_steps))
    t_steps = np.concatenate([t_steps, [0.0]])

    # Per-step churn + Euler/Heun constants (reference loop cfg_edm.py:188-208).
    def consts_at(t):
        sig = float(sigma(t))
        sv = float(s_fn(t))
        c_in, c_skip, c_out = _precond_coeffs(np.float64(sig), pred_type)
        c_noise = float(M - 1 - round_sigma_index(u, sig)[0])
        d_a = float(sigma_deriv(t)) / sig + float(s_deriv(t)) / sv
        d_b = float(sigma_deriv(t)) * sv / sig
        return sig, sv, float(c_in), c_noise, float(c_skip), float(c_out), d_a, d_b

    rows = {k: [] for k in (
        "ratio", "noise_scale", "h",
        "inv_s_hat", "c_in_hat", "c_noise_hat", "c_skip_hat", "c_out_hat",
        "d_a_hat", "d_b_hat",
        "inv_s_prime", "c_in_prime", "c_noise_prime", "c_skip_prime",
        "c_out_prime", "d_a_prime", "d_b_prime",
    )}
    for i in range(num_steps):
        t_cur, t_next = t_steps[i], t_steps[i + 1]
        sig_cur = float(sigma(t_cur))
        gamma = (
            min(S_churn / num_steps, np.sqrt(2) - 1)
            if S_min <= sig_cur <= S_max else 0.0
        )
        t_hat = float(sigma_inv(_round_sigma(u, sig_cur + gamma * sig_cur)[0]))
        sig_hat, s_hat, c_in_h, c_noise_h, c_skip_h, c_out_h, d_a_h, d_b_h = (
            consts_at(t_hat)
        )
        h = t_next - t_hat
        t_prime = t_hat + alpha * h
        if t_prime > 0:
            (sig_p, s_p, c_in_p, c_noise_p, c_skip_p, c_out_p,
             d_a_p, d_b_p) = consts_at(t_prime)
        else:
            # Last step is Euler-only; fill dummies (never used).
            sig_p = s_p = 1.0
            c_in_p = c_noise_p = c_skip_p = c_out_p = d_a_p = d_b_p = 0.0
        rows["ratio"].append(s_hat / float(s_fn(t_cur)))
        rows["noise_scale"].append(
            np.sqrt(max(sig_hat ** 2 - sig_cur ** 2, 0.0)) * s_hat * S_noise
        )
        rows["h"].append(h)
        rows["inv_s_hat"].append(1.0 / s_hat)
        rows["c_in_hat"].append(c_in_h)
        rows["c_noise_hat"].append(c_noise_h)
        rows["c_skip_hat"].append(c_skip_h)
        rows["c_out_hat"].append(c_out_h)
        rows["d_a_hat"].append(d_a_h)
        rows["d_b_hat"].append(d_b_h)
        rows["inv_s_prime"].append(1.0 / s_p)
        rows["c_in_prime"].append(c_in_p)
        rows["c_noise_prime"].append(c_noise_p)
        rows["c_skip_prime"].append(c_skip_p)
        rows["c_out_prime"].append(c_out_p)
        rows["d_a_prime"].append(d_a_p)
        rows["d_b_prime"].append(d_b_p)

    arrays = {k: np.asarray(v, np.float64) for k, v in rows.items()}
    return EDMPlan(
        **arrays,
        x0_scale=float(sigma(t_steps[0]) * s_fn(t_steps[0])),
        alpha=alpha, num_steps=num_steps, solver=solver, pred_type=pred_type,
    )



def _f32(x) -> float:
    """A Python float holding the f32 rounding of x: multiplying an f32
    tensor by it is the f32 product the JAX sampler computes."""
    return float(np.float32(x))


_PLAN_ROWS = ("ratio", "noise_scale", "h",
              "inv_s_hat", "c_in_hat", "c_noise_hat", "c_skip_hat", "c_out_hat",
              "d_a_hat", "d_b_hat",
              "inv_s_prime", "c_in_prime", "c_noise_prime", "c_skip_prime",
              "c_out_prime", "d_a_prime", "d_b_prime")


@torch.inference_mode()
def ablation_sampler(
    model_fn: Callable,
    generator: Optional[torch.Generator],
    latents: torch.Tensor,
    plan: EDMPlan,
    class_labels: Optional[torch.Tensor] = None,
    guidance_scales=None,
    img_channels: Optional[int] = None,
) -> torch.Tensor:
    """Run the EDM sampler from NHWC `latents` and return f32 samples.

    model_fn(x, t, y=..., g=...) -> denoiser raw output (an IntervalCFG
    wrapper or a bare model closure); only the first `img_channels` output
    channels are used (reference: tools/cfg_edm.py:67, 75).
    guidance_scales: optional [num_steps] per-step CFG scale
    (host-precomputed; see samplers.guidance.cfg_scale_for_time).
    Churn noise (only where the plan's noise_scale is non-zero) is drawn
    from `generator` on the latents' device.
    """
    c = img_channels if img_channels is not None else latents.shape[-1]
    cols = {k: [_f32(v) for v in getattr(plan, k)] for k in _PLAN_ROWS}
    if guidance_scales is None:
        guidance_scales = np.ones(plan.num_steps)
    cols["g"] = [_f32(v) for v in guidance_scales]
    batch = latents.shape[0]
    heun = plan.solver == "heun"
    alpha = np.float32(plan.alpha)
    w_cur = _f32(1 - 1 / (2 * plan.alpha))
    w_prime = _f32(1 / (2 * plan.alpha))

    def denoise(x_scaled, c_in, c_noise, c_skip, c_out, g):
        t_vec = torch.full((batch,), c_noise, dtype=torch.float32,
                           device=x_scaled.device)
        raw = model_fn(c_in * x_scaled, t_vec, y=class_labels, g=g)
        raw = raw[0] if isinstance(raw, tuple) else raw  # (out, zs) models
        return c_skip * x_scaled + c_out * raw[..., :c].float()

    x = latents.float() * _f32(plan.x0_scale)
    for i in range(plan.num_steps):
        col = {k: v[i] for k, v in cols.items()}
        x_hat = col["ratio"] * x
        if col["noise_scale"] != 0.0:
            eps = torch.randn(x.shape, generator=generator, dtype=torch.float32,
                              device=x.device)
            x_hat = x_hat + col["noise_scale"] * eps
        den = denoise(x_hat * col["inv_s_hat"], col["c_in_hat"],
                      col["c_noise_hat"], col["c_skip_hat"], col["c_out_hat"],
                      col["g"])
        d_cur = col["d_a_hat"] * x_hat - col["d_b_hat"] * den
        # The last step is Euler regardless (reference: tools/cfg_edm.py:202).
        if not heun or i == plan.num_steps - 1:
            x = x_hat + col["h"] * d_cur
            continue
        x_prime = x_hat + float(alpha * np.float32(col["h"])) * d_cur
        den_p = denoise(x_prime * col["inv_s_prime"], col["c_in_prime"],
                        col["c_noise_prime"], col["c_skip_prime"],
                        col["c_out_prime"], col["g"])
        d_prime = col["d_a_prime"] * x_prime - col["d_b_prime"] * den_p
        x = x_hat + col["h"] * (w_cur * d_cur + w_prime * d_prime)
    return x
