"""Noise-schedule coefficient tables, computed host-side in float64.

Plain numpy, copied from vaw_tpu/core/schedules.py so that the port imports
nothing of the JAX package; the tests hold the two bit-equal. The tables
mirror the reference's float64 coefficient tables (reference:
tools/gaussian_diffusion.py:59-123, 167-205), its DDIM respacing
(tools/respace.py:9-87) and the iDDPM sigma ladder used by the EDM sampler
(tools/cfg_edm.py:43-48, 83-100).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "get_named_beta_schedule",
    "betas_for_alpha_bar",
    "Schedule",
    "make_schedule",
    "space_timesteps",
    "respace_schedule",
    "edm_sigma_ladder",
]


def get_named_beta_schedule(
    schedule_name: str,
    num_diffusion_timesteps: int,
    lambda_max: float = 10.0,
    lambda_min: float = -10.0,
) -> np.ndarray:
    """Named beta schedules (reference: tools/gaussian_diffusion.py:59-104).

    - "linear": Ho et al. linear schedule, rescaled so any step count matches
      the 1000-step reference range [1e-4, 0.02].
    - "cosine": Nichol & Dhariwal cosine alpha-bar schedule.
    - "linear_logsnr": linear in log-SNR space; lambda(t) runs from
      lambda_max to lambda_min and alpha_bar(t) = sigmoid(lambda(t)).
    """
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        if scale * 0.02 >= 1.0:
            # T <= 20: the rescaled Ho schedule reaches beta = 1, so
            # alpha_bar hits 0 and the eps<->x0 conversion tables contain
            # inf -> NaN samples. The reference degenerates identically
            # (gaussian_diffusion.py:76-79); warn loudly instead of
            # returning silent garbage.
            import warnings

            warnings.warn(
                f"linear schedule with T={num_diffusion_timesteps} reaches "
                "beta=1 (alpha_bar=0): eps-prediction conversions will be "
                "non-finite. Use T>20 or the cosine schedule.",
                RuntimeWarning, stacklevel=2,
            )
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    if schedule_name == "linear_logsnr":

        def alpha_bar(t):
            lam = lambda_max + t * (lambda_min - lambda_max)
            return 1.0 / (1.0 + math.exp(-lam))

        return betas_for_alpha_bar(num_diffusion_timesteps, alpha_bar)
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps, alpha_bar, max_beta=0.999):
    """Discretize a continuous alpha_bar(t in [0,1]) into per-step betas
    (reference: tools/gaussian_diffusion.py:107-123)."""
    t = np.arange(num_diffusion_timesteps, dtype=np.float64)
    ab1 = np.array([alpha_bar(ti / num_diffusion_timesteps) for ti in t])
    ab2 = np.array([alpha_bar((ti + 1) / num_diffusion_timesteps) for ti in t])
    return np.minimum(1.0 - ab2 / ab1, max_beta)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Precomputed f64 coefficient tables for a discrete diffusion process
    (reference: tools/gaussian_diffusion.py:167-205). All fields are numpy;
    device code indexes them after casting to f32.
    """

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    alphas_cumprod_next: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    # FIXED_LARGE variance table: [posterior_variance[1], betas[1:]]
    fixed_large_variance: np.ndarray
    # Mapping from respaced indices to original timesteps (identity when not
    # respaced); used to remap t before the model sees it
    # (reference: tools/respace.py:118-130).
    timestep_map: np.ndarray
    original_num_steps: int

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_schedule(betas: np.ndarray, timestep_map: np.ndarray | None = None,
                  original_num_steps: int | None = None) -> Schedule:
    betas = np.asarray(betas, dtype=np.float64)
    assert betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    # Variance is 0 at t=0; clip the log by reusing the t=1 value.
    posterior_log_variance_clipped = np.log(
        np.append(posterior_variance[1], posterior_variance[1:])
    )
    if timestep_map is None:
        timestep_map = np.arange(betas.shape[0], dtype=np.int32)
    if original_num_steps is None:
        original_num_steps = int(betas.shape[0])
    return Schedule(
        betas=betas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        alphas_cumprod_next=alphas_cumprod_next,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=posterior_log_variance_clipped,
        posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev)
        / (1.0 - alphas_cumprod),
        posterior_mean_coef2=(1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
        / (1.0 - alphas_cumprod),
        fixed_large_variance=np.append(posterior_variance[1], betas[1:]),
        timestep_map=np.asarray(timestep_map, dtype=np.int32),
        original_num_steps=original_num_steps,
    )


def space_timesteps(num_timesteps, section_counts):
    """Pick a subset of timesteps from an original process
    (reference: tools/respace.py:9-62). Supports "ddimN" fixed striding and
    comma-separated per-section counts."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(
                f"cannot divide section of {size} steps into {section_count}"
            )
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        start_idx += size
    return set(all_steps)


def respace_schedule(base: Schedule, use_timesteps) -> Schedule:
    """Rebuild betas on a kept subset of timesteps
    (reference: tools/respace.py:74-88)."""
    use_timesteps = set(int(t) for t in use_timesteps)
    last_alpha_cumprod = 1.0
    new_betas, timestep_map = [], []
    for i, acp in enumerate(base.alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1 - acp / last_alpha_cumprod)
            last_alpha_cumprod = acp
            timestep_map.append(i)
    return make_schedule(
        np.array(new_betas, dtype=np.float64),
        timestep_map=np.array(timestep_map, dtype=np.int32),
        original_num_steps=base.num_timesteps,
    )


def _edm_alpha_bar(j, noise_schedule, M, C_2=0.008, lambda_max=10.0, lambda_min=-10.0):
    """alpha_bar(j) families used to build the iDDPM sigma ladder
    (reference: tools/cfg_edm.py:83-100). j counts *down* from M."""
    j = np.asarray(j, dtype=np.float64)
    if noise_schedule == "cosine":
        return np.sin(0.5 * np.pi * j / M / (C_2 + 1)) ** 2
    if noise_schedule == "linear":
        betas = np.linspace(0.0001, 0.02, M + 1, dtype=np.float64)
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        return alphas_cumprod[(M - j).astype(np.int64)]
    if noise_schedule == "linear_logsnr":
        t = (M - j) / M
        lam = lambda_max + t * (lambda_min - lambda_max)
        return 1.0 / (1.0 + np.exp(-lam))
    raise NotImplementedError(f"unknown noise schedule: {noise_schedule}")


def edm_sigma_ladder(noise_schedule="linear", M=1000, C_1=0.001, C_2=0.008,
                     lambda_max=10.0, lambda_min=-10.0) -> np.ndarray:
    """The iDDPM-style u[j] sigma ladder for EDM preconditioning
    (reference: tools/cfg_edm.py:43-48): built by the recursion
        u[j-1] = sqrt((u[j]^2 + 1) / max(alpha_bar(j-1)/alpha_bar(j), C_1) - 1)
    from u[M] = 0 down to u[0]. Returned as an (M+1,) f64 array; sigma_min =
    u[M-1], sigma_max = u[0].
    """
    u = np.zeros(M + 1, dtype=np.float64)
    ab = _edm_alpha_bar(np.arange(M + 1), noise_schedule, M, C_2,
                        lambda_max, lambda_min)
    for j in range(M, 0, -1):
        ratio = max(ab[j - 1] / ab[j], C_1)
        u[j - 1] = math.sqrt((u[j] ** 2 + 1) / ratio - 1)
    return u
