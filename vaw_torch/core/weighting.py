"""Variance-aware MSE loss weighting, the paper's contribution, and the
timestep importance samplers (counterpart of vaw_tpu/core/weighting.py;
reference: tools/gaussian_diffusion.py:1092-1148, tools/resample.py).

Every weight_type x mean_type cell of the reference's weight library as one
vectorized function on tensors; the uniform and the loss-aware
(sqrt E[loss^2]) timestep samplers, whose history lives in the train state.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .types import ModelMeanType

__all__ = ["compute_mse_loss_weight", "ResamplerState", "UniformSampler",
           "LossSecondMomentResampler", "create_named_schedule_sampler"]


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


@dataclasses.dataclass
class ResamplerState:
    """History of the loss-aware resampler, kept in the train state and its
    checkpoint (vaw_tpu/core/weighting.py:113-121): the last
    ``history_per_term`` losses of each timestep, oldest first, and how many
    of them are filled."""

    loss_history: torch.Tensor  # [T, history_per_term] f32
    loss_counts: torch.Tensor  # [T] int32


class UniformSampler:
    """Uniform timesteps with unit importance weights
    (reference: tools/resample.py:62-68)."""

    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, generator: torch.Generator, batch_size: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        device = generator.device
        t = torch.randint(0, self.num_timesteps, (batch_size,), generator=generator,
                          device=device)
        return t, torch.ones(batch_size, dtype=torch.float32, device=device)


class LossSecondMomentResampler:
    """sqrt(E[loss^2]) importance sampling with a warm-up
    (reference: tools/resample.py:132-162; vaw_tpu/core/weighting.py:
    140-218): uniform until every timestep holds history_per_term losses,
    then t with probability proportional to the root mean square of its
    history, mixed with uniform_prob of the uniform law. Functional, as the
    JAX class: ``sample`` reads a ResamplerState, ``update`` returns a new
    one."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob

    def init_state(self, device="cpu") -> ResamplerState:
        return ResamplerState(
            loss_history=torch.zeros((self.num_timesteps, self.history_per_term),
                                     dtype=torch.float32, device=device),
            loss_counts=torch.zeros(self.num_timesteps, dtype=torch.int32,
                                    device=device))

    def weights(self, state: ResamplerState) -> torch.Tensor:
        """[T] f32 sampling weights: ones until warmed up."""
        warmed_up = torch.all(state.loss_counts == self.history_per_term)
        w = torch.sqrt(torch.mean(state.loss_history ** 2, dim=-1))
        w = w / torch.sum(w)
        w = w * (1 - self.uniform_prob) + self.uniform_prob / self.num_timesteps
        return torch.where(warmed_up, w, torch.ones_like(w))

    def sample(self, generator: torch.Generator, state: ResamplerState,
               batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """t drawn from the weights (from `generator`) and the unbiasing
        importance weights 1 / (T p_t)."""
        w = self.weights(state)
        p = w / torch.sum(w)
        t = torch.multinomial(p, batch_size, replacement=True, generator=generator)
        return t, 1.0 / (self.num_timesteps * p[t])

    def update(self, state: ResamplerState, ts: torch.Tensor,
               losses: torch.Tensor) -> ResamplerState:
        """Fold a batch of per-sample losses into the history, equal to the
        reference's sequential per-item ring buffer (tools/resample.py:
        152-159) but vectorised as the JAX class is: each row keeps the last
        H of (its old valid entries ++ its new losses in batch order), and
        its count becomes min(count + k, H). One stable sort over the batch,
        one gather and one scatter over the [T, H] table, no host read."""
        H, T = self.history_per_term, self.num_timesteps
        ts = ts.long()
        losses = losses.float()
        hist, counts = state.loss_history, state.loss_counts
        k = torch.bincount(ts, minlength=T).to(torch.int32)  # arrivals per row
        new_counts = torch.clamp(counts + k, max=H)
        shift = torch.clamp(counts + k - H, min=0)  # old entries dropped per row
        cols = torch.arange(H, device=hist.device)[None, :] + shift[:, None]
        hist = torch.gather(hist, 1, torch.clamp(cols, max=H - 1).long())
        # Stable-sort the batch by timestep: an item's rank from the end of
        # its group gives its column; only the last H of a row survive.
        order = torch.sort(ts, stable=True).indices
        ts_s, losses_s = ts[order], losses[order]
        group_start = torch.searchsorted(ts_s, ts_s, right=False)
        rank = torch.arange(ts.shape[0], device=ts.device) - group_start
        from_end = k[ts_s].long() - 1 - rank
        dest = new_counts[ts_s].long() - 1 - from_end
        # Overwritten in the sequential semantics: sent to a spare column.
        dest = torch.where(from_end < H, dest, H)
        padded = torch.cat([hist, hist.new_zeros(T, 1)], dim=1)
        padded[ts_s, dest] = losses_s
        return ResamplerState(loss_history=padded[:, :H].contiguous(),
                              loss_counts=new_counts)


def create_named_schedule_sampler(name: str, num_timesteps: int):
    """(reference: tools/resample.py:9-21)"""
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")
