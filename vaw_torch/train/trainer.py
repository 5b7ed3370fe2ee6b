"""The train step (counterpart of vaw_tpu/train/trainer.py).

Eager PyTorch on one device. One step is: the step's random draws from the
Trainer's ``torch.Generator``, the weighted diffusion loss and its backward
per micro-batch (gradients summed in ``.grad``, then averaged, as the JAX
scan over micro-batches does), then the fused AdamW+EMA update, or the
unfused optax chain when --grad_clip is set. Compute runs in the model's
compute dtype (bf16 under --amp True) over f32 master weights; bf16 shares
f32's exponent range, so no loss scaler is needed, as on the TPU.

The generator is re-seeded from (cfg.seed, step) at every step, the
counterpart of the JAX package's ``fold_in(base_rng, step)``: a resumed run
draws what the uninterrupted run would have drawn. The process is a
GaussianDiffusion or a FlowMatching (continuous t). Under
``--time_sampler loss-second-moment`` a GaussianDiffusion's t comes from the
loss-aware resampler, whose importance weights multiply the per-sample
losses, and each step's per-sample losses, micro-batches included, are
folded into its history after the step (vaw_tpu/train/trainer.py:109-116,
320-327, 411-421). REPA (ROADMAP A13) is not ported yet and raises.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.diffusion import GaussianDiffusion
from ..core.weighting import LossSecondMomentResampler
from .fused_opt import bias_corrections, fused_adamw_ema, safe_int32_increment
from .state import TrainState, ema_update

__all__ = ["warmup_cosine_lr", "make_optimizer", "AdamW",
           "clip_by_global_norm_", "global_norm", "sample_from_latent",
           "Trainer"]


def warmup_cosine_lr(cfg) -> Callable[[int], np.float32]:
    """lr(step) = lr * lambda(step) with linear warmup and optional cosine
    decay to final_lr, in f32 as the JAX schedule computes it
    (reference: tools/utils.py:75-90)."""
    f32 = np.float32

    def schedule(step):
        step = f32(step)
        warm = step / f32(max(cfg.warmup_steps, 1))
        if cfg.cosine_decay:
            progress = (step - f32(cfg.warmup_steps)) / f32(
                max(cfg.total_steps - cfg.warmup_steps, 1))
            cos = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * progress))
            after = (f32(cfg.final_lr) + f32(cfg.lr - cfg.final_lr) * cos) / f32(cfg.lr)
        else:
            after = f32(1.0)
        lam = after if (cfg.warmup_steps == 0 or step >= cfg.warmup_steps) else warm
        return f32(cfg.lr) * f32(lam)

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), as
    a 0-d f32 tensor on the tensors' device."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float):
    """optax.clip_by_global_norm in place: each g becomes (g / norm) *
    max_norm when the global norm is not below max_norm. No epsilon is
    added to the norm (torch.nn.utils.clip_grad_norm_ adds 1e-6)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(warmup_cosine_lr))
    applied eagerly and in place (vaw_tpu/train/trainer.py:59-69). Moments
    are f32. The trainer takes this path only under --grad_clip or
    --fused_optimizer False."""

    def __init__(self, cfg):
        self.lr_fn = warmup_cosine_lr(cfg)
        self.b1, self.b2 = cfg.betas
        self.eps = cfg.eps
        self.weight_decay = cfg.weight_decay
        self.grad_clip = cfg.grad_clip

    @torch.no_grad()
    def step(self, params, grads, mu, nu, count: int) -> int:
        """One update of params, mu and nu in place; returns count + 1."""
        if self.grad_clip:
            clip_by_global_norm_(grads, self.grad_clip)
        b1, b2 = self.b1, self.b2
        count_inc = safe_int32_increment(count)
        bc1, bc2 = bias_corrections(b1, b2, count_inc)
        lr = float(self.lr_fn(count))
        for p, g, m, v in zip(params, grads, mu, nu):
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * g ** 2 + b2 * v)
            update = (m / float(bc1)) / (torch.sqrt(v / float(bc2)) + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * p
            p.add_(-lr * update)
        return count_inc


def make_optimizer(cfg) -> AdamW:
    """AdamW + optional global-norm clip (reference: main.py:354-355)."""
    return AdamW(cfg)


def sample_from_latent(latent: torch.Tensor, eps: torch.Tensor,
                       latent_scale: float = 1.0) -> torch.Tensor:
    """Re-sample stored VAE moments: latent = [mean | std] on the channel
    axis -> (mean + std * eps) * scale (reference: tools/trainer.py:21-25)."""
    mean, std = latent.chunk(2, dim=-1)
    return (mean + std * eps) * latent_scale


def _micro_batches(batch: Dict[str, torch.Tensor], accum: int):
    n = len(next(iter(batch.values())))
    if n % accum:
        raise ValueError(f"batch of {n} does not split into {accum} micro-batches")
    size = n // accum
    for i in range(accum):
        yield {k: v[i * size:(i + 1) * size] for k, v in batch.items()}


class Trainer:
    """Owns the train step of `model` (any ported backbone, on its
    device, with f32 master weights) under `process` (a GaussianDiffusion
    or a FlowMatching)."""

    def __init__(self, cfg, model: torch.nn.Module, process):
        if cfg.learn_align:
            raise NotImplementedError("REPA (learn_align) is not ported yet: "
                                      "ROADMAP A13")
        self.cfg = cfg
        self.model = model
        self.process = process
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.lr_fn = warmup_cosine_lr(cfg)
        self.optimizer = None if self.use_fused_opt() else make_optimizer(cfg)
        # As in the JAX trainer, the resampler applies to discrete diffusion
        # only; flow matching's t stays continuous and uniform in its law.
        self.resampler = None
        if (cfg.time_sampler == "loss-second-moment"
                and isinstance(process, GaussianDiffusion)):
            self.resampler = LossSecondMomentResampler(process.num_timesteps)
        self._resampler_state = None  # the history the step's draws read

    def use_fused_opt(self) -> bool:
        """The fused AdamW+EMA applies unless grads are clipped or it is
        turned off (vaw_tpu/train/trainer.py:146-151)."""
        return not self.cfg.grad_clip and self.cfg.fused_optimizer

    def init_state(self) -> TrainState:
        """State over the model's current parameters: EMA a copy of them,
        zero moments (bf16 under --opt_bf16_moments), step and count 0."""
        bf16_moments = self.cfg.opt_bf16_moments
        if bf16_moments and not self.use_fused_opt():
            raise ValueError("--opt_bf16_moments requires the fused optimizer "
                             "(--fused_optimizer True, no --grad_clip)")
        mdtype = torch.bfloat16 if bf16_moments else torch.float32
        params = dict(self.model.named_parameters())
        return TrainState(
            step=0, params=params,
            ema={k: p.detach().clone() for k, p in params.items()},
            count=0,
            mu={k: torch.zeros_like(p, dtype=mdtype) for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=mdtype) for k, p in params.items()},
            resampler=(self.resampler.init_state(self.device)
                       if self.resampler is not None else None),
        )

    def draw(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Optional[torch.Tensor]]:
        """The random draws of one micro-batch, from self.generator: t
        (and its importance weights under the loss-aware resampler, else
        None), the noise, the latent eps (when the batch holds VAE moments)
        and the label-drop ids (1 = drop to the null label; None without
        label dropout), which the model honours in training whatever its
        family. Tests replace this method to feed both packages the same
        numbers."""
        cfg, gen = self.cfg, self.generator
        x = batch["image"]
        n = x.shape[0]
        latent = cfg.in_chans == 4 and x.shape[-1] == 2 * cfg.in_chans
        shape = (*x.shape[:-1], cfg.in_chans) if latent else tuple(x.shape)
        if self.resampler is not None and self._resampler_state is not None:
            t, weights = self.resampler.sample(gen, self._resampler_state, n)
        else:
            t, weights = self.process.sample_t(gen, n), None
        draws = {"t": t, "weights": weights,
                 "noise": torch.randn(shape, generator=gen, device=self.device),
                 "latent": None, "drop": None}
        if latent:
            draws["latent"] = torch.randn(shape, generator=gen, device=self.device)
        if cfg.class_cond and "label" in batch and cfg.drop_label_prob > 0:
            draws["drop"] = (torch.rand(n, generator=gen, device=self.device)
                             < cfg.drop_label_prob).int()
        return draws

    def loss_fn(self, batch, draws) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean loss of one micro-batch (importance-weighted when the draws
        carry weights) and its metrics, with the per-sample losses and
        their t under "_per_sample" for the resampler
        (vaw_tpu/train/trainer.py:272-342, without REPA)."""
        cfg = self.cfg
        x = batch["image"].float()
        y = batch.get("label")
        if cfg.in_chans == 4 and x.shape[-1] == 2 * cfg.in_chans:
            x = sample_from_latent(x, draws["latent"], cfg.latent_scale)

        def model_fn(xt, t, **kwargs):
            return self.model(xt, t, train=True, force_drop_ids=draws["drop"],
                              **kwargs)

        model_kwargs = {"y": y} if (cfg.class_cond and y is not None) else {}
        terms = self.process.training_losses(model_fn, x, draws["t"],
                                             draws["noise"], model_kwargs)
        per_sample = terms["loss"]
        weights = draws.get("weights")
        loss = (weights * per_sample).mean() if weights is not None else per_sample.mean()
        metrics = {k: v.detach().mean() for k, v in terms.items()}
        metrics["_per_sample"] = (draws["t"], per_sample.detach())
        return loss, metrics

    def step(self, state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on a batch already on the device; updates
        `state` in place and returns it with 0-d device metrics (reading
        them is the caller's host sync)."""
        cfg = self.cfg
        self.generator.manual_seed(((cfg.seed & 0xFFFFFFFF) << 32) | state.step)
        names = list(state.params)
        params = [state.params[k] for k in names]
        for p in params:
            p.grad = None
        accum = max(1, cfg.grad_accumulation)
        loss = None
        metrics: Dict[str, torch.Tensor] = {}
        per_sample = []
        self._resampler_state = state.resampler
        for mb in _micro_batches(batch, accum):
            mb_loss, mb_metrics = self.loss_fn(mb, self.draw(mb))
            mb_loss.backward()
            per_sample.append(mb_metrics.pop("_per_sample"))
            loss = mb_loss.detach() if loss is None else loss + mb_loss.detach()
            for k, v in mb_metrics.items():
                metrics[k] = v if k not in metrics else metrics[k] + v
        if self.resampler is not None and state.resampler is not None:
            # Fold the step's (t, loss) pairs, every micro-batch's in order,
            # into the history (vaw_tpu/train/trainer.py:411-421).
            ts, losses = (torch.cat(v) for v in zip(*per_sample))
            state.resampler = self.resampler.update(state.resampler, ts, losses)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if accum > 1:
            inv = 1.0 / accum
            torch._foreach_mul_(grads, inv)
            loss = loss * inv
            metrics = {k: v * inv for k, v in metrics.items()}
        metrics["loss"] = loss
        if cfg.log_grad_norm:
            metrics["grad_norm"] = global_norm(grads)  # before any clipping
        ema = [state.ema[k] for k in names]
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        if self.optimizer is None:
            state.count = fused_adamw_ema(
                params, grads, mu, nu, ema, state.count, lr_fn=self.lr_fn,
                b1=cfg.betas[0], b2=cfg.betas[1], eps=cfg.eps,
                weight_decay=cfg.weight_decay, ema_decay=cfg.ema_decay)
        else:
            state.count = self.optimizer.step(params, grads, mu, nu, state.count)
            ema_update(params, ema, cfg.ema_decay)
        for p in params:
            p.grad = None
        state.step += 1
        return state, metrics
