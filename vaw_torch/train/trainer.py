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
320-327, 411-421). Under --learn_align the frozen REPA teacher
(``encoder_fn``) runs on each micro-batch without gradients, on its stored
pixels or on the images themselves, unless the batch carries its features
(vaw_tpu/train/trainer.py:278-293).

Under a device mesh (parallel/mesh.py) each rank holds its data row's
rows of the global batch (ranks that differ only on the model, stage or
sp axis hold the same rows), and ``init_state`` lays the model out on the
mesh as the JAX package's ``shard_state`` does (vaw_tpu/train/
trainer.py:213-266): tensor parallelism on the "model" axis, FSDP on the
"data" axis under --fsdp, stage ownership of the blocks under a
pipeline; the loud TP check runs first. Every rank draws the global
batch's t, noise and label-drop ids, micro-batch by micro-batch, from the
shared per-step generator and takes its rows, so the P-rank step is the
one-rank step on the concatenated batch, as JAX's jitted global step is:
the global batch is the ranks' rows in rank order and its micro-batch i is
rows [i B, (i + 1) B), as the JAX step splits it (vaw_tpu/cli/main.py:
447-471, trainer.py:351-357); each rank's micro-batch j is a contiguous
piece of one of them. The gradient mean over the data axis is an explicit
bucketed all-reduce after the backward (FSDP's reduce-scatter does it
under --fsdp; under sequence parallelism the sum runs over the sp axis
too, each rank holding its rows' share); the loss, the metrics and
grad_norm are global; the resampler folds every data rank's (t, loss) in
rank order; the fused AdamW+EMA runs on each rank's local shards.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.diffusion import GaussianDiffusion
from ..core.weighting import LossSecondMomentResampler
from ..encoders.align import get_feature
from ..parallel.mesh import data_index
from ..parallel.partition import (
    apply_fsdp,
    apply_tensor_parallel,
    assert_tp_rules_applied,
    full_tensors,
    local_like,
    replication_factor,
    to_local,
)
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
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None):
    """optax.clip_by_global_norm in place: each g becomes (g / norm) *
    max_norm when the global norm is not below max_norm. No epsilon is
    added to the norm (torch.nn.utils.clip_grad_norm_ adds 1e-6). `norm`,
    when given, is the norm of the whole (sharded) gradient."""
    norm = global_norm(grads) if norm is None else norm
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
    def step(self, params, grads, mu, nu, count: int,
             norm: Optional[torch.Tensor] = None) -> int:
        """One update of params, mu and nu in place; returns count + 1.
        `norm` is the gradient's global norm where it is sharded."""
        if self.grad_clip:
            clip_by_global_norm_(grads, self.grad_clip, norm)
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


def _rows(tree: Dict[str, Optional[torch.Tensor]], start: int, size: int):
    return {k: None if v is None else v[start:start + size] for k, v in tree.items()}


# Elements of one all-reduce of the gradient mean.
_BUCKET = 1 << 24


@torch.no_grad()
def _all_reduce_mean(tensors: List[torch.Tensor], group, divisor: int):
    """Sum `tensors` in place over `group` in flat buckets of one dtype,
    then divide by `divisor`."""
    by_kind: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for ts in by_kind.values():
        start = 0
        while start < len(ts):
            bucket, size = [], 0
            while start < len(ts) and (not bucket or size + ts[start].numel() <= _BUCKET):
                bucket.append(ts[start])
                size += ts[start].numel()
                start += 1
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=group)
            flat.div_(divisor)
            torch._foreach_copy_(bucket, [c.view_as(t) for c, t in zip(
                flat.split([t.numel() for t in bucket]), bucket)])


class Trainer:
    """Owns the train step of `model` (any ported backbone, on its
    device, with f32 master weights) under `process` (a GaussianDiffusion
    or a FlowMatching). `encoder_fn`, REPA's frozen teacher (preprocessed
    NHWC pixels -> token features), is run on batches without features."""

    def __init__(self, cfg, model: torch.nn.Module, process,
                 encoder_fn: Optional[Callable] = None, mesh=None,
                 apply_fn: Optional[Callable] = None):
        self.cfg = cfg
        self.model = model
        self.process = process
        self.encoder_fn = encoder_fn
        # The device mesh and, under a pipeline or sequence parallelism,
        # the forward that runs the model across it (the model's own
        # forward otherwise).
        self.mesh = mesh
        self.apply_fn = apply_fn
        self.data_rank, self.data_size = data_index(mesh)
        self.tp = 1
        self.permuted: Dict[str, int] = {}  # TP qkv parameters -> heads
        self._replication: Dict[str, int] = {}
        self._laid_out = False
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

    def _axis(self, name: str) -> int:
        names = self.mesh.mesh_dim_names
        return self.mesh.size(names.index(name)) if name in names else 1

    def shard_model(self):
        """Lay the model out on the mesh (vaw_tpu/train/trainer.py:213-266):
        the loud TP check, then pipeline ownership, or TP and FSDP."""
        cfg, mesh, model = self.cfg, self.mesh, self.model
        if self._laid_out:  # a second init_state must not split twice
            return
        self._laid_out = True
        assert_tp_rules_applied(model, self._axis("model"))
        names = mesh.mesh_dim_names
        world = dist.get_world_size()
        if "stage" in names:
            if cfg.fsdp:
                raise ValueError("fsdp+pp composition is not supported; run pp "
                                 "with dp only")
            owned = set(self.apply_fn.owned_blocks)
            for i, block in enumerate(model.blocks):
                if i not in owned:  # another stage's: dropped from this rank
                    block.to("meta")
            for name, _ in model.named_parameters():
                stage_held = name.startswith("blocks.")
                self._replication[name] = self.data_size if stage_held else world
            return
        if "model" not in names:
            if cfg.fsdp:
                raise ValueError(
                    "fsdp needs a ('data','model') mesh; on this "
                    f"{tuple(names)} mesh params would silently replicate "
                    "instead of ZeRO-sharding")
            return
        self.tp = self._axis("model")
        if self.tp > 1:
            self.permuted = apply_tensor_parallel(model, mesh)
        if cfg.fsdp:
            apply_fsdp(model, mesh)

    def init_state(self) -> TrainState:
        """State over the model's current parameters (laid out on the mesh
        first, where there is one): EMA a copy of them, zero moments (bf16
        under --opt_bf16_moments), step and count 0; under a mesh each is
        this rank's share, in the parameters' placements."""
        bf16_moments = self.cfg.opt_bf16_moments
        if bf16_moments and not self.use_fused_opt():
            raise ValueError("--opt_bf16_moments requires the fused optimizer "
                             "(--fused_optimizer True, no --grad_clip)")
        mdtype = torch.bfloat16 if bf16_moments else torch.float32
        if self.mesh is not None:
            self.shard_model()
        params = {k: p for k, p in self.model.named_parameters() if not p.is_meta}
        for k, p in params.items():
            self._replication.setdefault(k, replication_factor(p))
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

    def features(self, batch, x: torch.Tensor) -> Optional[torch.Tensor]:
        """REPA's teacher features for one micro-batch: the batch's own, else
        the teacher's on the batch's pixels, else on the images x in [-1, 1]
        mapped to [0, 255] (vaw_tpu/train/trainer.py:278-293); None without
        learn_align or a teacher."""
        features = batch.get("features")
        if features is not None or not self.cfg.learn_align or self.encoder_fn is None:
            return features
        pixels = batch.get("pixels")
        if pixels is None:
            if x.shape[-1] not in (1, 3):
                raise ValueError(
                    "REPA align needs teacher pixels: the batch has no "
                    f"'pixels' key and x has {x.shape[-1]} channels "
                    "(latent moments, not an image) — use a "
                    "Latent_Pixel dataset that stores pixels")
            pixels = (x + 1.0) * 127.5
        return get_feature(self.cfg.enc_type, pixels, self.encoder_fn)

    def loss_fn(self, batch, draws) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean loss of one micro-batch (importance-weighted when the draws
        carry weights) and its metrics, with the per-sample losses and
        their t under "_per_sample" for the resampler
        (vaw_tpu/train/trainer.py:272-342)."""
        cfg = self.cfg
        x = batch["image"].float()
        y = batch.get("label")
        features = self.features(batch, x)
        if cfg.in_chans == 4 and x.shape[-1] == 2 * cfg.in_chans:
            x = sample_from_latent(x, draws["latent"], cfg.latent_scale)

        forward = self.apply_fn or self.model

        def model_fn(xt, t, **kwargs):
            return forward(xt, t, train=True, force_drop_ids=draws["drop"], **kwargs)

        model_kwargs = {"y": y} if (cfg.class_cond and y is not None) else {}
        terms = self.process.training_losses(model_fn, x, draws["t"], draws["noise"],
                                             features=features, model_kwargs=model_kwargs)
        per_sample = terms["loss"]
        weights = draws.get("weights")
        loss = (weights * per_sample).mean() if weights is not None else per_sample.mean()
        metrics = {k: v.detach().mean() for k, v in terms.items()}
        metrics["_per_sample"] = (draws["t"], per_sample.detach())
        return loss, metrics

    def full(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Full reference-layout copies of a state tree (params, EMA or a
        moment), on every rank: DTensors gathered, the qkv rows back in
        [3, H, D] order, another stage's blocks from their owner. A
        collective under a mesh: every rank calls it."""
        out = full_tensors(tree, self.permuted, self.tp)
        if self.mesh is None or "stage" not in self.mesh.mesh_dim_names:
            return out
        group = self.mesh.get_group("stage")
        ranks = dist.get_process_group_ranks(group)
        stages = self._axis("stage")
        per = len(self.model.blocks) // stages
        device = next(iter(out.values())).device
        for name, p in self.model.named_parameters():
            if not name.startswith("blocks."):
                continue
            owner = ranks[int(name.split(".")[1]) // per]
            t = out.get(name)
            if t is None:
                t = torch.empty(p.shape, dtype=next(iter(tree.values())).dtype,
                                device=device)
            dist.broadcast(t, owner, group=group)
            out[name] = t
        return {k: out[k] for k, _ in self.model.named_parameters()}

    @property
    def holds_subset(self) -> bool:
        """Whether this rank's state holds only some of the parameters (a
        pipeline stage's blocks)."""
        return self.mesh is not None and "stage" in self.mesh.mesh_dim_names

    def local(self, name: str, full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """This rank's share, in `like`'s layout, of the reference-layout
        tensor `full` (no communication)."""
        return local_like(name, full, like, self.permuted, self.tp)

    def _data_group(self):
        return self.mesh.get_group("data")

    def _reduce_grads(self, grads: List[torch.Tensor]):
        """The data axis' gradient mean (summed over sp as well); FSDP's
        reduce-scatter has done it under --fsdp."""
        if self.mesh is None or self.cfg.fsdp:
            return
        sp = "sp" in self.mesh.mesh_dim_names
        group = dist.group.WORLD if sp else self._data_group()
        _all_reduce_mean(grads, group, self.data_size)

    def _global_norm(self, names: List[str], grads: List[torch.Tensor]) -> torch.Tensor:
        if self.mesh is None:
            return global_norm(grads)
        sq = sum((g.float() ** 2).sum() / self._replication[k]
                 for k, g in zip(names, grads))
        dist.all_reduce(sq)
        return torch.sqrt(sq)

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """`t` of every data rank, concatenated in rank order."""
        out = t.new_empty((self.data_size * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous(), group=self._data_group())
        return out

    def step(self, state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on this rank's rows of the batch, already on
        the device; updates `state` in place and returns it with 0-d device
        metrics (reading them is the caller's host sync)."""
        cfg = self.cfg
        self.generator.manual_seed(((cfg.seed & 0xFFFFFFFF) << 32) | state.step)
        names = list(state.params)
        params = [state.params[k] for k in names]
        for p in params:
            p.grad = None
        accum = max(1, cfg.grad_accumulation)
        n_local = len(next(iter(batch.values())))
        if n_local % accum:
            raise ValueError(f"batch of {n_local} does not split into {accum} micro-batches")
        chunk, ranks, rank = n_local // accum, self.data_size, self.data_rank
        self._resampler_state = state.resampler
        micro = [{k: v[j * chunk:(j + 1) * chunk] for k, v in batch.items()}
                 for j in range(accum)]
        if ranks == 1:
            draws = [self.draw(mb) for mb in micro]
        else:
            # The global micro-batches' draws, in the one-rank order; only
            # their shapes are read from this stand-in batch.
            shape = {k: v[:1].expand(chunk * ranks, *v.shape[1:]) for k, v in batch.items()}
            draws = [self.draw(shape) for _ in range(accum)]
        loss = None
        metrics: Dict[str, torch.Tensor] = {}
        per_sample = []
        for j, mb in enumerate(micro):
            # Local micro-batch j is rows [off, off + chunk) of global
            # micro-batch k // ranks, k = rank * accum + j.
            k = rank * accum + j
            mb_draws = draws[j] if ranks == 1 else _rows(
                draws[k // ranks], (k % ranks) * chunk, chunk)
            mb_loss, mb_metrics = self.loss_fn(mb, mb_draws)
            mb_loss.backward()
            per_sample.append(mb_metrics.pop("_per_sample"))
            loss = mb_loss.detach() if loss is None else loss + mb_loss.detach()
            for name, v in mb_metrics.items():
                metrics[name] = v if name not in metrics else metrics[name] + v
        if self.resampler is not None and state.resampler is not None:
            # Fold the step's (t, loss) pairs, every micro-batch's and
            # every data rank's, in the global batch's row order, into the
            # history (vaw_tpu/train/trainer.py:411-421).
            ts, losses = (torch.cat(v) for v in zip(*per_sample))
            if self.mesh is not None:
                ts, losses = self._gather_rows(ts), self._gather_rows(losses)
            state.resampler = self.resampler.update(state.resampler, ts, losses)
        with torch.no_grad():
            grads = [to_local(p.grad) if p.grad is not None else torch.zeros_like(to_local(p))
                     for p in params]
        self._reduce_grads(grads)
        if accum > 1:
            inv = 1.0 / accum
            torch._foreach_mul_(grads, inv)
            loss = loss * inv
            metrics = {k: v * inv for k, v in metrics.items()}
        metrics["loss"] = loss
        if self.mesh is not None:
            keys = list(metrics)
            values = torch.stack([metrics[k].float() for k in keys])
            dist.all_reduce(values, group=self._data_group())
            metrics = dict(zip(keys, (values / self.data_size).unbind()))
        norm = None
        if cfg.log_grad_norm or (cfg.grad_clip and self.mesh is not None):
            norm = self._global_norm(names, grads)  # before any clipping
        if cfg.log_grad_norm:
            metrics["grad_norm"] = norm
        with torch.no_grad():
            local = [to_local(p) for p in params]
            ema = [to_local(state.ema[k]) for k in names]
            mu = [to_local(state.mu[k]) for k in names]
            nu = [to_local(state.nu[k]) for k in names]
            if self.optimizer is None:
                state.count = fused_adamw_ema(
                    local, grads, mu, nu, ema, state.count, lr_fn=self.lr_fn,
                    b1=cfg.betas[0], b2=cfg.betas[1], eps=cfg.eps,
                    weight_decay=cfg.weight_decay, ema_decay=cfg.ema_decay)
            else:
                state.count = self.optimizer.step(
                    local, grads, mu, nu, state.count,
                    norm=norm if self.mesh is not None else None)
                ema_update(local, ema, cfg.ema_decay)
        for p in params:
            p.grad = None
        state.step += 1
        return state, metrics
