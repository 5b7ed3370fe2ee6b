"""Typed experiment configuration with CLI-compatible flags.

A copy of vaw_tpu/utils/config.py with the same flag surface, names and
defaults (reference: main.py:36-135, sample.py:20-117), so a command line of
either package works with the other. Only ``compute_dtype`` differs: it is a
torch dtype here.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["TrainConfig", "str2bool", "add_train_args", "add_sample_args",
           "config_from_args"]

# The JAX package's variant list (vaw_tpu/utils/config.py), so flags parse
# the same; vaw_torch.models.build_model says which are ported.
MODEL_VARIANTS = [
    "UNet-32", "ADM-32", "ADM-64", "ADM-128", "ADM-256", "ADM-512",
    "UNet-64", "LDM",
    "ViT-S", "ViT-B", "ViT-L", "ViT-XL",
    "DiT-S", "DiT-B", "DiT-L", "DiT-XL",
    "U-ViT-S", "U-ViT-S-D", "U-ViT-M", "U-ViT-L", "U-ViT-H",
    "MM-DiT-S", "MM-DiT-B", "MM-DiT-L",
]


def str2bool(v):
    """(reference: tools/utils.py:23-31)"""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


@dataclasses.dataclass
class TrainConfig:
    """One dataclass spanning the train + sample flag space
    (reference: main.py:36-135)."""

    # enable/disable
    train: bool = True
    eval: bool = True

    # data
    data_dir: str = "./data"
    dataset: str = "CIFAR-10"
    patch_size: Optional[int] = None
    in_chans: int = 3
    image_size: int = 32
    num_classes: int = 0
    model: str = "ADM-32"
    seed: int = 42

    # process selection
    model_mode: str = "diffusion"  # diffusion | flow
    path_type: str = "linear"  # linear | linear_logsnr | cosine
    sampler_type: str = "sde"  # sde | ode (flow)
    time_dist: Tuple = ("uniform", -0.8, 0.8)
    diffusion_steps: int = 1000

    # timestep importance sampling (reference defines but never wires
    # tools/resample.py; first-class here)
    time_sampler: str = "uniform"  # uniform | loss-second-moment

    # loss
    mean_type: str = "EPSILON"
    var_type: str = "FIXED_LARGE"
    loss_type: str = "MSE"
    weight_type: str = "constant"
    gamma: float = 0.0
    p2_gamma: float = 1.0
    p2_k: float = 1.0

    # training
    num_workers: int = 16
    batch_size: int = 128
    total_steps: int = 400_000
    ema_decay: float = 0.9999
    class_cond: bool = False
    learn_sigma: bool = False
    learn_align: bool = False
    align_type: str = "mse"
    enc_type: str = "dinov2-vit-b"
    encoder_depth: int = 0
    z_dims: int = 768

    # optimizer
    lr: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.0
    eps: float = 1e-8

    # CFG training / latent
    drop_label_prob: float = 0.0
    latent_scale: float = 0.18215

    # tricks
    warmup_steps: int = 0
    final_lr: float = 0.0
    grad_clip: Optional[float] = None
    dropout: float = 0.0
    cosine_decay: bool = False

    # distribution / precision (the reference's --parallel/--amp DDP+AMP
    # switches)
    parallel: bool = False
    amp: bool = True  # bf16 compute policy
    grad_accumulation: int = 1
    resume: Optional[str] = None
    data_axis: int = -1  # -1: all devices on the data axis
    model_axis: int = 1  # tensor-parallel degree
    pp_stages: int = 1  # pipeline-parallel stages (DiT scan_blocks only)
    pp_microbatches: int = 0  # 0: defaults to pp_stages
    sp_degree: int = 1  # sequence-parallel (ring attention) degree, DiT
    fsdp: bool = False  # ZeRO-3-style param/opt-state sharding over 'data'
    async_checkpoint: bool = False  # non-blocking checkpoint writes
    fused_optimizer: bool = True  # single-pass AdamW+EMA (train/fused_opt)
    # Store Adam mu/nu in bf16 (f32 update math, bf16 storage) — cuts the
    # optimizer slice's HBM traffic ~22%; params/EMA stay f32. Requires the
    # fused optimizer (the optax chain assumes f32 moments).
    opt_bf16_moments: bool = False
    log_grad_norm: bool = True  # costs one extra full grad read per step
    # gradient rematerialization (reference: models/unet.py use_checkpoint,
    # tools/nn.py:124-170) and scan-compiled DiT blocks (TPU extension)
    use_checkpoint: bool = False
    # 'full' = recompute everything (reference CheckpointFunction);
    # 'dots' = save matmul/conv outputs, recompute elementwise only
    remat_policy: str = "full"
    scan_blocks: bool = False

    # logging & sampling
    logdir: str = "./logs"
    # the metric writers of utils/kvlogger, comma-separated: csv, json, log,
    # stdout, tensorboard (the JAX CLI writes csv and json)
    log_formats: str = "csv,json"
    sample_size: int = 64
    sample_freq: int = 10_000
    sample_steps: int = 18
    class_labels: Optional[List[int]] = None
    use_classifier: Optional[str] = None
    guidance_scale: float = 1.0
    interval: Tuple[float, float] = (-1.0, -1.0)

    # latent VAE
    vae: str = "ema"

    # solvers
    solver: str = "heun"
    discretization: str = "edm"
    schedule: str = "linear"
    scaling: str = "none"

    # eval
    save_step: int = 100_000
    eval_step: int = 50_000
    num_samples: int = 50_000
    ref_batch: str = "./reference_batches/fid_stats_cifar_train.npz"

    # sample.py extras
    save_path: str = "./generated_samples"
    atol: float = 1e-6
    rtol: float = 1e-3

    @property
    def compute_dtype(self):
        """bf16 compute under --amp True (vaw_tpu/utils/config.py:173-177);
        weights stay f32 and are copied to this dtype for compute."""
        return torch.bfloat16 if self.amp else torch.float32

    def to_dict(self):
        return dataclasses.asdict(self)


_TRAIN_ONLY_DEFAULTS = {}
_SAMPLE_DELTAS = {
    # sample.py flag-default deltas vs main.py (reference: sample.py:20-117)
    "warmup_steps": 5000,
    "cosine_decay": True,
    "train": False,
    "eval": False,
}


def _add_common_args(p: argparse.ArgumentParser, defaults: dict):
    d = TrainConfig(**defaults)
    p.add_argument("--train", default=d.train, type=str2bool)
    p.add_argument("--eval", default=d.eval, type=str2bool)
    p.add_argument("--data_dir", type=str, default=d.data_dir)
    p.add_argument("--dataset", type=str, default=d.dataset,
                   choices=["CIFAR-10", "Gaussian", "Shapes", "CelebA",
                            "ImageNet", "LSUN", "Latent", "Latent_Pixel"])
    p.add_argument("--patch_size", type=int, default=d.patch_size)
    p.add_argument("--in_chans", type=int, default=d.in_chans)
    p.add_argument("--image_size", type=int, default=d.image_size)
    p.add_argument("--num_classes", type=int, default=d.num_classes)
    p.add_argument("--model", type=str, default=d.model, choices=MODEL_VARIANTS)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--model_mode", type=str, default=d.model_mode,
                   choices=["diffusion", "flow"])
    p.add_argument("--path_type", type=str, default=d.path_type,
                   choices=["linear", "linear_logsnr", "cosine"])
    p.add_argument("--sampler_type", type=str, default=d.sampler_type,
                   choices=["sde", "ode"])
    p.add_argument("--time_dist", nargs="+", default=list(d.time_dist))
    p.add_argument("--diffusion_steps", type=int, default=d.diffusion_steps)
    p.add_argument("--time_sampler", type=str, default=d.time_sampler,
                   choices=["uniform", "loss-second-moment"])
    p.add_argument("--mean_type", type=str, default=d.mean_type,
                   choices=["PREVIOUS_X", "START_X", "EPSILON", "VELOCITY",
                            "VECTOR", "SCORE"])
    p.add_argument("--var_type", type=str, default=d.var_type,
                   choices=["FIXED_LARGE", "FIXED_SMALL", "LEARNED",
                            "LEARNED_RANGE"])
    p.add_argument("--loss_type", type=str, default=d.loss_type,
                   choices=["MSE", "RESCALED_MSE", "KL", "RESCALED_KL"])
    p.add_argument("--weight_type", type=str, default=d.weight_type)
    p.add_argument("--gamma", type=float, default=d.gamma)
    p.add_argument("--p2_gamma", type=float, default=d.p2_gamma)
    p.add_argument("--p2_k", type=float, default=d.p2_k)
    p.add_argument("--num_workers", type=int, default=d.num_workers)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--total_steps", type=int, default=d.total_steps)
    p.add_argument("--ema_decay", type=float, default=d.ema_decay)
    p.add_argument("--class_cond", default=d.class_cond, type=str2bool)
    p.add_argument("--learn_sigma", default=d.learn_sigma, type=str2bool)
    p.add_argument("--learn_align", default=d.learn_align, type=str2bool)
    p.add_argument("--align_type", type=str, default=d.align_type,
                   choices=["cosine", "nt_xent", "mse_l2", "mse"])
    p.add_argument("--enc-type", "--enc_type", dest="enc_type", type=str,
                   default=d.enc_type)
    # the reference spells this --encoder_depth in main.py but
    # --encoder-depth in sample.py (sample.py:56); accept both.
    p.add_argument("--encoder_depth", "--encoder-depth",
                   dest="encoder_depth", type=int,
                   default=d.encoder_depth)
    p.add_argument("--z_dims", type=int, default=d.z_dims)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--betas", type=float, nargs=2, default=list(d.betas))
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--eps", type=float, default=d.eps)
    p.add_argument("--drop_label_prob", type=float, default=d.drop_label_prob)
    p.add_argument("--latent_scale", type=float, default=d.latent_scale)
    p.add_argument("--warmup_steps", type=int, default=d.warmup_steps)
    p.add_argument("--final_lr", type=float, default=d.final_lr)
    p.add_argument("--grad_clip", type=float, default=d.grad_clip)
    p.add_argument("--dropout", type=float, default=d.dropout)
    p.add_argument("--cosine_decay", default=d.cosine_decay, type=str2bool)
    p.add_argument("--parallel", default=d.parallel, type=str2bool)
    p.add_argument("--amp", default=d.amp, type=str2bool)
    p.add_argument("--grad_accumulation", type=int, default=d.grad_accumulation)
    p.add_argument("--resume", type=str, default=d.resume)
    p.add_argument("--data_axis", type=int, default=d.data_axis)
    p.add_argument("--model_axis", type=int, default=d.model_axis)
    p.add_argument("--pp_stages", type=int, default=d.pp_stages)
    p.add_argument("--pp_microbatches", type=int, default=d.pp_microbatches)
    p.add_argument("--sp_degree", type=int, default=d.sp_degree)
    p.add_argument("--fsdp", default=d.fsdp, type=str2bool)
    p.add_argument("--fused_optimizer", default=d.fused_optimizer,
                   type=str2bool)
    p.add_argument("--opt_bf16_moments", default=d.opt_bf16_moments,
                   type=str2bool)
    p.add_argument("--log_grad_norm", default=d.log_grad_norm, type=str2bool)
    p.add_argument("--async_checkpoint", default=d.async_checkpoint,
                   type=str2bool)
    p.add_argument("--use_checkpoint", default=d.use_checkpoint,
                   type=str2bool)
    p.add_argument("--remat_policy", default=d.remat_policy,
                   choices=["full", "dots"])
    p.add_argument("--scan_blocks", default=d.scan_blocks, type=str2bool)
    p.add_argument("--logdir", type=str, default=d.logdir)
    p.add_argument("--log_formats", type=str, default=d.log_formats)
    p.add_argument("--sample_size", type=int, default=d.sample_size)
    p.add_argument("--sample_freq", type=int, default=d.sample_freq)
    p.add_argument("--sample_steps", type=int, default=d.sample_steps)
    p.add_argument("--class_labels", type=int, nargs="+", default=d.class_labels)
    p.add_argument("--use_classifier", type=str, default=d.use_classifier)
    p.add_argument("--guidance_scale", type=float, default=d.guidance_scale)
    p.add_argument("--interval", type=float, nargs=2, default=list(d.interval),
                   metavar=("t_from", "t_to"))
    p.add_argument("--vae", type=str, choices=["ema", "mse"], default=d.vae)
    p.add_argument("--solver", type=str, default=d.solver)
    p.add_argument("--discretization", type=str, default=d.discretization,
                   choices=["vp", "ve", "iddpm", "edm"])
    p.add_argument("--schedule", type=str, default=d.schedule,
                   choices=["vp", "ve", "linear"])
    p.add_argument("--scaling", type=str, default=d.scaling,
                   choices=["vp", "none"])
    p.add_argument("--save_step", type=int, default=d.save_step)
    p.add_argument("--eval_step", type=int, default=d.eval_step)
    p.add_argument("--num_samples", type=int, default=d.num_samples)
    p.add_argument("--ref_batch", type=str, default=d.ref_batch)
    return p


def add_train_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Flag set of the reference main.py (reference: main.py:36-135)."""
    return _add_common_args(p, _TRAIN_ONLY_DEFAULTS)


def add_sample_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Flag set of the reference sample.py with its default deltas
    (reference: sample.py:20-117)."""
    p = _add_common_args(p, _SAMPLE_DELTAS)
    d = TrainConfig()
    p.add_argument("--save_path", type=str, default=d.save_path)
    p.add_argument("--atol", type=float, default=d.atol)
    p.add_argument("--rtol", type=float, default=d.rtol)
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    kwargs = {k: v for k, v in vars(args).items() if k in fields}
    for tup_field in ("betas", "interval", "time_dist"):
        if tup_field in kwargs and kwargs[tup_field] is not None:
            kwargs[tup_field] = tuple(kwargs[tup_field])
    return TrainConfig(**kwargs)
