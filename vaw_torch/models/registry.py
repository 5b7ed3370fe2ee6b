"""Model registry and builder (counterpart of vaw_tpu/models/registry.py;
reference: main.py:30-34, 184-221): the DiT, U-ViT, ViT, MM-DiT and ADM
UNet families. As in the JAX registry, the classifier (EncoderUNetModel,
built by samplers/classifier.py) and the super-resolution UNet
(SuperResModel) are not registered variants."""

from __future__ import annotations

import torch

from .dit import DiT_models
from .layers import GroupNorm32
from .mmdit import MMDiT
from .unet import UNet_models
from .uvit import UViT_models
from .vit import ViT_models

__all__ = ["MMDiT_models", "build_model", "cast_for_compute"]

# MM-DiT sizes follow the reference's hidden = 32 * depth, heads = depth rule
# (reference: encoders/mmdit.py:556-558; vaw_tpu/models/registry.py:13-20).
MMDiT_models = {
    "MM-DiT-S": dict(depth=12),
    "MM-DiT-B": dict(depth=24),
    "MM-DiT-L": dict(depth=32),
}


def build_model(cfg, device="cuda") -> torch.nn.Module:
    """Construct the backbone named by cfg.model with f32 weights on
    `device`, computing in cfg.compute_dtype (bf16 under --amp True) with
    label dropout cfg.drop_label_prob in training. cfg is a TrainConfig or
    any object with the same attribute names. As in the JAX package,
    class_cond=False means an unconditional model whatever num_classes
    says."""
    name = cfg.model
    num_classes = cfg.num_classes if cfg.class_cond else 0
    if name in DiT_models:
        if cfg.learn_align and cfg.scan_blocks:
            # as the JAX DiT refuses it (vaw_tpu/models/dit.py:166-167)
            raise ValueError("scan_blocks is incompatible with the REPA tap "
                             "(learn_align)")
        return DiT_models[name](
            image_size=cfg.image_size, patch_size=cfg.patch_size,
            in_channels=cfg.in_chans, num_classes=num_classes,
            learn_sigma=cfg.learn_sigma, learn_align=cfg.learn_align,
            encoder_depth=cfg.encoder_depth, z_dims=cfg.z_dims,
            class_dropout_prob=cfg.drop_label_prob,
            use_checkpoint=cfg.use_checkpoint, remat_policy=cfg.remat_policy,
            compute_dtype=cfg.compute_dtype,
        ).to(device)
    if name in UNet_models:
        # The UNet sizes fix their own image size (vaw_tpu/models/registry.py:
        # 40-48).
        return UNet_models[name](
            num_classes=cfg.num_classes, in_channels=cfg.in_chans,
            drop_label_prob=cfg.drop_label_prob, dropout=cfg.dropout,
            learn_sigma=cfg.learn_sigma, class_cond=cfg.class_cond,
            use_checkpoint=cfg.use_checkpoint, remat_policy=cfg.remat_policy,
            compute_dtype=cfg.compute_dtype,
        ).to(device)
    if name in UViT_models:
        if cfg.learn_sigma:
            # The reference U-ViT always predicts in_channels
            # (models/uvit.py:185-187): there is no variance head.
            raise ValueError(
                "U-ViT does not support learn_sigma (fixed in_channels "
                "output head); use --learn_sigma False or a UNet/DiT/ViT "
                "backbone")
        return UViT_models[name](
            image_size=cfg.image_size, patch_size=cfg.patch_size,
            in_channels=cfg.in_chans, num_classes=num_classes,
            class_dropout_prob=cfg.drop_label_prob,
            use_checkpoint=cfg.use_checkpoint, remat_policy=cfg.remat_policy,
            compute_dtype=cfg.compute_dtype,
        ).to(device)
    if name in ViT_models:
        return ViT_models[name](
            image_size=cfg.image_size, patch_size=cfg.patch_size,
            in_channels=cfg.in_chans, num_classes=num_classes,
            learn_sigma=cfg.learn_sigma, drop_rate=cfg.dropout,
            drop_label_prob=cfg.drop_label_prob,
            use_checkpoint=cfg.use_checkpoint, remat_policy=cfg.remat_policy,
            compute_dtype=cfg.compute_dtype,
        ).to(device)
    if name in MMDiT_models:
        depth = MMDiT_models[name]["depth"]
        return MMDiT(
            image_size=cfg.image_size, patch_size=cfg.patch_size,
            in_channels=cfg.in_chans, hidden_size=32 * depth, depth=depth,
            num_heads=depth, num_classes=num_classes,
            learn_sigma=cfg.learn_sigma, learn_align=cfg.learn_align,
            encoder_depth=cfg.encoder_depth, z_dims=(cfg.z_dims,),
            class_dropout_prob=cfg.drop_label_prob,
            use_checkpoint=cfg.use_checkpoint, remat_policy=cfg.remat_policy,
            # the reference's 16-grid table, widened for larger token grids
            pos_embed_max_size=max(16, cfg.image_size // cfg.patch_size),
            compute_dtype=cfg.compute_dtype,
        ).to(device)
    raise ValueError(f"Unsupported model variant: {name}")


@torch.no_grad()
def cast_for_compute(model: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """Cast `model`'s floating parameters and buffers to `dtype` in place,
    for a sampling copy made once, except what the JAX model keeps in f32
    under any compute dtype, which stays f32: the top-level submodules named
    by ``model.keep_f32`` (U-ViT's and ViT's heads and ViT's ``to_pixel``,
    the UNet's ``out``, MM-DiT's ``final_layer``), the parameters named by
    ``model.keep_f32_leaves`` wherever they sit (ViT's layer scales), and
    every ``GroupNorm32`` (the UNet's norms). Returns the model."""
    keep = tuple(getattr(model, "keep_f32", ()))
    leaves = tuple(getattr(model, "keep_f32_leaves", ()))
    norms = {name for name, m in model.named_modules() if isinstance(m, GroupNorm32)}
    for name, tensor in [*model.named_parameters(), *model.named_buffers()]:
        owner, _, leaf = name.rpartition(".")
        if (tensor.is_floating_point() and name.split(".")[0] not in keep
                and owner not in norms and leaf not in leaves):
            tensor.data = tensor.data.to(dtype)
    return model
