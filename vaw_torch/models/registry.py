"""Model registry and builder (counterpart of vaw_tpu/models/registry.py;
reference: main.py:30-34, 184-221). The DiT and U-ViT families are ported
so far; the other families raise with the ROADMAP item that ports them."""

from __future__ import annotations

import torch

from .dit import DiT_models
from .uvit import UViT_models

__all__ = ["build_model", "cast_for_compute"]

# Families of the JAX registry that the port has not reached yet.
_NOT_PORTED = {
    "UNet": "ROADMAP A10 (ADM UNet)",
    "ADM": "ROADMAP A10 (ADM UNet)",
    "LDM": "ROADMAP A10 (ADM UNet)",
    "ViT": "ROADMAP A12 (other backbones)",
    "MM-DiT": "ROADMAP A12 (other backbones)",
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
        if cfg.learn_align:
            raise NotImplementedError(
                "the DiT's REPA tap (learn_align) is not ported yet: ROADMAP A13")
        return DiT_models[name](
            image_size=cfg.image_size, patch_size=cfg.patch_size,
            in_channels=cfg.in_chans, num_classes=num_classes,
            learn_sigma=cfg.learn_sigma,
            class_dropout_prob=cfg.drop_label_prob,
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
            compute_dtype=cfg.compute_dtype,
        ).to(device)
    family = max((f for f in _NOT_PORTED if name.startswith(f)), key=len,
                 default=None)
    if family is not None:
        raise NotImplementedError(
            f"{name} is not ported to vaw_torch yet: {_NOT_PORTED[family]}")
    raise ValueError(f"Unsupported model variant: {name}")


@torch.no_grad()
def cast_for_compute(model: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """Cast `model`'s floating parameters and buffers to `dtype` in place,
    for a sampling copy made once, except those under the submodules named
    by ``model.keep_f32`` (U-ViT's head, which the JAX model keeps in f32
    under any compute dtype); they stay f32. Returns the model."""
    keep = tuple(getattr(model, "keep_f32", ()))
    for name, tensor in [*model.named_parameters(), *model.named_buffers()]:
        if tensor.is_floating_point() and name.split(".")[0] not in keep:
            tensor.data = tensor.data.to(dtype)
    return model
