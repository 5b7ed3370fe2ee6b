"""The noisy classifier of classifier guidance (counterpart of
vaw_tpu/samplers/classifier.py; reference: tools/sampler.py:51-80): an
EncoderUNet whose hyperparameters mirror the UNet size being sampled, its
frozen weights read from --use_classifier, exposed as classifier_fn(x, t)
-> logits for ``guidance.classifier_cond_fn``.

The checkpoint is a ``.pt``/``.pth`` state dict under the reference's
names: the file ``save_classifier_checkpoint`` writes, or a guided-diffusion
classifier release (its 1-d conv attention weights are reshaped by
``models.convert.reference_encoder_unet_to_torch``). The JAX package's
Orbax directory is refused: its params convert through
``models.convert.flax_to_torch`` with the port's classifier as ``model``.
The classifier runs in f32 with every weight frozen
(``requires_grad_(False)``), so the guidance gradient is taken with
respect to x alone.
"""

from __future__ import annotations

import os
from typing import Callable, Tuple

import torch

__all__ = ["build_classifier", "save_classifier_checkpoint", "make_classifier_model"]


def make_classifier_model(cfg, device="cuda"):
    """The EncoderUNet of cfg.model's UNet size with pool='attention'
    (reference: tools/sampler.py:58-73; vaw_tpu/samplers/classifier.py:
    make_classifier_model), f32 weights on `device`."""
    from ..models.unet import EncoderUNetModel, UNet_models

    if cfg.model not in UNet_models:
        raise ValueError(
            f"--use_classifier derives the classifier from a UNet variant; model "
            f"{cfg.model!r} is not one of {sorted(UNet_models)} (the reference has the "
            "same constraint: tools/sampler.py:59-73 reads UNet attributes)")
    with torch.device("meta"):  # the size's hyperparameters only, no weights
        unet = UNet_models[cfg.model](num_classes=cfg.num_classes, in_channels=cfg.in_chans,
                                      learn_sigma=cfg.learn_sigma,
                                      class_cond=cfg.class_cond)
    num_head_channels = unet.num_head_channels
    if num_head_channels == -1:
        # attention pooling needs a head size: the model's head count's
        num_head_channels = unet.model_channels // max(unet.num_heads, 1)
    return EncoderUNetModel(
        image_size=unet.image_size, in_channels=cfg.in_chans,
        model_channels=unet.model_channels, out_channels=cfg.num_classes,
        num_res_blocks=unet.num_res_blocks,
        attention_resolutions=unet.attention_resolutions, channel_mult=unet.channel_mult,
        num_head_channels=num_head_channels,
        use_scale_shift_norm=unet.use_scale_shift_norm,
        resblock_updown=unet.resblock_updown, pool="attention").to(device)


def save_classifier_checkpoint(path: str, model: torch.nn.Module) -> None:
    """Write the classifier's state dict with torch.save."""
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)


def build_classifier(cfg, device="cuda") -> Tuple[Callable, torch.nn.Module]:
    """-> (classifier_fn(x, t) -> f32 logits, the frozen EncoderUNetModel)."""
    from ..models.convert import reference_encoder_unet_to_torch

    path = cfg.use_classifier
    model = make_classifier_model(cfg, device=device)
    if os.path.isdir(path):
        raise ValueError(
            f"--use_classifier {path!r} is a directory (the JAX package's Orbax "
            "format); convert its params with vaw_torch.models.convert.flax_to_torch("
            "params, model=<the port's classifier>) and torch.save the state dict")
    if not path.endswith((".pt", ".pth")):
        raise ValueError(f"--use_classifier {path!r}: expected a .pt or .pth state dict")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(reference_encoder_unet_to_torch(sd, model), strict=True)
    model.requires_grad_(False).eval()

    def classifier_fn(x, t):
        return model(x.float(), t).float()

    return classifier_fn, model
