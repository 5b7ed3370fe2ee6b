"""Checkpoint loading.

A checkpoint of the port is one ``torch.save`` file holding
``{"ema": state_dict, "step": int}``, the EMA weights under the reference's
names (those of vaw_torch.models.dit.DiT). The JAX package's Orbax
checkpoints cannot be read without JAX; carry their params across with
vaw_torch.models.convert.flax_dit_to_torch. Saving comes with the training
slice.
"""

from __future__ import annotations

import os

import torch

__all__ = ["load_checkpoint"]


def load_checkpoint(path: str, model: torch.nn.Module) -> int:
    """Load the EMA weights at `path` into `model` (strictly: every tensor
    must match by name and shape) and return the checkpoint's step."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"checkpoint {path} not found")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "ema" not in ckpt or "step" not in ckpt:
        raise ValueError(f"{path} is not a vaw_torch checkpoint "
                         "({'ema': state_dict, 'step': int})")
    state = dict(ckpt["ema"])
    # The reference stores its frozen sin-cos table; the port recomputes it.
    state.pop("pos_embed", None)
    model.load_state_dict(state, strict=True)
    return int(ckpt["step"])
