"""Checkpoints of the train state (counterpart of vaw_tpu/train/checkpoint.py).

A checkpoint of the port is one ``torch.save`` file,
``{logdir}/checkpoint/{model}_{mean_type}_{path_type}_{step}.pt``, holding

    {"params": state_dict, "ema": state_dict,
     "opt": {"count": int, "mu": state_dict, "nu": state_dict},
     "step": int}

with every tensor under the model's state-dict names (the reference
model's names, which vaw_torch.models use) and on the CPU. ``load_checkpoint`` reads the EMA
weights into a model (the sample CLI; a file holding only ``{"ema",
"step"}`` works too); ``load_train_state`` restores the whole state for
--resume. The JAX package's Orbax checkpoints cannot be read without JAX;
carry their state across with vaw_torch.models.convert.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from .state import TrainState

__all__ = ["checkpoint_name", "save_checkpoint", "load_checkpoint",
           "load_train_state"]


def checkpoint_name(cfg, step: int) -> str:
    """(reference: tools/utils.py:101-103)"""
    return f"{cfg.model}_{cfg.mean_type}_{cfg.path_type}_{step}"


def _cpu(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tree.items()}


def save_checkpoint(cfg, step: int, state: TrainState,
                    logdir: Optional[str] = None) -> str:
    """Write `state` to {logdir}/checkpoint/<name>.pt (atomically: a
    reader never sees half a file) and return the path."""
    ckpt_dir = os.path.abspath(os.path.join(logdir or cfg.logdir, "checkpoint"))
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, checkpoint_name(cfg, step) + ".pt")
    payload = {
        "params": _cpu(state.params), "ema": _cpu(state.ema),
        "opt": {"count": int(state.count), "mu": _cpu(state.mu),
                "nu": _cpu(state.nu)},
        "step": int(step),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _read(path: str) -> dict:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"checkpoint {path} not found")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "ema" not in ckpt or "step" not in ckpt:
        raise ValueError(f"{path} is not a vaw_torch checkpoint "
                         "({'ema': state_dict, 'step': int, ...})")
    return ckpt


def load_checkpoint(path: str, model: torch.nn.Module) -> int:
    """Load the EMA weights at `path` into `model` (strictly: every tensor
    must match by name and shape) and return the checkpoint's step."""
    ckpt = _read(path)
    state = dict(ckpt["ema"])
    if "pos_embed" not in model.state_dict():
        # The reference DiT stores its frozen sin-cos table, which the
        # port's DiT recomputes; a learned table (U-ViT's) is loaded.
        state.pop("pos_embed", None)
    model.load_state_dict(state, strict=True)
    return int(ckpt["step"])


@torch.no_grad()
def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor],
               what: str):
    if set(dst) != set(src):
        raise ValueError(f"checkpoint {what} names differ from the model's: "
                         f"{sorted(set(dst) ^ set(src))[:8]}")
    for k, t in dst.items():
        if t.shape != src[k].shape:
            raise ValueError(f"checkpoint {what} {k}: shape "
                             f"{tuple(src[k].shape)}, expected {tuple(t.shape)}")
        t.copy_(src[k])


def load_train_state(path: str, state: TrainState) -> TrainState:
    """Restore params, EMA, Adam count and moments and the step from the
    checkpoint at `path` into `state` (in place, in its dtypes and on its
    device) for --resume."""
    ckpt = _read(path)
    if "params" not in ckpt or "opt" not in ckpt:
        raise ValueError(f"{path} holds EMA weights only, not a train state")
    _copy_into(state.params, ckpt["params"], "params")
    _copy_into(state.ema, ckpt["ema"], "ema")
    _copy_into(state.mu, ckpt["opt"]["mu"], "mu")
    _copy_into(state.nu, ckpt["opt"]["nu"], "nu")
    state.count = int(ckpt["opt"]["count"])
    state.step = int(ckpt["step"])
    return state
