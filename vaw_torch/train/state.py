"""Train state (counterpart of vaw_tpu/train/state.py:20-40).

One object holding {step, params, EMA, Adam count/mu/nu} and, under the
loss-aware timestep sampler, its history, keyed by the model's parameter
names. ``params`` are the model's own parameters
(the same storage), so an update in place is the model's update. The step
and the Adam count live on the host as Python ints: a train step reads
neither from the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..core.weighting import ResamplerState

__all__ = ["TrainState", "ema_update"]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    ema: Dict[str, torch.Tensor]
    # optax ScaleByAdamState: count (int32, saturating), mu, nu. optax's
    # schedule count moves in step with it, so one count serves both.
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    # The loss-aware timestep resampler's history on the device; None for
    # uniform sampling (vaw_tpu/train/state.py:24-29).
    resampler: Optional[ResamplerState] = None


@torch.no_grad()
def ema_update(params: List[torch.Tensor], ema: List[torch.Tensor],
               decay: float):
    """ema <- ema * decay + params * (1 - decay), in place
    (reference: tools/trainer.py:12-18)."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, params, alpha=1.0 - decay)
