"""Classifier-free (interval) guidance (counterpart of
vaw_tpu/samplers/guidance.py; reference: tools/sampler.py:10-48).

The EDM sampler plans each step's guidance scale g on the host from the
step's time value (``cfg_scale_for_time``); g = 1 disables guidance exactly,
since uncond + 1*(cond - uncond) == cond. A model that returns a tuple
(MM-DiT's ``(out, zs)``) is unpacked to its first element, as the JAX
wrapper does (vaw_tpu/samplers/guidance.py:79, 87, 95).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["IntervalCFG", "cfg_scale_for_time"]


def cfg_scale_for_time(time_value: float, guidance_scale: float,
                       interval: Tuple[float, float]) -> float:
    """Host-side per-step guidance scale (reference: tools/sampler.py:27-31):
    full scale inside [t_from, t_to) (or everywhere when the interval is
    disabled with negative bounds), 1.0 outside."""
    if abs(guidance_scale - 1.0) < 1e-8:
        return 1.0
    t_from, t_to = interval
    if t_from >= 0 and t_to > t_from:
        return guidance_scale if t_from <= time_value < t_to else 1.0
    return guidance_scale


def _first(out):
    """A model's prediction: the first element of a tuple output."""
    return out[0] if isinstance(out, tuple) else out


class IntervalCFG:
    """Classifier-free guidance by batch doubling
    (reference: tools/sampler.py:33-48). Wraps a model_fn(x, t, y=...) into
    fn(x, t, y, g): [cond; null] double batch -> uncond + g*(cond-uncond).
    When class conditioning is off it reduces to the raw model.

    As in the reference (sampler.py:47-48), the combination is applied to
    the FULL model output, learned-variance channels included; the DiT's
    three-channel ``forward_with_cfg`` is a different rule and is not used.
    """

    def __init__(self, model_fn: Callable, num_classes: int,
                 guidance_scale: float = 1.0,
                 interval: Tuple[float, float] = (-1.0, -1.0),
                 class_cond: bool = True):
        self.model_fn = model_fn
        self.null_label = int(num_classes)
        self.guidance_scale = float(guidance_scale)
        self.interval = interval
        self.class_cond = class_cond

    def __call__(self, x, t, y=None, g=None):
        if not self.class_cond or y is None:
            return _first(self.model_fn(x, t))
        if abs(self.guidance_scale - 1.0) < 1e-8:
            # Guidance at scale 1 is exactly the conditional model; skip the
            # doubled forward.
            return _first(self.model_fn(x, t, y=y))
        if g is None:
            t_from, t_to = self.interval
            # The reference's host-side interval check (sampler.py:27-31);
            # with the interval off the scale does not depend on t, which is
            # then not read back.
            g = (cfg_scale_for_time(float(t.float().mean()), self.guidance_scale,
                                    self.interval)
                 if t_from >= 0 and t_to > t_from else self.guidance_scale)
        y_null = torch.full_like(y, self.null_label)
        out = _first(self.model_fn(torch.cat([x, x]), torch.cat([t, t]),
                                   y=torch.cat([y, y_null])))
        cond, uncond = out.chunk(2, dim=0)
        return uncond + g * (cond - uncond)
