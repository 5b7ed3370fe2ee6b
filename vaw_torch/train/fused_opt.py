"""Fused AdamW + EMA update over lists of tensors (counterpart of
vaw_tpu/train/fused_opt.py:49-97).

The JAX version is one XLA loop fusion per leaf; here it is a short chain
of ``torch._foreach_*`` kernels over all parameters at once, updating the
params, moments and EMA in place (the JAX version returns new trees). The
semantics are those of optax.adamw(learning_rate=schedule) followed by the
EMA fold (vaw_tpu/train/fused_opt.py:10-16):
  - bias correction with count + 1, saturating at int32 max as
    optax.safe_int32_increment does;
  - weight decay added to the update before the lr scaling;
  - lr evaluated at the pre-increment count;
  - the EMA folded from the new params;
  - the update math in f32 whatever the moments' storage dtype: bf16
    moments (--opt_bf16_moments) are rounded on store, not on load.
A single fused kernel is optional later work.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

__all__ = ["INT32_MAX", "safe_int32_increment", "bias_corrections",
           "fused_adamw_ema"]

INT32_MAX = 2 ** 31 - 1


def safe_int32_increment(count: int) -> int:
    """count + 1, saturating at int32 max instead of wrapping negative
    (optax.safe_int32_increment)."""
    return count + 1 if count < INT32_MAX else INT32_MAX


def bias_corrections(b1: float, b2: float, count_inc: int
                     ) -> Tuple[np.float32, np.float32]:
    """(1 - b1**count_inc, 1 - b2**count_inc) in f32, as optax computes
    them."""
    c = np.float32(count_inc)
    one = np.float32(1.0)
    return one - np.float32(b1) ** c, one - np.float32(b2) ** c


@torch.no_grad()
def fused_adamw_ema(
    params: List[torch.Tensor], grads: List[torch.Tensor],
    mu: List[torch.Tensor], nu: List[torch.Tensor], ema: List[torch.Tensor],
    count: int, *, lr_fn: Callable[[int], float], b1: float, b2: float,
    eps: float, weight_decay: float, ema_decay: float,
) -> int:
    """One AdamW step and EMA fold, in place on params, mu, nu and ema
    (all lists in the same order). Returns the incremented count."""
    count_inc = safe_int32_increment(count)
    bc1, bc2 = bias_corrections(b1, b2, count_inc)
    lr = float(lr_fn(count))
    g = [x.float() for x in grads]
    # f32 working copies of the moments; for f32 storage these alias it.
    m = [x.float() for x in mu]
    v = [x.float() for x in nu]
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, g, alpha=1.0 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
    denom = torch._foreach_div(v, float(bc2))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(m, float(bc1))
    torch._foreach_div_(update, denom)
    if weight_decay:
        torch._foreach_add_(update, params, alpha=weight_decay)
    torch._foreach_add_(params, update, alpha=-lr)
    torch._foreach_mul_(ema, ema_decay)
    torch._foreach_add_(ema, params, alpha=1.0 - ema_decay)
    for store, work in ((mu, m), (nu, v)):
        if store[0].dtype != torch.float32:  # round on store
            torch._foreach_copy_(store, work)
    return count_inc
