"""Nearest-2x upsample followed by a SAME 3x3 conv, unfused and as four
phase convolutions (counterpart of vaw_tpu/ops/upsample_conv.py, which is
plain XLA there and plain PyTorch here: no kernel of its own).

Because nearest upsampling repeats each input pixel into a 2x2 block, every
output pixel of the 3x3 conv over the upsampled image reads only a 2x2
neighbourhood of distinct input pixels, with weights that depend only on the
output's parity (a, b). Grouping the 3x3 taps by the input pixel they land on
gives four 2x2 kernels:

    row tap map (parity a=0): u=0 <- {t=-1},  u=1 <- {t=0, t=+1}
    row tap map (parity a=1): u=0 <- {t=-1, t=0},  u=1 <- {t=+1}

(and the same for columns). One VALID 2x2 conv over the 1-padded input with
the [2, 2, Cin, 4*Cout] phase-stacked kernel computes all four phases, with
2.25x fewer MACs and no upsampled intermediate; the phases interleave back
with a reshape. Autograd flows through the tap sums and the small conv.

Layouts are the JAX package's: images NHWC, kernels HWIO [3, 3, Cin, Cout].
``VAW_FUSED_UPSAMPLE=1`` selects the phase form in the models (default off,
as in the JAX package).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "nearest2x_conv3x3",
    "nearest2x_conv3x3_reference",
    "upsample_nearest2x",
    "fused_upsample_conv_enabled",
]


def fused_upsample_conv_enabled() -> bool:
    """Opt-in switch (VAW_FUSED_UPSAMPLE=1) for the phase-conv form, default
    off as in vaw_tpu/ops/upsample_conv.py:fused_upsample_conv_enabled."""
    return os.environ.get("VAW_FUSED_UPSAMPLE", "0") == "1"


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, 2H, 2W, C] by pixel repetition."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, 2 * h, 2 * w, c)


def _conv_nhwc(x: torch.Tensor, w_hwio: torch.Tensor, padding) -> torch.Tensor:
    """Stride-1 conv of NHWC x with an HWIO kernel, NHWC out (x permuted to
    a channels-last NCHW view, no copy)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), padding=padding)
    return y.permute(0, 2, 3, 1)


def nearest2x_conv3x3_reference(x: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """Unfused: nearest-2x upsample, then SAME 3x3 conv (w3 HWIO)."""
    return _conv_nhwc(upsample_nearest2x(x), w3, padding=1)


def _phase_kernel(w3: torch.Tensor) -> torch.Tensor:
    """[3, 3, Cin, Cout] -> [2, 2, Cin, 4*Cout] phase-stacked kernel; output
    channel block ab = 2a + b holds K_ab (a = row parity)."""
    def groups(w, dim, parity):
        t = w.unbind(dim)
        return [t[0], t[1] + t[2]] if parity == 0 else [t[0] + t[1], t[2]]

    phases = []
    for a in (0, 1):
        rows = groups(w3, 0, a)  # two [3, Cin, Cout] row-combined slabs
        for b in (0, 1):
            phases.append(torch.stack(
                [torch.stack(groups(r, 0, b), dim=0) for r in rows], dim=0))
    return torch.cat(phases, dim=-1)


def nearest2x_conv3x3(x: torch.Tensor, w3: torch.Tensor,
                      kernel_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused nearest-2x upsample + SAME 3x3 conv: x [N, H, W, Cin], w3
    [3, 3, Cin, Cout] -> [N, 2H, 2W, Cout], equal to
    ``nearest2x_conv3x3_reference`` up to the reassociation of the tap
    sums. kernel_dtype casts the phase kernel after the sums (pass the
    compute dtype with an f32 w3 to keep the sums in f32)."""
    n, h, w, _ = x.shape
    cout = w3.shape[-1]
    k = _phase_kernel(w3)
    if kernel_dtype is not None:
        k = k.to(kernel_dtype)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = _conv_nhwc(xp, k, padding=0).reshape(n, h + 1, w + 1, 4, cout)
    # phase (a, b) lives at out[:, q + a, r + b, 2a + b]; interleave to
    # y[:, 2q + a, 2r + b]
    z = torch.stack([out[:, a:a + h, b:b + w, 2 * a + b]
                     for a in (0, 1) for b in (0, 1)], dim=3)  # [N, H, W, 4, Cout]
    z = z.reshape(n, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
    return z.reshape(n, 2 * h, 2 * w, cout)
