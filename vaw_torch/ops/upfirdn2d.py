"""upfirdn2d: upsample, FIR filter, downsample (StyleGAN2 resampling).

Counterpart of vaw_tpu/ops/upfirdn2d.py (reference:
tools/op/upfirdn2d.py:149-209, the native path). The JAX package runs it
as one ``lax.conv_general_dilated``, not a Pallas kernel, so the port has
no kernel for it either: the filter is one depthwise ``F.conv2d``
(``groups=C``, cuDNN on the card) with the kernel flipped, which autograd
differentiates to any order.

Layout as in the JAX package: NHWC ``x``, a ``[kh, kw]`` filter applied
per channel, ``up``/``down`` an int or an ``(x, y)`` tuple, and ``pad``
``(p0, p1)`` on both axes or ``(x0, x1, y0, y1)``. Torch has no lhs
dilation, so the upsample zero-stuffs explicitly to ``h * up`` rows, the
reference's ``up - 1`` trailing zeros kept (JAX folds them into its conv
padding); a negative pad crops.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["upfirdn2d", "make_kernel", "upsample2d", "downsample2d", "blur",
           "no_weight_gradients"]


def make_kernel(k) -> np.ndarray:
    """Normalize a 1D/2D FIR kernel (StyleGAN2 make_kernel semantics)."""
    k = np.asarray(k, dtype=np.float64)
    if k.ndim == 1:
        k = np.outer(k, k)
    k /= k.sum()
    return k.astype(np.float32)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def upfirdn2d(x: torch.Tensor, kernel, up=1, down=1, pad=(0, 0)) -> torch.Tensor:
    """x: [N, H, W, C]; kernel: [kh, kw] FIR filter applied per channel.

      1. zero-stuff by `up` (up-1 zeros after each pixel),
      2. pad by (pad[0], pad[1]) on both spatial axes, or (x0, x1) and
         (y0, y1) for a 4-tuple (a negative pad crops),
      3. convolve with `kernel`,
      4. subsample by `down`.
    Returns [N, H', W', C] in x's dtype.
    """
    up_x, up_y = _pair(up)
    down_x, down_y = _pair(down)
    pad_x0, pad_x1 = pad[0], pad[1]
    pad_y0, pad_y1 = (pad[2], pad[3]) if len(pad) == 4 else (pad[0], pad[1])

    n, h, w, c = x.shape
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    kh, kw = k.shape
    # The reference correlates with the flipped kernel (a true convolution);
    # F.conv2d correlates, so flip here. One filter per channel.
    weight = k.flip(0, 1).reshape(1, 1, kh, kw).expand(c, 1, kh, kw)

    out = x.permute(0, 3, 1, 2)  # NCHW view
    if up_x > 1 or up_y > 1:
        out = F.pad(out.reshape(n, c, h, 1, w, 1), (0, up_x - 1, 0, 0, 0, up_y - 1))
        out = out.reshape(n, c, h * up_y, w * up_x)
    out = F.pad(out, (max(pad_x0, 0), max(pad_x1, 0), max(pad_y0, 0), max(pad_y1, 0)))
    out = out[:, :, max(-pad_y0, 0): out.shape[2] - max(-pad_y1, 0),
              max(-pad_x0, 0): out.shape[3] - max(-pad_x1, 0)]
    out = F.conv2d(out, weight, stride=(down_y, down_x), groups=c)
    return out.permute(0, 2, 3, 1)


def upsample2d(x, kernel=(1, 3, 3, 1), factor=2, gain=1):
    """StyleGAN2 upsample: zero-stuff + FIR, gain-corrected."""
    k = make_kernel(kernel) * (gain * factor ** 2)
    p = k.shape[0] - factor
    return upfirdn2d(x, k, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample2d(x, kernel=(1, 3, 3, 1), factor=2, gain=1):
    k = make_kernel(kernel) * gain
    p = k.shape[0] - factor
    return upfirdn2d(x, k, down=factor, pad=((p + 1) // 2, p // 2))


def blur(x, kernel=(1, 3, 3, 1), pad=(2, 1)):
    return upfirdn2d(x, make_kernel(kernel), pad=pad)


def no_weight_gradients(conv_fn):
    """The reference's conv2d_gradfix.no_weight_gradients (reference:
    tools/op/conv2d_gradfix.py:22-48): the filter reaches conv_fn detached,
    so no gradient flows to it; x keeps gradients of every order."""

    def wrapped(x, w, *args, **kwargs):
        return conv_fn(x, w.detach(), *args, **kwargs)

    return wrapped
