"""Fused bias + leaky ReLU x scale, the StyleGAN2 fused_bias_act op, as a
hand-written CUDA kernel (counterpart of vaw_tpu/ops/fused_act.py; reference:
tools/op/fused_act.py:20-127).

``fused_leaky_relu(x, bias)`` computes
``where(x + b >= 0, x + b, (x + b) * slope) * scale`` with the bias on the
trailing (NHWC channel) axis. Its forward is ``csrc/fused_act.cu`` (the
Pallas ``_kernel``); its backward is written in differentiable torch ops,
from the JAX package's JVP (``grad * where(y >= 0, 1, slope) * scale``, and
for the bias the sum over every axis but the last), so a second derivative
works as JAX's "any order" does. On a CUDA tensor the forward launches the
kernel or raises; on a CPU tensor it runs ``fused_leaky_relu_reference``.
``fused_leaky_relu.launches`` counts kernel launches.

x and the bias share one dtype, bf16 or f32, as in the JAX kernel (whose
output ref refuses the f32 values a bf16 x with an f32 bias would give).
Arithmetic follows it: in bf16 each of the add, the slope multiply and the
scale multiply rounds to bf16, with slope and scale themselves rounded to
bf16 as JAX rounds its weak-typed Python constants.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import nn

from . import _build

__all__ = ["FusedLeakyReLU", "fused_leaky_relu", "fused_leaky_relu_reference"]


def _constant(value: float, dtype: torch.dtype) -> float:
    """value as it is after rounding to dtype."""
    return float(torch.tensor(value, dtype=dtype))


def fused_leaky_relu_reference(x: torch.Tensor, bias: torch.Tensor,
                               negative_slope: float = 0.2,
                               scale: float = 2 ** 0.5) -> torch.Tensor:
    """Plain version of the kernel, in x's dtype with the constants rounded
    to it."""
    y = x + bias
    slope = _constant(negative_slope, x.dtype)
    return torch.where(y >= 0, y, y * slope) * _constant(scale, x.dtype)


@functools.cache
def _kernel():
    fn = _build.load_library("fused_act").vaw_fused_leaky_relu
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, bias: torch.Tensor):
    if bias.dim() != 1 or x.dim() < 1 or x.shape[-1] != bias.shape[0]:
        raise ValueError(f"bias must be [C] with C the last axis of x, got x "
                         f"{tuple(x.shape)} and bias {tuple(bias.shape)}")
    if bias.dtype != x.dtype:
        raise TypeError(f"bias must be in x's dtype {x.dtype}, got {bias.dtype}")


def _forward(x: torch.Tensor, bias: torch.Tensor, negative_slope: float,
             scale: float) -> torch.Tensor:
    _check(x, bias)
    if x.device.type == "cpu":
        return fused_leaky_relu_reference(x, bias, negative_slope, scale)
    if x.device.type != "cuda" or bias.device != x.device:
        raise ValueError(f"x and bias must be on one CUDA device, got {x.device} "
                         f"and {bias.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bf16 or f32, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16 or not bias.is_contiguous():
        raise ValueError("kernel takes a contiguous, 16-byte aligned x and a "
                         "contiguous bias")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    kernel = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(x.data_ptr(), bias.data_ptr(), out.data_ptr(), x.numel(),
                     x.shape[-1], _constant(negative_slope, x.dtype),
                     _constant(scale, x.dtype), int(x.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"fused_act launch failed: CUDA error {err}")
    fused_leaky_relu.launches += 1
    return out


def _vjp(x: torch.Tensor, bias: torch.Tensor, g: torch.Tensor, negative_slope: float,
         scale: float):
    """(dx, dbias) from the JAX package's JVP (vaw_tpu/ops/fused_act.py:
    70-79), in differentiable torch ops: the derivative is a mask of scale
    and slope * scale, computed in f32 and rounded to x's dtype as JAX casts
    its weak-typed mask, so it can be differentiated again."""
    mult = torch.where(x + bias >= 0,
                       torch.tensor(scale, dtype=torch.float32, device=x.device),
                       torch.tensor(negative_slope * scale, dtype=torch.float32,
                                    device=x.device))
    gx = g.to(x.dtype) * mult.to(x.dtype)
    return gx, gx.sum(dim=tuple(range(gx.dim() - 1)))


class _FusedLeakyReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        ctx.save_for_backward(x, bias)
        ctx.negative_slope, ctx.scale = negative_slope, scale
        return _forward(x, bias, negative_slope, scale)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        dx, dbias = _vjp(x, bias, g, ctx.negative_slope, ctx.scale)
        return dx, dbias, None, None


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2,
                     scale: float = 2 ** 0.5) -> torch.Tensor:
    """leaky_relu(x + bias, negative_slope) * scale, bias [C] on x's last
    axis, differentiable to any order in x and bias (reference:
    tools/op/fused_act.py:78-127)."""
    return _FusedLeakyReLU.apply(x, bias, float(negative_slope), float(scale))


fused_leaky_relu.launches = 0


class FusedLeakyReLU(nn.Module):
    """The module form (reference: tools/op/fused_act.py:78-92): a zero
    initialised f32 bias of `channels` values on the last axis of its
    input, cast to the input's dtype on each call. The JAX package's shim
    takes the bias from the caller's Flax parameter tree instead."""

    def __init__(self, channels: int, negative_slope: float = 0.2,
                 scale: float = 2 ** 0.5):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))
        self.negative_slope = negative_slope
        self.scale = scale

    def forward(self, x):
        return fused_leaky_relu(x, self.bias.to(x.dtype), self.negative_slope, self.scale)
