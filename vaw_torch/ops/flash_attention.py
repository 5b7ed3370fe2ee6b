"""Fused multi-head attention read straight from the QKV projection.

Port of ``vaw_tpu/ops/flash_attention.py:_flash_p6``: its forward
(``_fwd_kernel_p6``) is ``csrc/flash_fused_fwd.cu`` and its backward
(``_bwd_kernel_p6``) is ``csrc/flash_fused_bwd.cu``. ``flash_attention_fused``
is differentiable: an autograd Function keeps (qkv, o, lse) from the forward
and recomputes P from lse in the backward. On a CUDA tensor both directions
launch the hand-written kernels or raise; on a CPU tensor they run
``flash_attention_fused_reference`` and ``flash_attention_fused_bwd_reference``,
the same math in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = [
    "flash_attention_fused",
    "flash_attention_fused_bwd",
    "flash_attention_fused_reference",
    "flash_attention_fused_bwd_reference",
]


def _split_dims(qkv2d: torch.Tensor, num_heads: int) -> Tuple[int, int, int, int]:
    if qkv2d.dim() != 3:
        raise ValueError(f"qkv2d must be [B, T, 3*H*D], got {tuple(qkv2d.shape)}")
    b, t, hd3 = qkv2d.shape
    if hd3 % (3 * num_heads):
        raise ValueError(f"last axis {hd3} is not 3 * num_heads({num_heads}) * D")
    return b, t, num_heads, hd3 // (3 * num_heads)


def flash_attention_fused_reference(
    qkv2d: torch.Tensor, num_heads: int, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: the f32-softmax math of
    ``vaw_tpu/ops/attention.py:_xla_attention``, with P.V also in f32 as in
    ``_fwd_kernel_p6``. Returns (o [B, T, H*D] in the input dtype,
    lse [B*H, T] f32)."""
    b, t, h, d = _split_dims(qkv2d, num_heads)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    f = qkv2d.float().reshape(b, t, 3, h, d).permute(2, 0, 3, 1, 4)  # [3,b,h,t,d]
    q, k, v = f[0] * scale, f[1], f[2]
    s = q @ k.transpose(-1, -2)  # [b, h, t, t]
    lse = torch.logsumexp(s, dim=-1)
    o = torch.softmax(s, dim=-1) @ v  # [b, h, t, d]
    o = o.permute(0, 2, 1, 3).reshape(b, t, h * d).to(qkv2d.dtype)
    return o, lse.reshape(b * h, t)


def flash_attention_fused_bwd_reference(
    qkv2d: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, num_heads: int, scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the backward kernel, the f32 math of
    ``_bwd_kernel_p6`` (vaw_tpu/ops/flash_attention.py:597-623): P is
    recomputed from lse, delta = rowsum(dout * out) uses the input-dtype
    out, dk uses the scaled q and dq is scaled after dS k. Returns dqkv
    [B, T, 3*H*D] in the input dtype, laid out like qkv2d."""
    b, t, h, d = _split_dims(qkv2d, num_heads)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    f = qkv2d.float().reshape(b, t, 3, h, d).permute(2, 0, 3, 1, 4)  # [3,b,h,t,d]
    q, k, v = f[0] * scale, f[1], f[2]
    o = out.float().reshape(b, t, h, d).transpose(1, 2)  # [b, h, t, d]
    do = dout.float().reshape(b, t, h, d).transpose(1, 2)
    delta = (do * o).sum(-1, keepdim=True)  # [b, h, t, 1]
    p = torch.exp(q @ k.transpose(-1, -2) - lse.float().reshape(b, h, t, 1))
    dv = p.transpose(-1, -2) @ do
    ds = p * (do @ v.transpose(-1, -2) - delta)
    dk = ds.transpose(-1, -2) @ q
    dq = (ds @ k) * scale
    dqkv = torch.stack([dq, dk, dv])  # [3, b, h, t, d]
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, t, 3 * h * d).to(qkv2d.dtype)


@functools.cache
def _fwd_kernel():
    fn = _build.load_library("flash_fused_fwd").vaw_flash_fused_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = _build.load_library("flash_fused_bwd").vaw_flash_fused_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_input(name: str, x: torch.Tensor, dtype: torch.dtype, d: int):
    """What both kernels refuse; raises rather than fall back."""
    if x.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {x.device}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bf16 or f32, got {dtype}")
    if x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype}, expected {dtype}")
    if d % 8 or d > 128:
        raise ValueError(f"kernel takes D % 8 == 0 and D <= 128, got D={d}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"kernel takes a contiguous, 16-byte aligned {name}")


def _fused_forward(qkv2d: torch.Tensor, num_heads: int, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, t, h, d = _split_dims(qkv2d, num_heads)
    if qkv2d.device.type == "cpu":
        return flash_attention_fused_reference(qkv2d, num_heads, scale)
    _check_kernel_input("qkv2d", qkv2d, qkv2d.dtype, d)
    if max(b, h) > 65535:
        raise ValueError(f"kernel grid takes B, H <= 65535, got B={b}, H={h}")
    out = torch.empty((b, t, h * d), dtype=qkv2d.dtype, device=qkv2d.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=qkv2d.device)
    kernel = _fwd_kernel()
    with torch.cuda.device(qkv2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(qkv2d.data_ptr(), out.data_ptr(), lse.data_ptr(),
                     b, t, h, d, float(scale),
                     int(qkv2d.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash_fused_fwd launch failed: CUDA error {err}")
    flash_attention_fused.launches += 1
    return out, lse


def flash_attention_fused_bwd(
    qkv2d: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, num_heads: int, scale: Optional[float] = None,
) -> torch.Tensor:
    """Gradient of ``flash_attention_fused``'s o with respect to qkv2d:
    dqkv [B, T, 3*H*D] in the input dtype, laid out like qkv2d (dq | dk |
    dv), from the forward's (qkv2d, o, lse) and the incoming dout.

    A CUDA tensor goes to the hand-written kernel; what it does not take
    raises. A CPU tensor goes to ``flash_attention_fused_bwd_reference``.
    ``flash_attention_fused_bwd.launches`` counts kernel launches."""
    b, t, h, d = _split_dims(qkv2d, num_heads)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if qkv2d.device.type == "cpu":
        return flash_attention_fused_bwd_reference(qkv2d, out, lse, dout,
                                                   num_heads, scale)
    dtype = qkv2d.dtype
    for name, x in (("qkv2d", qkv2d), ("out", out), ("dout", dout)):
        _check_kernel_input(name, x, dtype, d)
    _check_kernel_input("lse", lse, torch.float32, d)
    if out.shape != (b, t, h * d) or dout.shape != (b, t, h * d):
        raise ValueError(f"out and dout must be [{b}, {t}, {h * d}], got "
                         f"{tuple(out.shape)} and {tuple(dout.shape)}")
    if lse.shape != (b * h, t):
        raise ValueError(f"lse must be [{b * h}, {t}], got {tuple(lse.shape)}")
    if len({x.device for x in (qkv2d, out, lse, dout)}) != 1:
        raise ValueError("qkv2d, out, lse and dout must be on one device")
    if max(b, h) > 65535:
        raise ValueError(f"kernel grid takes B, H <= 65535, got B={b}, H={h}")
    dqkv = torch.empty_like(qkv2d)
    delta = torch.empty((b * h, t), dtype=torch.float32, device=qkv2d.device)
    kernel = _bwd_kernel()
    with torch.cuda.device(qkv2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(qkv2d.data_ptr(), out.data_ptr(), dout.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(),
                     b, t, h, d, float(scale), int(dtype == torch.bfloat16),
                     stream)
    if err:
        raise RuntimeError(f"flash_fused_bwd launch failed: CUDA error {err}")
    flash_attention_fused_bwd.launches += 1
    return dqkv


class _FlashFused(torch.autograd.Function):
    """o = attention(qkv2d); the backward recomputes P from the saved lse
    (the custom_vjp of vaw_tpu's _flash_p6)."""

    @staticmethod
    def forward(ctx, qkv2d, num_heads, scale):
        out, lse = _fused_forward(qkv2d, num_heads, scale)
        ctx.save_for_backward(qkv2d, out, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        qkv2d, out, lse = ctx.saved_tensors
        dqkv = flash_attention_fused_bwd(qkv2d, out, lse, dout.contiguous(),
                                         ctx.num_heads, ctx.scale)
        return dqkv, None, None


def flash_attention_fused(
    qkv2d: torch.Tensor, num_heads: int, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-causal MHA of qkv2d [B, T, 3*H*D] (last axis laid out (3, H, D))
    -> (o [B, T, H*D] in the input dtype, lse [B*H, T] f32), differentiable
    in qkv2d through o.

    A CUDA tensor goes to the hand-written kernels; what they do not take
    raises. A CPU tensor goes to the plain versions.
    ``flash_attention_fused.launches`` counts forward kernel launches."""
    _, _, _, d = _split_dims(qkv2d, num_heads)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return _FlashFused.apply(qkv2d, num_heads, float(scale))


flash_attention_fused.launches = 0
flash_attention_fused_bwd.launches = 0
