"""Fused multi-head attention read straight from the QKV projection.

Port of the forward of ``vaw_tpu/ops/flash_attention.py:_flash_p6``
(``_fwd_kernel_p6``). On a CUDA tensor ``flash_attention_fused`` launches
the hand-written kernel in ``csrc/flash_fused_fwd.cu`` or raises; on a CPU
tensor it runs ``flash_attention_fused_reference``, the same math in plain
PyTorch. The backward (``_bwd_kernel_p6``) belongs to training and is not
ported yet, so the kernel refuses inputs that need a gradient.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["flash_attention_fused", "flash_attention_fused_reference"]


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
    """Plain version of the kernel: the f32-softmax math of
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


@functools.cache
def _kernel():
    fn = _build.load_library("flash_fused_fwd").vaw_flash_fused_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_fused(
    qkv2d: torch.Tensor, num_heads: int, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-causal MHA of qkv2d [B, T, 3*H*D] (last axis laid out (3, H, D))
    -> (o [B, T, H*D] in the input dtype, lse [B*H, T] f32).

    A CUDA tensor goes to the hand-written kernel; what it does not take
    raises. A CPU tensor goes to ``flash_attention_fused_reference``.
    ``flash_attention_fused.launches`` counts kernel launches."""
    b, t, h, d = _split_dims(qkv2d, num_heads)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if qkv2d.device.type == "cpu":
        return flash_attention_fused_reference(qkv2d, num_heads, scale)
    if qkv2d.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qkv2d.device}")
    if qkv2d.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bf16 or f32, got {qkv2d.dtype}")
    if d % 8 or d > 128:
        raise ValueError(f"kernel takes D % 8 == 0 and D <= 128, got D={d}")
    if not qkv2d.is_contiguous() or qkv2d.data_ptr() % 16:
        raise ValueError("kernel takes a contiguous, 16-byte aligned qkv2d")
    if qkv2d.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "the attention backward (_bwd_kernel_p6) is not ported yet "
            "(ROADMAP B2); call under torch.no_grad() or inference_mode()")
    if max(b, h) > 65535:
        raise ValueError(f"kernel grid takes B, H <= 65535, got B={b}, H={h}")
    out = torch.empty((b, t, h * d), dtype=qkv2d.dtype, device=qkv2d.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=qkv2d.device)
    kernel = _kernel()
    with torch.cuda.device(qkv2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(qkv2d.data_ptr(), out.data_ptr(), lse.data_ptr(),
                     b, t, h, d, float(scale),
                     int(qkv2d.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash_fused_fwd launch failed: CUDA error {err}")
    flash_attention_fused.launches += 1
    return out, lse


flash_attention_fused.launches = 0
