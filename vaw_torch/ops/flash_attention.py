"""Flash attention of the port: the fused-projection kernels of the DiT and
the general-T kernels of every other model.

Port of two families of ``vaw_tpu/ops/flash_attention.py``:

- ``_flash_p6``, the DiT's attention read straight from the raw QKV
  projection ``[B, T, 3*H*D]``: its forward (``_fwd_kernel_p6``) is
  ``csrc/flash_fused_fwd.cu`` (TMA + wgmma in bf16, through the view
  ``fused_tensor_map``) and its backward (``_bwd_kernel_p6``)
  ``csrc/flash_fused_bwd.cu`` (mma.sync and FMA kernels) or, for bf16 with
  D <= 64, the general backward's TMA + wgmma pair of ``csrc/flash_bwd.cu``
  on the three views of the packed row (``flash_fused_bwd_design``); entry
  ``flash_attention_fused``.
- ``_flash``, the general-T kernel over ``[B, Tq, H, D]`` / ``[B, Tk, H, D]``
  with Tq and Tk independent and D <= 256: its forward (``_fwd_kernel``) is
  ``csrc/flash_fwd.cu`` and its backward (``_bwd_kernel``)
  ``csrc/flash_bwd.cu`` (TMA + wgmma in bf16 through one tensor map per
  view, ``general_tensor_map``; the kernel is chosen by the call,
  ``flash_fwd_design`` and ``flash_bwd_design``); entries
  ``flash_attention`` (three tensors) and ``flash_attention_packed`` (q, k
  and v as strided views of one packed ``[B, T, 3, H, D]`` projection, and
  one packed gradient).
- ``_flash_p5``, the d-major packed kernel over ``[B, 3, H, D, T]`` (T the
  unit stride) that ``flash_attention_packed`` takes where the JAX package
  does (``_packed5_supported``: T = 256): its forward (``_fwd_kernel_p5``)
  is ``csrc/flash_p5_fwd.cu`` (TMA + wgmma in bf16; the kernel is chosen
  by shape, ``flash_p5_fwd_design``) and its backward (``_bwd_kernel_p5``)
  ``csrc/flash_p5_bwd.cu`` (TMA + wgmma in bf16 for D <= 64,
  ``flash_p5_bwd_design``); entry ``flash_attention_p5``.

Each entry is differentiable: an autograd Function keeps the inputs, o and
lse from the forward and recomputes P from lse in the backward. On a CUDA
tensor both directions launch the hand-written kernels or raise; on a CPU
tensor they run the plain versions (``*_reference``), the same math in
plain PyTorch. Each launching wrapper counts its launches
(``<entry>.launches``; every entry but the fused forward also by kernel,
``<entry>.launches_by_design``: ``flash_attention``,
``flash_attention_bwd``, ``flash_attention_fused_bwd``,
``flash_attention_p5`` and ``flash_attention_p5_bwd``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = [
    "KERNEL_DESIGNS",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_reference",
    "flash_attention_fwd",
    "flash_attention_packed",
    "flash_attention_reference",
    "flash_bwd_design",
    "flash_fused_bwd_design",
    "flash_fwd_design",
    "flash_attention_fused",
    "flash_attention_fused_bwd",
    "flash_attention_fused_reference",
    "flash_attention_fused_bwd_reference",
    "fused_tensor_map",
    "general_tensor_map",
    "flash_attention_p5",
    "flash_attention_p5_bwd",
    "flash_attention_p5_bwd_reference",
    "flash_attention_p5_fwd",
    "flash_attention_p5_reference",
    "flash_p5_bwd_design",
    "flash_p5_fwd_design",
]

# The bf16 and f32 kernels of the attention entries that choose among
# several, by the name their launches are counted under.
KERNEL_DESIGNS = ("wgmma", "mma_sync", "fma")


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


def fused_tensor_map(b: int, t: int, h: int, d: int, itemsize: int):
    """The bf16 forward kernel's TMA view of qkv2d [B, T, 3*H*D]: the dims
    of [B, T, 3, H, D] innermost first, and the byte strides of all but the
    innermost. TMA takes only strides that are multiples of 16 bytes, so the
    head dim must be a multiple of 8 (which also makes the row stride
    3*H*D*itemsize one); raises ValueError otherwise."""
    dims = (d, h, 3, t, b)
    strides = (d * itemsize, h * d * itemsize, 3 * h * d * itemsize,
               3 * h * d * itemsize * t)
    if d % 8:
        raise ValueError(f"the TMA view takes D % 8 == 0, got D={d}")
    bad = [s for s in strides if s % 16]
    if bad:
        raise ValueError(f"the TMA view takes strides that are multiples of 16 "
                         f"bytes, got {list(strides)}")
    return dims, strides


def _fused_forward(qkv2d: torch.Tensor, num_heads: int, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, t, h, d = _split_dims(qkv2d, num_heads)
    if qkv2d.device.type == "cpu":
        return flash_attention_fused_reference(qkv2d, num_heads, scale)
    _check_kernel_input("qkv2d", qkv2d, qkv2d.dtype, d)
    if qkv2d.dtype == torch.bfloat16:
        fused_tensor_map(b, t, h, d, qkv2d.element_size())
    if max(b, h) > 65535:
        raise ValueError(f"kernel grid takes B, H <= 65535, got B={b}, H={h}")
    out = torch.empty((b, t, h * d), dtype=qkv2d.dtype, device=qkv2d.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=qkv2d.device)
    with torch.cuda.device(qkv2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        if qkv2d.dtype == torch.bfloat16 and not scale > 0:
            # The bf16 kernel's softmax takes its max on the raw scores, so it
            # takes scale > 0 only; other scales go to the general mma.sync
            # forward on the packed row's three views (the same contract).
            views = qkv2d.view(b, t, 3, h, d).unbind(2)
            err = _general_fwd_kernel()(*(x.data_ptr() for x in views), out.data_ptr(),
                                        lse.data_ptr(), _strides(*views), b, t, t, h, d,
                                        float(scale), 1, stream)
        else:
            err = _fwd_kernel()(qkv2d.data_ptr(), out.data_ptr(), lse.data_ptr(),
                                b, t, h, d, float(scale),
                                int(qkv2d.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash_fused_fwd launch failed: CUDA error {err}")
    flash_attention_fused.launches += 1
    return out, lse


def flash_fused_bwd_design(dtype: torch.dtype, d: int, scale: float) -> str:
    """Which fused backward kernels take a call the wrapper admits (D % 8
    == 0, D <= 128): "wgmma" for bf16 with D <= 64 and scale > 0, the
    general backward's TMA + wgmma pair by ``flash_bwd_design``'s rule (the
    packed row's q, k, v and dq, dk, dv are strided views that TMA maps
    whenever D % 8 == 0), "mma_sync" for other bf16 calls (DiT-XL/2's
    D = 72, any scale <= 0), "fma" for f32. Chosen by the call alone, never
    as a fallback: a launch the kernel refuses raises."""
    return flash_bwd_design(dtype, d, scale)


def flash_attention_fused_bwd(
    qkv2d: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, num_heads: int, scale: Optional[float] = None,
) -> torch.Tensor:
    """Gradient of ``flash_attention_fused``'s o with respect to qkv2d:
    dqkv [B, T, 3*H*D] in the input dtype, laid out like qkv2d (dq | dk |
    dv), from the forward's (qkv2d, o, lse) and the incoming dout.

    A CUDA tensor goes to the hand-written kernels
    ``flash_fused_bwd_design`` picks; what they do not take raises. A CPU
    tensor goes to ``flash_attention_fused_bwd_reference``.
    ``flash_attention_fused_bwd.launches`` counts kernel launches, and
    ``flash_attention_fused_bwd.launches_by_design`` the same by kernel (the
    wgmma launches are not counted under ``flash_attention_bwd``)."""
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
    design = flash_fused_bwd_design(dtype, d, scale)
    with torch.cuda.device(qkv2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        if design == "wgmma":
            # The general pair on the packed row's views: q, k, v and dq, dk,
            # dv are the thirds of [B, T, 3, H, D]; out and dout [B, T, H, D].
            views = qkv2d.view(b, t, 3, h, d).unbind(2)
            grads = dqkv.view(b, t, 3, h, d).unbind(2)
            n = _general_bwd_scratch_floats()(b, t, h)
            scratch = torch.empty(n, dtype=torch.float32, device=qkv2d.device)
            err = _general_bwd_wgmma_kernel()(
                *(x.data_ptr() for x in views), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), scratch.data_ptr(), n, *(g.data_ptr() for g in grads),
                _map_strides(*views, *grads), b, t, t, h, d, float(scale), stream)
        else:
            delta = torch.empty((b * h, t), dtype=torch.float32, device=qkv2d.device)
            err = _bwd_kernel()(qkv2d.data_ptr(), out.data_ptr(), dout.data_ptr(),
                                lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(),
                                b, t, h, d, float(scale), int(dtype == torch.bfloat16),
                                stream)
    if err:
        raise RuntimeError(f"flash_fused_bwd ({design}) launch failed: CUDA error {err}")
    flash_attention_fused_bwd.launches += 1
    flash_attention_fused_bwd.launches_by_design[design] += 1
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
flash_attention_fused_bwd.launches_by_design = dict.fromkeys(KERNEL_DESIGNS, 0)


# ------------------------------------------------------------------ #
# General T (_flash): separate, strided q/k/v [B, Tq|Tk, H, D].
# ------------------------------------------------------------------ #


def _general_dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k and v must be [B, T, H, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if tuple(k.shape) != (b, tk, h, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be [{b}, Tk, {h}, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    return b, tq, tk, h, d


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the general forward kernel, the math of
    ``_fwd_kernel`` (vaw_tpu/ops/flash_attention.py:88-127): q scaled in f32
    before the scores, f32 softmax and P.V. Returns (o [B, Tq, H, D] in the
    input dtype, lse [B*H, Tq] f32)."""
    b, tq, _, h, d = _general_dims(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = (q.float().transpose(1, 2) * scale) @ k.float().permute(0, 2, 3, 1)
    lse = torch.logsumexp(s, dim=-1)  # [b, h, tq]
    o = torch.softmax(s, dim=-1) @ v.float().transpose(1, 2)
    return o.transpose(1, 2).to(q.dtype).contiguous(), lse.reshape(b * h, tq)


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the general backward kernel, the f32 math of
    ``_bwd_kernel`` (vaw_tpu/ops/flash_attention.py:130-175): P recomputed
    from lse, delta = rowsum(dout * out) from the input-dtype out, dk from
    the scaled q, dq scaled after dS k. Returns (dq, dk, dv), contiguous, in
    the input dtype."""
    b, tq, _, h, d = _general_dims(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qs = q.float().transpose(1, 2) * scale  # [b, h, tq, d]
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    o, do = out.float().transpose(1, 2), dout.float().transpose(1, 2)
    delta = (do * o).sum(-1, keepdim=True)
    p = torch.exp(qs @ kf.transpose(-1, -2) - lse.float().reshape(b, h, tq, 1))
    dv = p.transpose(-1, -2) @ do
    ds = p * (do @ vf.transpose(-1, -2) - delta)
    dk = ds.transpose(-1, -2) @ qs
    dq = (ds @ kf) * scale
    return tuple(g.transpose(1, 2).to(q.dtype).contiguous() for g in (dq, dk, dv))


@functools.cache
def _general_fwd_kernel():
    fn = _build.load_library("flash_fwd").vaw_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)] + [
        ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _general_bwd_kernel():
    fn = _build.load_library("flash_bwd").vaw_flash_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_longlong)] + [
        ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _general_fwd_wgmma_kernel():
    fn = _build.load_library("flash_fwd").vaw_flash_fwd_wgmma
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)] + [
        ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _general_bwd_wgmma_kernel():
    fn = _build.load_library("flash_bwd").vaw_flash_bwd_wgmma
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                  ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _general_bwd_scratch_floats():
    fn = _build.load_library("flash_bwd").vaw_flash_bwd_wgmma_scratch_floats
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn


def _check_view(name: str, x: torch.Tensor, dtype: torch.dtype, device):
    """What the general kernels refuse in a [B, T, H, D] view; raises rather
    than fall back."""
    if x.device != device or x.device.type != "cuda":
        raise ValueError(f"{name} is on {x.device}; the kernel takes tensors on "
                         f"one CUDA device ({device})")
    if x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype}, expected {dtype}")
    if x.stride(-1) != 1:
        raise ValueError(f"kernel takes a unit stride over D; {name} has {x.stride()}")
    if x.data_ptr() % 16 or any(s * x.element_size() % 16 for s in x.stride()[:3]):
        raise ValueError(f"kernel takes 16-byte aligned rows; {name} has base "
                         f"{x.data_ptr()} and strides {x.stride()}")


def _check_general(b: int, h: int, d: int, dtype: torch.dtype):
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bf16 or f32, got {dtype}")
    if d % 8 or d > 256:
        raise ValueError(f"kernel takes D % 8 == 0 and D <= 256, got D={d}")
    if max(b, h) > 65535:
        raise ValueError(f"kernel grid takes B, H <= 65535, got B={b}, H={h}")


def _strides(*views: torch.Tensor):
    values = [s for x in views for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(values))(*values)


def _tma_refusal(x: torch.Tensor) -> Optional[str]:
    """Why TMA takes no tensor map of the [B, T, H, D] view x, or None."""
    if x.dim() != 4:
        return f"the TMA view takes a [B, T, H, D] tensor, got {tuple(x.shape)}"
    if x.stride(3) != 1:
        return f"the TMA view takes a unit stride over D, got {x.stride()}"
    strides = [x.stride(i) * x.element_size() for i in (2, 1, 0)]
    if x.data_ptr() % 16 or any(s <= 0 or s % 16 or s >= 1 << 40 for s in strides):
        return (f"the TMA view takes a 16-byte aligned base and strides that are "
                f"positive multiples of 16 bytes, got base {x.data_ptr()} and byte "
                f"strides {strides}")
    return None


def general_tensor_map(x: torch.Tensor) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The bf16 wgmma kernels' TMA view of one [B, T, H, D] tensor (q, k,
    v, or a gradient): the dims of [D, H, T, B] innermost first, and the
    byte strides of H, T and B, the view's own (a packed [B, T, 3, H, D]
    projection's q, k and v share its strides). TMA takes a unit stride over
    D, a 16-byte aligned base and strides that are positive multiples of 16
    bytes below 2**40 (so no stride-0 view, such as a k expanded over the
    heads); raises ValueError otherwise."""
    why = _tma_refusal(x)
    if why:
        raise ValueError(why)
    b, t, h, d = x.shape
    return (d, h, t, b), tuple(x.stride(i) * x.element_size() for i in (2, 1, 0))


def _map_strides(*views: torch.Tensor):
    """The byte strides of each view's tensor map, for the wgmma entries."""
    values = [s for x in views for s in general_tensor_map(x)[1]]
    return (ctypes.c_longlong * len(values))(*values)


def flash_fwd_design(dtype: torch.dtype, d: int, scale: float,
                     views: Tuple[torch.Tensor, ...] = ()) -> str:
    """Which general forward kernel takes a call the wrapper admits (D % 8
    == 0, D <= 256): "wgmma" (TMA + wgmma) for bf16 with D <= 128, scale > 0
    (its softmax takes the max on the raw scores) and `views` (q, k, v) that
    each have a tensor map (``general_tensor_map``: not a stride-0 view),
    "mma_sync" for other bf16 calls, "fma" for f32. Chosen by the call
    alone, never as a fallback: a launch the kernel refuses raises."""
    if dtype == torch.float32:
        return "fma"
    mapped = not any(_tma_refusal(x) for x in views)
    return "wgmma" if d <= 128 and scale > 0 and mapped else "mma_sync"


def flash_bwd_design(dtype: torch.dtype, d: int, scale: float,
                     views: Tuple[torch.Tensor, ...] = ()) -> str:
    """Which general backward kernels take a call the wrapper admits:
    "wgmma" (TMA + wgmma) for bf16 with D <= 64 (the registers of a dK/dV
    warpgroup's two accumulators and its P and dS fragments), scale > 0
    and `views` (q, k, v, dq, dk, dv) that each have a tensor map, as the
    forward, "mma_sync" for other bf16 calls, "fma" for f32. Chosen by the
    call alone, never as a fallback."""
    if dtype == torch.float32:
        return "fma"
    mapped = not any(_tma_refusal(x) for x in views)
    return "wgmma" if d <= 64 and scale > 0 and mapped else "mma_sync"


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One general forward: q [B, Tq, H, D], k and v [B, Tk, H, D], each
    with any batch, token and head strides -> (o [B, Tq, H, D] contiguous in
    the input dtype, lse [B*H, Tq] f32). Not differentiable; see
    ``flash_attention``.

    A CUDA tensor goes to the hand-written kernel ``flash_fwd_design``
    picks; what it does not take raises. A CPU tensor goes to
    ``flash_attention_reference``. ``flash_attention.launches`` counts
    kernel launches, and ``flash_attention.launches_by_design`` the same by
    kernel."""
    b, tq, tk, h, d = _general_dims(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    _check_general(b, h, d, q.dtype)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_view(name, x, q.dtype, q.device)
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    design = flash_fwd_design(q.dtype, d, scale, (q, k, v))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if design == "wgmma":
            err = _general_fwd_wgmma_kernel()(*ptrs, _map_strides(q, k, v), b, tq, tk, h,
                                              d, float(scale), stream)
        else:
            err = _general_fwd_kernel()(*ptrs, _strides(q, k, v), b, tq, tk, h, d,
                                        float(scale), int(q.dtype == torch.bfloat16),
                                        stream)
    if err:
        raise RuntimeError(f"flash_fwd ({design}) launch failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_design[design] += 1
    return out, lse


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, scale: Optional[float] = None,
    grads: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradient of ``flash_attention``'s o with respect to q, k and v:
    (dq, dk, dv) in the input dtype, from the forward's (q, k, v, o, lse)
    and the incoming dout [B, Tq, H, D]. `grads`, if given, are the three
    tensors to write (views of one packed gradient, say), each shaped like
    its input; otherwise they are allocated.

    A CUDA tensor goes to the hand-written kernels ``flash_bwd_design``
    picks; what they do not take raises. A CPU tensor goes to
    ``flash_attention_bwd_reference``. ``flash_attention_bwd.launches``
    counts kernel launches, and ``flash_attention_bwd.launches_by_design``
    the same by kernel."""
    b, tq, tk, h, d = _general_dims(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if grads is not None and [tuple(g.shape) for g in grads] != [
            tuple(x.shape) for x in (q, k, v)]:
        raise ValueError("grads must be shaped like q, k and v")
    if q.device.type == "cpu":
        ref = flash_attention_bwd_reference(q, k, v, out, lse, dout, scale)
        if grads is None:
            return ref
        for g, r in zip(grads, ref):
            g.copy_(r)
        return tuple(grads)
    dtype, device = q.dtype, q.device
    _check_general(b, h, d, dtype)
    if grads is None:
        grads = tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                      for x in (q, k, v))
    for name, x in (("q", q), ("k", k), ("v", v), ("dq", grads[0]),
                    ("dk", grads[1]), ("dv", grads[2])):
        _check_view(name, x, dtype, device)
    for name, x, shape, want in (("out", out, (b, tq, h, d), dtype),
                                 ("dout", dout, (b, tq, h, d), dtype),
                                 ("lse", lse, (b * h, tq), torch.float32)):
        if tuple(x.shape) != shape or x.dtype != want or x.device != device:
            raise ValueError(f"{name} must be a {want} {list(shape)} on {device}, "
                             f"got {x.dtype} {list(x.shape)} on {x.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"kernel takes a contiguous, 16-byte aligned {name}")
    design = flash_bwd_design(dtype, d, scale, (q, k, v, *grads))
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
              lse.data_ptr())
    outputs = tuple(g.data_ptr() for g in grads)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        if design == "wgmma":
            n = _general_bwd_scratch_floats()(b, tq, h)
            scratch = torch.empty(n, dtype=torch.float32, device=device)
            err = _general_bwd_wgmma_kernel()(*inputs, scratch.data_ptr(), n, *outputs,
                                              _map_strides(q, k, v, *grads), b, tq, tk,
                                              h, d, float(scale), stream)
        else:
            delta = torch.empty((b * h, tq), dtype=torch.float32, device=device)
            err = _general_bwd_kernel()(*inputs, delta.data_ptr(), *outputs,
                                        _strides(q, k, v, *grads), b, tq, tk, h, d,
                                        float(scale), int(dtype == torch.bfloat16),
                                        stream)
    if err:
        raise RuntimeError(f"flash_bwd ({design}) launch failed: CUDA error {err}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_design[design] += 1
    return tuple(grads)


class _Flash(torch.autograd.Function):
    """o = attention(q, k, v); the backward recomputes P from the saved lse
    (the custom_vjp of vaw_tpu's _flash)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         ctx.scale)
        return dq, dk, dv, None


class _FlashPacked(torch.autograd.Function):
    """o = attention of the three views of one packed qkv; the backward
    writes dq | dk | dv into one gradient laid out like qkv."""

    @staticmethod
    def forward(ctx, qkv, scale):
        out, lse = flash_attention_fwd(*qkv.unbind(2), scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        dqkv = torch.empty_like(qkv)
        flash_attention_bwd(*qkv.unbind(2), out, lse, dout.contiguous(), ctx.scale,
                            grads=dqkv.unbind(2))
        return dqkv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal MHA: q [B, Tq, H, D], k and v [B, Tk, H, D] -> o
    [B, Tq, H, D] in the input dtype, f32 online softmax, differentiable in
    q, k and v (vaw_tpu/ops/flash_attention.py:flash_attention).

    A CUDA tensor goes to the hand-written kernels; what they do not take
    raises. A CPU tensor goes to the plain versions.
    ``flash_attention.launches`` counts forward kernel launches."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return _Flash.apply(q, k, v, float(scale))


# ------------------------------------------------------------------ #
# d-major packed (_flash_p5): f5 [B, 3, H, D, T], T the unit stride; q, k
# and v are its three sections.
# ------------------------------------------------------------------ #


def _p5_dims(f5: torch.Tensor) -> Tuple[int, int, int, int]:
    if f5.dim() != 5 or f5.shape[1] != 3:
        raise ValueError(f"f5 must be [B, 3, H, D, T], got {tuple(f5.shape)}")
    b, _, h, d, t = f5.shape
    return b, h, d, t


def _p5_sections(f5: torch.Tensor, scale: float):
    """q * scale, k and v of f5 in f32, each [B*H, D, T]."""
    b, h, d, t = _p5_dims(f5)
    q, k, v = (f5[:, i].float().reshape(b * h, d, t) for i in range(3))
    return q * scale, k, v


def flash_attention_p5_reference(
    f5: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the p5 forward kernel, the math of ``_fwd_kernel_p5``
    (vaw_tpu/ops/flash_attention.py:414-440): q scaled in f32 before the
    scores, f32 softmax and P.V. Returns (o [B*H, D, T] d-major in the input
    dtype, lse [B*H, T] f32)."""
    b, h, d, t = _p5_dims(f5)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q, k, v = _p5_sections(f5, scale)
    s = q.transpose(1, 2) @ k  # [bh, tq, tk]
    lse = torch.logsumexp(s, dim=-1)
    o = v @ torch.softmax(s, dim=-1).transpose(1, 2)  # [bh, d, tq]
    return o.to(f5.dtype), lse


def flash_attention_p5_bwd_reference(
    f5: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the p5 backward kernel, the f32 math of
    ``_bwd_kernel_p5`` (vaw_tpu/ops/flash_attention.py:443-477): P
    recomputed from lse, delta = rowsum(dout * out) from the input-dtype
    out, dk from the scaled q, dq scaled after dS k. out and dout are
    [B*H, D, T]. Returns dqkv [B, 3, H, D, T] (dq | dk | dv) in the input
    dtype."""
    b, h, d, t = _p5_dims(f5)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q, k, v = _p5_sections(f5, scale)
    o, do = out.float(), dout.float()
    delta = (do * o).sum(1)[:, :, None]  # [bh, tq, 1]
    p = torch.exp(q.transpose(1, 2) @ k - lse.float()[:, :, None])  # [bh, tq, tk]
    dv = do @ p
    ds = p * (do.transpose(1, 2) @ v - delta)
    dk = q @ ds
    dq = (k @ ds.transpose(1, 2)) * scale
    dqkv = torch.stack([g.reshape(b, h, d, t) for g in (dq, dk, dv)], dim=1)
    return dqkv.to(f5.dtype)


@functools.cache
def _p5_fwd_kernel():
    fn = _build.load_library("flash_p5_fwd").vaw_flash_p5_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _p5_fwd_wgmma_kernel():
    fn = _build.load_library("flash_p5_fwd").vaw_flash_p5_fwd_wgmma
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _p5_bwd_kernel():
    fn = _build.load_library("flash_p5_bwd").vaw_flash_p5_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _p5_bwd_wgmma_kernel():
    fn = _build.load_library("flash_p5_bwd").vaw_flash_p5_bwd_wgmma
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p] + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _p5_bwd_scratch_floats():
    fn = _build.load_library("flash_p5_bwd").vaw_flash_p5_bwd_wgmma_scratch_floats
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn


def _check_p5(f5: torch.Tensor, b: int, h: int, d: int, t: int):
    """What the p5 kernels refuse in f5; raises rather than fall back."""
    _check_kernel_input("f5", f5, f5.dtype, d)
    if t % 8:
        raise ValueError(f"kernel takes T % 8 == 0 (16-byte rows), got T={t}")
    if max(b, h) > 65535:
        raise ValueError(f"kernel grid takes B, H <= 65535, got B={b}, H={h}")


def flash_p5_fwd_design(dtype: torch.dtype, scale: float) -> str:
    """Which p5 forward kernel takes a call the wrapper admits (D % 8 == 0,
    D <= 128, T % 8 == 0): "wgmma" (TMA + wgmma) for bf16 with scale > 0
    (its softmax takes the max on the raw scores), "mma_sync" for bf16 with
    scale <= 0, "fma" for f32. Chosen by the call alone, never as a
    fallback: a launch the kernel refuses raises."""
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if scale > 0 else "mma_sync"


def flash_p5_bwd_design(dtype: torch.dtype, d: int, scale: float) -> str:
    """Which p5 backward kernels take a call the wrapper admits (D % 8 ==
    0, D <= 128, T % 8 == 0): "wgmma" (TMA + wgmma) for bf16 with D <= 64
    (a dK/dV warpgroup holds two accumulators and P's and dS's fragments in
    registers) and scale > 0, "mma_sync" for other bf16 calls, "fma" for
    f32. Chosen by the call alone, never as a fallback."""
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if d <= 64 and scale > 0 else "mma_sync"


def flash_attention_p5_fwd(
    f5: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One p5 forward: f5 [B, 3, H, D, T] contiguous -> (o [B*H, D, T]
    d-major in the input dtype, lse [B*H, T] f32). Not differentiable; see
    ``flash_attention_p5``.

    A CUDA tensor goes to the hand-written kernel ``flash_p5_fwd_design``
    picks; what it does not take raises. A CPU tensor goes to
    ``flash_attention_p5_reference``. ``flash_attention_p5.launches``
    counts kernel launches, and ``flash_attention_p5.launches_by_design``
    the same by kernel."""
    b, h, d, t = _p5_dims(f5)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if f5.device.type == "cpu":
        return flash_attention_p5_reference(f5, scale)
    _check_p5(f5, b, h, d, t)
    out = torch.empty((b * h, d, t), dtype=f5.dtype, device=f5.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=f5.device)
    design = flash_p5_fwd_design(f5.dtype, scale)
    with torch.cuda.device(f5.device):
        stream = torch.cuda.current_stream().cuda_stream
        if design == "wgmma":
            err = _p5_fwd_wgmma_kernel()(f5.data_ptr(), out.data_ptr(), lse.data_ptr(), b,
                                         h, d, t, float(scale), stream)
        else:
            err = _p5_fwd_kernel()(f5.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, d,
                                   t, float(scale), int(f5.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash_p5_fwd ({design}) launch failed: CUDA error {err}")
    flash_attention_p5.launches += 1
    flash_attention_p5.launches_by_design[design] += 1
    return out, lse


def flash_attention_p5_bwd(
    f5: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Gradient of ``flash_attention_p5``'s o with respect to f5: dqkv
    [B, 3, H, D, T] in the input dtype (dq | dk | dv), from the forward's
    (f5, o, lse) and the incoming dout [B*H, D, T].

    A CUDA tensor goes to the hand-written kernels ``flash_p5_bwd_design``
    picks; what they do not take raises. A CPU tensor goes to
    ``flash_attention_p5_bwd_reference``. ``flash_attention_p5_bwd.launches``
    counts kernel launches, and ``flash_attention_p5_bwd.launches_by_design``
    the same by kernel."""
    b, h, d, t = _p5_dims(f5)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if f5.device.type == "cpu":
        return flash_attention_p5_bwd_reference(f5, out, lse, dout, scale)
    _check_p5(f5, b, h, d, t)
    for name, x, shape, want in (("out", out, (b * h, d, t), f5.dtype),
                                 ("dout", dout, (b * h, d, t), f5.dtype),
                                 ("lse", lse, (b * h, t), torch.float32)):
        if tuple(x.shape) != shape or x.dtype != want or x.device != f5.device:
            raise ValueError(f"{name} must be a {want} {list(shape)} on {f5.device}, "
                             f"got {x.dtype} {list(x.shape)} on {x.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"kernel takes a contiguous, 16-byte aligned {name}")
    dqkv = torch.empty_like(f5)
    design = flash_p5_bwd_design(f5.dtype, d, scale)
    ptrs = (f5.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr())
    with torch.cuda.device(f5.device):
        stream = torch.cuda.current_stream().cuda_stream
        if design == "wgmma":
            n = _p5_bwd_scratch_floats()(b, h, t)
            scratch = torch.empty(n, dtype=torch.float32, device=f5.device)
            err = _p5_bwd_wgmma_kernel()(*ptrs, scratch.data_ptr(), n, dqkv.data_ptr(),
                                         b, h, d, t, float(scale), stream)
        else:
            delta = torch.empty((b * h, t), dtype=torch.float32, device=f5.device)
            err = _p5_bwd_kernel()(*ptrs, delta.data_ptr(), dqkv.data_ptr(), b, h, d, t,
                                   float(scale), int(f5.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash_p5_bwd ({design}) launch failed: CUDA error {err}")
    flash_attention_p5_bwd.launches += 1
    flash_attention_p5_bwd.launches_by_design[design] += 1
    return dqkv


class _FlashP5(torch.autograd.Function):
    """o = attention of the three sections of f5; the backward recomputes P
    from the saved lse and writes one packed dqkv (the custom_vjp of
    vaw_tpu's _flash_p5)."""

    @staticmethod
    def forward(ctx, f5, scale):
        out, lse = flash_attention_p5_fwd(f5, scale)
        ctx.save_for_backward(f5, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        f5, out, lse = ctx.saved_tensors
        return flash_attention_p5_bwd(f5, out, lse, dout.contiguous(), ctx.scale), None


def flash_attention_p5(f5: torch.Tensor,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal MHA of the d-major packed f5 [B, 3, H, D, T] -> o
    [B*H, D, T] d-major in the input dtype, f32 softmax, differentiable in
    f5 (vaw_tpu/ops/flash_attention.py:_flash_p5).

    A CUDA tensor goes to the hand-written kernels; what they do not take
    raises. A CPU tensor goes to the plain versions.
    ``flash_attention_p5.launches`` counts forward kernel launches."""
    _, _, d, _ = _p5_dims(f5)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return _FlashP5.apply(f5, float(scale))


# The JAX package's gate for its zero-copy d-major packed kernel
# (_packed5_supported, _pick_p5_bb and _P5_SWEPT_BYTES of
# vaw_tpu/ops/flash_attention.py:367-411), copied: the packed entry takes
# the p5 kernels exactly where the JAX package does.
_P5_SWEPT_BYTES = 88_080_384


def _packed5_supported(b: int, h: int, d: int, t: int) -> bool:
    if t != 256 or d % 8 or d > 128:
        return False
    for bb in (4, 2, 1):
        rows = bb * h
        if b % bb or (rows % 8 and rows != b * h):
            continue
        if rows * t * t * 16 + rows * d * t * 48 <= _P5_SWEPT_BYTES:
            return True
    return False


def flash_attention_packed(qkv: torch.Tensor, scale: Optional[float] = None,
                           d_major_out: bool = False) -> torch.Tensor:
    """Fused-projection self-attention: qkv [B, T, 3, H, D] -> o
    [B, T, H, D], or d-major [B, H*D, T] with `d_major_out`; differentiable
    in qkv (vaw_tpu/ops/flash_attention.py:flash_attention_packed).

    Where the JAX package runs its d-major packed kernel (T = 256 within
    its VMEM budget, ``_packed5_supported``) qkv is transposed once, as
    there, into f5 [B, 3, H, D, T] for the p5 kernels
    (``flash_attention_p5``), and the [B, T, H, D] result is a view of
    their d-major o. At other shapes the general kernels read q, k and v as
    strided views of qkv (no copy) and write the gradient as one tensor
    laid out like qkv (dq | dk | dv)."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be [B, T, 3, H, D], got {tuple(qkv.shape)}")
    b, t, _, h, d = qkv.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if _packed5_supported(b, h, d, t):
        f5 = qkv.reshape(b, t, 3 * h * d).transpose(1, 2).contiguous()
        out = flash_attention_p5(f5.reshape(b, 3, h, d, t), scale)
        if d_major_out:
            return out.reshape(b, h * d, t)
        return out.reshape(b, h, d, t).permute(0, 3, 1, 2)
    out = _FlashPacked.apply(qkv, float(scale))
    if d_major_out:
        return out.permute(0, 2, 3, 1).reshape(b, h * d, t)
    return out


flash_attention.launches = 0
flash_attention.launches_by_design = dict.fromkeys(KERNEL_DESIGNS, 0)
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_design = dict.fromkeys(KERNEL_DESIGNS, 0)
flash_attention_p5.launches = 0
flash_attention_p5.launches_by_design = dict.fromkeys(KERNEL_DESIGNS, 0)
flash_attention_p5_bwd.launches = 0
flash_attention_p5_bwd.launches_by_design = dict.fromkeys(KERNEL_DESIGNS, 0)
