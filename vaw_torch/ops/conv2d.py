"""The UNet's stride-1 3x3 conv as hand-written CUDA kernels (counterpart of
vaw_tpu/ops/conv2d.py).

Port of the two Pallas kernels there:

- ``conv3x3_pallas`` (``_fwd_kernel``), the forward: an implicit GEMM in
  ``csrc/conv3x3_fwd.cu``. The backward's dgrad is the same kernel on the
  180-degree rotated filter with its in and out channels swapped.
- ``conv3x3_wgrad_pallas`` (``_wgrad_kernel``), the filter gradient: a
  split-K GEMM over the pixels in ``csrc/conv3x3_wgrad.cu``.

Layouts are the JAX package's at every public function: x and y NHWC
``[N, H, W, C]``, filters HWIO ``[3, 3, Cin, Cout]``. Padding is 1 on every
side, stride 1. ``conv3x3`` is differentiable (the custom_vjp at
vaw_tpu/ops/conv2d.py:209-229). On a CUDA tensor each wrapper launches its
kernel or raises; on a CPU tensor it runs the plain version
(``conv3x3_reference``, ``conv3x3_wgrad_reference``). Each launching wrapper
counts its launches (``<wrapper>.launches``); a dgrad counts under the
forward.

``use_pallas_conv`` (``VAW_PALLAS_CONV=1``) sends the UNet's stride-1 3x3
convs here, and ``conv3x3_supported`` is the JAX package's gate, copied: the
kernels run exactly where the TPU kernel runs.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["conv3x3", "conv3x3_pallas", "conv3x3_reference", "conv3x3_supported",
           "conv3x3_wgrad_pallas", "conv3x3_wgrad_reference", "use_pallas_conv"]


def use_pallas_conv() -> bool:
    """The switch for the UNet's 3x3 convs (vaw_tpu/ops/conv2d.py:34-38):
    opt-in via VAW_PALLAS_CONV=1, default off as in the JAX package."""
    return os.environ.get("VAW_PALLAS_CONV", "0") == "1"


def conv3x3_supported(shape, cout, tile_h=8, *, itemsize) -> bool:
    """The JAX package's gate (vaw_tpu/ops/conv2d.py:58-97), copied.
    itemsize (required, keyword-only): bytes per element of the conv's
    compute dtype (2 for bf16, 4 for f32). The estimate is the TPU kernel's
    scoped-VMEM budget; the port keeps it so that each shape goes where it
    goes in the JAX package."""
    n, h, w, cin = shape
    if not (h % tile_h == 0 and h >= tile_h and w % 8 == 0):
        return False
    wp = w + 2 + ((-(w + 2)) % 8)
    b = itemsize

    def fwd_est(ci, co):
        ci_p = ci + ((-ci) % 128)
        return (ci_p * 9 * co * b
                + (tile_h + 2) * wp * ci_p * b
                + (tile_h + 2) * wp * 9 * co * 4
                + tile_h * w * co * b)

    cin_p = cin + ((-cin) % 128)
    wgrad_est = ((tile_h + 2) * wp * cin_p * b
                 + (tile_h + 2) * wp * 9 * cout * b
                 + cin_p * 9 * cout * 4
                 + tile_h * w * cout * b)
    est = max(fwd_est(cin, cout), fwd_est(cout, cin), wgrad_est)
    return est <= 12 * 1024 * 1024


def _taps(x: torch.Tensor):
    """The nine shifted [N*H*W, Cin] f32 views of x zero-padded by one
    pixel, by tap (dy, dx) in row-major order."""
    n, h, w, cin = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    for dy in range(3):
        for dx in range(3):
            yield dy, dx, xp[:, dy:dy + h, dx:dx + w].reshape(n * h * w, cin)


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward kernel: the sum of nine shifted
    [N*H*W, Cin] @ [Cin, Cout] products in f32 over the zero-padded x,
    rounded once to x's dtype. x [N, H, W, Cin], w [3, 3, Cin, Cout]."""
    n, h, wd, _ = x.shape
    wf = w.float()
    acc = None
    for dy, dx, tap in _taps(x):
        prod = tap @ wf[dy, dx]
        acc = prod if acc is None else acc + prod
    return acc.reshape(n, h, wd, w.shape[-1]).to(x.dtype)


def conv3x3_wgrad_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of the wgrad kernel: dw[dy, dx] = the shifted
    x[N*H*W, Cin]^T @ g[N*H*W, Cout] in f32, rounded once to x's dtype.
    Returns [3, 3, Cin, Cout]."""
    gf = g.float().reshape(-1, g.shape[-1])
    dw = torch.empty((3, 3, x.shape[-1], g.shape[-1]), dtype=torch.float32,
                     device=x.device)
    for dy, dx, tap in _taps(x):
        dw[dy, dx] = tap.t() @ gf
    return dw.to(x.dtype)


@functools.cache
def _fwd_kernel():
    fn = _build.load_library("conv3x3_fwd").vaw_conv3x3_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _wgrad_lib():
    lib = _build.load_library("conv3x3_wgrad")
    lib.vaw_conv3x3_wgrad_splits.argtypes = [ctypes.c_int] * 6
    lib.vaw_conv3x3_wgrad_splits.restype = ctypes.c_int
    lib.vaw_conv3x3_wgrad.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    lib.vaw_conv3x3_wgrad.restype = ctypes.c_int
    return lib


def _check_image(name: str, x: torch.Tensor, dtype: torch.dtype, device):
    """What both kernels refuse in an NHWC operand; raises rather than fall
    back."""
    if x.device != device or x.device.type != "cuda":
        raise ValueError(f"{name} is on {x.device}; the kernel takes tensors on "
                         f"one CUDA device ({device})")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bf16 or f32, got {dtype}")
    if x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype}, expected {dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"kernel takes a contiguous, 16-byte aligned {name}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"kernel takes fewer than 2**31 elements; {name} has "
                         f"{x.numel()}")


def _check_shape(x: torch.Tensor):
    if x.dim() != 4 or min(x.shape) < 1:
        raise ValueError(f"x must be a non-empty [N, H, W, C], got {tuple(x.shape)}")


def conv3x3_pallas(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = conv3x3(x, w), stride 1, pad 1 (vaw_tpu/ops/conv2d.py:101-137).
    x [N, H, W, Cin] bf16 or f32, w [3, 3, Cin, Cout] (cast to x's dtype)
    -> y [N, H, W, Cout] in x's dtype; f32 sums, one rounding, no bias.

    A CUDA tensor goes to the hand-written kernel; what it does not take
    raises. A CPU tensor goes to ``conv3x3_reference``.
    ``conv3x3_pallas.launches`` counts kernel launches."""
    _check_shape(x)
    n, h, wd, cin = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be [3, 3, {cin}, Cout], got {tuple(w.shape)}")
    cout = w.shape[-1]
    if x.device.type == "cpu":
        return conv3x3_reference(x, w.to(x.dtype))
    _check_image("x", x, x.dtype, x.device)
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    # The kernel's B operand: [Cout, K] with K = (tap, ci) tap-major, padded
    # with zeros to a multiple of 8 so that every row is 16-byte aligned.
    k = 9 * cin
    kpad = k + (-k) % 8
    wk = w.to(x.dtype).permute(3, 0, 1, 2).reshape(cout, k)
    if kpad != k:
        wk = F.pad(wk, (0, kpad - k))
    wk = wk.contiguous()
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    kernel = _fwd_kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(x.data_ptr(), wk.data_ptr(), y.data_ptr(), n, h, wd, cin, cout,
                     kpad, int(x.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"conv3x3_fwd launch failed: CUDA error {err}")
    conv3x3_pallas.launches += 1
    return y


def conv3x3_wgrad_pallas(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw [3, 3, Cin, Cout] of conv3x3(x, .) against the cotangent g
    [N, H, W, Cout] (vaw_tpu/ops/conv2d.py:168-206): f32 sums, cast to x's
    dtype.

    The kernel splits the pixels over blocks, writes f32 partial sums to a
    workspace and adds them in a fixed order in a second kernel, so the
    result does not change from run to run. A CUDA tensor goes to the
    kernels; what they do not take raises. A CPU tensor goes to
    ``conv3x3_wgrad_reference``. ``conv3x3_wgrad_pallas.launches`` counts
    launches."""
    _check_shape(x)
    n, h, wd, cin = x.shape
    if g.dim() != 4 or tuple(g.shape[:3]) != (n, h, wd):
        raise ValueError(f"g must be [{n}, {h}, {wd}, Cout], got {tuple(g.shape)}")
    cout = g.shape[-1]
    if x.device.type == "cpu":
        return conv3x3_wgrad_reference(x, g)
    _check_image("x", x, x.dtype, x.device)
    _check_image("g", g, x.dtype, x.device)
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = _wgrad_lib()
    splits = lib.vaw_conv3x3_wgrad_splits(n, h, wd, cin, cout, is_bf16)
    if splits <= 0:
        raise ValueError(f"wgrad kernel refuses x {tuple(x.shape)}, g {tuple(g.shape)}")
    work = torch.empty((splits, 9 * cin, cout), dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, cin, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vaw_conv3x3_wgrad(x.data_ptr(), g.data_ptr(), work.data_ptr(),
                                    dw.data_ptr(), n, h, wd, cin, cout, splits,
                                    is_bf16, stream)
    if err:
        raise RuntimeError(f"conv3x3_wgrad launch failed: CUDA error {err}")
    conv3x3_wgrad_pallas.launches += 1
    return dw


conv3x3_pallas.launches = 0
conv3x3_wgrad_pallas.launches = 0


class _Conv3x3(torch.autograd.Function):
    """The custom_vjp of vaw_tpu/ops/conv2d.py:209-229: the forward kernel;
    dx is the forward kernel on the rotated, in/out-swapped filter, dw the
    wgrad kernel."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_pallas(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:  # not for the image at the stem
            dx = conv3x3_pallas(g, w.flip(0, 1).transpose(2, 3).to(g.dtype))
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad_pallas(x, g).to(w.dtype)
        return dx, dw


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable 3x3 conv, stride 1, pad 1: x [N, H, W, Cin], w
    [3, 3, Cin, Cout] -> [N, H, W, Cout] in x's dtype."""
    return _Conv3x3.apply(x, w)
