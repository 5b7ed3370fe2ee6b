"""The UNet's stride-1 3x3 conv as hand-written CUDA kernels (counterpart of
vaw_tpu/ops/conv2d.py).

Port of the two Pallas kernels there:

- ``conv3x3_pallas`` (``_fwd_kernel``), the forward: an implicit GEMM in
  ``csrc/conv3x3_fwd.cu``. The backward's dgrad is the same kernel on the
  180-degree rotated filter with its in and out channels swapped. Four
  kernels there, chosen by shape and dtype (``conv3x3_design``): for Cin
  and Cout multiples of 64, TMA + wgmma in bf16 and, in f32, TMA + TF32
  wgmma with each product as three TF32 passes ("tf32x3"); mma.sync for
  the other bf16 shapes (the 3-channel stem) and FMAs for the other f32
  ones (the stem and the 3-channel head).
- ``conv3x3_wgrad_pallas`` (``_wgrad_kernel``), the filter gradient: a
  split-K GEMM over the pixels in ``csrc/conv3x3_wgrad.cu``, its partials
  summed in a fixed order. Four kernels there, chosen by shape and dtype
  (``conv3x3_wgrad_design``): TMA + wgmma for bf16 and, for f32, TMA +
  TF32 wgmma with each product as three TF32 passes ("tf32x3"), both with
  Cin and Cout multiples of 64 and on the split that ``conv3x3_wgrad_plan``
  makes; mma.sync and FMAs for the other shapes.

Layouts are the JAX package's at every public function: x and y NHWC
``[N, H, W, C]``, filters HWIO ``[3, 3, Cin, Cout]``. Padding is 1 on every
side, stride 1. ``conv3x3`` is differentiable (the custom_vjp at
vaw_tpu/ops/conv2d.py:209-229). On a CUDA tensor each wrapper launches its
kernel or raises; on a CPU tensor it runs the plain version
(``conv3x3_reference``, ``conv3x3_wgrad_reference``). Each launching wrapper
counts its launches (``<wrapper>.launches``); a dgrad counts under the
forward, and ``<wrapper>.launches_by_design`` splits each count by kernel.
Each launch also records its FLOPs for ``compiled_flops`` (``ops/flops.py``).

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

from . import _build, flops

__all__ = ["CONV_DESIGNS", "conv3x3", "conv3x3_design", "conv3x3_pallas",
           "conv3x3_reference", "conv3x3_supported", "conv3x3_tf32x3_tiling",
           "conv3x3_wgmma_tiling",
           "conv3x3_wgrad_design", "conv3x3_wgrad_pallas", "conv3x3_wgrad_plan",
           "conv3x3_wgrad_reference", "use_pallas_conv"]

# The kernels of csrc/conv3x3_fwd.cu and of csrc/conv3x3_wgrad.cu, by the
# name their launches are counted under ("tf32x3": the f32 design of either
# on the tensor cores, three TF32 passes a product).
CONV_DESIGNS = ("wgmma", "mma_sync", "fma", "tf32x3")
# Output pixels of a forward wgmma tile (two warpgroups of 64 rows).
WGMMA_TILE_PIXELS = 128
# Pixels of a wgrad wgmma K step (one TMA box; 32 for the 3xTF32 design,
# whose f32 rows hold half as many channels), and the SMs of an H100 SXM,
# which the wgrad's split fills with one wave of blocks.
WGRAD_BOX_PIXELS = 64
WGRAD_TF32X3_BOX_PIXELS = 32
H100_SMS = 132


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


def conv3x3_design(shape, cout: int, dtype: torch.dtype) -> str:
    """Which forward kernel takes a conv of x [N, H, W, Cin] = ``shape`` to
    ``cout`` channels in ``dtype`` (the dgrad is a forward with Cin and Cout
    swapped): for Cin and Cout multiples of 64, "wgmma" (TMA + wgmma) in
    bf16 and "tf32x3" (TMA + TF32 wgmma, three TF32 passes a product) in
    f32; for the other shapes (the 3-channel stem and head) "mma_sync" in
    bf16 and "fma" in f32. Chosen by shape and dtype alone, never as a
    fallback: a launch the kernel refuses raises."""
    cin = shape[-1]
    if cin % 64 == 0 and cout % 64 == 0:
        return "tf32x3" if dtype == torch.float32 else "wgmma"
    return "fma" if dtype == torch.float32 else "mma_sync"


def _pixel_box(h: int, w: int, pixels: int):
    """A box of (images, rows, columns) holding `pixels` pixels (a power of
    two): the image's width rounded up to a power of two (at most
    `pixels`), then as many rows as the height (rounded up) and `pixels`
    allow, then images."""
    bw = min(pixels, 1 << (w - 1).bit_length())
    bh = min(pixels // bw, 1 << (h - 1).bit_length())
    return pixels // (bw * bh), bh, bw


def _tile_channels(cout: int) -> int:
    """BN of a wgmma tile: 192, 128 or 64, the largest that divides Cout."""
    return next(b for b in (192, 128, 64) if cout % b == 0)


def conv3x3_wgmma_tiling(h: int, w: int, cout: int):
    """The wgmma kernel's tile: a box of (images, rows, columns) holding 128
    output pixels (2x64 at W = 64, 4x32 at 32, 8x16 at 16, 2 images of 8x8
    at 8), and the output channels of a tile, BN: 192, 128 or 64, the
    largest that divides Cout. Returns (bni, bh, bw, bn)."""
    return (*_pixel_box(h, w, WGMMA_TILE_PIXELS), _tile_channels(cout))


def conv3x3_tf32x3_tiling(h: int, w: int, cout: int):
    """The 3xTF32 forward's tile: the wgmma kernel's box of 128 output
    pixels, and BN output channels, 96 where it divides Cout, else 64 (its
    f32 accumulator and running sums share a thread's registers). Returns
    (bni, bh, bw, bn)."""
    return (*_pixel_box(h, w, WGMMA_TILE_PIXELS), 96 if cout % 96 == 0 else 64)


def conv3x3_wgrad_design(shape, cout: int, dtype: torch.dtype) -> str:
    """Which wgrad kernel takes x [N, H, W, Cin] = ``shape`` against a
    cotangent of ``cout`` channels in ``dtype``: for Cin and Cout multiples
    of 64, "wgmma" (TMA + wgmma) in bf16 and "tf32x3" (TMA + TF32 wgmma,
    three TF32 passes a product) in f32; for the other shapes (the
    3-channel stem and head) "mma_sync" in bf16 and "fma" in f32. Chosen by
    shape and dtype alone, never as a fallback."""
    cin = shape[-1]
    if cin % 64 == 0 and cout % 64 == 0:
        return "tf32x3" if dtype == torch.float32 else "wgmma"
    return "fma" if dtype == torch.float32 else "mma_sync"


def conv3x3_wgrad_plan(n: int, h: int, w: int, cin: int, cout: int,
                       design: str = "wgmma"):
    """The wgmma or 3xTF32 (`design` "tf32x3") wgrad's tiling and split,
    from the shape alone.

    K steps are boxes of 64 output pixels for wgmma (1x64 at W = 64, 2x32 at
    32, 4x16 at 16, one 8x8 image at 8) and of 32 for tf32x3 (1x32 at W =
    64 and 32, 2x16 at 16, 4x8 at 8), numbered image-major, then row, then
    column. An output tile is three 64-row slabs of dw (rows tap-major, so a
    slab is 64 input channels of one tap) by BN output channels (192, 128 or
    64 for wgmma, the largest that divides Cout; 96 or 64 for tf32x3, whose
    f32 accumulator and running sums share a thread's registers: the one
    whose blocks fill the SMs' waves better, 96 on a tie); there are 3 *
    Cin / 64 * Cout / BN of them. The boxes are cut into `splits` runs of `per` consecutive boxes
    (the last may be shorter, none is empty), about one wave of blocks over
    the H100's 132 SMs in all. Returns (bni, bh, bw, bn, splits, per)."""
    if design == "tf32x3":
        bni, bh, bw = _pixel_box(h, w, WGRAD_TF32X3_BOX_PIXELS)
        boxes = -(-n // bni) * -(-h // bh) * -(-w // bw)
        # BN = 96 where it divides Cout, unless 64 fills the SMs' waves
        # better (one block an SM: at 384 -> 384 BN = 96 makes 72 blocks,
        # 64 makes 108).
        bn = max((b for b in (96, 64) if cout % b == 0),
                 key=lambda b: _wave_fill(_wgrad_blocks(cin, cout, b, boxes)))
    else:
        bni, bh, bw = _pixel_box(h, w, WGRAD_BOX_PIXELS)
        bn = _tile_channels(cout)
        boxes = -(-n // bni) * -(-h // bh) * -(-w // bw)
    tiles = 3 * (cin // 64) * (cout // bn)
    want = max(1, min(H100_SMS // tiles, boxes))
    per = -(-boxes // want)
    return bni, bh, bw, bn, -(-boxes // per), per


def _wgrad_blocks(cin: int, cout: int, bn: int, boxes: int) -> int:
    """Blocks of the wgrad plan: its tiles times about one wave's splits."""
    tiles = 3 * (cin // 64) * (cout // bn)
    return tiles * max(1, min(H100_SMS // tiles, boxes))


def _wave_fill(blocks: int) -> float:
    """The share of the waves' block slots (one block an SM) that `blocks`
    fill."""
    return blocks / (-(-blocks // H100_SMS) * H100_SMS)


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
def _wgmma_kernel():
    fn = _build.load_library("conv3x3_fwd").vaw_conv3x3_fwd_wgmma
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _tf32x3_kernel():
    fn = _build.load_library("conv3x3_fwd").vaw_conv3x3_fwd_tf32x3
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
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
    lib.vaw_conv3x3_wgrad_wgmma.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    lib.vaw_conv3x3_wgrad_wgmma.restype = ctypes.c_int
    lib.vaw_conv3x3_wgrad_tf32x3.argtypes = lib.vaw_conv3x3_wgrad_wgmma.argtypes
    lib.vaw_conv3x3_wgrad_tf32x3.restype = ctypes.c_int
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
    ``conv3x3_pallas.launches`` counts kernel launches, and
    ``conv3x3_pallas.launches_by_design`` the same by kernel
    (``conv3x3_design``)."""
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
    design = conv3x3_design(x.shape, cout, x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if design == "wgmma":
            err = _wgmma_kernel()(x.data_ptr(), wk.data_ptr(), y.data_ptr(), n, h, wd,
                                  cin, cout, *conv3x3_wgmma_tiling(h, wd, cout), stream)
        elif design == "tf32x3":
            # The filter's TF32 hi and lo halves, split by the kernel's entry.
            halves = torch.empty((2, cout, k), dtype=torch.float32, device=x.device)
            err = _tf32x3_kernel()(x.data_ptr(), wk.data_ptr(), halves.data_ptr(),
                                   y.data_ptr(), n, h, wd, cin, cout,
                                   *conv3x3_tf32x3_tiling(h, wd, cout), stream)
        else:
            err = _fwd_kernel()(x.data_ptr(), wk.data_ptr(), y.data_ptr(), n, h, wd,
                                cin, cout, kpad, int(x.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"conv3x3_fwd ({design}) launch failed: CUDA error {err}")
    flops.record(flops.conv3x3_flops(n, h, wd, cin, cout))
    conv3x3_pallas.launches += 1
    conv3x3_pallas.launches_by_design[design] += 1
    return y


def conv3x3_wgrad_pallas(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw [3, 3, Cin, Cout] of conv3x3(x, .) against the cotangent g
    [N, H, W, Cout] (vaw_tpu/ops/conv2d.py:168-206): f32 sums, cast to x's
    dtype.

    The kernel splits the pixels over blocks, writes f32 partial sums to a
    workspace and adds them in a fixed order in a second kernel, so the
    result does not change from run to run. A CUDA tensor goes to the
    kernel ``conv3x3_wgrad_design`` picks; what it does not take raises. A
    CPU tensor goes to ``conv3x3_wgrad_reference``.
    ``conv3x3_wgrad_pallas.launches`` counts launches, and
    ``conv3x3_wgrad_pallas.launches_by_design`` the same by kernel."""
    _check_shape(x)
    n, h, wd, cin = x.shape
    if g.dim() != 4 or tuple(g.shape[:3]) != (n, h, wd):
        raise ValueError(f"g must be [{n}, {h}, {wd}, Cout], got {tuple(g.shape)}")
    cout = g.shape[-1]
    if x.device.type == "cpu":
        return conv3x3_wgrad_reference(x, g)
    _check_image("x", x, x.dtype, x.device)
    _check_image("g", g, x.dtype, x.device)
    design = conv3x3_wgrad_design(x.shape, cout, x.dtype)
    lib = _wgrad_lib()
    if design in ("wgmma", "tf32x3"):
        plan = conv3x3_wgrad_plan(n, h, wd, cin, cout, design)
        splits = plan[4]
    else:
        is_bf16 = int(x.dtype == torch.bfloat16)
        splits = lib.vaw_conv3x3_wgrad_splits(n, h, wd, cin, cout, is_bf16)
    if splits <= 0:
        raise ValueError(f"wgrad kernel refuses x {tuple(x.shape)}, g {tuple(g.shape)}")
    work = torch.empty((splits, 9 * cin, cout), dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, cin, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if design in ("wgmma", "tf32x3"):
            entry = (lib.vaw_conv3x3_wgrad_wgmma if design == "wgmma"
                     else lib.vaw_conv3x3_wgrad_tf32x3)
            err = entry(x.data_ptr(), g.data_ptr(), work.data_ptr(), dw.data_ptr(), n, h,
                        wd, cin, cout, *plan, stream)
        else:
            err = lib.vaw_conv3x3_wgrad(x.data_ptr(), g.data_ptr(), work.data_ptr(),
                                        dw.data_ptr(), n, h, wd, cin, cout, splits,
                                        is_bf16, stream)
    if err:
        raise RuntimeError(f"conv3x3_wgrad ({design}) launch failed: CUDA error {err}")
    flops.record(flops.conv3x3_flops(n, h, wd, cin, cout))
    conv3x3_wgrad_pallas.launches += 1
    conv3x3_wgrad_pallas.launches_by_design[design] += 1
    return dw


conv3x3_pallas.launches = 0
conv3x3_pallas.launches_by_design = dict.fromkeys(CONV_DESIGNS, 0)
conv3x3_wgrad_pallas.launches = 0
conv3x3_wgrad_pallas.launches_by_design = dict.fromkeys(CONV_DESIGNS, 0)


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
