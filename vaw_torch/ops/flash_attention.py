"""Flash attention of the port: the fused-projection kernels of the DiT and
the general-T kernels of every other model.

Port of two families of ``vaw_tpu/ops/flash_attention.py``:

- ``_flash_p6``, the DiT's attention read straight from the raw QKV
  projection ``[B, T, 3*H*D]``: its forward (``_fwd_kernel_p6``) is the
  general forward's kernels of ``csrc/flash_fwd.cu`` on the packed row's
  three views (TMA + wgmma in bf16 at every D <= 128, 3xTF32 in f32 with
  scale > 0) or, for f32 with scale <= 0, ``csrc/flash_fused_fwd.cu``'s
  FMA kernel, and its backward (``_bwd_kernel_p6``)
  ``csrc/flash_fused_bwd.cu`` (mma.sync and FMA kernels) or the general
  backward's pair of ``csrc/flash_bwd.cu`` on the three views of the
  packed row (TMA + wgmma in bf16 for D <= 128, its 3xTF32 design in f32
  for D <= 64; ``flash_fused_bwd_design``); entry ``flash_attention_fused``.
- ``_flash``, the general-T kernel over ``[B, Tq, H, D]`` / ``[B, Tk, H, D]``
  with Tq and Tk independent and D <= 256: its forward (``_fwd_kernel``) is
  ``csrc/flash_fwd.cu`` and its backward (``_bwd_kernel``)
  ``csrc/flash_bwd.cu`` (TMA + wgmma in bf16 through one tensor map per
  view, ``general_tensor_map``, and in f32 both directions' 3xTF32 designs
  on the same maps; the kernel is chosen by the call, ``flash_fwd_design``
  and ``flash_bwd_design``); entries
  ``flash_attention`` (three tensors) and ``flash_attention_packed`` (q, k
  and v as strided views of one packed ``[B, T, 3, H, D]`` projection, and
  one packed gradient).
- ``_flash_p5``, the d-major packed kernel over ``[B, 3, H, D, T]`` (T the
  unit stride) that ``flash_attention_packed`` takes where the JAX package
  does (``_packed5_supported``: T = 256): its forward (``_fwd_kernel_p5``)
  is ``csrc/flash_p5_fwd.cu`` (TMA + wgmma in bf16, TMA + TF32 wgmma,
  three passes a product, in f32; the kernel is chosen by the call,
  ``flash_p5_fwd_design``) and its backward (``_bwd_kernel_p5``)
  ``csrc/flash_p5_bwd.cu`` (TMA + wgmma in bf16 for D <= 128, TMA + TF32
  wgmma in f32 for D <= 64, ``flash_p5_bwd_design``); entry
  ``flash_attention_p5``.

Each entry is differentiable: an autograd Function keeps the inputs, o and
lse from the forward and recomputes P from lse in the backward. On a CUDA
tensor both directions launch the hand-written kernels or raise; on a CPU
tensor they run the plain versions (``*_reference``), the same math in
plain PyTorch. Each launching wrapper counts its launches
(``<entry>.launches``) and, by kernel, ``<entry>.launches_by_design``
(every entry: ``flash_attention``, ``flash_attention_bwd``,
``flash_attention_fused``, ``flash_attention_fused_bwd``,
``flash_attention_p5`` and ``flash_attention_p5_bwd``), and records its
FLOPs for ``compiled_flops`` (``ops/flops.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading
from typing import Any, NamedTuple, Optional, Tuple

import torch

from . import _build, flops

__all__ = [
    "KERNEL_DESIGNS",
    "P5_TF32X3_MIN_TILES",
    "TF32X3_MIN_TILES",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_reference",
    "flash_attention_fwd",
    "flash_attention_packed",
    "flash_attention_reference",
    "flash_bwd_design",
    "flash_fused_bwd_design",
    "flash_fused_fwd_design",
    "flash_fwd_design",
    "flash_attention_fused",
    "flash_attention_fused_bwd",
    "flash_attention_fused_reference",
    "flash_attention_fused_bwd_reference",
    "flash_fwd_consumers",
    "flash_fwd_key_tile",
    "fused_supported",
    "general_tensor_map",
    "flash_attention_p5",
    "flash_attention_p5_bwd",
    "flash_attention_p5_bwd_reference",
    "flash_attention_p5_fwd",
    "flash_attention_p5_reference",
    "flash_p5_bwd_design",
    "flash_p5_fwd_design",
    "score_tiles",
]

# The bf16 and f32 kernels of the attention entries that choose among
# several, by the name their launches are counted under: "tf32x3" is an f32
# design on the tensor cores (three TF32 passes a product): the general
# forward's and backward's (also the fused entries') and the p5 forward's
# and backward's.
KERNEL_DESIGNS = ("wgmma", "mma_sync", "fma", "tf32x3")
# The f32 calls that take the 3xTF32 designs of the general and fused
# entries: at least this many 64 x 64 score tiles (``score_tiles``); smaller
# f32 calls would run the FMA kernels. Set from both designs' ms a call
# through the entry, as issued (back to back) in two runs and, in brackets,
# on the device alone, on an H100 80GB HBM3 at 700 W (chip_smoke.py phases
# 3c and 3j at CLF_GENERAL_F32 and CROSSOVER_F32; D = 64, the 512-tile row's
# D = 32):
#
#  tiles  forward: tf32x3       FMA                  backward: tf32x3     FMA
#      1  .0241/.0302 (.0068)  .0524/.0339 (.0164)  .0414/.0429 (.0193)  .0473/.0482 (.0437)
#     12  .0343/.0312 (.0072)  .0357/.0331 (.0167)  .0343/.0262 (.0198)  .0578/.0504 (.0466)
#     48  .0347/.0363 (.0076)  .0340/.0343 (.0171)  .0355/.0265 (.0208)  .0501/.0495 (.0477)
#    192  .0370/.0356 (.0122)  .0382/.0356 (.0227)  .0355/.0414 (.0328)  .0623/.0639 (.0606)
#    512  .0384/.0319 (.0137)  .0362/.0288 (.0267)  .0674/.0451 (.0429)  .0785/.0777 (.0786)
#    576  .0339/.0207 (.0193)  .0841/.0835 (.0838)  .0766/.0721 (.0723)  .2291/.2270 (.2289)
#   1536  .0344/.0346 (.0332)  .1596/.1592 (.1594)  .1338/.1336 (.1338)  .4357/.4317 (.4360)
#
# Both designs run one launch plan's host path (``_Plan``), so below about
# 600 tiles either call is host-bound at 20-45 µs a call. The backward's
# 3xTF32 pair is the faster as issued at every count, the forward ties within
# a few µs (FMA 2-10 % ahead at 48 and 512 tiles in both runs, less than the
# 20 % between the runs), and the 3xTF32 designs' device time is the lower
# everywhere. With no crossover the count is the least one timed, at which
# tf32x3 ran no slower in either direction. (The earlier 576 came from the
# 3xTF32 path's own host work, its tensor-map strides and their refusal
# checks worked out in Python at every call.)
TF32X3_MIN_TILES = 1
# The p5 forward's own count, timed the same way (phase 3j at
# F32_P5_FWD_SHAPES): its wrapper keeps its per-call work, the same for both
# designs, so below about 600 tiles the two trade places from run to run;
# tf32x3 ran no slower in both runs from 576 tiles on (as issued, two runs
# (device): 288 tiles, D = 64: 0.0624/0.0462 (0.0218) against FMA
# 0.0537/0.0538 (0.0532); 512, D = 32: 0.0377/0.0367 (0.0153) against
# 0.0429/0.0294 (0.0292); 576, D = 64: 0.0343/0.0404 (0.0221) against
# 0.0868/0.0862 (0.0870); 768, D = 32: 0.0389/0.0453 (0.0153) against
# 0.0488/0.0487 (0.0483)).
P5_TF32X3_MIN_TILES = 576


# Consumer warpgroups of the bf16 wgmma forward (flash_fwd.cu:
# flash_fwd_wgmma; 64 queries each, so a work item is 64 * NWG queries) with
# a head dim padded to 32 or 64, by (Tq, padded D); above 64 wide it is
# always two (their accumulators). Two waste no query rows where Tq is a
# multiple of 128 and leave the registers for 128-key tiles
# (``flash_fwd_key_tile``: with three, S's 64 floats spill), three hide
# more of the softmax's latencies on 64-key tiles. Set from ms a call
# through the entry (the device alone in brackets) with each count forced,
# P in one bf16 term, on the key tile of ``flash_fwd_key_tile`` (128 at Tk
# = 256 and 1024 for two, 64 for three and elsewhere), at the models' bf16
# shapes (B = 128 or 256, the sampling and training batches), on an H100
# 80GB HBM3 at 700 W (probes/_torch_attention_ab.py --set consumers, and
# --key-tile 64 for three at T = 256 and 1024):
#
#  (B, Tq, H, D)                       two                 three
#  DiT-B/2    (128, 256, 12, 64)   .0923/.0914 (.0906)  .1277/.1276 (.1274)
#  DiT-B/2    (256, 256, 12, 64)   .1702/.1702 (.1708)  .2476/.2469 (.2474)
#  U-ViT-L/2  (128, 258, 16, 64)   .2293/.2297 (.2297)  .2001/.1998 (.2001)
#  ViT-B/2    (128, 258, 12, 64)   .1708/.1708 (.1704)  .1522/.1522 (.1522)
#  MM-DiT-B/2 (128, 257, 24, 32)   .2877/.2877 (.2832)  .2447/.2446 (.2443)
#  LDM        (128, 1024, 8, 32)   .6198/.6200 (.6098)  .6617/.6638 (.6691)
#  LDM        (128, 64, 32, 32)    .0515/.0508 (.0502)  .0504/.0514 (.0502)
#  ADM-64     (128, 1024, 6, 64)   .5325/.5314 (.5364)  .5857/.5856 (.6008)
#  ADM-64     (128, 64, 12, 64)    .0297/.0303 (.0264)  .0258/.0284 (.0243)
#
# Two where they ran faster beyond the spread of a count's runs, three
# elsewhere: at T = 64 the calls are host-bound and three ran no slower on
# the device.
WGMMA_FWD_TWO_CONSUMERS = frozenset({(256, 64), (1024, 64), (1024, 32)})


def flash_fwd_consumers(tq: int, dp: int) -> int:
    """The consumer warpgroups of the bf16 wgmma forward for Tq queries and
    a head dim padded to `dp` (32, 64, 80 or 128; ``_wgmma_dp``): for dp <=
    64 two at the (Tq, dp) of ``WGMMA_FWD_TWO_CONSUMERS`` and three
    elsewhere, two above 64."""
    if dp > 64 or (tq, dp) in WGMMA_FWD_TWO_CONSUMERS:
        return 2
    return 3


def flash_fwd_key_tile(tq: int, tk: int, dp: int) -> int:
    """The keys of a tile the bf16 wgmma forward streams: 128 for a head
    dim padded to 32 or 64 with two consumer warpgroups
    (``flash_fwd_consumers``) and Tk a multiple of 128 (the DiT's 256,
    LDM's and ADM-64's 1024): S is one wgmma N = 128 and the softmax
    rescales O every 128 keys; 64 elsewhere (at T = 257 and 258 128-key
    tiles would compute 384 keys, a third of them masked, against 320).
    Timed against 64 at the shapes of ``WGMMA_FWD_TWO_CONSUMERS``'s table
    on an H100 80GB HBM3 at 700 W: DiT-B/2's (128, 256, 12, 64) ran .0906
    ms on the device against .1027, ADM-64's (128, 1024, 6, 64) .5364
    against .6778 (two consumers) and .6008 (three)."""
    if dp <= 64 and tk % 128 == 0 and flash_fwd_consumers(tq, dp) == 2:
        return 128
    return 64


def _wgmma_dp(d: int) -> int:
    """The head dim of the wgmma forward's tiles: D padded to 32, 64, 80 or
    128 (flash_fwd.cu:vaw_flash_fwd_wgmma)."""
    return next(dp for dp in (32, 64, 80, 128) if d <= dp)


def score_tiles(b: int, tq: int, tk: int, h: int) -> int:
    """The 64 x 64 tiles of an attention call's scores:
    B * H * ceil(Tq / 64) * ceil(Tk / 64)."""
    return b * h * -(-tq // 64) * -(-tk // 64)


def _tf32x3_pays(views: Tuple[torch.Tensor, ...]) -> bool:
    """Whether an f32 call on `views` (q and k first, [B, T, H, D]) has the
    work to pay for a 3xTF32 design (``TF32X3_MIN_TILES``); a call given no
    views is ruled on its head dim and scale alone."""
    if len(views) < 2:
        return True
    q, k = views[0], views[1]
    return score_tiles(q.shape[0], q.shape[1], k.shape[1], q.shape[2]) >= TF32X3_MIN_TILES


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
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = _build.load_library("flash_fused_bwd").vaw_flash_fused_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_supported(d: int) -> bool:
    """The head dims both fused kernels take, at any T: D % 8 == 0 (16-byte
    rows in bf16) and D <= 128 (their register tiles)."""
    return d % 8 == 0 and d <= 128


def _check_kernel_device(x: torch.Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {x.device}")


def _check_kernel_input(name: str, x: torch.Tensor, dtype: torch.dtype, d: int,
                        device: bool = True):
    """What both kernels refuse; raises rather than fall back. `device`
    False leaves the device to the caller (a plan builder that runs on CPU
    tensors too)."""
    if device:
        _check_kernel_device(x)
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bf16 or f32, got {dtype}")
    if x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype}, expected {dtype}")
    if not fused_supported(d):
        raise ValueError(f"kernel takes D % 8 == 0 and D <= 128, got D={d}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"kernel takes a contiguous, 16-byte aligned {name}")


def _fused_views(qkv2d: torch.Tensor, h: int, d: int):
    """q, k and v of qkv2d [B, T, 3*H*D] as [B, T, H, D] views, and their
    byte offsets in the packed row."""
    b, t, _ = qkv2d.shape
    step = h * d * qkv2d.element_size()
    return qkv2d.view(b, t, 3, h, d).unbind(2), (0, step, 2 * step)


def _fused_fwd_plan(qkv2d: torch.Tensor, num_heads: int, scale: float) -> _Plan:
    """The plan of a fused forward's signature, its C entry not yet bound:
    the wrapper's checks and the design; for a design on the packed row's
    views (the general kernels: all but "fma"), their stride array and
    offsets and the C entry's trailing ints (``_fwd_tail``). Reads dtypes,
    shapes and strides (and the base's alignment, which every call checks
    again), so it runs on CPU tensors too."""
    b, t, h, d = _split_dims(qkv2d, num_heads)
    _check_kernel_input("qkv2d", qkv2d, qkv2d.dtype, d, device=False)
    if max(b, h) > 65535:
        raise ValueError(f"kernel grid takes B, H <= 65535, got B={b}, H={h}")
    views, offsets = _fused_views(qkv2d, h, d)
    design = flash_fused_fwd_design(qkv2d.dtype, d, scale, views)
    fwd_flops = flops.attention_fwd_flops(b, t, t, h, d)
    if design == "fma":
        # The fused FMA kernel reads qkv2d itself.
        return _Plan(design, (b, t, h, d), None, (), qkv2d.device, 1.0 / math.sqrt(d),
                     fwd_flops)
    # The general forward on the packed row's three views (the same
    # contract; every view maps, D % 8 == 0 making each stride a multiple of
    # 16 bytes): TMA + wgmma in bf16, mma.sync in bf16 with scale <= 0 (the
    # wgmma kernel's softmax takes its max on the raw scores), 3xTF32 in
    # f32; o [B, T, H*D] is the contiguous [B, T, H, D] they write.
    return _Plan(design, (b, t, t, h, d), _call_strides(design, views),
                 _fwd_tail(design, qkv2d.dtype, t, t, d), qkv2d.device, 1.0 / math.sqrt(d),
                 fwd_flops, offsets=offsets)


def _fused_forward(qkv2d: torch.Tensor, num_heads: int, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    key = ("fused_fwd", _signature(qkv2d), num_heads, scale > 0, TF32X3_MIN_TILES)
    plan = _plans.get(key)
    if plan is None:
        _split_dims(qkv2d, num_heads)
        if qkv2d.device.type == "cpu":
            return flash_attention_fused_reference(qkv2d, num_heads, scale)
        plan = _fused_fwd_plan(qkv2d, num_heads, scale)
        _check_kernel_device(qkv2d)
        kernels = (_GENERAL_FWD_KERNELS if plan.offsets
                   else dict.fromkeys(KERNEL_DESIGNS, _fwd_kernel))
        plan = _remember(key, _bind(plan, kernels))
    _check_bases((), (("qkv2d", qkv2d),))
    b, t, h, d = plan.dims[0], plan.dims[1], plan.dims[-2], plan.dims[-1]
    out = torch.empty((b, t, h * d), dtype=qkv2d.dtype, device=plan.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=plan.device)
    base = qkv2d.data_ptr()
    with _on_device(plan.device):
        stream = _stream(plan.device)
        if plan.offsets:
            err = plan.kernel(*(base + o for o in plan.offsets), out.data_ptr(),
                              lse.data_ptr(), plan.strides, *plan.dims, float(scale),
                              *plan.tail, stream)
        else:
            err = plan.kernel(base, out.data_ptr(), lse.data_ptr(), *plan.dims,
                              float(scale), *plan.tail, stream)
    if err:
        raise RuntimeError(f"flash_fused_fwd ({plan.design}) launch failed: CUDA error {err}")
    flops.record(plan.flops)
    flash_attention_fused.launches += 1
    flash_attention_fused.launches_by_design[plan.design] += 1
    return out, lse


def flash_fused_fwd_design(dtype: torch.dtype, d: int, scale: float,
                           views: Tuple[torch.Tensor, ...] = ()) -> str:
    """Which forward kernel takes a fused call the wrapper admits (D % 8
    == 0, D <= 128), each but "fma" a general forward kernel on the packed
    row's three views (always mapped: D % 8 == 0 makes every stride a
    multiple of 16 bytes): "wgmma", the TMA + wgmma forward (padded to 32,
    64, 80 or 128 wide, ``flash_fwd_consumers`` consumer warpgroups), for
    bf16 with scale > 0; "mma_sync" for bf16 with scale <= 0; "tf32x3", the
    3xTF32 forward, for f32 with scale > 0 and, where the packed row's
    `views` (q, k, v) are given, at least ``TF32X3_MIN_TILES`` score tiles;
    "fma", the fused FMA kernel, for other f32 calls. Chosen by the call
    alone, never as a fallback: a launch the kernel refuses raises."""
    if dtype == torch.float32:
        return "tf32x3" if scale > 0 and _tf32x3_pays(views) else "fma"
    return "wgmma" if scale > 0 else "mma_sync"


def flash_fused_bwd_design(dtype: torch.dtype, d: int, scale: float,
                           views: Tuple[torch.Tensor, ...] = ()) -> str:
    """Which fused backward kernels take a call the wrapper admits (D % 8
    == 0, D <= 128), by ``flash_bwd_design``'s rule on the packed row's
    `views` (q, k, v, dq, dk, dv: strided views that TMA maps whenever
    D % 8 == 0): with scale > 0 the general backward's pair on those views,
    "wgmma" (TMA + wgmma) in bf16 at every admitted D (DiT-XL/2's 72 on
    80-wide tiles, 128 on 128-wide ones) and, in f32 for D <= 64 with at
    least ``TF32X3_MIN_TILES`` score tiles, "tf32x3" (three TF32 passes a
    product); for other calls the fused kernels, "mma_sync" in bf16 (any
    scale <= 0) and "fma" in f32 (D > 64, a scale <= 0). With no views the
    call is ruled on D and scale alone. Chosen by the call alone, never as
    a fallback: a launch the kernel refuses raises."""
    return flash_bwd_design(dtype, d, scale, views)


def _fused_bwd_plan(qkv2d: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                    dout: torch.Tensor, num_heads: int, scale: float) -> _Plan:
    """The plan of a fused backward's signature, its C entry not yet bound:
    the wrapper's checks and the design; for the general pair on the packed
    row's views, their stride array (q, k, v, then dq, dk, dv: dqkv is laid
    out like qkv2d) and offsets."""
    b, t, h, d = _split_dims(qkv2d, num_heads)
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
    views, offsets = _fused_views(qkv2d, h, d)
    design = flash_fused_bwd_design(dtype, d, scale, views * 2)
    bwd_flops = flops.attention_bwd_flops(b, t, t, h, d)
    if design in ("wgmma", "tf32x3"):
        # The general pair on the packed row's views; out and dout are
        # [B, T, H, D]. Its scratch is the same for both designs.
        return _Plan(design, (b, t, t, h, d), _call_strides(design, views * 2), (),
                     qkv2d.device, 1.0 / math.sqrt(d), bwd_flops, offsets=offsets)
    return _Plan(design, (b, t, h, d), None, (int(dtype == torch.bfloat16),),
                 qkv2d.device, 1.0 / math.sqrt(d), bwd_flops)


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
    general pair's wgmma and tf32x3 launches are not counted under
    ``flash_attention_bwd``). The checks, the design, the stride array and
    the scratch size are worked out once for each call signature
    (``_Plan``)."""
    key = ("fused_bwd", _signature(qkv2d, out, lse, dout), num_heads,
           scale is None or scale > 0, TF32X3_MIN_TILES)
    plan = _plans.get(key)
    if plan is None:
        _, _, _, d = _split_dims(qkv2d, num_heads)
        if scale is None:
            scale = 1.0 / math.sqrt(d)
        if qkv2d.device.type == "cpu":
            return flash_attention_fused_bwd_reference(qkv2d, out, lse, dout,
                                                       num_heads, scale)
        plan = _fused_bwd_plan(qkv2d, out, lse, dout, num_heads, scale)
        kernels = (_GENERAL_BWD_KERNELS if plan.offsets
                   else dict.fromkeys(KERNEL_DESIGNS, _bwd_kernel))
        plan = _remember(key, _bind(plan, kernels, _general_bwd_scratch_floats))
    elif scale is None:
        scale = plan.scale
    _check_bases((), (("qkv2d", qkv2d), ("out", out), ("dout", dout), ("lse", lse)))
    b, t, h = plan.dims[0], plan.dims[1], plan.dims[-2]
    dqkv = torch.empty_like(qkv2d)
    base, grad = qkv2d.data_ptr(), dqkv.data_ptr()
    with _on_device(plan.device):
        stream = _stream(plan.device)
        if plan.offsets:
            scratch = torch.empty(plan.scratch, dtype=torch.float32, device=plan.device)
            err = plan.kernel(
                *(base + o for o in plan.offsets), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), scratch.data_ptr(), plan.scratch,
                *(grad + o for o in plan.offsets), plan.strides, *plan.dims, float(scale),
                stream)
        else:
            delta = torch.empty((b * h, t), dtype=torch.float32, device=plan.device)
            err = plan.kernel(base, out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), grad, *plan.dims, float(scale), *plan.tail,
                              stream)
    if err:
        raise RuntimeError(f"flash_fused_bwd ({plan.design}) launch failed: CUDA error {err}")
    flops.record(plan.flops)
    flash_attention_fused_bwd.launches += 1
    flash_attention_fused_bwd.launches_by_design[plan.design] += 1
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
    ``flash_attention_fused.launches`` counts forward kernel launches, and
    ``flash_attention_fused.launches_by_design`` the same by kernel
    (``flash_fused_fwd_design``)."""
    _, _, _, d = _split_dims(qkv2d, num_heads)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return _FlashFused.apply(qkv2d, num_heads, float(scale))


flash_attention_fused.launches = 0
flash_attention_fused.launches_by_design = dict.fromkeys(KERNEL_DESIGNS, 0)
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
        ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _general_fwd_tf32x3_kernel():
    fn = _build.load_library("flash_fwd").vaw_flash_fwd_tf32x3
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
def _general_bwd_tf32x3_kernel():
    # The wgmma entry's contract, in f32.
    fn = _build.load_library("flash_bwd").vaw_flash_bwd_tf32x3
    fn.argtypes = _general_bwd_wgmma_kernel().argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _general_bwd_scratch_floats():
    fn = _build.load_library("flash_bwd").vaw_flash_bwd_wgmma_scratch_floats
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn


# The C entry of each design of the general pair, by the name its launches
# count under.
_GENERAL_FWD_KERNELS = {"wgmma": _general_fwd_wgmma_kernel,
                        "tf32x3": _general_fwd_tf32x3_kernel,
                        "mma_sync": _general_fwd_kernel, "fma": _general_fwd_kernel}
_GENERAL_BWD_KERNELS = {"wgmma": _general_bwd_wgmma_kernel,
                        "tf32x3": _general_bwd_tf32x3_kernel,
                        "mma_sync": _general_bwd_kernel, "fma": _general_bwd_kernel}


def _check_view(name: str, x: torch.Tensor, dtype: torch.dtype, device):
    """What the general kernels refuse in a [B, T, H, D] view; raises rather
    than fall back. The launching wrappers also refuse a q that is not on a
    CUDA device (``_check_cuda``)."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}; the kernel takes tensors on "
                         f"one CUDA device ({device})")
    if x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype}, expected {dtype}")
    if x.stride(-1) != 1:
        raise ValueError(f"kernel takes a unit stride over D; {name} has {x.stride()}")
    if x.data_ptr() % 16 or any(s * x.element_size() % 16 for s in x.stride()[:3]):
        raise ValueError(_unaligned_view(name, x))


def _unaligned_view(name: str, x: torch.Tensor) -> str:
    return (f"kernel takes 16-byte aligned rows; {name} has base {x.data_ptr()} and "
            f"strides {x.stride()}")


def _check_cuda(name: str, x: torch.Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"{name} is on {x.device}; the kernel takes tensors on one "
                         f"CUDA device ({x.device})")


def _check_general(b: int, h: int, d: int, dtype: torch.dtype):
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bf16 or f32, got {dtype}")
    if d % 8 or d > 256:
        raise ValueError(f"kernel takes D % 8 == 0 and D <= 256, got D={d}")
    if max(b, h) > 65535:
        raise ValueError(f"kernel grid takes B, H <= 65535, got B={b}, H={h}")


def _longlongs(values):
    values = list(values)
    return (ctypes.c_longlong * len(values))(*values)


def _strides(*views: torch.Tensor):
    return _longlongs(s for x in views for s in x.stride()[:3])


def _tma_refusal(x: torch.Tensor) -> Optional[str]:
    """Why TMA takes no tensor map of the [B, T, H, D] view x, or None."""
    if x.dim() != 4:
        return f"the TMA view takes a [B, T, H, D] tensor, got {tuple(x.shape)}"
    if x.stride(3) != 1:
        return f"the TMA view takes a unit stride over D, got {x.stride()}"
    strides = _byte_strides(x)
    if x.data_ptr() % 16 or any(s <= 0 or s % 16 or s >= 1 << 40 for s in strides):
        return (f"the TMA view takes a 16-byte aligned base and strides that are "
                f"positive multiples of 16 bytes, got base {x.data_ptr()} and byte "
                f"strides {list(strides)}")
    return None


def _byte_strides(x: torch.Tensor) -> Tuple[int, int, int]:
    """The byte strides of H, T and B of a [B, T, H, D] view."""
    return tuple(x.stride(i) * x.element_size() for i in (2, 1, 0))


def general_tensor_map(x: torch.Tensor) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The wgmma and 3xTF32 kernels' TMA view of one [B, T, H, D] tensor
    (q, k, v, or a gradient): the dims of [D, H, T, B] innermost first, and the
    byte strides of H, T and B, the view's own (a packed [B, T, 3, H, D]
    projection's q, k and v share its strides). TMA takes a unit stride over
    D, a 16-byte aligned base and strides that are positive multiples of 16
    bytes below 2**40 (so no stride-0 view, such as a k expanded over the
    heads); raises ValueError otherwise."""
    why = _tma_refusal(x)
    if why:
        raise ValueError(why)
    b, t, h, d = x.shape
    return (d, h, t, b), _byte_strides(x)


def _map_strides(*views: torch.Tensor):
    """The byte strides of each view's tensor map, for the wgmma entries."""
    return _longlongs(s for x in views for s in general_tensor_map(x)[1])


def _call_strides(design: str, views: Tuple[torch.Tensor, ...]):
    """The stride array of the C entry that `design` launches on `views`:
    the byte strides of H, T and B of each view's tensor map for the wgmma
    and 3xTF32 kernels (``_map_strides``; the design has already found that
    every view maps), the element strides of B, T and H for the others
    (``_strides``)."""
    if design in ("wgmma", "tf32x3"):
        return _longlongs(s for x in views for s in _byte_strides(x))
    return _strides(*views)


def _fwd_tail(design: str, dtype: torch.dtype, tq: int, tk: int, d: int
              ) -> Tuple[int, ...]:
    """The trailing ints of the general forward's C entry for `design`: the
    wgmma kernel's consumer warpgroups (``flash_fwd_consumers``) and key
    tile (``flash_fwd_key_tile``), the mma.sync and FMA kernels' bf16 flag,
    nothing for the 3xTF32 kernel."""
    if design == "wgmma":
        dp = _wgmma_dp(d)
        return flash_fwd_consumers(tq, dp), flash_fwd_key_tile(tq, tk, dp)
    if design == "tf32x3":
        return ()
    return (int(dtype == torch.bfloat16),)


class _Plan(NamedTuple):
    """What one call signature of a launching entry fixes, worked out at its
    first call (every check but the base pointers' alignment, the design, the
    C entry's stride array) and looked up at every later call (``_plans``).
    A signature is each tensor's dtype, device, shape and strides, the sign of
    the scale (and the fused entries' head count) and ``TF32X3_MIN_TILES``,
    which the tests and chip_smoke.py set at run time."""
    design: str
    dims: Tuple[int, ...]        # the C entry's ints: B, Tq, Tk, H, D (fused own: B, T, H, D)
    strides: Any                 # the C entry's stride array, or None
    tail: Tuple[int, ...]        # the C entry's trailing ints (``_fwd_tail``; the backward's
                                 # mma.sync and FMA entries' bf16 flag)
    device: torch.device
    scale: float                 # the default scale, 1 / sqrt(D)
    flops: int
    kernel: Any = None           # the C entry, bound on the card (``_bind``)
    scratch: int = 0             # f32 scratch floats of the wgmma / tf32x3 pair
    offsets: Tuple[int, ...] = ()  # the fused entries' q, k, v in the packed row, bytes


# Launch plans by signature, oldest first; the oldest goes when the table is
# full. A refused signature is never stored: it raises again at every call.
_PLAN_SLOTS = 256
_plans: dict = {}
_plans_lock = threading.Lock()


def _signature(*tensors: torch.Tensor) -> tuple:
    return tuple((x.dtype, x.get_device(), x.shape, x.stride()) for x in tensors)


def _fwd_key(q, k, v, scale: Optional[float]) -> tuple:
    """The signature of a general forward call: its plan's key."""
    return ("fwd", _signature(q, k, v), scale is None or scale > 0, TF32X3_MIN_TILES)


def _bwd_key(q, k, v, out, lse, dout, scale: Optional[float], grads) -> tuple:
    """The signature of a general backward call: its plan's key."""
    return ("bwd", _signature(q, k, v, out, lse, dout),
            None if grads is None else _signature(*grads), scale is None or scale > 0,
            TF32X3_MIN_TILES)


def _remember(key: tuple, plan: _Plan) -> _Plan:
    with _plans_lock:
        if len(_plans) >= _PLAN_SLOTS:
            del _plans[next(iter(_plans))]
        _plans[key] = plan
    return plan


def _bind(plan: _Plan, kernels: dict, scratch=None) -> _Plan:
    """The plan with its C entry from `kernels` (design -> getter) and, for
    the wgmma and tf32x3 backward pair, its scratch size from
    `scratch`(B, Tq, H)."""
    n = 0
    if scratch is not None and plan.design in ("wgmma", "tf32x3"):
        b, tq, _, h, _ = plan.dims
        n = scratch()(b, tq, h)
    return plan._replace(kernel=kernels[plan.design](), scratch=n)


def _on_device(device: torch.device):
    """The device context a launch needs: none when `device` is current."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _stream(device: torch.device) -> int:
    """The handle of `device`'s current stream: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, read the way
    PyTorch's generated code reads it, without building a Stream object
    (probes/_torch_host_split.py times both)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _check_bases(views, dense=()):
    """The per-call half of the checks: every base 16-byte aligned, in the
    order the signature's checks run (`views` by ``_check_view``'s rule,
    then the `dense` tensors)."""
    for name, x in views:
        if x.data_ptr() % 16:
            raise ValueError(_unaligned_view(name, x))
    for name, x in dense:
        if x.data_ptr() % 16:
            raise ValueError(f"kernel takes a contiguous, 16-byte aligned {name}")


def flash_fwd_design(dtype: torch.dtype, d: int, scale: float,
                     views: Tuple[torch.Tensor, ...] = ()) -> str:
    """Which general forward kernel takes a call the wrapper admits (D % 8
    == 0, D <= 256): for D <= 128, scale > 0 (the softmax takes the max on
    the raw scores) and `views` (q, k, v) that each have a tensor map
    (``general_tensor_map``: not a stride-0 view), "wgmma" (TMA + wgmma) in
    bf16 and, in f32 with at least ``TF32X3_MIN_TILES`` score tiles,
    "tf32x3" (TMA + wgmma, three TF32 passes a product); for other calls
    "mma_sync" in bf16 and "fma" in f32. With no views the call is ruled on
    D and scale alone. Chosen by the call alone, never as a fallback: a
    launch the kernel refuses raises."""
    mapped = not any(_tma_refusal(x) for x in views)
    if d <= 128 and scale > 0 and mapped:
        if dtype != torch.float32:
            return "wgmma"
        return "tf32x3" if _tf32x3_pays(views) else "fma"
    return "fma" if dtype == torch.float32 else "mma_sync"


def flash_bwd_design(dtype: torch.dtype, d: int, scale: float,
                     views: Tuple[torch.Tensor, ...] = ()) -> str:
    """Which general backward kernels take a call the wrapper admits: for
    scale > 0 and `views` (q, k, v, dq, dk, dv) that each have a tensor map,
    as the forward, "wgmma" (TMA + wgmma) in bf16 with D <= 128 (padded to
    32, 64, 80, 96 or 128: the XL models' 72, UNet-64's 96 and ViT-S's 128
    included; from 96 the dK/dV kernel gives dV and dK a warpgroup each)
    and, in f32 with D <= 64 (its split tiles fill shared memory there) and
    at least ``TF32X3_MIN_TILES`` score tiles, "tf32x3" (TMA + wgmma, three
    TF32 passes a product); for other calls "mma_sync" in bf16 (D > 128, a
    scale <= 0, a view without a tensor map) and "fma" in f32. With no
    views the call is ruled on D and scale alone. Chosen by the call alone,
    never as a fallback."""
    mapped = not any(_tma_refusal(x) for x in views)
    if scale > 0 and mapped:
        if dtype != torch.float32 and d <= 128:
            return "wgmma"
        if dtype == torch.float32 and d <= 64:
            return "tf32x3" if _tf32x3_pays(views) else "fma"
    return "fma" if dtype == torch.float32 else "mma_sync"


def _general_fwd_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> _Plan:
    """The plan of a general forward's signature, its C entry not yet bound:
    the wrapper's checks (raising what the kernels refuse), the design and
    the stride array. Reads dtypes, devices, shapes and strides (and the
    bases' alignment, which every call checks again), so it runs on CPU
    tensors too."""
    b, tq, tk, h, d = _general_dims(q, k, v)
    _check_general(b, h, d, q.dtype)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_view(name, x, q.dtype, q.device)
    design = flash_fwd_design(q.dtype, d, scale, (q, k, v))
    return _Plan(design, (b, tq, tk, h, d), _call_strides(design, (q, k, v)),
                 _fwd_tail(design, q.dtype, tq, tk, d), q.device, 1.0 / math.sqrt(d),
                 flops.attention_fwd_flops(b, tq, tk, h, d))


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
    kernel. The checks, the design and the stride array are worked out once
    for each call signature (``_Plan``)."""
    key = _fwd_key(q, k, v, scale)
    plan = _plans.get(key)
    if plan is None:
        _, _, _, _, d = _general_dims(q, k, v)
        if scale is None:
            scale = 1.0 / math.sqrt(d)
        if q.device.type == "cpu":
            return flash_attention_reference(q, k, v, scale)
        plan = _general_fwd_plan(q, k, v, scale)
        _check_cuda("q", q)
        plan = _remember(key, _bind(plan, _GENERAL_FWD_KERNELS))
    elif scale is None:
        scale = plan.scale
    _check_bases((("q", q), ("k", k), ("v", v)))
    b, tq, _, h, d = plan.dims
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=plan.device)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=plan.device)
    with _on_device(plan.device):
        err = plan.kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          lse.data_ptr(), plan.strides, *plan.dims, float(scale), *plan.tail,
                          _stream(plan.device))
    if err:
        raise RuntimeError(f"flash_fwd ({plan.design}) launch failed: CUDA error {err}")
    flops.record(plan.flops)
    flash_attention.launches += 1
    flash_attention.launches_by_design[plan.design] += 1
    return out, lse


def _general_bwd_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                      scale: float, grads: Tuple[torch.Tensor, ...]) -> _Plan:
    """The plan of a general backward's signature, its C entry not yet
    bound: the wrapper's checks, the design and the stride array, as
    ``_general_fwd_plan``."""
    b, tq, tk, h, d = _general_dims(q, k, v)
    dtype, device = q.dtype, q.device
    _check_general(b, h, d, dtype)
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
    views = (q, k, v, *grads)
    design = flash_bwd_design(dtype, d, scale, views)
    mapped = design in ("wgmma", "tf32x3")
    return _Plan(design, (b, tq, tk, h, d), _call_strides(design, views),
                 () if mapped else (int(dtype == torch.bfloat16),), device,
                 1.0 / math.sqrt(d), flops.attention_bwd_flops(b, tq, tk, h, d))


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
    the same by kernel. The checks, the design, the stride array and the
    scratch size are worked out once for each call signature (``_Plan``)."""
    key = _bwd_key(q, k, v, out, lse, dout, scale, grads)
    plan = _plans.get(key)
    if plan is None:
        _, _, _, _, d = _general_dims(q, k, v)
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
        if grads is None:
            grads = _contiguous_grads(q, k, v)
        plan = _general_bwd_plan(q, k, v, out, lse, dout, scale, grads)
        _check_cuda("q", q)
        plan = _remember(key, _bind(plan, _GENERAL_BWD_KERNELS, _general_bwd_scratch_floats))
    else:
        if scale is None:
            scale = plan.scale
        if grads is None:
            grads = _contiguous_grads(q, k, v)
    _check_bases((("q", q), ("k", k), ("v", v), ("dq", grads[0]), ("dk", grads[1]),
                  ("dv", grads[2])), (("out", out), ("dout", dout), ("lse", lse)))
    b, tq, _, h, _ = plan.dims
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
           lse.data_ptr())
    outs = tuple(g.data_ptr() for g in grads)
    if plan.scratch:
        # The pair's scratch (lse in the log2 domain and delta) is the same
        # for both designs.
        scratch = torch.empty(plan.scratch, dtype=torch.float32, device=plan.device)
        scratch_args = (scratch.data_ptr(), plan.scratch)
    else:
        scratch = torch.empty((b * h, tq), dtype=torch.float32, device=plan.device)
        scratch_args = (scratch.data_ptr(),)
    with _on_device(plan.device):
        err = plan.kernel(*ins, *scratch_args, *outs, plan.strides, *plan.dims,
                          float(scale), *plan.tail, _stream(plan.device))
    if err:
        raise RuntimeError(f"flash_bwd ({plan.design}) launch failed: CUDA error {err}")
    flops.record(plan.flops)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_design[plan.design] += 1
    return tuple(grads)


def _contiguous_grads(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.empty_like(x, memory_format=torch.contiguous_format) for x in xs)


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
def _p5_fwd_tf32x3_kernel():
    # The wgmma entry's contract, in f32.
    fn = _build.load_library("flash_p5_fwd").vaw_flash_p5_fwd_tf32x3
    fn.argtypes = _p5_fwd_wgmma_kernel().argtypes
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
def _p5_bwd_tf32x3_kernel():
    # The wgmma entry's contract, in f32.
    fn = _build.load_library("flash_p5_bwd").vaw_flash_p5_bwd_tf32x3
    fn.argtypes = _p5_bwd_wgmma_kernel().argtypes
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


def flash_p5_fwd_design(dtype: torch.dtype, scale: float,
                        shape: Tuple[int, ...] = ()) -> str:
    """Which p5 forward kernel takes a call the wrapper admits (D % 8 == 0,
    D <= 128, T % 8 == 0), on f5 of `shape` [B, 3, H, D, T]: "wgmma" (TMA
    + wgmma) for bf16 with scale > 0 (its softmax takes the max on the raw
    scores), "mma_sync" for bf16 with scale <= 0; "tf32x3" (TMA + TF32
    wgmma, three passes a product) for f32 with scale > 0, D <= 64 (its
    shared memory) and at least ``P5_TF32X3_MIN_TILES`` score tiles, "fma"
    for other f32 calls. With no shape an f32 call is ruled on its scale
    alone. Chosen by the call alone, never as a fallback: a launch the
    kernel refuses raises."""
    if dtype == torch.float32:
        if scale > 0 and (not shape or (shape[3] <= 64 and score_tiles(
                shape[0], shape[4], shape[4], shape[2]) >= P5_TF32X3_MIN_TILES)):
            return "tf32x3"
        return "fma"
    return "wgmma" if scale > 0 else "mma_sync"


def flash_p5_bwd_design(dtype: torch.dtype, d: int, scale: float) -> str:
    """Which p5 backward kernels take a call the wrapper admits (D % 8 ==
    0, D <= 128, T % 8 == 0): with scale > 0, "wgmma" (TMA + wgmma) for
    bf16 at every admitted D (from 80 the dK/dV kernel gives dV and dK a
    warpgroup each) and "tf32x3" (TMA + TF32 wgmma, three passes a product)
    for f32 with D <= 64 (its split tiles fill shared memory there);
    "mma_sync" for other bf16 calls (scale <= 0), "fma" for other f32 calls.
    No crossover by size: the tf32x3 pair beats the FMA kernels through the
    entry down to 288 score tiles (PERF.md, Findings). Chosen by the call
    alone, never as a fallback: a launch the kernels refuse raises."""
    if not scale > 0:
        return "fma" if dtype == torch.float32 else "mma_sync"
    if dtype == torch.float32:
        return "tf32x3" if d <= 64 else "fma"
    return "wgmma"


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
    design = flash_p5_fwd_design(f5.dtype, scale, f5.shape)
    with torch.cuda.device(f5.device):
        stream = torch.cuda.current_stream().cuda_stream
        if design in ("wgmma", "tf32x3"):
            kernel = _p5_fwd_wgmma_kernel if design == "wgmma" else _p5_fwd_tf32x3_kernel
            err = kernel()(f5.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, d, t,
                           float(scale), stream)
        else:
            err = _p5_fwd_kernel()(f5.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, d,
                                   t, float(scale), int(f5.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash_p5_fwd ({design}) launch failed: CUDA error {err}")
    flops.record(flops.attention_fwd_flops(b, t, t, h, d))
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
        if design in ("wgmma", "tf32x3"):
            n = _p5_bwd_scratch_floats()(b, h, t)
            scratch = torch.empty(n, dtype=torch.float32, device=f5.device)
            kernel = _p5_bwd_wgmma_kernel if design == "wgmma" else _p5_bwd_tf32x3_kernel
            err = kernel()(*ptrs, scratch.data_ptr(), n, dqkv.data_ptr(), b, h, d, t,
                           float(scale), stream)
        else:
            delta = torch.empty((b * h, t), dtype=torch.float32, device=f5.device)
            err = _p5_bwd_kernel()(*ptrs, delta.data_ptr(), dqkv.data_ptr(), b, h, d, t,
                                   float(scale), int(f5.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash_p5_bwd ({design}) launch failed: CUDA error {err}")
    flops.record(flops.attention_bwd_flops(b, t, t, h, d))
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
