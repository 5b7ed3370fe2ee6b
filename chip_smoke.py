#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (vaw_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device   the card's name and power limit (nvidia-smi); no card, no run.
  2. build    every CUDA kernel of the paths from vaw_torch/ops/csrc (nvcc,
              sm_90a, one process per source, all started together).
  3. kernel   the fused attention forward (flash_fused_fwd.cu, the DiT's;
              TMA + wgmma in bf16) against its plain PyTorch version at the
              sampling shapes and at T in {64, 256, 257, 1024} x D in {40,
              64, 72, 128}, bf16 and f32, with its time beside its bound, the
              plain version's time and one PyTorch library call's time.
  3b. bwd     the fused backward (flash_fused_bwd.cu) against its plain
              version at the training shape (B=256, T=256, H=12, D=64) in
              bf16 and f32, and at T=257 and D=128, with the same times; the
              library call is scaled_dot_product_attention's backward.
  3c. general the general-T forward (flash_fwd.cu) against its plain
              version: the U-ViT-L/2 sampling shape (B=128, T=258, H=16,
              D=64, q, k and v as views of one packed projection), Tq=77
              with Tk=300, D=72, D=256 and T=4096, bf16 and f32, with the
              four times at the first shape.
  3d. general bwd  the general-T backward (flash_bwd.cu) at the same shapes
              (one packed gradient at the first), with the four times.
  3e. p5      the d-major packed forward (flash_p5_fwd.cu, the UNet's T = 256
              attention; TMA + wgmma in bf16) against its plain version on
              [B, 3, H, D, T] at the LDM sampling shape (B=128, T=256, H=16,
              D=32), (4, 256, 9, 64), (2, 256, 8, 16) and (8, 256, 4, 128),
              bf16 and f32, each through the kernel its call selects (wgmma,
              mma.sync or FMA, counted), with the four times at the first
              shape (SDPA on q, k and v copied, untimed, to contiguous
              [B, H, T, D]) and the mma.sync kernel's time and error there.
  3f. p5 bwd  the p5 backward (flash_p5_bwd.cu, one packed dqkv) at the same
              shapes, the first at the LDM training batch B=256, with the
              four times there.
  3g. conv    the 3x3 conv forward (conv3x3_fwd.cu) and its dgrad (the same
              kernels on the rotated filter) against the plain version at
              ADM-64's admitted shapes at the sampling batch 128 (64 px
              192->192, timed; 384->192; 32 px 384->384; 16 px 384->576; the
              3-channel stem; the f32 head 192->3), at 8 px (two images to a
              wgmma box), at (3, 12, 20, 64->128) (a box that does not
              divide the image) and (2, 16, 8, 24->16), bf16 and f32, each
              through the kernel its shape selects (wgmma, mma.sync or FMA,
              counted), with the kernel, plain, cuDNN and bound times, and
              the mma.sync kernel's time at the timed shape.
  3h. wgrad   the conv's filter gradient (conv3x3_wgrad.cu: split-K partials
              and their fixed-order sum; bit-equal when repeated; TMA + wgmma
              for bf16 with Cin and Cout multiples of 64) at the ADM-64
              training batch 64 (timed) and the shapes of 3g, each through
              the kernel its shape selects (counted), with the mma.sync
              kernel's time and error at the timed shape.
  3i. act     the fused bias + leaky ReLU (fused_act.cu), which no model
              calls, at (128, 64, 64, 192) bf16 and f32: values, first and
              second derivatives against the plain version through its op
              entry (its launches are counted there), and the times.
Then, for DiT-B/2 (phases 4-7, the fused kernels), U-ViT-L/2 (phases 8-11,
the general kernels) and LDM (phases 12-15, the p5 kernels at its 16x16
level and the general ones at 32x32 and 8x8), each with seeded random
weights at full width and depth on 32x32x4 latents, and ADM-64 (phases
16-19, pixel space, 64x64x3, under VAW_PALLAS_CONV=1, set for those phases
only: the conv kernels on the 30 convs the JAX gate admits, the general
attention kernels):
  sample      the sampling path through its entry point,
              vaw_torch.cli.sample.main: 128 samples in two batches of 64,
              18 Heun EDM steps at CFG 1.5, bf16.
  model       one forward at B=128 through the kernels against the same
              forward through the plain attention (and, for ADM-64, the
              plain conv), in f32 and in the sampler's bf16 copy.
  train       the training path through its entry point,
              vaw_torch.cli.main.main, on Gaussian data with the flagship
              recipe (cosine schedule, EPSILON target, lambda weight, label
              dropout 0.1, AdamW (0.9, 0.95) with the fused AdamW+EMA, bf16
              over f32 masters), 30 steps at batch 256 (DiT, LDM), 128
              (U-ViT) or 64 (ADM-64), and a step-30 checkpoint that loads back
              with the run's EMA weights (U-ViT's learned pos_embed included).
  grad        one backward in f32 at B=32 (DiT) or 16 (U-ViT, LDM, ADM-64)
              through the kernels against the plain route, per parameter
              group.
Before each sample and train phase every kernel's launch count is set to
0; it is read just after and must be exactly the expected count for that
path's kernels (840, 360 + 360, 1470, 630 + 630; LDM 350 p5 + 770 general
in sampling, 150 + 150 p5 and 330 + 330 general in training; ADM-64 2100
conv + 1540 general in sampling, 1770 conv forward/dgrad + 900 wgrad and
660 + 660 general in training) and 0 for the others; the launches by
kernel of the conv forward, the wgrad and the p5 forward must be exact too
(a bf16 ADM-64 forward: 28 wgmma convs, the stem on mma.sync, the f32 head
on FMAs; a backward: 28 wgmma dgrads and the head's on FMAs, 28 wgmma
wgrads, the stem's on mma.sync and the head's on FMAs; every bf16 LDM p5
forward on wgmma).

Exits non-zero, printing no result, without a CUDA card or if any phase
fails. Otherwise it prints one {"kernels": [...]} JSON line (nine kernels)
and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple
from unittest import mock

import torch
import torch.nn.functional as F

import vaw_torch.cli.main as train_cli
import vaw_torch.cli.sample as sample_cli
from vaw_torch.models import cast_for_compute
from vaw_torch.models import layers as model_layers
from vaw_torch.models import unet as unet_module
from vaw_torch.models import uvit as uvit_module
from vaw_torch.models.dit import DiT_B
from vaw_torch.models.unet import ADM_64, LDM
from vaw_torch.models.uvit import UViT_L
from vaw_torch.ops import _build
from vaw_torch.ops import conv2d as conv_ops
from vaw_torch.ops import flash_attention as flash_ops
from vaw_torch.ops.conv2d import (
    CONV_DESIGNS,
    conv3x3_design,
    conv3x3_pallas,
    conv3x3_reference,
    conv3x3_wgrad_design,
    conv3x3_wgrad_pallas,
    conv3x3_wgrad_plan,
    conv3x3_wgrad_reference,
)
from vaw_torch.ops.flash_attention import (
    P5_FWD_DESIGNS,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fused,
    flash_attention_fused_bwd,
    flash_attention_fused_bwd_reference,
    flash_attention_fused_reference,
    flash_attention_p5,
    flash_attention_p5_bwd,
    flash_attention_p5_bwd_reference,
    flash_attention_p5_fwd,
    flash_attention_p5_reference,
    flash_attention_reference,
    flash_p5_fwd_design,
)
from vaw_torch.ops.fused_act import fused_leaky_relu, fused_leaky_relu_reference
from vaw_torch.samplers import driver as sampler_driver
from vaw_torch.train import Trainer, load_checkpoint

# H100 SXM peaks (NVIDIA data sheet): HBM rate, dense bf16 tensor-core rate
# and the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# DiT-B/2's attention on 32x32x4 latents: T = 256 tokens, 12 heads of 64;
# sampling batches of 64 samples (128 rows with CFG), 18 Heun steps.
SAMPLE_SIZE, NUM_SAMPLES, STEPS = 64, 128, 18
B_MAIN, T_MAIN, H_MAIN, D_MAIN = 2 * SAMPLE_SIZE, 256, 12, 64

# Further fused-forward checks at B=4, H=4: every T with every D.
FUSED_T = (64, 256, 257, 1024)
FUSED_D = (40, 64, 72, 128)

# Kernel against its plain version on the same inputs: f32 differs only in
# summation order and exp2f; bf16 output is one rounding of |o| < 2.
ATOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
LSE_ATOL = 1e-4
# bf16 model forward against the f32 plain forward, relative to max|out|.
MODEL_BF16_RTOL = 3e-2
MODEL_F32_RTOL = 1e-4
# Backward kernel against its plain version, relative to max|grad|: f32
# differs in summation order and exp2f; bf16 rounds P and dS to bf16 hi+lo
# (about 16 bits) and each gradient once to bf16.
BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Model gradient through the kernels against the plain attention route,
# f32, relative to each parameter group's max|grad|.
GRAD_F32_RTOL = 1e-4

# Training phases: the flagship recipe for 30 steps, the first five warm-up.
TRAIN_STEPS, TRAIN_WARMUP = 30, 5
DIT_TRAIN_BATCH = 256
# General-T kernel checks: (B, Tq, Tk, H, D); the first is the U-ViT-L/2
# sampling shape, timed, with q, k and v read as views of one packed qkv.
GENERAL_SHAPES = [(2 * SAMPLE_SIZE, 258, 258, 16, 64), (16, 77, 300, 16, 64),
                  (16, 258, 258, 12, 72), (8, 258, 258, 4, 256),
                  (2, 4096, 4096, 2, 64)]

# p5 kernel checks: (B, T, H, D) on [B, 3, H, D, T]; the first is the LDM
# shape (16x16 level, 16 heads of 32), timed at the sampling batch (128 rows
# with CFG) in the forward and the training batch in the backward.
LDM_TRAIN_BATCH = 256
P5_SHAPES = [(2 * SAMPLE_SIZE, 256, 16, 32), (4, 256, 9, 64), (2, 256, 8, 16),
             (8, 256, 4, 128)]
P5_BWD_SHAPES = [(LDM_TRAIN_BATCH, 256, 16, 32)] + P5_SHAPES[1:]

# Conv kernel checks: (N, H, W, Cin, Cout, dtypes). The first is ADM-64's
# 64x64 level at the sampling batch (128 rows with CFG), timed; then its
# other admitted shapes (the 64 px skip concat, 32 and 16 px, the stem on
# the image and the f32 head) and the shape of tests/test_ops.py:190.
BOTH = (torch.bfloat16, torch.float32)
CONV_SHAPES = [(2 * SAMPLE_SIZE, 64, 64, 192, 192, BOTH),
               (2 * SAMPLE_SIZE, 64, 64, 384, 192, BOTH),
               (2 * SAMPLE_SIZE, 32, 32, 384, 384, BOTH),
               (2 * SAMPLE_SIZE, 16, 16, 384, 576, BOTH),
               (2 * SAMPLE_SIZE, 64, 64, 3, 192, BOTH),
               (2 * SAMPLE_SIZE, 64, 64, 192, 3, (torch.float32,)),
               (2 * SAMPLE_SIZE, 8, 8, 768, 768, BOTH),
               (3, 12, 20, 64, 128, BOTH),
               (2, 16, 8, 24, 16, BOTH)]
# The wgrad at ADM-64's training batch first (timed), then the same shapes.
ADM_TRAIN_BATCH = 64
WGRAD_SHAPES = [(ADM_TRAIN_BATCH, 64, 64, 192, 192, BOTH)] + [
    s for s in CONV_SHAPES[1:] if s[1] != 8]
# Conv kernel against its plain version, relative to max|result|: both sum
# exact products in f32 (bf16 values multiply exactly) in another order;
# bf16 results may then round one step apart. The wgrad sums up to 524288
# products an element.
CONV_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
WGRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# Fused bias + leaky ReLU: ADM-64's widest 64 px activation at the sampling
# batch.
ACT_SHAPE = (2 * SAMPLE_SIZE, 64, 64, 192)

# Each kernel's launch counter, by the kernel's name in the result line.
COUNTERS = {"flash_fused_fwd": flash_attention_fused,
            "flash_fused_bwd": flash_attention_fused_bwd,
            "flash_fwd": flash_attention, "flash_bwd": flash_attention_bwd,
            "flash_p5_fwd": flash_attention_p5, "flash_p5_bwd": flash_attention_p5_bwd,
            "conv3x3_fwd": conv3x3_pallas, "conv3x3_wgrad": conv3x3_wgrad_pallas,
            "fused_act": fused_leaky_relu}
# The kernels whose wrappers choose among several kernels by shape, and
# count their launches by kernel (``launches_by_design``).
DESIGNS = {"conv3x3_fwd": CONV_DESIGNS, "conv3x3_wgrad": CONV_DESIGNS,
           "flash_p5_fwd": P5_FWD_DESIGNS}


def reset_launches():
    for fn in COUNTERS.values():
        fn.launches = 0
    for name, designs in DESIGNS.items():
        COUNTERS[name].launches_by_design = dict.fromkeys(designs, 0)


def read_launches() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def read_designs() -> dict:
    """Launches by kernel (wgmma, mma_sync, fma) of the conv forward, the
    wgrad and the p5 forward."""
    return {name: dict(COUNTERS[name].launches_by_design) for name in DESIGNS}


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b, tq, tk, h, d, dtype) -> tuple[float, str]:
    """Least time for one forward: q, k and v read once, o and lse written
    once, or the 4*B*H*Tq*Tk*D score and P.V operations at the dtype's
    peak."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * tq * h * d + 2 * b * tk * h * d) * elt + b * h * tq * 4
    flops = 4 * b * h * tq * tk * d
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def attention_bwd_bound_ms(b, tq, tk, h, d, dtype) -> tuple[float, str]:
    """Least time for one backward: q, k, v, o, dout and lse read once and
    dq, dk, dv written once, or the 10*B*H*Tq*Tk*D operations of its five
    products at the dtype's peak."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = (4 * b * tq * h * d + 4 * b * tk * h * d) * elt + b * h * tq * 4
    flops = 10 * b * h * tq * tk * d
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {torch.cuda.get_device_name(0)}", flush=True)
    return card


def phase_build():
    t0 = time.perf_counter()
    logs = _build.build()
    seconds = time.perf_counter() - t0
    for name in _build.KERNEL_SOURCES:
        log = logs.get(name, "")  # empty when the library was already built
        registers = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", log))
        print(f"[build] {name}: {_build.library_path(name).name}, "
              f"{len(registers)} kernel instantiations, registers per thread "
              f"{registers}, spill stores {spills} bytes")
    print(f"[build] {len(_build.KERNEL_SOURCES)} kernel source(s) in "
          f"{seconds:.1f} s", flush=True)


def phase_kernel(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_record = None
    shapes = [(B_MAIN, T_MAIN, H_MAIN, D_MAIN), (16, 257, 12, 64)] + [
        (4, t, 4, d) for t in FUSED_T for d in FUSED_D]
    for (b, t, h, d) in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((b, t, 3 * h * d), generator=gen,
                              device="cuda").to(dtype)
            o, lse = flash_attention_fused(qkv, h)
            torch.cuda.synchronize()
            ro, rlse = flash_attention_fused_reference(qkv, h)
            err = (o.float() - ro.float()).abs().max().item()
            lse_err = (lse - rlse).abs().max().item()
            tag = f"B={b} T={t} H={h} D={d} {str(dtype)[6:]}"
            print(f"[kernel] {tag}: max|o - plain| {err:.3e} (tol {ATOL[dtype]:.0e}), "
                  f"max|lse - plain| {lse_err:.3e} (tol {LSE_ATOL:.0e})", flush=True)
            check(torch.isfinite(o.float()).all().item(), f"{tag}: non-finite output")
            check(err <= ATOL[dtype] and lse_err <= LSE_ATOL, f"{tag}: kernel disagrees")
            if (b, t, dtype) != (B_MAIN, T_MAIN, torch.bfloat16):
                continue
            ms = cuda_ms(lambda: flash_attention_fused(qkv, h), iters=50)
            plain_ms = cuda_ms(lambda: flash_attention_fused_reference(qkv, h), iters=10)
            q, k, v = qkv.view(b, t, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=50)
            bound_ms, bound_by = attention_bound_ms(b, t, t, h, d, dtype)
            print(f"[kernel] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
                  f"kernel / sdpa {ms / library_ms:.3f} [{card}]", flush=True)
            main_record = dict(
                name="flash_fused_fwd", route="cuda",
                source="vaw_torch/ops/csrc/flash_fused_fwd.cu",
                replaces="vaw_tpu/ops/flash_attention.py:570",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    return main_record


def phase_bwd(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)
    main_record = None
    for (b, t, h, d) in [(DIT_TRAIN_BATCH, T_MAIN, H_MAIN, D_MAIN), (16, 257, 12, 64),
                         (16, 256, 6, 128)]:
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda").to(dtype)
            dout = torch.randn((b, t, h * d), generator=gen, device="cuda").to(dtype)
            o, lse = flash_attention_fused(qkv, h)
            dqkv = flash_attention_fused_bwd(qkv, o, lse, dout, h)
            torch.cuda.synchronize()
            want = flash_attention_fused_bwd_reference(qkv, o, lse, dout, h)
            scale = want.float().abs().max().item()
            err = (dqkv.float() - want.float()).abs().max().item()
            tag = f"B={b} T={t} H={h} D={d} {str(dtype)[6:]}"
            print(f"[bwd] {tag}: max|dqkv - plain| {err:.3e} = {err / scale:.3e} "
                  f"of max|dqkv| {scale:.3f} (tol {BWD_RTOL[dtype]:.0e})", flush=True)
            check(torch.isfinite(dqkv.float()).all().item(), f"{tag}: non-finite dqkv")
            check(err <= BWD_RTOL[dtype] * scale, f"{tag}: backward kernel disagrees")
            if (b, t, dtype) != (DIT_TRAIN_BATCH, T_MAIN, torch.bfloat16):
                continue
            ms = cuda_ms(lambda: flash_attention_fused_bwd(qkv, o, lse, dout, h), iters=20)
            plain_ms = cuda_ms(lambda: flash_attention_fused_bwd_reference(
                qkv, o, lse, dout, h), iters=3, warmup=1)
            # SDPA's backward on the same q/k/v views, from a retained graph.
            leaf = qkv.detach().requires_grad_(True)
            q, k, v = leaf.view(b, t, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
            sdpa_out = F.scaled_dot_product_attention(q, k, v)
            g4 = dout.view(b, t, h, d).transpose(1, 2)
            library_ms = cuda_ms(lambda: torch.autograd.grad(
                sdpa_out, (q, k, v), g4, retain_graph=True), iters=20)
            del leaf, q, k, v, sdpa_out
            bound_ms, bound_by = attention_bwd_bound_ms(b, t, t, h, d, dtype)
            print(f"[bwd] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}) [{card}]", flush=True)
            main_record = dict(
                name="flash_fused_bwd", route="cuda",
                source="vaw_torch/ops/csrc/flash_fused_bwd.cu",
                replaces="vaw_tpu/ops/flash_attention.py:592",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    return main_record


def _general_inputs(gen, b, tq, tk, h, d, dtype, packed):
    """q [B, Tq, H, D], k and v [B, Tk, H, D] on the card; with `packed`
    (Tq == Tk) the three views of one [B, T, 3, H, D] projection."""
    if packed:
        qkv = torch.randn((b, tq, 3, h, d), generator=gen, device="cuda").to(dtype)
        return qkv, qkv.unbind(2)
    q = torch.randn((b, tq, h, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, tk, h, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    return None, (q, k, v)


def phase_general(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(4)
    main_record = None
    for i, (b, tq, tk, h, d) in enumerate(GENERAL_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            _, (q, k, v) = _general_inputs(gen, b, tq, tk, h, d, dtype, packed=i == 0)
            o, lse = flash_attention_fwd(q, k, v)
            torch.cuda.synchronize()
            ro, rlse = flash_attention_reference(q, k, v)
            err = (o.float() - ro.float()).abs().max().item()
            lse_err = (lse - rlse).abs().max().item()
            del ro, rlse
            tag = f"B={b} Tq={tq} Tk={tk} H={h} D={d} {str(dtype)[6:]}"
            print(f"[general] {tag}: max|o - plain| {err:.3e} (tol {ATOL[dtype]:.0e}), "
                  f"max|lse - plain| {lse_err:.3e} (tol {LSE_ATOL:.0e})", flush=True)
            check(torch.isfinite(o.float()).all().item(), f"{tag}: non-finite output")
            check(err <= ATOL[dtype] and lse_err <= LSE_ATOL,
                  f"{tag}: general forward kernel disagrees")
            if i != 0 or dtype != torch.bfloat16:
                continue
            ms = cuda_ms(lambda: flash_attention_fwd(q, k, v), iters=50)
            plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v), iters=5,
                               warmup=1)
            qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh),
                                 iters=50)
            bound_ms, bound_by = attention_bound_ms(b, tq, tk, h, d, dtype)
            print(f"[general] {tag} (packed views): kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} "
                  f"ms ({bound_by}) [{card}]", flush=True)
            main_record = dict(
                name="flash_fwd", route="cuda", source="vaw_torch/ops/csrc/flash_fwd.cu",
                replaces="vaw_tpu/ops/flash_attention.py:88",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    return main_record


def phase_general_bwd(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(5)
    main_record = None
    for i, (b, tq, tk, h, d) in enumerate(GENERAL_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            qkv, (q, k, v) = _general_inputs(gen, b, tq, tk, h, d, dtype, packed=i == 0)
            dout = torch.randn((b, tq, h, d), generator=gen, device="cuda").to(dtype)
            o, lse = flash_attention_fwd(q, k, v)
            dqkv = torch.empty_like(qkv) if qkv is not None else None
            grads = dqkv.unbind(2) if dqkv is not None else None
            got = flash_attention_bwd(q, k, v, o, lse, dout, grads=grads)
            torch.cuda.synchronize()
            want = flash_attention_bwd_reference(q, k, v, o, lse, dout)
            tag = f"B={b} Tq={tq} Tk={tk} H={h} D={d} {str(dtype)[6:]}"
            worst = 0.0
            for name, x, w in zip(("dq", "dk", "dv"), got, want):
                scale = w.float().abs().max().item()
                err = (x.float() - w.float()).abs().max().item()
                worst = max(worst, err / scale)
                check(torch.isfinite(x.float()).all().item(), f"{tag}: non-finite {name}")
                check(err <= BWD_RTOL[dtype] * scale,
                      f"{tag}: general backward kernel disagrees in {name}")
            del want
            print(f"[general bwd] {tag}: max|grad - plain| / max|grad| over dq, dk, "
                  f"dv {worst:.3e} (tol {BWD_RTOL[dtype]:.0e})", flush=True)
            if i != 0 or dtype != torch.bfloat16:
                continue
            ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, lse, dout, grads=grads),
                         iters=20)
            plain_ms = cuda_ms(lambda: flash_attention_bwd_reference(
                q, k, v, o, lse, dout), iters=3, warmup=1)
            # SDPA's backward on the same q/k/v views, from a retained graph.
            leaf = qkv.detach().requires_grad_(True)
            qh, kh, vh = (x.transpose(1, 2) for x in leaf.unbind(2))
            sdpa_out = F.scaled_dot_product_attention(qh, kh, vh)
            library_ms = cuda_ms(lambda: torch.autograd.grad(
                sdpa_out, (qh, kh, vh), dout.transpose(1, 2), retain_graph=True), iters=20)
            del leaf, qh, kh, vh, sdpa_out
            bound_ms, bound_by = attention_bwd_bound_ms(b, tq, tk, h, d, dtype)
            print(f"[general bwd] {tag} (packed views, one packed gradient): kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa backward {library_ms:.4f} "
                  f"ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]", flush=True)
            main_record = dict(
                name="flash_bwd", route="cuda", source="vaw_torch/ops/csrc/flash_bwd.cu",
                replaces="vaw_tpu/ops/flash_attention.py:130",
                launches=None, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    return main_record


def _p5_inputs(gen, b, t, h, d, dtype):
    """f5 [B, 3, H, D, T] on the card, q and k at 0.5, v at 1."""
    f5 = torch.randn((b, 3, h, d, t), generator=gen, device="cuda")
    f5[:, :2] *= 0.5
    return f5.to(dtype)


def _bhtd(f5):
    """q, k and v of f5 copied to contiguous [B, H, T, D], SDPA's layout."""
    return [f5[:, i].transpose(-1, -2).contiguous() for i in range(3)]


def _used(name: str, before: dict) -> dict:
    """Launches by kernel of `name` since `before` (a read_designs())."""
    return {k: v - before[name][k] for k, v in read_designs()[name].items()
            if v > before[name][k]}


def _mma_sync_p5(f5):
    """The bf16 mma.sync kernel of flash_p5_fwd.cu on a call the router
    sends to wgmma: its time beside the wgmma kernel's. Not counted (it is
    no launch of a path)."""
    b, _, h, d, t = f5.shape
    out = torch.empty((b * h, d, t), dtype=f5.dtype, device=f5.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=f5.device)
    err = flash_ops._p5_fwd_kernel()(f5.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h,
                                     d, t, 1.0 / math.sqrt(d), 1,
                                     torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"mma.sync p5 forward launch failed: CUDA error {err}")
    return out, lse


def phase_p5(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(6)
    main_record = None
    for i, (b, t, h, d) in enumerate(P5_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            f5 = _p5_inputs(gen, b, t, h, d, dtype)
            before = read_designs()
            o, lse = flash_attention_p5_fwd(f5)
            torch.cuda.synchronize()
            design = flash_p5_fwd_design(dtype, 1.0 / math.sqrt(d))
            tag = f"B={b} T={t} H={h} D={d} {str(dtype)[6:]}"
            used = _used("flash_p5_fwd", before)
            check(used == {design: 1}, f"{tag}: p5 launches by kernel {used}, expected "
                  f"{ {design: 1} }")
            ro, rlse = flash_attention_p5_reference(f5)
            err = (o.float() - ro.float()).abs().max().item()
            lse_err = (lse - rlse).abs().max().item()
            print(f"[p5] {tag}: kernel {design}; max|o - plain| {err:.3e} (tol "
                  f"{ATOL[dtype]:.0e}), max|lse - plain| {lse_err:.3e} (tol "
                  f"{LSE_ATOL:.0e})", flush=True)
            check(torch.isfinite(o.float()).all().item(), f"{tag}: non-finite output")
            check(err <= ATOL[dtype] and lse_err <= LSE_ATOL,
                  f"{tag}: p5 forward kernel disagrees")
            if i != 0 or dtype != torch.bfloat16:
                del ro, rlse
                continue
            old_o, old_lse = _mma_sync_p5(f5)
            old_err = (old_o.float() - ro.float()).abs().max().item()
            old_lse_err = (old_lse - rlse).abs().max().item()
            del ro, rlse
            check(old_err <= ATOL[dtype] and old_lse_err <= LSE_ATOL,
                  f"{tag}: the mma.sync p5 kernel disagrees")
            ms = cuda_ms(lambda: flash_attention_p5_fwd(f5), iters=50)
            mma_sync_ms = cuda_ms(lambda: _mma_sync_p5(f5), iters=50)
            plain_ms = cuda_ms(lambda: flash_attention_p5_reference(f5), iters=10)
            q, k, v = _bhtd(f5)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=50)
            del q, k, v
            bound_ms, bound_by = attention_bound_ms(b, t, t, h, d, dtype)
            print(f"[p5] {tag}: kernel ({design}) {ms:.4f} ms, mma.sync kernel "
                  f"{mma_sync_ms:.4f} ms (max|o - plain| {old_err:.3e}), plain "
                  f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}); kernel / sdpa {ms / library_ms:.3f} [{card}]", flush=True)
            main_record = dict(
                name="flash_p5_fwd", route="cuda", source="vaw_torch/ops/csrc/flash_p5_fwd.cu",
                replaces="vaw_tpu/ops/flash_attention.py:414",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                mma_sync_ms=mma_sync_ms)
    return main_record


def phase_p5_bwd(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(7)
    main_record = None
    for i, (b, t, h, d) in enumerate(P5_BWD_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            f5 = _p5_inputs(gen, b, t, h, d, dtype)
            dout = torch.randn((b * h, d, t), generator=gen, device="cuda").to(dtype)
            o, lse = flash_attention_p5_fwd(f5)
            dqkv = flash_attention_p5_bwd(f5, o, lse, dout)
            torch.cuda.synchronize()
            want = flash_attention_p5_bwd_reference(f5, o, lse, dout)
            tag = f"B={b} T={t} H={h} D={d} {str(dtype)[6:]}"
            worst = 0.0
            for j, name in enumerate(("dq", "dk", "dv")):
                w = want[:, j].float()
                scale = w.abs().max().item()
                err = (dqkv[:, j].float() - w).abs().max().item()
                worst = max(worst, err / scale)
                check(torch.isfinite(dqkv[:, j].float()).all().item(),
                      f"{tag}: non-finite {name}")
                check(err <= BWD_RTOL[dtype] * scale,
                      f"{tag}: p5 backward kernel disagrees in {name}")
            del want
            print(f"[p5 bwd] {tag}: max|grad - plain| / max|grad| over dq, dk, dv "
                  f"{worst:.3e} (tol {BWD_RTOL[dtype]:.0e})", flush=True)
            if i != 0 or dtype != torch.bfloat16:
                continue
            ms = cuda_ms(lambda: flash_attention_p5_bwd(f5, o, lse, dout), iters=20)
            plain_ms = cuda_ms(lambda: flash_attention_p5_bwd_reference(
                f5, o, lse, dout), iters=3, warmup=1)
            # SDPA's backward on contiguous [B, H, T, D] copies, from a
            # retained graph.
            q, k, v = (x.requires_grad_(True) for x in _bhtd(f5))
            sdpa_out = F.scaled_dot_product_attention(q, k, v)
            g4 = dout.view(b, h, d, t).transpose(-1, -2)
            library_ms = cuda_ms(lambda: torch.autograd.grad(
                sdpa_out, (q, k, v), g4, retain_graph=True), iters=20)
            del q, k, v, sdpa_out
            bound_ms, bound_by = attention_bwd_bound_ms(b, t, t, h, d, dtype)
            print(f"[p5 bwd] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                  f"backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
                  f"[{card}]", flush=True)
            main_record = dict(
                name="flash_p5_bwd", route="cuda", source="vaw_torch/ops/csrc/flash_p5_bwd.cu",
                replaces="vaw_tpu/ops/flash_attention.py:443",
                launches=None, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    return main_record


def conv_bound_ms(n, h, w, cin, cout, dtype) -> tuple[float, str]:
    """Least time for one conv or wgrad: the two image operands (x and y,
    or x and g) and the filter read or written once, or the
    2*9*Cin*Cout*N*H*W operations at the dtype's peak."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = n * h * w * (cin + cout) * elt + 9 * cin * cout * elt
    flops = 2 * 9 * cin * cout * n * h * w
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def _conv_inputs(gen, n, h, w, cin, cout, dtype):
    x = torch.randn((n, h, w, cin), generator=gen, device="cuda").to(dtype)
    wt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
          / math.sqrt(9 * cin)).to(dtype)
    g = torch.randn((n, h, w, cout), generator=gen, device="cuda").to(dtype)
    return x, wt, g


def _rel_err(got, want) -> tuple[float, float]:
    scale = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() / scale, scale


def _mma_sync_conv(x, wt):
    """The bf16 mma.sync kernel of conv3x3_fwd.cu on any shape, also one the
    router sends to wgmma: its time beside the wgmma kernel's. Not counted
    (it is no launch of a path)."""
    n, h, w, cin = x.shape
    cout = wt.shape[-1]
    wk = wt.permute(3, 0, 1, 2).reshape(cout, 9 * cin).contiguous()
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    err = conv_ops._fwd_kernel()(x.data_ptr(), wk.data_ptr(), y.data_ptr(), n, h, w,
                                 cin, cout, 9 * cin, 1,
                                 torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"mma.sync conv launch failed: CUDA error {err}")
    return y


def phase_conv(card: str) -> dict:
    """3g: the conv forward and its dgrad (the same kernels on the rotated,
    in/out-swapped filter) against the plain version, each shape through
    the kernel conv3x3_design picks for it."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    main_record = None
    for i, (n, h, w, cin, cout, dtypes) in enumerate(CONV_SHAPES):
        for dtype in dtypes:
            x, wt, g = _conv_inputs(gen, n, h, w, cin, cout, dtype)
            w_rot = wt.flip(0, 1).transpose(2, 3)
            before = read_designs()
            y = conv3x3_pallas(x, wt)
            dx = conv3x3_pallas(g, w_rot)
            torch.cuda.synchronize()
            used = _used("conv3x3_fwd", before)
            designs = (conv3x3_design(x.shape, cout, dtype),
                       conv3x3_design(g.shape, cin, dtype))
            tag = f"N={n} {h}x{w} {cin}->{cout} {str(dtype)[6:]}"
            want_used = {d: designs.count(d) for d in designs}
            check(used == want_used, f"{tag}: conv launches by kernel {used}, "
                  f"expected {want_used}")
            errs, abs_errs = [], []
            for name, got, want in (("y", y, conv3x3_reference(x, wt)),
                                    ("dx", dx, conv3x3_reference(g, w_rot))):
                check(torch.isfinite(got.float()).all().item(), f"{tag}: non-finite {name}")
                err, scale = _rel_err(got, want)
                errs.append(err)
                abs_errs.append(err * scale)
                check(err <= CONV_RTOL[dtype], f"{tag}: conv kernel disagrees in {name}")
                del want
            print(f"[conv] {tag}: kernels y {designs[0]}, dgrad {designs[1]}; max|y - "
                  f"plain| / max|y| {errs[0]:.3e}, dgrad {errs[1]:.3e} (tol "
                  f"{CONV_RTOL[dtype]:.0e})", flush=True)
            if i != 0 or dtype != torch.bfloat16:
                continue
            old = _mma_sync_conv(x, wt)
            old_err, _ = _rel_err(old, conv3x3_reference(x, wt))
            check(old_err <= CONV_RTOL[dtype], f"{tag}: the mma.sync kernel disagrees")
            ms = cuda_ms(lambda: conv3x3_pallas(x, wt), iters=20)
            mma_sync_ms = cuda_ms(lambda: _mma_sync_conv(x, wt), iters=20)
            plain_ms = cuda_ms(lambda: conv3x3_reference(x, wt), iters=3, warmup=1)
            # cuDNN on the channels-last view of the same tensors (no TF32).
            xc, wc = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            library_ms = cuda_ms(lambda: F.conv2d(xc, wc, padding=1), iters=20)
            bound_ms, bound_by = conv_bound_ms(n, h, w, cin, cout, dtype)
            print(f"[conv] {tag}: kernel ({designs[0]}) {ms:.4f} ms, mma.sync kernel "
                  f"{mma_sync_ms:.4f} ms (max rel err {old_err:.3e}), plain "
                  f"{plain_ms:.4f} ms, cuDNN {library_ms:.4f} ms, bound {bound_ms:.4f} "
                  f"ms ({bound_by}); kernel / cuDNN {ms / library_ms:.3f} [{card}]",
                  flush=True)
            main_record = dict(
                name="conv3x3_fwd", route="cuda", source="vaw_torch/ops/csrc/conv3x3_fwd.cu",
                replaces="vaw_tpu/ops/conv2d.py:41",
                launches=None, max_abs_err=abs_errs[0], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                mma_sync_ms=mma_sync_ms)
    return main_record


def _mma_sync_wgrad(x, g):
    """The bf16 mma.sync wgrad of conv3x3_wgrad.cu (its own split and sum)
    on any shape, also one the router sends to wgmma: its time beside the
    wgmma kernel's. Not counted (it is no launch of a path)."""
    n, h, w, cin = x.shape
    cout = g.shape[-1]
    lib = conv_ops._wgrad_lib()
    splits = lib.vaw_conv3x3_wgrad_splits(n, h, w, cin, cout, 1)
    work = torch.empty((splits, 9 * cin, cout), dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, cin, cout), dtype=x.dtype, device=x.device)
    err = lib.vaw_conv3x3_wgrad(x.data_ptr(), g.data_ptr(), work.data_ptr(), dw.data_ptr(),
                                n, h, w, cin, cout, splits, 1,
                                torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"mma.sync wgrad launch failed: CUDA error {err}")
    return dw


def phase_wgrad(card: str) -> dict:
    """3h: the wgrad (split-K partials and their fixed-order sum) against
    the plain version, each shape through the kernel conv3x3_wgrad_design
    picks for it."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    main_record = None
    for i, (n, h, w, cin, cout, dtypes) in enumerate(WGRAD_SHAPES):
        for dtype in dtypes:
            x, _, g = _conv_inputs(gen, n, h, w, cin, cout, dtype)
            before = read_designs()
            dw = conv3x3_wgrad_pallas(x, g)
            again = conv3x3_wgrad_pallas(x, g)
            torch.cuda.synchronize()
            design = conv3x3_wgrad_design(x.shape, cout, dtype)
            tag = f"N={n} {h}x{w} {cin}->{cout} {str(dtype)[6:]}"
            used = _used("conv3x3_wgrad", before)
            check(used == {design: 2}, f"{tag}: wgrad launches by kernel {used}, "
                  f"expected { {design: 2} }")
            want = conv3x3_wgrad_reference(x, g)
            err, scale = _rel_err(dw, want)
            print(f"[wgrad] {tag}: kernel {design}; max|dw - plain| / max|dw| {err:.3e} "
                  f"of {scale:.3f} (tol {WGRAD_RTOL[dtype]:.0e}), repeat bit-equal "
                  f"{torch.equal(dw, again)}", flush=True)
            check(torch.isfinite(dw.float()).all().item(), f"{tag}: non-finite dw")
            check(err <= WGRAD_RTOL[dtype], f"{tag}: wgrad kernel disagrees")
            check(torch.equal(dw, again), f"{tag}: wgrad differs from run to run")
            if i != 0 or dtype != torch.bfloat16:
                continue
            old_err, _ = _rel_err(_mma_sync_wgrad(x, g), want)
            check(old_err <= WGRAD_RTOL[dtype], f"{tag}: the mma.sync wgrad disagrees")
            ms = cuda_ms(lambda: conv3x3_wgrad_pallas(x, g), iters=20)
            mma_sync_ms = cuda_ms(lambda: _mma_sync_wgrad(x, g), iters=20)
            plain_ms = cuda_ms(lambda: conv3x3_wgrad_reference(x, g), iters=3, warmup=1)
            xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            library_ms = cuda_ms(lambda: torch.nn.grad.conv2d_weight(
                xc, (cout, cin, 3, 3), gc, padding=1), iters=20)
            bound_ms, bound_by = conv_bound_ms(n, h, w, cin, cout, dtype)
            print(f"[wgrad] {tag}: kernel ({design}, plan {conv3x3_wgrad_plan(n, h, w, cin, cout)}) "
                  f"{ms:.4f} ms, mma.sync kernel {mma_sync_ms:.4f} ms (max rel err "
                  f"{old_err:.3e}), plain {plain_ms:.4f} ms, cuDNN conv2d_weight "
                  f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); kernel / "
                  f"cuDNN {ms / library_ms:.3f} [{card}]", flush=True)
            main_record = dict(
                name="conv3x3_wgrad", route="cuda",
                source="vaw_torch/ops/csrc/conv3x3_wgrad.cu",
                replaces="vaw_tpu/ops/conv2d.py:141",
                launches=None, max_abs_err=err * scale, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                mma_sync_ms=mma_sync_ms)
    return main_record


def phase_act(card: str) -> tuple[dict, int]:
    """3i: the fused bias + leaky ReLU, which no model calls: its own run
    through the op entry (values, first and second derivatives, counted),
    against the plain version, then the times. Returns the record and the
    launches of that run."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    main_record, own = None, 0
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(ACT_SHAPE, generator=gen, device="cuda").to(dtype)
        b = (0.5 * torch.randn(ACT_SHAPE[-1:], generator=gen, device="cuda")).to(dtype)
        g = torch.randn(ACT_SHAPE, generator=gen, device="cuda").to(dtype)

        def derivatives(fn):
            """The op's value, its gradients against g, and the second
            derivative d/dx sum(d/dx sum(out^2))."""
            xg, bg = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
            out = fn(xg, bg)
            dx, db = torch.autograd.grad((out.float() * g.float()).sum(), (xg, bg),
                                         retain_graph=True)
            (gx,) = torch.autograd.grad((out.float() ** 2).sum(), xg, create_graph=True)
            (h,) = torch.autograd.grad(gx.float().sum(), xg)
            return out.detach(), dx, db, h

        before = fused_leaky_relu.launches
        got = derivatives(fused_leaky_relu)
        own += fused_leaky_relu.launches - before
        torch.cuda.synchronize()
        want = derivatives(fused_leaky_relu_reference)
        tag = f"{tuple(ACT_SHAPE)} {str(dtype)[6:]}"
        err = (got[0].float() - want[0].float()).abs().max().item()
        gerr = max(_rel_err(a, b_)[0] for a, b_ in zip(got[1:], want[1:]))
        print(f"[act] {tag}: max|out - plain| {err:.3e} (tol 0), first and second "
              f"derivatives max rel err {gerr:.3e} (tol {WGRAD_RTOL[dtype]:.0e})",
              flush=True)
        check(all(torch.isfinite(a.float()).all().item() for a in got),
              f"{tag}: non-finite fused_act output or gradient")
        check(err == 0.0, f"{tag}: fused_act kernel disagrees")
        check(gerr <= WGRAD_RTOL[dtype], f"{tag}: fused_act derivatives disagree")
        del got, want
        if dtype != torch.bfloat16:
            continue
        slope, scale = 0.2, 2 ** 0.5
        ms = cuda_ms(lambda: fused_leaky_relu(x, b), iters=50)
        plain_ms = cuda_ms(lambda: fused_leaky_relu_reference(x, b), iters=20)
        eager_ms = cuda_ms(lambda: F.leaky_relu(x + b, slope) * scale, iters=50)
        nbytes = 2 * x.numel() * x.element_size() + b.numel() * b.element_size()
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"[act] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, eager "
              f"F.leaky_relu(x + b) * scale {eager_ms:.4f} ms (three PyTorch calls; no "
              f"single call computes it), bound {bound_ms:.4f} ms (bytes) [{card}]",
              flush=True)
        main_record = dict(
            name="fused_act", route="cuda", source="vaw_torch/ops/csrc/fused_act.cu",
            replaces="vaw_tpu/ops/fused_act.py:34",
            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by="bytes", library_ms=None, eager_ms=eager_ms)
    return main_record, own


def seeded_dit_b() -> torch.nn.Module:
    """DiT-B/2 with f32 master weights from a seed; the zero-initialised
    adaLN modulation and head get small seeded noise so that samples are
    not just the scaled input noise."""
    torch.manual_seed(0)
    model = DiT_B(image_size=32, patch_size=2, in_channels=4,
                  class_dropout_prob=0.1, num_classes=1000,
                  learn_sigma=False).cuda()
    heads = [blk.adaLN_modulation[1] for blk in model.blocks] + [
        model.final_layer.adaLN_modulation[1], model.final_layer.linear]
    with torch.no_grad():
        for lin in heads:
            lin.weight.normal_(0.0, 0.02)
            lin.bias.normal_(0.0, 0.02)
    return model.eval()


def seeded_uvit_l() -> torch.nn.Module:
    """U-ViT-L/2 with f32 weights from a seed (the JAX model's initialisers)."""
    torch.manual_seed(0)
    return UViT_L(image_size=32, patch_size=2, in_channels=4, num_classes=1000,
                  class_dropout_prob=0.1).cuda().eval()


def seeded_unet(ctor) -> torch.nn.Module:
    """A UNet with f32 weights from a seed (the JAX model's initialisers);
    the zero-initialised ResBlock output convs, attention projections and
    final conv get small seeded noise so that no block is the identity and
    the output is not zero."""
    torch.manual_seed(0)
    model = ctor().cuda()
    zero = [model.out[2]] + [m.proj_out for m in model.modules()
                             if isinstance(m, unet_module.AttentionBlock)] + [
        m.out_layers[3] for m in model.modules() if isinstance(m, unet_module.ResBlock)]
    with torch.no_grad():
        for layer in zero:
            layer.weight.normal_(0.0, 0.02)
            layer.bias.normal_(0.0, 0.02)
    return model.eval()


def _plain_fused(qkv2d, num_heads, scale=None):
    return flash_attention_fused_reference(qkv2d, num_heads, scale)[0]


def _plain_packed(qkv, scale=None):
    return flash_attention_reference(*qkv.unbind(2), scale)[0]


class Family(NamedTuple):
    """One model's path through the phases: its CLI model flags, the
    launches of each kernel in one forward and in one backward of the model,
    its batches, how to build it, the entries to replace with their plain
    versions for the plain route (each a mock.patch.object triple), its
    input image shape and the environment its phases run under."""
    tag: str
    model_args: list
    fwd: dict
    bwd: dict
    train_batch: int
    grad_batch: int
    seeded: Callable[[], torch.nn.Module]
    ctor: Callable[..., torch.nn.Module]
    plain: tuple
    image: tuple = (32, 32, 4)
    env: dict = {}
    # Launches of an f32 forward and backward where they differ (the conv
    # gate's budget depends on the dtype's size).
    fwd_f32: dict = None
    bwd_f32: dict = None
    # Launches by kernel in one bf16 forward and backward, {kernel name:
    # {design: launches}}, for the kernels of DESIGNS on the path.
    fwd_design: dict = {}
    bwd_design: dict = {}

    @property
    def f32(self) -> tuple:
        return self.fwd_f32 or self.fwd, self.bwd_f32 or self.bwd


@contextlib.contextmanager
def plain_route(fam: Family):
    with contextlib.ExitStack() as stack:
        for target in fam.plain:
            stack.enter_context(mock.patch.object(*target))
        yield


@contextlib.contextmanager
def environment(env: dict):
    """os.environ with `env` set, restored on exit."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


MODEL_ARGS = ["--image_size", "32", "--patch_size", "2", "--in_chans", "4",
              "--num_classes", "1000", "--class_cond", "True",
              "--drop_label_prob", "0.1", "--amp", "True"]
RECIPE_ARGS = ["--dataset", "Gaussian", "--weight_type", "lambda", "--mean_type",
               "EPSILON", "--path_type", "cosine", "--betas", "0.9", "0.95",
               "--total_steps", str(TRAIN_STEPS), "--eval", "False",
               "--sample_freq", "0", "--save_step", str(TRAIN_STEPS)]
# DiT-B/2: T = 256, 12 heads of 64, 12 blocks, through the fused p6 kernels.
DIT = Family("DiT-B/2", ["--model", "DiT-B"] + MODEL_ARGS, {"flash_fused_fwd": 12},
             {"flash_fused_bwd": 12}, DIT_TRAIN_BATCH, 32, seeded_dit_b,
             lambda: DiT_B(image_size=32, patch_size=2, in_channels=4,
                           class_dropout_prob=0.1, num_classes=1000, learn_sigma=False),
             ((model_layers, "multi_head_attention_fused", _plain_fused),))
# U-ViT-L/2: T = 1 label + 1 time + 256 patch tokens = 258, 16 heads of 64,
# 21 blocks (10 in, 1 mid, 10 out), through the general-T kernels; batch
# 128 in training (no remat yet).
UVIT = Family("U-ViT-L/2", ["--model", "U-ViT-L"] + MODEL_ARGS, {"flash_fwd": 21},
              {"flash_bwd": 21}, 128, 16, seeded_uvit_l,
              lambda: UViT_L(image_size=32, patch_size=2, in_channels=4,
                             num_classes=1000, class_dropout_prob=0.1),
              ((uvit_module, "multi_head_attention_packed", _plain_packed),))
# LDM: 16 attention blocks a forward, heads of 32 channels: 5 at 16x16
# (T = 256, 16 heads) through the p5 kernels, 5 at 32x32 (T = 1024, 8 heads)
# and 6 at 8x8 (T = 64, 32 heads) through the general ones; batch 256 in
# training.
def _ldm():
    return LDM(num_classes=1000, in_channels=4, drop_label_prob=0.1)


LDM_FAMILY = Family("LDM", ["--model", "LDM"] + MODEL_ARGS,
                    {"flash_p5_fwd": 5, "flash_fwd": 11},
                    {"flash_p5_bwd": 5, "flash_bwd": 11}, LDM_TRAIN_BATCH, 16,
                    lambda: seeded_unet(_ldm), _ldm,
                    ((unet_module, "multi_head_attention_packed", _plain_packed),),
                    # bf16: every p5 forward on the TMA + wgmma kernel.
                    fwd_design={"flash_p5_fwd": {"wgmma": 5}})


# ADM-64: pixel space, 64x64x3, 192 channels, mult (1, 2, 3, 4), 3 res
# blocks a level, attention at 32, 16 and 8 px with heads of 64, 295.9M
# parameters, under VAW_PALLAS_CONV=1. A forward sends 30 of its 71
# stride-1 3x3 convs through the conv kernel (the JAX gate's choice; the
# rest, all at 8 px or past the gate's budget, go to cuDNN) and its 22
# attention blocks (T = 1024, 256, 64) through the general kernels: at
# T = 256 with nine heads of 64 the p5 gate admits only B in {1, 2, 4}. A
# backward runs 29 dgrads (none for the image at the stem) and 30 wgrads.
# In f32 the gate's budget admits 26 (not the 64 px 384 -> 192 convs and the
# 16 px 384 -> 576 one).
def _adm64():
    return ADM_64(num_classes=1000, in_channels=3, drop_label_prob=0.1)


ADM64 = Family("ADM-64", ["--model", "ADM-64", "--image_size", "64", "--in_chans", "3",
                          "--num_classes", "1000", "--class_cond", "True",
                          "--drop_label_prob", "0.1", "--amp", "True"],
               {"conv3x3_fwd": 30, "flash_fwd": 22},
               {"conv3x3_fwd": 29, "conv3x3_wgrad": 30, "flash_bwd": 22},
               ADM_TRAIN_BATCH, 16, lambda: seeded_unet(_adm64), _adm64,
               ((unet_module, "multi_head_attention_packed", _plain_packed),
                (unet_module, "conv3x3", conv3x3_reference)),
               image=(64, 64, 3), env={"VAW_PALLAS_CONV": "1"},
               fwd_f32={"conv3x3_fwd": 26, "flash_fwd": 22},
               bwd_f32={"conv3x3_fwd": 25, "conv3x3_wgrad": 26, "flash_bwd": 22},
               # bf16: Cin and Cout multiples of 64 on wgmma, the 3-channel
               # stem on mma.sync, the f32 head (its dgrad and wgrad) on FMAs.
               fwd_design={"conv3x3_fwd": {"wgmma": 28, "mma_sync": 1, "fma": 1}},
               bwd_design={"conv3x3_fwd": {"wgmma": 28, "fma": 1},
                           "conv3x3_wgrad": {"wgmma": 28, "mma_sync": 1, "fma": 1}})


def expect(*per_call: tuple) -> dict:
    """Every kernel's expected launches, from (launches per model call,
    calls) pairs: the sums for the kernels named, 0 for the others."""
    want = dict.fromkeys(COUNTERS, 0)
    for counts, calls in per_call:
        for name, n in counts.items():
            want[name] += n * calls
    return want


def expect_designs(*per_call: tuple) -> dict:
    """Every kernel's expected launches by design, from ({kernel: {design:
    launches}} per model call, calls) pairs; 0 for the others."""
    want = {name: dict.fromkeys(designs, 0) for name, designs in DESIGNS.items()}
    for counts, calls in per_call:
        for name, by_design in counts.items():
            for design, n in by_design.items():
                want[name][design] += n * calls
    return want


def phase_sample(card: str, fam: Family, model: torch.nn.Module) -> dict:
    finite, batch_s = [], []
    inverse_normalize = sampler_driver._inverse_normalize
    edm_batch = sampler_driver.Sampler._edm_batch

    def checked_inverse_normalize(x):
        finite.append(bool(torch.isfinite(x).all().item()))
        return inverse_normalize(x)

    def timed_edm_batch(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = edm_batch(self, *args, **kwargs)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        return out

    # Heun: 2 * 18 - 1 model calls per batch.
    calls = (2 * STEPS - 1) * (NUM_SAMPLES // SAMPLE_SIZE)
    want = expect((fam.fwd, calls))
    want_designs = expect_designs((fam.fwd_design, calls))
    with tempfile.TemporaryDirectory(prefix="vaw_chip_smoke_") as tmp:
        ckpt = Path(tmp) / "ema.pt"
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        torch.save({"ema": state, "step": 0}, ckpt)
        out_dir = Path(tmp) / "samples"
        argv = fam.model_args + [
            "--solver", "heun", "--discretization", "edm", "--sample_steps", str(STEPS),
            "--guidance_scale", "1.5", "--sample_size", str(SAMPLE_SIZE),
            "--num_samples", str(NUM_SAMPLES), "--resume", str(ckpt),
            "--save_path", str(out_dir)]
        with mock.patch.object(sampler_driver, "_inverse_normalize",
                               checked_inverse_normalize), \
                mock.patch.object(sampler_driver.Sampler, "_edm_batch", timed_edm_batch):
            reset_launches()
            t0 = time.perf_counter()
            sample_cli.main(argv)
            wall = time.perf_counter() - t0
            counts = read_launches()
            designs = read_designs()
        pngs = list(out_dir.rglob("*.png"))
    print(f"[sample] {fam.tag}: {len(pngs)} PNGs, finite before uint8 per batch "
          f"{finite}, launches {counts} (expected {want})")
    check(len(pngs) == NUM_SAMPLES, f"{len(pngs)} PNGs, expected {NUM_SAMPLES}")
    check(len(finite) == NUM_SAMPLES // SAMPLE_SIZE and all(finite),
          f"{fam.tag}: non-finite samples before the uint8 cast")
    check(counts == want, f"{fam.tag} sampling launches {counts}, expected {want}")
    print(f"[sample] {fam.tag}: launches by kernel {designs} (expected "
          f"{want_designs})")
    check(designs == want_designs, f"{fam.tag} sampling launches by kernel "
          f"{designs}, expected {want_designs}")
    per_batch = ", ".join(f"{SAMPLE_SIZE / s:.2f}" for s in batch_s)
    print(f"[sample] {fam.tag} EDM Heun {STEPS} steps CFG 1.5 bf16, batches of "
          f"{SAMPLE_SIZE}: samples/s per batch [{per_batch}] (first includes "
          f"warm-up), CLI wall {wall:.2f} s for {NUM_SAMPLES} [{card}]", flush=True)
    return counts, designs


def phase_model(fam: Family, model: torch.nn.Module):
    """One forward at B=128 through the kernel, in f32 and in the sampler's
    bf16 copy, against the f32 forward through the plain attention."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    b = 2 * SAMPLE_SIZE
    x = torch.randn((b, *fam.image), generator=gen, device="cuda")
    t = torch.rand((b,), generator=gen, device="cuda") * 999
    y = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    with torch.inference_mode():
        with plain_route(fam):
            want = model(x, t, y)
        before = read_launches()
        got_f32 = model(x, t, y)
        launched = {k: n - before[k] for k, n in read_launches().items()}
        fwd_f32 = fam.f32[0]
        check(launched == expect((fwd_f32, 1)),
              f"{fam.tag}: the kernel route launched {launched}, expected {fwd_f32}")
        got_bf16 = cast_for_compute(model, torch.bfloat16)(x, t, y)
    scale = want.abs().max().item()
    for name, got, tol in (("f32", got_f32, MODEL_F32_RTOL),
                           ("bf16", got_bf16, MODEL_BF16_RTOL)):
        rel = (got - want).abs().max().item() / scale
        print(f"[model] {fam.tag} B={b} {name} kernels vs f32 plain route: max rel "
              f"err {rel:.3e} (tol {tol:.0e}), max|out| {scale:.3f}", flush=True)
        check(math.isfinite(rel) and rel <= tol, f"{fam.tag}: {name} forward disagrees")


def phase_train(card: str, fam: Family) -> dict:
    """The training path through vaw_torch.cli.main.main; Trainer.step is
    wrapped to keep each step's loss (a device tensor, read after the run)
    and a CUDA event after it, so the run is timed without extra syncs. The
    step-30 checkpoint must load back into the model with every EMA
    tensor the run ended with (U-ViT's learned pos_embed included)."""
    losses, events = [], []
    step = Trainer.step

    def recorded_step(self, state, batch):
        state, metrics = step(self, state, batch)
        losses.append(metrics["loss"])
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return state, metrics

    want = expect((fam.fwd, TRAIN_STEPS), (fam.bwd, TRAIN_STEPS))
    want_designs = expect_designs((fam.fwd_design, TRAIN_STEPS),
                                  (fam.bwd_design, TRAIN_STEPS))
    name = fam.model_args[1]
    with tempfile.TemporaryDirectory(prefix="vaw_chip_train_") as tmp:
        argv = fam.model_args + RECIPE_ARGS + [
            "--batch_size", str(fam.train_batch), "--logdir", tmp]
        with mock.patch.object(Trainer, "step", recorded_step):
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            ctx = train_cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            designs = read_designs()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        trained = {k: v.detach().cpu() for k, v in ctx["state"].ema.items()}
        del ctx
        torch.cuda.empty_cache()
        ckpts = glob.glob(f"{tmp}/*/checkpoint/{name}_EPSILON_cosine_{TRAIN_STEPS}.pt")
        check(len(ckpts) == 1, f"checkpoint of step {TRAIN_STEPS}: found {ckpts}")
        with torch.device("meta"):  # shapes only; every parameter comes from the file
            model = fam.ctor()
        model = model.to_empty(device="cpu")
        ckpt_step = load_checkpoint(ckpts[0], model)
        loaded = all(torch.equal(p.detach(), trained[k])
                     for k, p in model.named_parameters())
        del model, trained
    values = [float(x) for x in losses]
    seconds = events[TRAIN_WARMUP - 1].elapsed_time(events[-1]) / 1e3
    imgs_per_s = (TRAIN_STEPS - TRAIN_WARMUP) * fam.train_batch / seconds
    print(f"[train] {fam.tag}: {len(values)} steps, loss first {values[0]:.5f} last "
          f"{values[-1]:.5f}, all finite {all(map(math.isfinite, values))}; launches "
          f"{launches} (expected {want}); checkpoint {Path(ckpts[0]).name} (step "
          f"{ckpt_step}) loads back with the run's EMA weights: {loaded}")
    print(f"[train] {fam.tag} losses {[round(v, 5) for v in values]}")
    print(f"[train] {fam.tag} batch {fam.train_batch} bf16 over f32 masters, fused "
          f"AdamW+EMA: {imgs_per_s:.2f} imgs/s over steps {TRAIN_WARMUP + 1}-"
          f"{TRAIN_STEPS} ({1e3 * seconds / (TRAIN_STEPS - TRAIN_WARMUP):.2f} ms/step, "
          f"CUDA events), CLI wall {wall:.2f} s, peak memory {peak_gb:.2f} GiB [{card}]",
          flush=True)
    check(len(values) == TRAIN_STEPS and all(map(math.isfinite, values)),
          f"{fam.tag}: non-finite training loss")
    check(values[-1] < values[0], f"{fam.tag}: loss did not fall: {values[0]} -> "
          f"{values[-1]}")
    check(ckpt_step == TRAIN_STEPS and loaded,
          f"{fam.tag}: checkpoint step {ckpt_step}, EMA weights loaded back {loaded}")
    check(launches == want, f"{fam.tag} train launches {launches}, expected {want}")
    print(f"[train] {fam.tag}: launches by kernel {designs} (expected "
          f"{want_designs})")
    check(designs == want_designs, f"{fam.tag} train launches by kernel "
          f"{designs}, expected {want_designs}")
    return launches, designs


def _grad_group(name: str) -> str:
    """blocks.3.attn.qkv.weight -> blocks.attn.qkv; mid_block.norm1.bias ->
    mid_block.norm1; x_embedder.proj.bias -> x_embedder."""
    parts = name.split(".")
    if parts[0] in ("blocks", "in_blocks", "out_blocks", "mid_block", "input_blocks",
                    "middle_block", "output_blocks"):
        return ".".join([parts[0]] + [p for p in parts[1:-1] if not p.isdigit()])
    return parts[0]


def phase_grad(fam: Family):
    """One backward in f32 through the kernels against the same backward
    through the plain attention, per parameter group."""
    model = fam.seeded().float().train()
    gen = torch.Generator(device="cuda").manual_seed(3)
    b = fam.grad_batch
    x = torch.randn((b, *fam.image), generator=gen, device="cuda")
    t = torch.rand((b,), generator=gen, device="cuda") * 999
    y = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    g = torch.randn((b, *fam.image), generator=gen, device="cuda")

    def grads():
        model.zero_grad(set_to_none=True)
        (model(x, t, y) * g).sum().backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    with plain_route(fam):
        want = grads()
    before = read_launches()
    got = grads()
    launched = {k: n - before[k] for k, n in read_launches().items()}
    fwd, bwd = fam.f32
    check(launched == expect((fwd, 1), (bwd, 1)), f"{fam.tag}: the kernel "
          f"route launched {launched}, expected {fwd} and {bwd}")
    launched = {k: n - fwd.get(k, 0) for k, n in launched.items() if k in bwd}
    worst = {}
    for name in want:
        group = _grad_group(name)
        scale = want[name].abs().max().item()
        err = (got[name] - want[name]).abs().max().item()
        prev = worst.get(group, (0.0, 0.0))
        worst[group] = (max(prev[0], err), max(prev[1], scale))
    rel = {k: e / s if s > 0 else e for k, (e, s) in worst.items()}
    print(f"[grad] {fam.tag} B={b} f32 kernels vs plain route (backward "
          f"launches {launched}), max rel grad error per group: "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(rel.items()))
          + f" (tol {GRAD_F32_RTOL:.0e})", flush=True)
    check(all(math.isfinite(v) and v <= GRAD_F32_RTOL for v in rel.values()),
          f"{fam.tag}: f32 model gradient disagrees")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    card = phase_device()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = [phase_kernel(card), phase_bwd(card), phase_general(card),
               phase_general_bwd(card), phase_p5(card), phase_p5_bwd(card),
               phase_conv(card), phase_wgrad(card)]
    act_record, act_launches = phase_act(card)
    records.append(act_record)
    by_path, designs_by_path = {}, {}
    for key, fam in (("dit", DIT), ("uvit", UVIT), ("ldm", LDM_FAMILY), ("adm64", ADM64)):
        with environment(fam.env):
            model = fam.seeded()
            by_path[f"sample_{key}"], designs_by_path[f"sample_{key}"] = phase_sample(
                card, fam, model)
            phase_model(fam, model)
            del model
            torch.cuda.empty_cache()
            by_path[f"train_{key}"], designs_by_path[f"train_{key}"] = phase_train(
                card, fam)
            phase_grad(fam)
            torch.cuda.empty_cache()
    for record in records:
        record["launches_by_path"] = {p: n[record["name"]] for p, n in by_path.items()}
    # No model calls the fused bias + leaky ReLU: its launches are those of
    # its own run through the op entry in phase 3i.
    act_record["launches_by_path"]["op_entry_3i"] = act_launches
    for record in records:
        record["launches"] = sum(record["launches_by_path"].values())
    # Launches by kernel (wgmma, mma.sync, FMA) and path of the conv forward,
    # the wgrad and the p5 forward.
    for record in records:
        if record["name"] in DESIGNS:
            record["launches_by_design_by_path"] = {
                design: {p: d[record["name"]][design] for p, d in designs_by_path.items()}
                for design in DESIGNS[record["name"]]}
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
