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
  3b. bwd     the fused backward against its plain version at the training
              shape (B=256, T=256, H=12, D=64) in bf16 and f32, and at T=257
              and D=128, each through the kernels its call selects (bf16
              with D <= 64: flash_bwd.cu's TMA + wgmma pair on the packed
              row's views; D = 128: flash_fused_bwd.cu's mma.sync kernels;
              f32: its FMA kernels; counted) and bit-equal when repeated,
              with the same times and the old mma.sync kernels' time and
              error at the first shape; the library call is
              scaled_dot_product_attention's backward.
  3c. general the general-T forward (flash_fwd.cu; TMA + wgmma in bf16 for
              D <= 128) against its plain version: the U-ViT-L/2 sampling
              shape (B=128, T=258, H=16, D=64, q, k and v as views of one
              packed projection), Tq=77 with Tk=300, D=72, D=256, T=4096,
              LDM's (16, 1024, 8, 32) and (128, 64, 32, 32) and ADM-64's
              (16, T, H, 64) for T, H = 1024, 6; 256, 9; 64, 12, bf16 and
              f32, each through the kernel its call selects (wgmma,
              mma.sync or FMA, counted), with the four times at the first
              shape and the mma.sync kernel's time and error there; then,
              held against the plain version first, the kernel, the
              mma.sync kernel, SDPA and the bound at LDM's and ADM-64's
              T = 1024 shapes (B=128; 8 heads of 32, 6 heads of 64).
  3d. general bwd  the general-T backward (flash_bwd.cu; TMA + wgmma in bf16
              for D <= 64) at the same shapes (one packed gradient at the
              first), each through the kernels its call selects (counted)
              and bit-equal when repeated, with the four times and the
              mma.sync kernels' at the first shape; the same checks, then
              the times, at the two T = 1024 shapes.
  3e. p5      the d-major packed forward (flash_p5_fwd.cu, the UNet's T = 256
              attention; TMA + wgmma in bf16) against its plain version on
              [B, 3, H, D, T] at the LDM sampling shape (B=128, T=256, H=16,
              D=32), (4, 256, 9, 64), (2, 256, 8, 16) and (8, 256, 4, 128),
              bf16 and f32, each through the kernel its call selects (wgmma,
              mma.sync or FMA, counted), with the four times at the first
              shape (SDPA on q, k and v copied, untimed, to contiguous
              [B, H, T, D]) and the mma.sync kernel's time and error there.
  3f. p5 bwd  the p5 backward (flash_p5_bwd.cu, one packed dqkv; TMA + wgmma
              in bf16 for D <= 64) at the same shapes, the first at the LDM
              training batch B=256, each through the kernels its call
              selects (counted) and bit-equal when repeated, with the four
              times and the old mma.sync kernels' there.
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
Then the slice of ViT, MM-DiT, flow matching, the loss-aware resampler
and learned variance (``phase_slice11``), each with seeded random weights at
full width and depth:
  ViT-B/2 (32x32x4 latents, 1000 classes, T = 258, 12 heads of 64, the
              general kernels through the packed entry): sample, model,
              train (30 steps at 256 under the flagship recipe with
              --time_sampler loss-second-moment, printing how many of the
              1000 history rows are warmed up) and grad, as above; 12
              general forwards and 12 backwards a step, all on wgmma.
  MM-DiT-B/2 (505M parameters, 24 joint blocks, 24 heads of 32, T = 257 over
              the one-token context and 256 patches, on 32x32x3 Shapes
              images with 10 classes): one batch of 64 (CFG 1.5) each with
              the flow SDE (Heun, 18 steps: 35 model calls), the ODE (Heun:
              34) and the adaptive dopri5 ODE (1 + 6 calls an attempt; its
              accepted and rejected steps printed), each counted exactly;
              model; 30 rectified-flow steps at 256 (--model_mode flow,
              linear path, VECTOR target, lambda weight), the mean of the
              last five losses below that of the first five; grad. 24
              general forwards and 24 backwards a step, all on wgmma.
  DiT-B/2 learned variance (--learn_sigma True --var_type LEARNED_RANGE):
              sample (the EDM sampler takes the first 4 of 8 channels;
              4-channel PNGs), train (30 steps at 256, finite vb terms) and
              8 steps under --loss_type KL; the fused kernels' counts.
Phases 3c and 3d time the general kernels at the two new shapes too:
ViT-B/2's (128, 258, 12, 64) on packed views and MM-DiT-B/2's (128, 257, 24,
32) on three tensors, beside SDPA and the bound.
Then, on seeded data written to a temporary directory:
  20. data-cifar  DiT-B/2 (3 channels, 10 classes) trained through the CLI
              on a CIFAR-10-layout archive (5 x 2048 rows and a test batch,
              seeded uint8): batches through the native gather
              (vaw_torch.runtime, at least one call a step) and the
              prefetcher, 30 steps at batch 256 with the flagship recipe,
              asynchronous checkpoints at steps 15 and 30; 360 + 360 fused
              launches, a finite loss, and the step-30 file equal to the
              final params, EMA and moments bit for bit. Then the same run
              with synchronous saves and with none: each run's ms a step
              and the time of step 16, the first after the step-15 save.
  21. async-snapshot  AsyncCheckpointWriter.save, then at once one more
              fused AdamW+EMA step on the same DiT-B/2 state: the file holds
              the state before that step, bit for bit.
  22. data-latent  where h5py imports: a 12288-item latents.h5 (8 x 32 x 32
              f32 moments, uint16 labels; the layout of vaw_tpu/data/
              preprocessing.py), DiT-B/2 trained 40 steps at batch 256
              through the slab loader (a slab boundary crossed with a carry)
              and the prefetcher: 480 + 480 fused launches, imgs/s. Without
              h5py one line says so and the phase is not run.
  23. remat   DiT-B/2's f32 gradient at batch 256 under each policy against
              the one without remat, with cuDNN held to deterministic
              algorithms (the patch conv's filter gradient): bit-equal, as
              is the gradient without remat taken twice; then through the
              CLI, bf16, 10 steps
              each: DiT-B/2 at 256 without remat and under "full" and "dots"
              (a rematted block runs its attention forward again: 240 + 120
              fused launches), U-ViT-L/2 at the recipe's 256 under "full"
              (420 + 210 general launches), and U-ViT-L/2 without remat at 128
              and at 256; the peak memory of every run.
  24. host    cli/profile_train.py's resident and loader-fed (through
              prefetch_to_device) steps of DiT-B/2 on Gaussian latents, on
              the CIFAR-10 archive and, with h5py, on the latent file.
Before each sample and train phase every kernel's launch count is set to
0; it is read just after and must be exactly the expected count for that
path's kernels (840, 360 + 360, 1470, 630 + 630; LDM 350 p5 + 770 general
in sampling, 150 + 150 p5 and 330 + 330 general in training; ADM-64 2100
conv + 1540 general in sampling, 1770 conv forward/dgrad + 900 wgrad and
660 + 660 general in training) and 0 for the others; the launches by
kernel of the conv forward, the wgrad, the p5 forward and backward, the
general forward and backward and the fused backward must be exact too (a
bf16 ADM-64 forward: 28 wgmma convs, the stem on mma.sync, the f32 head
on FMAs; a backward: 28 wgmma dgrads and the head's on FMAs, 28 wgmma
wgrads, the stem's on mma.sync and the head's on FMAs; every bf16 LDM p5
call on wgmma; every bf16 general forward and backward of U-ViT-L/2,
LDM and ADM-64 on wgmma: 21, 11 and 22 a forward, as many a backward;
DiT-B/2's 12 fused backwards a step on wgmma), and every grad phase's
(f32) on the FMA kernels.

A bound is the larger of two times: the bytes each function must move at
the HBM rate and its tensor-core operations at the bf16 (or f32) peak; the
term that binds is printed. At the T = 1024 shapes phases 3c and 3d also
print, beside the bound, the time of the B*H*Tq*Tk exponentials on the
special-function units alone (16 a clock on each SM at the card's maximum
SM clock, from nvidia-smi): a floor for a kernel that takes every exp2
there, not a bound of the function.

Exits non-zero, printing no result, without a CUDA card or if any phase
fails. Otherwise it prints the total time, one {"kernels": [...]} JSON line
(nine kernels) and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import glob
import json
import math
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

import vaw_torch.cli.main as train_cli
import vaw_torch.cli.sample as sample_cli
from vaw_torch.cli import profile_train
from vaw_torch.models import build_model, cast_for_compute
from vaw_torch.models import layers as model_layers
from vaw_torch.models import mmdit as mmdit_module
from vaw_torch.models import unet as unet_module
from vaw_torch.models import uvit as uvit_module
from vaw_torch.models import vit as vit_module
from vaw_torch.models.dit import DiT_B
from vaw_torch.models.mmdit import MMDiT
from vaw_torch.models.layers import REMAT_POLICIES
from vaw_torch.models.unet import ADM_64, LDM
from vaw_torch.models.uvit import UViT_L
from vaw_torch.models.vit import ViT_B
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
    KERNEL_DESIGNS,
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
    flash_bwd_design,
    flash_fused_bwd_design,
    flash_fwd_design,
    flash_p5_bwd_design,
    flash_p5_fwd_design,
)
from vaw_torch.ops.fused_act import fused_leaky_relu, fused_leaky_relu_reference
from vaw_torch.runtime import native
from vaw_torch.samplers import driver as sampler_driver
from vaw_torch.train import AsyncCheckpointWriter, Trainer, checkpoint_name, load_checkpoint

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
# Then LDM's 32x32 level (T = 1024, 8 heads of 32) at a cut batch and its
# 8x8 level (T = 64, 32 heads of 32), and ADM-64's 32, 16 and 8 px levels
# (T = 1024, 256 and 64 with 6, 9 and 12 heads of 64) at a cut batch.
GENERAL_SHAPES = [(2 * SAMPLE_SIZE, 258, 258, 16, 64), (16, 77, 300, 16, 64),
                  (16, 258, 258, 12, 72), (8, 258, 258, 4, 256),
                  (2, 4096, 4096, 2, 64), (16, 1024, 1024, 8, 32),
                  (2 * SAMPLE_SIZE, 64, 64, 32, 32), (16, 1024, 1024, 6, 64),
                  (16, 256, 256, 9, 64), (16, 64, 64, 12, 64)]
# The general kernels' model shapes at T = 1024 at the sampling batch, held
# against the plain version and timed: LDM's 32x32 level and ADM-64's 32 px
# level (6 heads of 64), q, k and v views of one packed qkv.
# Then the two shapes the ViT-B/2 and MM-DiT-B/2 paths add, at the sampling
# batch: ViT-B/2's T = 258 (256 patches, a time and a class token) with 12
# heads of 64 on the packed views, and MM-DiT-B/2's T = 257 (a one-token
# context and 256 patches) with 24 heads of 32 on q, k and v concatenated
# from the two streams (three tensors, not views). Each entry: (B, Tq, Tk,
# H, D, packed).
GENERAL_T1024 = [(2 * SAMPLE_SIZE, 1024, 1024, 8, 32, True),
                 (2 * SAMPLE_SIZE, 1024, 1024, 6, 64, True),
                 (2 * SAMPLE_SIZE, 258, 258, 12, 64, True),
                 (2 * SAMPLE_SIZE, 257, 257, 24, 32, False)]

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
           "flash_p5_fwd": KERNEL_DESIGNS, "flash_p5_bwd": KERNEL_DESIGNS,
           "flash_fwd": KERNEL_DESIGNS, "flash_bwd": KERNEL_DESIGNS,
           "flash_fused_bwd": KERNEL_DESIGNS}


def reset_launches():
    for fn in COUNTERS.values():
        fn.launches = 0
    for name, designs in DESIGNS.items():
        COUNTERS[name].launches_by_design = dict.fromkeys(designs, 0)


def read_launches() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def read_designs() -> dict:
    """Launches by kernel (wgmma, mma_sync, fma) of the conv forward, the
    wgrad, the p5 forward and backward, the general forward and backward
    and the fused backward."""
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


@functools.cache
def exp_rate() -> float:
    """Exponentials a second on the special-function units alone: 16 ex2 a
    clock on each SM at the card's maximum SM clock."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 16 * sms * float(mhz) * 1e6


def sfu_exp_ms(b, tq, tk, h) -> float:
    """Time of attention's B*H*Tq*Tk exponentials on the special-function
    units alone: a floor for a kernel that takes every exp2 there, not for
    the function (exp2 also runs as a polynomial on the FMA pipes), so it is
    printed beside the bound and not in it."""
    return b * h * tq * tk / exp_rate() * 1e3


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


# Fused backward checks: (B, T, H, D); the first is DiT-B/2's training
# shape, timed.
FUSED_BWD_SHAPES = [(DIT_TRAIN_BATCH, T_MAIN, H_MAIN, D_MAIN), (16, 257, 12, 64),
                    (16, 256, 6, 128)]


def _expected_design(dtype, d: int) -> str:
    """The kernel a fused or p5 backward with the default scale must take:
    FMA in f32, wgmma for bf16 with D <= 64, mma.sync above."""
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if d <= 64 else "mma_sync"


def _mma_sync_fused_bwd(qkv, o, lse, dout, h):
    """The bf16 mma.sync kernels of flash_fused_bwd.cu (delta, dK/dV, dQ) on
    a call the router sends to wgmma: their time and error beside the wgmma
    pair's. Not counted (it is no launch of a path)."""
    b, t, hd3 = qkv.shape
    d = hd3 // (3 * h)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b * h, t), dtype=torch.float32, device=qkv.device)
    err = flash_ops._bwd_kernel()(
        qkv.data_ptr(), o.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dqkv.data_ptr(), b, t, h, d, 1.0 / math.sqrt(d), 1,
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"mma.sync fused backward launch failed: CUDA error {err}")
    return dqkv


def phase_bwd(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)
    main_record = None
    for i, (b, t, h, d) in enumerate(FUSED_BWD_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda").to(dtype)
            dout = torch.randn((b, t, h * d), generator=gen, device="cuda").to(dtype)
            o, lse = flash_attention_fused(qkv, h)
            before = read_designs()
            dqkv = flash_attention_fused_bwd(qkv, o, lse, dout, h)
            again = flash_attention_fused_bwd(qkv, o, lse, dout, h)
            torch.cuda.synchronize()
            design = flash_fused_bwd_design(dtype, d, 1.0 / math.sqrt(d))
            tag = f"B={b} T={t} H={h} D={d} {str(dtype)[6:]}"
            check(design == _expected_design(dtype, d), f"{tag}: design {design}")
            used = _used("flash_fused_bwd", before)
            check(used == {design: 2}, f"{tag}: fused backward launches by kernel {used}, "
                  f"expected { {design: 2} }")
            check(_used("flash_bwd", before) == {}, f"{tag}: counted under flash_bwd")
            same = torch.equal(dqkv, again)
            check(same, f"{tag}: a repeated fused backward is not bit-equal")
            del again
            want = flash_attention_fused_bwd_reference(qkv, o, lse, dout, h)
            scale = want.float().abs().max().item()
            err = (dqkv.float() - want.float()).abs().max().item()
            print(f"[bwd] {tag}: kernel {design}; max|dqkv - plain| {err:.3e} = "
                  f"{err / scale:.3e} of max|dqkv| {scale:.3f} (tol "
                  f"{BWD_RTOL[dtype]:.0e}); repeat bit-equal {same}", flush=True)
            check(torch.isfinite(dqkv.float()).all().item(), f"{tag}: non-finite dqkv")
            check(err <= BWD_RTOL[dtype] * scale, f"{tag}: backward kernel disagrees")
            if i != 0 or dtype != torch.bfloat16:
                del want
                continue
            old = _mma_sync_fused_bwd(qkv, o, lse, dout, h)
            old_rel = (old.float() - want.float()).abs().max().item() / scale
            del want, old
            check(old_rel <= BWD_RTOL[dtype], f"{tag}: the mma.sync fused backward disagrees")
            ms = cuda_ms(lambda: flash_attention_fused_bwd(qkv, o, lse, dout, h), iters=20)
            mma_sync_ms = cuda_ms(lambda: _mma_sync_fused_bwd(qkv, o, lse, dout, h),
                                  iters=20)
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
            print(f"[bwd] {tag}: kernel ({design}) {ms:.4f} ms, mma.sync kernels "
                  f"{mma_sync_ms:.4f} ms (max rel err {old_rel:.3e}), plain {plain_ms:.4f} "
                  f"ms, sdpa backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}); kernel / sdpa {ms / library_ms:.3f} [{card}]", flush=True)
            # The DiT's backward runs flash_bwd.cu's wgmma pair.
            main_record = dict(
                name="flash_fused_bwd", route="cuda",
                source="vaw_torch/ops/csrc/flash_bwd.cu",
                replaces="vaw_tpu/ops/flash_attention.py:592",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                mma_sync_ms=mma_sync_ms)
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


def _mma_sync_general(q, k, v):
    """The bf16 mma.sync kernel of flash_fwd.cu on a call the router sends
    to wgmma: its time and error beside the wgmma kernel's. Not counted (it
    is no launch of a path)."""
    b, tq, h, d = q.shape
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    err = flash_ops._general_fwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        flash_ops._strides(q, k, v), b, tq, k.shape[1], h, d, 1.0 / math.sqrt(d), 1,
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"mma.sync general forward launch failed: CUDA error {err}")
    return out, lse


def _mma_sync_general_bwd(q, k, v, o, lse, dout, grads):
    """The bf16 mma.sync kernels of flash_bwd.cu (delta, dK/dV, dQ) into
    `grads` on a call the router sends to wgmma. Not counted."""
    b, tq, h, d = q.shape
    delta = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    err = flash_ops._general_bwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(g.data_ptr() for g in grads),
        flash_ops._strides(q, k, v, *grads), b, tq, k.shape[1], h, d, 1.0 / math.sqrt(d),
        1, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"mma.sync general backward launch failed: CUDA error {err}")
    return grads


def _sdpa_bwd_ms(qkv, dout, iters):
    """SDPA's backward on the q/k/v views of qkv, from a retained graph."""
    leaf = qkv.detach().requires_grad_(True)
    qh, kh, vh = (x.transpose(1, 2) for x in leaf.unbind(2))
    sdpa_out = F.scaled_dot_product_attention(qh, kh, vh)
    return cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, (qh, kh, vh), dout.transpose(1, 2), retain_graph=True), iters=iters)


def phase_general(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(4)
    main_record = None
    for i, (b, tq, tk, h, d) in enumerate(GENERAL_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            _, (q, k, v) = _general_inputs(gen, b, tq, tk, h, d, dtype, packed=i == 0)
            before = read_designs()
            o, lse = flash_attention_fwd(q, k, v)
            torch.cuda.synchronize()
            design = flash_fwd_design(dtype, d, 1.0 / math.sqrt(d), (q, k, v))
            tag = f"B={b} Tq={tq} Tk={tk} H={h} D={d} {str(dtype)[6:]}"
            used = _used("flash_fwd", before)
            check(used == {design: 1}, f"{tag}: general forward launches by kernel {used}, "
                  f"expected { {design: 1} }")
            ro, rlse = flash_attention_reference(q, k, v)
            err = (o.float() - ro.float()).abs().max().item()
            lse_err = (lse - rlse).abs().max().item()
            print(f"[general] {tag}: kernel {design}; max|o - plain| {err:.3e} (tol "
                  f"{ATOL[dtype]:.0e}), max|lse - plain| {lse_err:.3e} (tol "
                  f"{LSE_ATOL:.0e})", flush=True)
            check(torch.isfinite(o.float()).all().item(), f"{tag}: non-finite output")
            check(err <= ATOL[dtype] and lse_err <= LSE_ATOL,
                  f"{tag}: general forward kernel disagrees")
            if i != 0 or dtype != torch.bfloat16:
                del ro, rlse
                continue
            old_o, old_lse = _mma_sync_general(q, k, v)
            old_err = (old_o.float() - ro.float()).abs().max().item()
            old_lse_err = (old_lse - rlse).abs().max().item()
            del ro, rlse
            check(old_err <= ATOL[dtype] and old_lse_err <= LSE_ATOL,
                  f"{tag}: the mma.sync general forward disagrees")
            ms = cuda_ms(lambda: flash_attention_fwd(q, k, v), iters=50)
            mma_sync_ms = cuda_ms(lambda: _mma_sync_general(q, k, v), iters=50)
            plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v), iters=5,
                               warmup=1)
            qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh),
                                 iters=50)
            bound_ms, bound_by = attention_bound_ms(b, tq, tk, h, d, dtype)
            print(f"[general] {tag} (packed views): kernel ({design}) {ms:.4f} ms, "
                  f"mma.sync kernel {mma_sync_ms:.4f} ms (max|o - plain| {old_err:.3e}), "
                  f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}); kernel / sdpa {ms / library_ms:.3f} "
                  f"[{card}]", flush=True)
            main_record = dict(
                name="flash_fwd", route="cuda", source="vaw_torch/ops/csrc/flash_fwd.cu",
                replaces="vaw_tpu/ops/flash_attention.py:88",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                mma_sync_ms=mma_sync_ms, model_shapes={})
    for (b, tq, tk, h, d, packed) in GENERAL_T1024:
        qkv, (q, k, v) = _general_inputs(gen, b, tq, tk, h, d, torch.bfloat16, packed)
        design = flash_fwd_design(torch.bfloat16, d, 1.0 / math.sqrt(d), (q, k, v))
        tag = f"B={b} Tq={tq} Tk={tk} H={h} D={d} bfloat16"
        before = read_designs()
        o, lse = flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        used = _used("flash_fwd", before)
        check(used == {design: 1}, f"{tag}: general forward launches by kernel {used}")
        ro, rlse = flash_attention_reference(q, k, v)
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        del ro, rlse, o, lse
        check(err <= ATOL[torch.bfloat16] and lse_err <= LSE_ATOL,
              f"{tag}: general forward kernel disagrees ({err:.3e}, {lse_err:.3e})")
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v), iters=20)
        mma_sync_ms = cuda_ms(lambda: _mma_sync_general(q, k, v), iters=20)
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=20)
        bound_ms, bound_by = attention_bound_ms(b, tq, tk, h, d, torch.bfloat16)
        sfu_ms = sfu_exp_ms(b, tq, tk, h)
        print(f"[general] {tag} ({'packed views' if packed else 'q, k, v'}): kernel "
              f"{design}; max|o - plain| {err:.3e} "
              f"(tol {ATOL[torch.bfloat16]:.0e}), max|lse - plain| {lse_err:.3e} (tol "
              f"{LSE_ATOL:.0e}); kernel {ms:.4f} ms, mma.sync kernel {mma_sync_ms:.4f} ms, "
              f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), exp2 on "
              f"the special-function units alone {sfu_ms:.4f} ms; kernel / sdpa "
              f"{ms / library_ms:.3f} [{card}]", flush=True)
        main_record["model_shapes"][tag] = dict(
            ms=ms, mma_sync_ms=mma_sync_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by=bound_by, sfu_exp_ms=sfu_ms, max_abs_err=err)
        del qkv, q, k, v, qh, kh, vh
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
            before = read_designs()
            got = [x.clone() for x in flash_attention_bwd(q, k, v, o, lse, dout, grads=grads)]
            again = flash_attention_bwd(q, k, v, o, lse, dout, grads=grads)
            torch.cuda.synchronize()
            design = flash_bwd_design(dtype, d, 1.0 / math.sqrt(d),
                                      (q, k, v, *(grads or ())))
            tag = f"B={b} Tq={tq} Tk={tk} H={h} D={d} {str(dtype)[6:]}"
            used = _used("flash_bwd", before)
            check(used == {design: 2}, f"{tag}: general backward launches by kernel "
                  f"{used}, expected { {design: 2} }")
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            check(same, f"{tag}: a repeated general backward is not bit-equal")
            want = flash_attention_bwd_reference(q, k, v, o, lse, dout)
            worst = 0.0
            for name, x, w in zip(("dq", "dk", "dv"), got, want):
                scale = w.float().abs().max().item()
                err = (x.float() - w.float()).abs().max().item()
                worst = max(worst, err / scale)
                check(torch.isfinite(x.float()).all().item(), f"{tag}: non-finite {name}")
                check(err <= BWD_RTOL[dtype] * scale,
                      f"{tag}: general backward kernel disagrees in {name}")
            print(f"[general bwd] {tag}: kernel {design}; max|grad - plain| / max|grad| "
                  f"over dq, dk, dv {worst:.3e} (tol {BWD_RTOL[dtype]:.0e}); repeat "
                  f"bit-equal {same}", flush=True)
            del got, again
            if i != 0 or dtype != torch.bfloat16:
                del want
                continue
            old = _mma_sync_general_bwd(q, k, v, o, lse, dout,
                                        [torch.empty_like(x) for x in (q, k, v)])
            old_worst = max((x.float() - w.float()).abs().max().item()
                            / w.float().abs().max().item() for x, w in zip(old, want))
            del want, old
            check(old_worst <= BWD_RTOL[dtype], f"{tag}: the mma.sync general backward "
                  f"disagrees")
            ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, lse, dout, grads=grads),
                         iters=20)
            mma_sync_ms = cuda_ms(lambda: _mma_sync_general_bwd(q, k, v, o, lse, dout, grads),
                                  iters=20)
            plain_ms = cuda_ms(lambda: flash_attention_bwd_reference(
                q, k, v, o, lse, dout), iters=3, warmup=1)
            library_ms = _sdpa_bwd_ms(qkv, dout, iters=20)
            bound_ms, bound_by = attention_bwd_bound_ms(b, tq, tk, h, d, dtype)
            print(f"[general bwd] {tag} (packed views, one packed gradient): kernel "
                  f"({design}) {ms:.4f} ms, mma.sync kernels {mma_sync_ms:.4f} ms (max "
                  f"rel err {old_worst:.3e}), plain {plain_ms:.4f} ms, sdpa backward "
                  f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); kernel / "
                  f"sdpa {ms / library_ms:.3f} [{card}]", flush=True)
            main_record = dict(
                name="flash_bwd", route="cuda", source="vaw_torch/ops/csrc/flash_bwd.cu",
                replaces="vaw_tpu/ops/flash_attention.py:130",
                launches=None, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                mma_sync_ms=mma_sync_ms, model_shapes={})
    for (b, tq, tk, h, d, packed) in GENERAL_T1024:
        qkv, (q, k, v) = _general_inputs(gen, b, tq, tk, h, d, torch.bfloat16, packed)
        dout = torch.randn((b, tq, h, d), generator=gen, device="cuda").bfloat16()
        o, lse = flash_attention_fwd(q, k, v)
        grads = (torch.empty_like(qkv).unbind(2) if packed
                 else tuple(torch.empty_like(x) for x in (q, k, v)))
        design = flash_bwd_design(torch.bfloat16, d, 1.0 / math.sqrt(d), (q, k, v, *grads))
        tag = f"B={b} Tq={tq} Tk={tk} H={h} D={d} bfloat16"
        before = read_designs()
        got = [x.clone() for x in flash_attention_bwd(q, k, v, o, lse, dout, grads=grads)]
        again = flash_attention_bwd(q, k, v, o, lse, dout, grads=grads)
        torch.cuda.synchronize()
        used = _used("flash_bwd", before)
        check(used == {design: 2}, f"{tag}: general backward launches by kernel {used}")
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        check(same, f"{tag}: a repeated general backward is not bit-equal")
        worst = 0.0
        for name, x, w in zip(("dq", "dk", "dv"), got,
                              flash_attention_bwd_reference(q, k, v, o, lse, dout)):
            err = (x.float() - w.float()).abs().max().item()
            worst = max(worst, err / w.float().abs().max().item())
            check(torch.isfinite(x.float()).all().item(), f"{tag}: non-finite {name}")
        del got, again, x, w
        check(worst <= BWD_RTOL[torch.bfloat16],
              f"{tag}: general backward kernel disagrees ({worst:.3e})")
        ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, lse, dout, grads=grads),
                     iters=10)
        mma_sync_ms = cuda_ms(lambda: _mma_sync_general_bwd(q, k, v, o, lse, dout, grads),
                              iters=10)
        library_ms = _sdpa_bwd_ms(qkv if packed else torch.stack((q, k, v), 2), dout,
                                  iters=10)
        bound_ms, bound_by = attention_bwd_bound_ms(b, tq, tk, h, d, torch.bfloat16)
        sfu_ms = sfu_exp_ms(b, tq, tk, h)
        print(f"[general bwd] {tag} ("
              f"{'packed views, one packed gradient' if packed else 'q, k, v'}): kernel "
              f"{design}; "
              f"max|grad - plain| / max|grad| over dq, dk, dv {worst:.3e} (tol "
              f"{BWD_RTOL[torch.bfloat16]:.0e}); repeat bit-equal {same}; kernel {ms:.4f} "
              f"ms, mma.sync kernels {mma_sync_ms:.4f} ms, sdpa backward {library_ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by}), exp2 on the special-function "
              f"units alone {sfu_ms:.4f} ms; kernel / sdpa {ms / library_ms:.3f} [{card}]",
              flush=True)
        main_record["model_shapes"][tag] = dict(
            ms=ms, mma_sync_ms=mma_sync_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by=bound_by, sfu_exp_ms=sfu_ms, max_abs_err=worst)
        del qkv, q, k, v, dout, o, lse, grads
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


def _mma_sync_p5_bwd(f5, o, lse, dout):
    """The bf16 mma.sync kernels of flash_p5_bwd.cu (delta, dK/dV, dQ) on a
    call the router sends to wgmma: their time and error beside the wgmma
    pair's. Not counted."""
    b, _, h, d, t = f5.shape
    dqkv = torch.empty_like(f5)
    delta = torch.empty((b * h, t), dtype=torch.float32, device=f5.device)
    err = flash_ops._p5_bwd_kernel()(
        f5.data_ptr(), o.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dqkv.data_ptr(), b, h, d, t, 1.0 / math.sqrt(d), 1,
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"mma.sync p5 backward launch failed: CUDA error {err}")
    return dqkv


def _p5_rel_err(got, want) -> float:
    """max|got - want| / max|want| over dq, dk and dv, the worst of three."""
    return max((got[:, j].float() - want[:, j].float()).abs().max().item()
               / want[:, j].float().abs().max().item() for j in range(3))


def phase_p5_bwd(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(7)
    main_record = None
    for i, (b, t, h, d) in enumerate(P5_BWD_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            f5 = _p5_inputs(gen, b, t, h, d, dtype)
            dout = torch.randn((b * h, d, t), generator=gen, device="cuda").to(dtype)
            o, lse = flash_attention_p5_fwd(f5)
            before = read_designs()
            dqkv = flash_attention_p5_bwd(f5, o, lse, dout)
            again = flash_attention_p5_bwd(f5, o, lse, dout)
            torch.cuda.synchronize()
            design = flash_p5_bwd_design(dtype, d, 1.0 / math.sqrt(d))
            tag = f"B={b} T={t} H={h} D={d} {str(dtype)[6:]}"
            check(design == _expected_design(dtype, d), f"{tag}: design {design}")
            used = _used("flash_p5_bwd", before)
            check(used == {design: 2}, f"{tag}: p5 backward launches by kernel {used}, "
                  f"expected { {design: 2} }")
            same = torch.equal(dqkv, again)
            check(same, f"{tag}: a repeated p5 backward is not bit-equal")
            del again
            want = flash_attention_p5_bwd_reference(f5, o, lse, dout)
            for j, name in enumerate(("dq", "dk", "dv")):
                check(torch.isfinite(dqkv[:, j].float()).all().item(),
                      f"{tag}: non-finite {name}")
            worst = _p5_rel_err(dqkv, want)
            print(f"[p5 bwd] {tag}: kernel {design}; max|grad - plain| / max|grad| over "
                  f"dq, dk, dv {worst:.3e} (tol {BWD_RTOL[dtype]:.0e}); repeat bit-equal "
                  f"{same}", flush=True)
            check(worst <= BWD_RTOL[dtype], f"{tag}: p5 backward kernel disagrees")
            if i != 0 or dtype != torch.bfloat16:
                del want
                continue
            old_worst = _p5_rel_err(_mma_sync_p5_bwd(f5, o, lse, dout), want)
            del want
            check(old_worst <= BWD_RTOL[dtype], f"{tag}: the mma.sync p5 backward disagrees")
            ms = cuda_ms(lambda: flash_attention_p5_bwd(f5, o, lse, dout), iters=20)
            mma_sync_ms = cuda_ms(lambda: _mma_sync_p5_bwd(f5, o, lse, dout), iters=20)
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
            print(f"[p5 bwd] {tag}: kernel ({design}) {ms:.4f} ms, mma.sync kernels "
                  f"{mma_sync_ms:.4f} ms (max rel err {old_worst:.3e}), plain "
                  f"{plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}); kernel / sdpa {ms / library_ms:.3f} "
                  f"[{card}]", flush=True)
            main_record = dict(
                name="flash_p5_bwd", route="cuda", source="vaw_torch/ops/csrc/flash_p5_bwd.cu",
                replaces="vaw_tpu/ops/flash_attention.py:443",
                launches=None, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                mma_sync_ms=mma_sync_ms)
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


def seeded_dit_b(learn_sigma: bool = False) -> torch.nn.Module:
    """DiT-B/2 with f32 master weights from a seed; the zero-initialised
    adaLN modulation and head get small seeded noise so that samples are
    not just the scaled input noise."""
    torch.manual_seed(0)
    model = DiT_B(image_size=32, patch_size=2, in_channels=4,
                  class_dropout_prob=0.1, num_classes=1000,
                  learn_sigma=learn_sigma).cuda()
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


def _vit_b():
    return ViT_B(image_size=32, patch_size=2, in_channels=4, num_classes=1000,
                 learn_sigma=False, drop_label_prob=0.1)


def seeded_vit_b() -> torch.nn.Module:
    """ViT-B/2 with f32 weights from a seed (the JAX model's initialisers;
    its head is damped by init_scale 0.001, as in training)."""
    torch.manual_seed(0)
    return _vit_b().cuda().eval()


def _mmdit_b():
    """MM-DiT-B/2 as the registry builds it: depth 24, hidden 32 * 24 = 768,
    24 heads of 32; on 32x32x3 images with 10 classes (the Shapes data)."""
    return MMDiT(image_size=32, patch_size=2, in_channels=3, hidden_size=768,
                 depth=24, num_heads=24, num_classes=10, class_dropout_prob=0.1)


def seeded_mmdit_b() -> torch.nn.Module:
    """MM-DiT-B/2 with f32 weights from a seed; the zero-initialised adaLN
    modulations and head get small seeded noise, so that no block is the
    identity and the output is not zero."""
    torch.manual_seed(0)
    model = _mmdit_b().cuda()
    heads = [stream.adaLN_modulation[1] for blk in model.joint_blocks
             for stream in (blk.context_block, blk.x_block)] + [
        model.final_layer.adaLN_modulation[1], model.final_layer.linear]
    with torch.no_grad():
        for lin in heads:
            lin.weight.normal_(0.0, 0.02)
            lin.bias.normal_(0.0, 0.02)
    return model.eval()


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


def _plain_general(q, k, v, scale=None):
    return flash_attention_reference(q, k, v, scale)[0]


def _out(o):
    """A model's prediction: MM-DiT returns (out, zs)."""
    return o[0] if isinstance(o, tuple) else o


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
    # The train phase's flags after the model's: the flagship recipe unless
    # given, then `train_extra`.
    recipe: list = None
    train_extra: list = []
    # Labels drawn in the model and grad phases; the train phase's losses
    # must fall: the mean of the last `fall_window` below that of the first.
    classes: int = 1000
    fall_window: int = 1

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
             ((model_layers, "multi_head_attention_fused", _plain_fused),),
             # bf16: every fused backward on the general TMA + wgmma pair.
             bwd_design={"flash_fused_bwd": {"wgmma": 12}})
# U-ViT-L/2: T = 1 label + 1 time + 256 patch tokens = 258, 16 heads of 64,
# 21 blocks (10 in, 1 mid, 10 out), through the general-T kernels; batch
# 128 in the train phase (phase 23 trains the recipe's 256 rematted).
UVIT = Family("U-ViT-L/2", ["--model", "U-ViT-L"] + MODEL_ARGS, {"flash_fwd": 21},
              {"flash_bwd": 21}, 128, 16, seeded_uvit_l,
              lambda: UViT_L(image_size=32, patch_size=2, in_channels=4,
                             num_classes=1000, class_dropout_prob=0.1),
              ((uvit_module, "multi_head_attention_packed", _plain_packed),),
              # bf16: every general forward and backward on TMA + wgmma.
              fwd_design={"flash_fwd": {"wgmma": 21}},
              bwd_design={"flash_bwd": {"wgmma": 21}})
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
                    # bf16: every p5 and every general forward and backward
                    # on the TMA + wgmma kernels.
                    fwd_design={"flash_p5_fwd": {"wgmma": 5}, "flash_fwd": {"wgmma": 11}},
                    bwd_design={"flash_p5_bwd": {"wgmma": 5}, "flash_bwd": {"wgmma": 11}})


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
               # stem on mma.sync, the f32 head (its dgrad and wgrad) on FMAs;
               # every general forward and backward on wgmma.
               fwd_design={"conv3x3_fwd": {"wgmma": 28, "mma_sync": 1, "fma": 1},
                           "flash_fwd": {"wgmma": 22}},
               bwd_design={"conv3x3_fwd": {"wgmma": 28, "fma": 1},
                           "conv3x3_wgrad": {"wgmma": 28, "mma_sync": 1, "fma": 1},
                           "flash_bwd": {"wgmma": 22}})


# ViT-B/2: T = 256 patches + a time and a class token = 258, 12 heads of 64,
# 12 blocks, through the packed entry and the general-T kernels; trained
# under the flagship recipe with the loss-aware timestep resampler.
VIT = Family("ViT-B/2", ["--model", "ViT-B"] + MODEL_ARGS, {"flash_fwd": 12},
             {"flash_bwd": 12}, 256, 16, seeded_vit_b, _vit_b,
             ((vit_module, "multi_head_attention_packed", _plain_packed),),
             fwd_design={"flash_fwd": {"wgmma": 12}},
             bwd_design={"flash_bwd": {"wgmma": 12}},
             train_extra=["--time_sampler", "loss-second-moment"])
# MM-DiT-B/2: 24 joint blocks of width 768, 24 heads of 32, joint attention
# over a one-token context and 256 patches (T = 257) through the general-T
# kernels on q, k and v concatenated from the two streams; trained with
# rectified flow (SD3's recipe: linear path, VECTOR target) and the lambda
# weight, sampled with the flow SDE and ODE. It runs on the Shapes data,
# 32x32x3 with 10 classes (the same T): on the Gaussian stand-in the data
# is the noise law itself, so the flow target n - x0 has no part that a
# head blind to t can learn first, and the loss stays at 2 for far more
# than 30 steps.
MMDIT_TRAIN_BATCH = 256
FLOW_ARGS = ["--model_mode", "flow", "--path_type", "linear", "--mean_type", "VECTOR"]
MMDIT = Family("MM-DiT-B/2", ["--model", "MM-DiT-B", "--image_size", "32", "--patch_size",
                              "2", "--in_chans", "3", "--num_classes", "10",
                              "--class_cond", "True", "--drop_label_prob", "0.1",
                              "--amp", "True"],
               {"flash_fwd": 24}, {"flash_bwd": 24}, MMDIT_TRAIN_BATCH, 16,
               seeded_mmdit_b, _mmdit_b,
               ((mmdit_module, "multi_head_attention", _plain_general),),
               image=(32, 32, 3),
               fwd_design={"flash_fwd": {"wgmma": 24}},
               bwd_design={"flash_bwd": {"wgmma": 24}},
               recipe=[("Shapes" if a == "Gaussian" else a) for a in RECIPE_ARGS
                       if a not in ("--mean_type", "EPSILON", "--path_type", "cosine")]
               + FLOW_ARGS,
               classes=10, fall_window=5)
# DiT-B/2 with learned variance: a 2C-channel head, LEARNED_RANGE, the vb
# term beside the MSE; the same 12 fused kernels a forward and a backward.
LV_ARGS = ["--learn_sigma", "True", "--var_type", "LEARNED_RANGE"]
DIT_LV = DIT._replace(
    tag="DiT-B/2 learned variance", model_args=DIT.model_args + LV_ARGS,
    seeded=lambda: seeded_dit_b(learn_sigma=True),
    ctor=lambda: DiT_B(image_size=32, patch_size=2, in_channels=4,
                       class_dropout_prob=0.1, num_classes=1000, learn_sigma=True))
KL_STEPS = 8


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
        channels = _png_channels(pngs)
    print(f"[sample] {fam.tag}: {len(pngs)} PNGs of {channels} channels, finite before "
          f"uint8 per batch "
          f"{finite}, launches {counts} (expected {want})")
    check(len(pngs) == NUM_SAMPLES, f"{len(pngs)} PNGs, expected {NUM_SAMPLES}")
    check(channels == {fam.image[-1]}, f"{fam.tag}: PNGs of {channels} channels, "
          f"expected {fam.image[-1]}")
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


def _png_channels(pngs) -> set:
    """The channel counts of the first PNGs (1 for a grey image)."""
    from PIL import Image

    arrays = [np.asarray(Image.open(p)) for p in pngs[:4]]
    return {a.shape[2] if a.ndim == 3 else 1 for a in arrays}


FLOW_SAMPLERS = (("sde", "heun"), ("ode", "heun"), ("ode", "dopri5"))


def phase_sample_flow(card: str, fam: Family, model: torch.nn.Module) -> dict:
    """The flow sampling path through vaw_torch.cli.sample.main: one batch of
    64 (128 rows with CFG 1.5) with the SDE (Heun, STEPS steps: 2 * STEPS - 1
    model calls), the ODE (Heun: 2 * (STEPS - 1) calls) and the adaptive
    dopri5 ODE (rtol 1e-3, atol 1e-6: 1 + 6 calls an attempt), each with
    its launches counted exactly and its samples finite."""
    paths = {}
    flow_batch = sampler_driver.Sampler._flow_batch
    inverse_normalize = sampler_driver._inverse_normalize
    with tempfile.TemporaryDirectory(prefix="vaw_chip_flow_") as tmp:
        ckpt = Path(tmp) / "ema.pt"
        torch.save({"ema": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                    "step": 0}, ckpt)
        for sampler_type, solver in FLOW_SAMPLERS:
            finite, batch_s, samplers = [], [], []

            def checked_inverse_normalize(x):
                finite.append(bool(torch.isfinite(x).all().item()))
                return inverse_normalize(x)

            def timed_flow_batch(self, *args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = flow_batch(self, *args, **kwargs)
                torch.cuda.synchronize()
                batch_s.append(time.perf_counter() - t0)
                samplers.append(self)
                return out

            out_dir = Path(tmp) / f"{sampler_type}_{solver}"
            argv = fam.model_args + FLOW_ARGS + [
                "--sampler_type", sampler_type, "--solver", solver,
                "--sample_steps", str(STEPS), "--guidance_scale", "1.5",
                "--sample_size", str(SAMPLE_SIZE), "--num_samples", str(SAMPLE_SIZE),
                "--resume", str(ckpt), "--save_path", str(out_dir)]
            with mock.patch.object(sampler_driver, "_inverse_normalize",
                                   checked_inverse_normalize), \
                    mock.patch.object(sampler_driver.Sampler, "_flow_batch",
                                      timed_flow_batch):
                reset_launches()
                sample_cli.main(argv)
                counts, designs = read_launches(), read_designs()
            pngs = list(out_dir.rglob("*.png"))
            steps = samplers[0].last_dopri5
            if solver == "dopri5":
                calls = 1 + 6 * (steps["accepted"] + steps["rejected"])
            else:
                calls = 2 * (STEPS - 1) + int(sampler_type == "sde")
            want = expect((fam.fwd, calls))
            want_designs = expect_designs((fam.fwd_design, calls))
            tag = f"{fam.tag} flow {sampler_type.upper()} {solver}"
            extra = (f", dopri5 {steps['accepted']} accepted and {steps['rejected']} "
                     f"rejected steps (t = {steps['t']:.3g} at the end)"
                     if solver == "dopri5" else "")
            print(f"[sample-flow] {tag}: {len(pngs)} PNGs, finite {finite}, {calls} model "
                  f"calls{extra}; launches {counts} (expected {want}); by kernel {designs}; "
                  f"{SAMPLE_SIZE / batch_s[0]:.2f} samples/s (one batch of {SAMPLE_SIZE}, "
                  f"CFG 1.5, bf16, {batch_s[0]:.3f} s, first call includes warm-up) "
                  f"[{card}]", flush=True)
            check(len(pngs) == SAMPLE_SIZE and finite == [True],
                  f"{tag}: {len(pngs)} PNGs, finite {finite}")
            check(counts == want, f"{tag} launches {counts}, expected {want}")
            check(designs == want_designs, f"{tag} launches by kernel {designs}, "
                  f"expected {want_designs}")
            if solver == "dopri5":
                check(steps["t"] <= 1e-6, f"{tag}: dopri5 did not reach t = 0")
            paths[f"sample_mmdit_{sampler_type}_{solver}"] = (counts, designs)
    return paths


def phase_kl(card: str) -> tuple:
    """A few DiT-B/2 steps with learned variance under --loss_type KL (the
    variational bound alone) through the CLI: finite losses and the fused
    kernels' exact launches."""
    argv = DIT_LV.model_args + RECIPE_ARGS + ["--loss_type", "KL"]
    for flag, value in (("--total_steps", KL_STEPS), ("--save_step", 0)):
        argv[argv.index(flag) + 1] = str(value)
    with tempfile.TemporaryDirectory(prefix="vaw_chip_kl_") as tmp:
        run = run_train_cli(argv + ["--batch_size", str(DIT_TRAIN_BATCH), "--logdir", tmp])
        free(run)
    check_run("train DiT-B/2 KL", run, KL_STEPS, DIT.fwd, DIT.bwd, DIT.fwd_design,
              DIT.bwd_design)
    print(f"[train] DiT-B/2 learned variance, loss KL, batch {DIT_TRAIN_BATCH}: losses "
          f"{[round(v, 5) for v in run['losses']]}, {run['imgs_per_s']:.2f} imgs/s over "
          f"steps {TRAIN_WARMUP + 1}-{KL_STEPS} [{card}]", flush=True)
    return run["launches"], run["designs"]


def phase_model(fam: Family, model: torch.nn.Module):
    """One forward at B=128 through the kernel, in f32 and in the sampler's
    bf16 copy, against the f32 forward through the plain attention."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    b = 2 * SAMPLE_SIZE
    x = torch.randn((b, *fam.image), generator=gen, device="cuda")
    t = torch.rand((b,), generator=gen, device="cuda") * 999
    y = torch.randint(0, fam.classes, (b,), generator=gen, device="cuda")
    with torch.inference_mode():
        with plain_route(fam):
            want = _out(model(x, t, y))
        before = read_launches()
        got_f32 = _out(model(x, t, y))
        launched = {k: n - before[k] for k, n in read_launches().items()}
        fwd_f32 = fam.f32[0]
        check(launched == expect((fwd_f32, 1)),
              f"{fam.tag}: the kernel route launched {launched}, expected {fwd_f32}")
        got_bf16 = _out(cast_for_compute(model, torch.bfloat16)(x, t, y))
    scale = want.abs().max().item()
    for name, got, tol in (("f32", got_f32, MODEL_F32_RTOL),
                           ("bf16", got_bf16, MODEL_BF16_RTOL)):
        rel = (got - want).abs().max().item() / scale
        print(f"[model] {fam.tag} B={b} {name} kernels vs f32 plain route: max rel "
              f"err {rel:.3e} (tol {tol:.0e}), max|out| {scale:.3f}", flush=True)
        check(math.isfinite(rel) and rel <= tol, f"{fam.tag}: {name} forward disagrees")


# The data, remat and host-path phases (20-24): DiT-B/2 on a seeded
# CIFAR-10-layout archive and a seeded latent HDF5 file, both written to a
# temporary directory; remat of DiT-B/2 and U-ViT-L/2.
CIFAR_ROWS, CIFAR_STEPS, CIFAR_SAVE = 2048, 30, 15
LATENT_ITEMS, LATENT_STEPS = 12288, 40
REMAT_STEPS, UVIT_REMAT_BATCH = 10, 256
CIFAR_ARGS = ["--model", "DiT-B", "--image_size", "32", "--patch_size", "2",
              "--in_chans", "3", "--num_classes", "10", "--class_cond", "True",
              "--drop_label_prob", "0.1", "--amp", "True"]


def run_train_cli(argv: list) -> dict:
    """vaw_torch.cli.main.main(argv) with every launch count, the native
    gather's count and the peak memory reset just before; returns the
    launches (total and by kernel), the per-step losses (and vb terms, with
    a learned variance), the steady imgs/s
    (CUDA events after the first five steps), each step's time from the
    event of the step before (step_ms[i] for step i + 1; None for the
    first), the wall time, the peak memory and the run's context."""
    losses, vbs, events = [], [], []
    step = Trainer.step

    def recorded_step(self, state, batch):
        state, metrics = step(self, state, batch)
        losses.append(metrics["loss"])
        if "vb" in metrics:
            vbs.append(metrics["vb"])
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return state, metrics

    with mock.patch.object(Trainer, "step", recorded_step):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        native.gather_normalize.calls = 0
        t0 = time.perf_counter()
        ctx = train_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, designs = read_launches(), read_designs()
    values = [float(x) for x in losses]
    batch = ctx["trainer"].cfg.batch_size
    seconds = events[TRAIN_WARMUP - 1].elapsed_time(events[-1]) / 1e3
    step_ms = [None] + [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return {"ctx": ctx, "launches": launches, "designs": designs, "losses": values,
            "vb": [float(x) for x in vbs],
            "step_ms": step_ms,
            "gathers": native.gather_normalize.calls, "wall_s": wall,
            "imgs_per_s": (len(values) - TRAIN_WARMUP) * batch / seconds,
            "ms_per_step": 1e3 * seconds / (len(values) - TRAIN_WARMUP),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def check_run(tag: str, run: dict, steps: int, fwd: dict, bwd: dict,
              fwd_design: dict = None, bwd_design: dict = None):
    """A train run's losses finite and its launches exactly `steps` x the
    per-step counts, in all and by kernel."""
    want = expect((fwd, steps), (bwd, steps))
    want_designs = expect_designs((fwd_design or {}, steps), (bwd_design or {}, steps))
    values = run["losses"]
    print(f"[{tag}] {len(values)} steps, loss first {values[0]:.5f} last "
          f"{values[-1]:.5f}; launches {run['launches']} (expected {want}); by "
          f"kernel {run['designs']} (expected {want_designs})", flush=True)
    check(len(values) == steps and all(map(math.isfinite, values)),
          f"{tag}: {len(values)} losses, expected {steps} finite")
    check(run["launches"] == want, f"{tag}: launches {run['launches']}, expected {want}")
    check(run["designs"] == want_designs,
          f"{tag}: launches by kernel {run['designs']}, expected {want_designs}")


def free(run: dict):
    run.pop("ctx", None)
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(card: str, fam: Family) -> dict:
    """The training path through vaw_torch.cli.main.main (``run_train_cli``:
    each step's loss is kept as a device tensor, read after the run, with a
    CUDA event after it, so the run is timed without extra syncs). The
    step-30 checkpoint must load back into the model with every EMA
    tensor the run ended with (U-ViT's learned pos_embed included)."""
    argv = fam.model_args + (fam.recipe or RECIPE_ARGS) + fam.train_extra
    name = checkpoint_name(train_cli.parse_args(argv), TRAIN_STEPS)
    with tempfile.TemporaryDirectory(prefix="vaw_chip_train_") as tmp:
        run = run_train_cli(argv + ["--batch_size", str(fam.train_batch), "--logdir", tmp])
        trained = {k: v.detach().cpu() for k, v in run["ctx"]["state"].ema.items()}
        resampler = run["ctx"]["state"].resampler
        if resampler is not None:
            counts = resampler.loss_counts
            print(f"[train] {fam.tag}: loss-aware resampler history, "
                  f"{int((counts == 10).sum())} of {counts.numel()} rows warmed up "
                  f"(10 losses each), {int(counts.sum())} losses held", flush=True)
        free(run)
        ckpts = glob.glob(f"{tmp}/*/checkpoint/{name}.pt")
        check(len(ckpts) == 1, f"checkpoint of step {TRAIN_STEPS}: found {ckpts}")
        with torch.device("meta"):  # shapes only; every parameter comes from the file
            model = fam.ctor()
        model = model.to_empty(device="cpu")
        ckpt_step = load_checkpoint(ckpts[0], model)
        loaded = all(torch.equal(p.detach(), trained[k])
                     for k, p in model.named_parameters())
        del model, trained
    check_run(f"train {fam.tag}", run, TRAIN_STEPS, fam.fwd, fam.bwd,
              fam.fwd_design, fam.bwd_design)
    values = run["losses"]
    if run["vb"]:
        print(f"[train] {fam.tag} vb terms {[round(v, 5) for v in run['vb']]}", flush=True)
        check(all(map(math.isfinite, run["vb"])), f"{fam.tag}: non-finite vb")
    print(f"[train] {fam.tag}: checkpoint {Path(ckpts[0]).name} (step {ckpt_step}) "
          f"loads back with the run's EMA weights: {loaded}")
    print(f"[train] {fam.tag} losses {[round(v, 5) for v in values]}")
    print(f"[train] {fam.tag} batch {fam.train_batch} bf16 over f32 masters, fused "
          f"AdamW+EMA: {run['imgs_per_s']:.2f} imgs/s over steps {TRAIN_WARMUP + 1}-"
          f"{TRAIN_STEPS} ({run['ms_per_step']:.2f} ms/step, CUDA events), CLI wall "
          f"{run['wall_s']:.2f} s, peak memory {run['peak_gib']:.2f} GiB [{card}]",
          flush=True)
    w = fam.fall_window
    first, last = sum(values[:w]) / w, sum(values[-w:]) / w
    check(last < first, f"{fam.tag}: loss did not fall: mean of the first {w} "
          f"{first} -> of the last {w} {last}")
    check(ckpt_step == TRAIN_STEPS and loaded,
          f"{fam.tag}: checkpoint step {ckpt_step}, EMA weights loaded back {loaded}")
    return run["launches"], run["designs"]


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
    y = torch.randint(0, fam.classes, (b,), generator=gen, device="cuda")
    g = torch.randn((b, *fam.image), generator=gen, device="cuda")

    def grads():
        model.zero_grad(set_to_none=True)
        (_out(model(x, t, y)) * g).sum().backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    with plain_route(fam):
        want = grads()
    before = read_launches()
    before_designs = read_designs()
    got = grads()
    launched = {k: n - before[k] for k, n in read_launches().items()}
    fwd, bwd = fam.f32
    check(launched == expect((fwd, 1), (bwd, 1)), f"{fam.tag}: the kernel "
          f"route launched {launched}, expected {fwd} and {bwd}")
    # In f32 every kernel that chooses by the call runs its FMA kernel.
    by_design = {k: _used(k, before_designs) for k in DESIGNS}
    want_designs = {k: {"fma": launched[k]} if launched[k] else {} for k in DESIGNS}
    check(by_design == want_designs, f"{fam.tag}: f32 launches by kernel {by_design}, "
          f"expected {want_designs}")
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


def write_cifar(root: Path) -> Path:
    """A CIFAR-10-layout archive of seeded uint8 rows: data_batch_1..5 of
    CIFAR_ROWS rows each and a test_batch, each a pickle of {b"data":
    [n, 3072] uint8, b"labels": [n] ints below 10}."""
    rng = np.random.default_rng(20)
    base = root / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        data = {b"data": rng.integers(0, 256, (CIFAR_ROWS, 3072), dtype=np.uint8),
                b"labels": rng.integers(0, 10, CIFAR_ROWS).tolist()}
        with open(base / name, "wb") as f:
            pickle.dump(data, f)
    return root


def write_latents(root: Path) -> Path:
    """latents.h5 in the layout of vaw_tpu/data/preprocessing.py:70-80:
    train_latents [n, 8, 32, 32] f32 (4 channels of means, then 4 of
    positive standard deviations) and train_labels [n] uint16 below 1000,
    seeded; 384 MiB for LATENT_ITEMS items."""
    import h5py

    rng = np.random.default_rng(21)
    path = root / "latents.h5"
    with h5py.File(path, "w") as f:
        lat = f.create_dataset("train_latents", (LATENT_ITEMS, 8, 32, 32), dtype="float32")
        lab = f.create_dataset("train_labels", (LATENT_ITEMS,), dtype="uint16")
        for start in range(0, LATENT_ITEMS, 2048):
            n = min(2048, LATENT_ITEMS - start)
            chunk = np.empty((n, 8, 32, 32), np.float32)
            chunk[:, :4] = rng.standard_normal((n, 4, 32, 32), dtype=np.float32)
            chunk[:, 4:] = rng.uniform(0.05, 0.5, (n, 4, 32, 32)).astype(np.float32)
            lat[start:start + n] = chunk
            lab[start:start + n] = rng.integers(0, 1000, n)
    return path


def phase_data_cifar(card: str, data_dir: Path):
    """DiT-B/2 (3 channels, 10 classes) trained through the CLI on the
    CIFAR-10 archive: batches through the native gather and the
    prefetcher, asynchronous checkpoints at steps 15 and 30; the step-30
    file holds the final in-memory state bit for bit. Then the same run
    with synchronous saves and with no saves, for the cost of a save in
    the timed window (steps 6-30)."""
    def argv(tmp, save_step, asynchronous):
        return CIFAR_ARGS + RECIPE_ARGS + [
            "--dataset", "CIFAR-10", "--data_dir", str(data_dir), "--num_workers", "8",
            "--batch_size", str(DIT_TRAIN_BATCH), "--total_steps", str(CIFAR_STEPS),
            "--save_step", str(save_step), "--async_checkpoint", str(asynchronous),
            "--logdir", tmp]

    with tempfile.TemporaryDirectory(prefix="vaw_chip_cifar_") as tmp:
        run = run_train_cli(argv(tmp, CIFAR_SAVE, True))
        check_run("data-cifar", run, CIFAR_STEPS, DIT.fwd, DIT.bwd,
                  bwd_design=DIT.bwd_design)
        state = run["ctx"]["state"]
        ckpts = sorted(glob.glob(f"{tmp}/*/checkpoint/DiT-B_EPSILON_cosine_*.pt"))
        names = [Path(c).name for c in ckpts]
        check(len(ckpts) == 2, f"data-cifar: checkpoints {names}, expected steps "
              f"{CIFAR_SAVE} and {CIFAR_STEPS}")
        saved = torch.load(next(c for c in ckpts if c.endswith(f"_{CIFAR_STEPS}.pt")),
                           map_location="cpu", weights_only=True)
        trees = (("params", state.params, saved["params"]), ("ema", state.ema, saved["ema"]),
                 ("mu", state.mu, saved["opt"]["mu"]), ("nu", state.nu, saved["opt"]["nu"]))
        equal = {name: set(live) == set(disk) and all(
            torch.equal(t.detach().cpu(), disk[k]) for k, t in live.items())
            for name, live, disk in trees}
    print(f"[data-cifar] native gathers {run['gathers']}, checkpoints {names}; the "
          f"step-{CIFAR_STEPS} file equals the final state bit for bit: {equal}, step "
          f"{saved['step']}, count {saved['opt']['count']} (state {state.count})")
    check(run["gathers"] >= CIFAR_STEPS, f"data-cifar: {run['gathers']} native "
          f"gathers, expected at least {CIFAR_STEPS}")
    check(all(equal.values()) and saved["step"] == CIFAR_STEPS
          and saved["opt"]["count"] == state.count,
          f"data-cifar: the step-{CIFAR_STEPS} checkpoint differs from the final state")
    del state, saved, trees
    free(run)
    timed = [("asynchronous", run)]
    for saves, save_step, asynchronous in (("synchronous", CIFAR_SAVE, False),
                                           ("no", 0, False)):
        with tempfile.TemporaryDirectory(prefix="vaw_chip_cifar_") as tmp:
            other = run_train_cli(argv(tmp, save_step, asynchronous))
        check_run(f"data-cifar, {saves} saves", other, CIFAR_STEPS, DIT.fwd, DIT.bwd,
                  bwd_design=DIT.bwd_design)
        free(other)
        timed.append((saves, other))
    for saves, timed_run in timed:
        at = f" at steps {CIFAR_SAVE} and {CIFAR_STEPS}" if saves != "no" else ""
        print(f"[data-cifar] DiT-B/2 batch {DIT_TRAIN_BATCH} on CIFAR-10 through the "
              f"prefetcher, {saves} saves{at}: {timed_run['imgs_per_s']:.2f} imgs/s "
              f"({timed_run['ms_per_step']:.2f} ms/step, CUDA events over steps "
              f"{TRAIN_WARMUP + 1}-{CIFAR_STEPS}), step {CIFAR_SAVE + 1} "
              f"{timed_run['step_ms'][CIFAR_SAVE]:.2f} ms, peak memory "
              f"{timed_run['peak_gib']:.2f} GiB [{card}]", flush=True)
    return run["launches"], run["designs"]


def phase_async_snapshot():
    """AsyncCheckpointWriter.save, then at once one more fused AdamW+EMA
    step on the same state: the file holds the state before that step."""
    cfg = train_cli.parse_args(DIT.model_args + RECIPE_ARGS + [
        "--batch_size", "32"])
    torch.manual_seed(0)
    trainer = Trainer(cfg, build_model(cfg, device="cuda"),
                      train_cli.build_diffusion(cfg))
    state = trainer.init_state()
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = {"image": torch.randn((32, 32, 32, 4), generator=gen, device="cuda"),
             "label": torch.randint(0, 1000, (32,), generator=gen, device="cuda")}
    state, _ = trainer.step(state, batch)  # moments and EMA away from their init
    trees = ("params", "ema", "mu", "nu")
    before = {n: {k: t.detach().cpu().clone() for k, t in getattr(state, n).items()}
              for n in trees}
    with tempfile.TemporaryDirectory(prefix="vaw_chip_async_") as tmp:
        with AsyncCheckpointWriter(state) as writer:  # its buffers made here
            path = writer.save(cfg, 1, state, logdir=tmp)
            state, _ = trainer.step(state, batch)  # in place, right after the snapshot
            writer.wait()
        saved = torch.load(path, map_location="cpu", weights_only=True)
    disk = {"params": saved["params"], "ema": saved["ema"], "mu": saved["opt"]["mu"],
            "nu": saved["opt"]["nu"]}
    equal = {n: all(torch.equal(disk[n][k], before[n][k]) for k in before[n])
             for n in trees}
    moved = {n: any(not torch.equal(t.detach().cpu(), before[n][k])
                    for k, t in getattr(state, n).items()) for n in trees}
    print(f"[async-snapshot] the file equals the state before the next step: "
          f"{equal}; that step changed the live state: {moved}", flush=True)
    check(all(equal.values()), "async-snapshot: the file is not the snapshot's state")
    check(all(moved.values()), "async-snapshot: the step after the save changed nothing")
    del trainer, state, before, saved, disk
    gc.collect()
    torch.cuda.empty_cache()


def phase_data_latent(card: str, path: Path):
    """DiT-B/2 through the CLI on the latent file: slab reads (8192 items,
    the second slab carried), the prefetcher, 40 steps at batch 256."""
    with tempfile.TemporaryDirectory(prefix="vaw_chip_latent_") as tmp:
        argv = DIT.model_args + RECIPE_ARGS + [
            "--dataset", "Latent", "--data_dir", str(path),
            "--batch_size", str(DIT_TRAIN_BATCH), "--total_steps", str(LATENT_STEPS),
            "--save_step", "0", "--logdir", tmp]
        run = run_train_cli(argv)
    check_run("data-latent", run, LATENT_STEPS, DIT.fwd, DIT.bwd,
              bwd_design=DIT.bwd_design)
    print(f"[data-latent] DiT-B/2 batch {DIT_TRAIN_BATCH} on {LATENT_ITEMS} latents "
          f"through the slab loader and the prefetcher: {run['imgs_per_s']:.2f} imgs/s "
          f"({run['ms_per_step']:.2f} ms/step, CUDA events over steps "
          f"{TRAIN_WARMUP + 1}-{LATENT_STEPS}), peak memory {run['peak_gib']:.2f} GiB "
          f"[{card}]", flush=True)
    free(run)
    return run["launches"], run["designs"]


def phase_remat_grad():
    """DiT-B/2's f32 gradient at batch 256 without remat and under each
    policy, bit-equal, with cuDNN held to deterministic algorithms: the
    patch conv's filter gradient (x_embedder) is otherwise summed in no
    fixed order, so that even the gradient without remat, taken twice,
    differs there."""
    model = DIT.seeded().float().train()
    gen = torch.Generator(device="cuda").manual_seed(5)
    b = DIT_TRAIN_BATCH
    x = torch.randn((b, 32, 32, 4), generator=gen, device="cuda")
    t = torch.rand((b,), generator=gen, device="cuda") * 999
    y = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    g = torch.randn((b, 32, 32, 4), generator=gen, device="cuda")

    def grads(use_checkpoint, policy="full"):
        model.use_checkpoint, model.remat_policy = use_checkpoint, policy
        model.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        (_out(model(x, t, y)) * g).sum().backward()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        return {k: p.grad.clone() for k, p in model.named_parameters()}, peak

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want, peak = grads(False)
        peaks = {"none": peak}
        for policy in (None, *REMAT_POLICIES):
            got, peak = grads(policy is not None, policy or "full")
            if policy is not None:
                peaks[policy] = peak
            differ = sorted({_grad_group(k) for k in want
                             if not torch.equal(got[k], want[k])})
            what = "without remat, taken again" if policy is None else f"under {policy!r}"
            print(f"[remat] DiT-B/2 B={b} f32 gradient {what}, cuDNN deterministic: "
                  f"bit-equal to the gradient without remat {not differ}; groups "
                  f"that differ {differ}", flush=True)
            check(not differ, f"remat {policy or 'none'}: the gradient differs in {differ}")
            del got
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"[remat] DiT-B/2 B={b} f32 forward + backward peak memory (GiB): "
          + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items()), flush=True)
    del model, want
    gc.collect()
    torch.cuda.empty_cache()


def phase_remat_train(card: str) -> tuple:
    """Through the CLI, bf16: DiT-B/2 at batch 256 without remat and under
    each policy (an attention forward runs again in each rematted block's
    backward: 24 fused forwards a step), and U-ViT-L/2 at the recipe's
    batch 256 under "full" (42 general forwards a step), beside U-ViT-L/2
    without remat at 128 and at 256 (which fits in 80 GB). Prints each
    run's peak memory."""
    by_path, designs_by_path, peaks = {}, {}, {}
    remat_fwd = {"flash_fused_fwd": 2 * DIT.fwd["flash_fused_fwd"]}
    for policy in (None, *REMAT_POLICIES):
        flags = [] if policy is None else ["--use_checkpoint", "True",
                                           "--remat_policy", policy]
        with tempfile.TemporaryDirectory(prefix="vaw_chip_remat_") as tmp:
            run = run_train_cli(DIT.model_args + RECIPE_ARGS + flags + [
                "--batch_size", str(DIT_TRAIN_BATCH), "--total_steps",
                str(REMAT_STEPS), "--save_step", "0", "--logdir", tmp])
        tag = f"remat DiT-B/2 {policy or 'none'}"
        check_run(tag, run, REMAT_STEPS, DIT.fwd if policy is None else remat_fwd,
                  DIT.bwd, bwd_design=DIT.bwd_design)
        peaks[f"DiT-B/2 {DIT_TRAIN_BATCH} {policy or 'none'}"] = run["peak_gib"]
        print(f"[{tag}] {run['imgs_per_s']:.2f} imgs/s ({run['ms_per_step']:.2f} "
              f"ms/step), peak memory {run['peak_gib']:.2f} GiB [{card}]", flush=True)
        if policy is not None:
            by_path[f"remat_dit_{policy}"] = run["launches"]
            designs_by_path[f"remat_dit_{policy}"] = run["designs"]
        free(run)
    uvit_fwd = {"flash_fwd": 2 * UVIT.fwd["flash_fwd"]}
    uvit_fwd_design = {"flash_fwd": {"wgmma": 2 * UVIT.fwd["flash_fwd"]}}
    for batch, policy in ((UVIT_REMAT_BATCH, "full"), (UVIT.train_batch, None),
                          (UVIT_REMAT_BATCH, None)):
        flags = [] if policy is None else ["--use_checkpoint", "True",
                                           "--remat_policy", policy]
        tag = f"remat U-ViT-L/2 {batch} {policy or 'none'}"
        with tempfile.TemporaryDirectory(prefix="vaw_chip_remat_") as tmp:
            run = run_train_cli(UVIT.model_args + RECIPE_ARGS + flags + [
                "--batch_size", str(batch), "--total_steps", str(REMAT_STEPS),
                "--save_step", "0", "--logdir", tmp])
        check_run(tag, run, REMAT_STEPS, UVIT.fwd if policy is None else uvit_fwd,
                  UVIT.bwd, fwd_design=UVIT.fwd_design if policy is None else uvit_fwd_design,
                  bwd_design=UVIT.bwd_design)
        peaks[f"U-ViT-L/2 {batch} {policy or 'none'}"] = run["peak_gib"]
        print(f"[{tag}] {run['imgs_per_s']:.2f} imgs/s ({run['ms_per_step']:.2f} "
              f"ms/step), peak memory {run['peak_gib']:.2f} GiB [{card}]", flush=True)
        if policy is not None:
            by_path["remat_uvit_full"] = run["launches"]
            designs_by_path["remat_uvit_full"] = run["designs"]
        free(run)
    print("[remat] peak memory of the train runs (GiB, torch.cuda.max_memory_allocated): "
          + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items()) + f" [{card}]", flush=True)
    return by_path, designs_by_path


def phase_host_path(card: str, cifar_dir: Path, latent_path):
    """profile_train's resident and loader-fed steps (the loader through
    prefetch_to_device) for DiT-B/2 on Gaussian latents, on CIFAR-10 and on
    the latent file."""
    runs = [("Gaussian", [])]
    runs.append(("CIFAR-10", ["--dataset", "CIFAR-10", "--data_dir", str(cifar_dir),
                              "--in_chans", "3", "--num_classes", "10",
                              "--num_workers", "8"]))
    if latent_path is not None:
        runs.append(("Latent", ["--dataset", "Latent", "--data_dir", str(latent_path)]))
    for name, argv in runs:
        print(f"[host] DiT-B/2 batch {DIT_TRAIN_BATCH} on {name} [{card}]", flush=True)
        rc = profile_train.main(argv)
        check(rc == 0, f"host path on {name}: profile_train exited {rc}")
        gc.collect()
        torch.cuda.empty_cache()


def phase_slice11(card: str, by_path: dict, designs_by_path: dict):
    """ViT-B/2 (sample, model, train with the loss-aware resampler, grad),
    MM-DiT-B/2 (flow SDE and ODE samples, model, rectified-flow train,
    grad) and DiT-B/2 with learned variance (sample, train with the vb
    term, then under the KL loss)."""
    model = VIT.seeded()
    by_path["sample_vit"], designs_by_path["sample_vit"] = phase_sample(card, VIT, model)
    phase_model(VIT, model)
    del model
    torch.cuda.empty_cache()
    by_path["train_vit"], designs_by_path["train_vit"] = phase_train(card, VIT)
    phase_grad(VIT)
    torch.cuda.empty_cache()
    model = MMDIT.seeded()
    for path, (counts, designs) in phase_sample_flow(card, MMDIT, model).items():
        by_path[path], designs_by_path[path] = counts, designs
    phase_model(MMDIT, model)
    del model
    torch.cuda.empty_cache()
    by_path["train_mmdit"], designs_by_path["train_mmdit"] = phase_train(card, MMDIT)
    phase_grad(MMDIT)
    torch.cuda.empty_cache()
    model = DIT_LV.seeded()
    by_path["sample_dit_lv"], designs_by_path["sample_dit_lv"] = phase_sample(
        card, DIT_LV, model)
    del model
    torch.cuda.empty_cache()
    by_path["train_dit_lv"], designs_by_path["train_dit_lv"] = phase_train(card, DIT_LV)
    by_path["train_dit_kl"], designs_by_path["train_dit_kl"] = phase_kl(card)
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    start = time.perf_counter()
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
    phase_slice11(card, by_path, designs_by_path)
    with tempfile.TemporaryDirectory(prefix="vaw_chip_data_") as data:
        cifar_dir = write_cifar(Path(data))
        by_path["train_cifar"], designs_by_path["train_cifar"] = phase_data_cifar(
            card, cifar_dir)
        phase_async_snapshot()
        latent_path = None
        try:
            import h5py  # noqa: F401 - the latent phase needs it
        except ImportError as e:
            print(f"[data-latent] h5py does not import here ({e}): the latent phase "
                  "is not run", flush=True)
        else:
            latent_path = write_latents(Path(data))
            by_path["train_latent"], designs_by_path["train_latent"] = phase_data_latent(
                card, latent_path)
        phase_remat_grad()
        paths, designs = phase_remat_train(card)
        by_path.update(paths)
        designs_by_path.update(designs)
        phase_host_path(card, cifar_dir, latent_path)
    for record in records:
        record["launches_by_path"] = {p: n[record["name"]] for p, n in by_path.items()}
    # No model calls the fused bias + leaky ReLU: its launches are those of
    # its own run through the op entry in phase 3i.
    act_record["launches_by_path"]["op_entry_3i"] = act_launches
    for record in records:
        record["launches"] = sum(record["launches_by_path"].values())
    # Launches by kernel (wgmma, mma.sync, FMA) and path of the conv forward,
    # the wgrad, the p5 forward and the general forward and backward.
    for record in records:
        if record["name"] in DESIGNS:
            record["launches_by_design_by_path"] = {
                design: {p: d[record["name"]][design] for p, d in designs_by_path.items()}
                for design in DESIGNS[record["name"]]}
    print(f"chip_smoke: every phase passed in {time.perf_counter() - start:.1f} s "
          f"[{card}]", flush=True)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
