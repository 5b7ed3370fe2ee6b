#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (vaw_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device   the card's name and power limit (nvidia-smi); no card, no run.
  2. build    every CUDA kernel of the path from vaw_torch/ops/csrc (nvcc,
              sm_90a, one process per source, all started together).
  3. kernel   each kernel against its plain PyTorch version on the card at
              the main path's shapes, with its time beside its bound, the
              plain version's time and one PyTorch library call's time.
  4. sample   the main path through its normal entry point,
              vaw_torch.cli.sample.main: a seeded DiT-B/2 (random weights,
              adaLN and head included) sampling 128 latents with 18 Heun
              EDM steps at CFG 1.5, bf16. Every kernel's launch count is
              set to 0 just before and read just after.
  5. model    one DiT-B/2 forward on the card through the kernel against
              the same forward through the plain attention in f32.

Exits non-zero, printing no result, without a CUDA card or if any phase
fails. Otherwise it prints one {"kernels": [...]} JSON line and, last,
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import torch
import torch.nn.functional as F

import vaw_torch.cli.sample as sample_cli
from vaw_torch.models import layers as model_layers
from vaw_torch.models.dit import DiT_B
from vaw_torch.ops import _build
from vaw_torch.ops.flash_attention import (
    flash_attention_fused,
    flash_attention_fused_reference,
)
from vaw_torch.samplers import driver as sampler_driver

# H100 SXM peaks (NVIDIA data sheet): HBM rate, dense bf16 tensor-core rate
# and the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# DiT-B/2 on 32x32x4 latents: T = 256 tokens, 12 heads of 64, 12 blocks.
SAMPLE_SIZE, NUM_SAMPLES, STEPS = 64, 128, 18
B_MAIN, T_MAIN, H_MAIN, D_MAIN, DEPTH = 2 * SAMPLE_SIZE, 256, 12, 64, 12
# Heun: 2 * 18 - 1 model calls per batch, one kernel launch per block each.
EXPECTED_LAUNCHES = DEPTH * (2 * STEPS - 1) * (NUM_SAMPLES // SAMPLE_SIZE)

# Kernel against its plain version on the same inputs: f32 differs only in
# summation order and exp2f; bf16 output is one rounding of |o| < 2.
ATOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
LSE_ATOL = 1e-4
# bf16 DiT-B/2 forward against the f32 plain forward, relative to max|out|.
MODEL_BF16_RTOL = 3e-2
MODEL_F32_RTOL = 1e-4


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


def attention_bound_ms(b, t, h, d, dtype) -> tuple[float, str]:
    """Least time for one call: qkv read once, o and lse written once, or
    the 4*B*H*T*T*D score and P.V operations at the dtype's peak."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = b * t * 3 * h * d * elt + b * t * h * d * elt + b * h * t * 4
    flops = 4 * b * h * t * t * d
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_record = None
    for (b, t, h, d) in [(B_MAIN, T_MAIN, H_MAIN, D_MAIN), (16, 257, 12, 64)]:
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
            bound_ms, bound_by = attention_bound_ms(b, t, h, d, dtype)
            print(f"[kernel] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
                  f"[{card}]", flush=True)
            main_record = dict(
                name="flash_fused_fwd", route="cuda",
                source="vaw_torch/ops/csrc/flash_fused_fwd.cu",
                replaces="vaw_tpu/ops/flash_attention.py:570",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    return main_record


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


def phase_sample(card: str, model: torch.nn.Module) -> int:
    finite = []
    batch_s = []
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

    with tempfile.TemporaryDirectory(prefix="vaw_chip_smoke_") as tmp:
        ckpt = Path(tmp) / "ema.pt"
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        torch.save({"ema": state, "step": 0}, ckpt)
        out_dir = Path(tmp) / "samples"
        argv = ["--model", "DiT-B", "--image_size", "32", "--patch_size", "2",
                "--in_chans", "4", "--num_classes", "1000", "--class_cond", "True",
                "--drop_label_prob", "0.1", "--amp", "True", "--solver", "heun",
                "--discretization", "edm", "--sample_steps", str(STEPS),
                "--guidance_scale", "1.5", "--sample_size", str(SAMPLE_SIZE),
                "--num_samples", str(NUM_SAMPLES), "--resume", str(ckpt),
                "--save_path", str(out_dir)]
        with mock.patch.object(sampler_driver, "_inverse_normalize",
                               checked_inverse_normalize), \
                mock.patch.object(sampler_driver.Sampler, "_edm_batch",
                                  timed_edm_batch):
            flash_attention_fused.launches = 0
            t0 = time.perf_counter()
            sample_cli.main(argv)
            wall = time.perf_counter() - t0
            launches = flash_attention_fused.launches
        pngs = list(out_dir.rglob("*.png"))
    print(f"[sample] {len(pngs)} PNGs, finite before uint8 per batch {finite}, "
          f"flash_fused_fwd launches {launches} (expected {EXPECTED_LAUNCHES})")
    check(len(pngs) == NUM_SAMPLES, f"{len(pngs)} PNGs, expected {NUM_SAMPLES}")
    check(len(finite) == NUM_SAMPLES // SAMPLE_SIZE and all(finite),
          "non-finite samples before the uint8 cast")
    check(launches == EXPECTED_LAUNCHES, f"{launches} kernel launches on the "
          f"main path, expected {EXPECTED_LAUNCHES}")
    per_batch = ", ".join(f"{SAMPLE_SIZE / s:.2f}" for s in batch_s)
    print(f"[sample] DiT-B/2 EDM Heun {STEPS} steps CFG 1.5 bf16, batches of "
          f"{SAMPLE_SIZE}: samples/s per batch [{per_batch}] (first includes "
          f"warm-up), CLI wall {wall:.2f} s for {NUM_SAMPLES} [{card}]", flush=True)
    return launches


def phase_model(model: torch.nn.Module):
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((B_MAIN, 32, 32, 4), generator=gen, device="cuda")
    t = torch.rand((B_MAIN,), generator=gen, device="cuda") * 999
    y = torch.randint(0, 1000, (B_MAIN,), generator=gen, device="cuda")

    def plain(qkv2d, num_heads, scale=None):
        return flash_attention_fused_reference(qkv2d, num_heads, scale)[0]

    with torch.inference_mode():
        with mock.patch.object(model_layers, "multi_head_attention_fused", plain):
            want = model(x, t, y)
        got_f32 = model(x, t, y)
        got_bf16 = model.to(torch.bfloat16)(x, t, y)
    scale = want.abs().max().item()
    for name, got, tol in (("f32", got_f32, MODEL_F32_RTOL),
                           ("bf16", got_bf16, MODEL_BF16_RTOL)):
        rel = (got - want).abs().max().item() / scale
        print(f"[model] DiT-B/2 B={B_MAIN} {name} kernel vs f32 plain attention: "
              f"max rel err {rel:.3e} (tol {tol:.0e}), max|out| {scale:.3f}",
              flush=True)
        check(math.isfinite(rel) and rel <= tol, f"{name} model forward disagrees")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    card = phase_device()
    phase_build()
    record = phase_kernel(card)
    model = seeded_dit_b()
    record["launches"] = phase_sample(card, model)
    phase_model(model)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
