#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (vaw_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device   the card's name and power limit (nvidia-smi); no card, no run.
  2. build    every CUDA kernel of the paths from vaw_torch/ops/csrc (nvcc,
              sm_90a, one process per source, all started together).
  3. kernel   the attention forward against its plain PyTorch version on
              the card at the sampling shapes, with its time beside its
              bound, the plain version's time and one PyTorch library
              call's time.
  3b. bwd     the attention backward against its plain version at the
              training shape (B=256, T=256, H=12, D=64) in bf16 and f32,
              and at T=257 and D=128, with the same times; the library
              call is scaled_dot_product_attention's backward.
  4. sample   the sampling path through its entry point,
              vaw_torch.cli.sample.main: a seeded DiT-B/2 (random weights,
              adaLN and head included) sampling 128 latents with 18 Heun
              EDM steps at CFG 1.5, bf16.
  5. model    one DiT-B/2 forward on the card through the kernel against
              the same forward through the plain attention in f32.
  6. train    the training path through its entry point,
              vaw_torch.cli.main.main: DiT-B/2 on 32x32x4 Gaussian latents
              with the flagship recipe (cosine schedule, EPSILON target,
              lambda weight, label dropout 0.1, AdamW (0.9, 0.95) with the
              fused AdamW+EMA, bf16 over f32 masters), batch 256, 30 steps,
              a checkpoint at step 30 that the sample path's loader reads.
  7. grad     one DiT-B/2 backward at B=32 in f32 through the kernels
              against the same backward through the plain attention.
Before each of phases 4 and 6 every kernel's launch count is set to 0, and
it is read just after.

Exits non-zero, printing no result, without a CUDA card or if any phase
fails. Otherwise it prints one {"kernels": [...]} JSON line and, last,
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import glob
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

import vaw_torch.cli.main as train_cli
import vaw_torch.cli.sample as sample_cli
from vaw_torch.models import layers as model_layers
from vaw_torch.models.dit import DiT_B
from vaw_torch.ops import _build
from vaw_torch.ops.flash_attention import (
    flash_attention_fused,
    flash_attention_fused_bwd,
    flash_attention_fused_bwd_reference,
    flash_attention_fused_reference,
)
from vaw_torch.samplers import driver as sampler_driver
from vaw_torch.train import Trainer, load_checkpoint

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
# Backward kernel against its plain version, relative to max|dqkv|: f32
# differs in summation order and exp2f; bf16 rounds P and dS to bf16 hi+lo
# (about 16 bits) and dqkv once to bf16.
BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# DiT-B/2 gradient through the kernels against the plain attention route,
# f32, relative to each parameter group's max|grad|.
GRAD_F32_RTOL = 1e-4

# Training phase: the flagship recipe at batch 256 for 30 steps; one
# forward and one backward launch per block per step.
TRAIN_BATCH, TRAIN_STEPS, TRAIN_WARMUP = 256, 30, 5
TRAIN_LAUNCHES = DEPTH * TRAIN_STEPS
TRAIN_ARGV = [
    "--model", "DiT-B", "--image_size", "32", "--patch_size", "2",
    "--in_chans", "4", "--num_classes", "1000", "--class_cond", "True",
    "--dataset", "Gaussian", "--weight_type", "lambda", "--mean_type",
    "EPSILON", "--path_type", "cosine", "--drop_label_prob", "0.1",
    "--betas", "0.9", "0.95", "--amp", "True", "--batch_size",
    str(TRAIN_BATCH), "--total_steps", str(TRAIN_STEPS), "--eval", "False",
    "--sample_freq", "0", "--save_step", str(TRAIN_STEPS)]
GRAD_BATCH = 32


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


def attention_bwd_bound_ms(b, t, h, d, dtype) -> tuple[float, str]:
    """Least time for one backward call: qkv, o, dout and lse read once and
    dqkv written once, or the 10*B*H*T*T*D operations of its five products
    at the dtype's peak."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * t * 3 * h * d + 2 * b * t * h * d) * elt + b * h * t * 4
    flops = 10 * b * h * t * t * d
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


def phase_bwd(card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)
    main_record = None
    for (b, t, h, d) in [(TRAIN_BATCH, T_MAIN, H_MAIN, D_MAIN), (16, 257, 12, 64),
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
            if (b, t, dtype) != (TRAIN_BATCH, T_MAIN, torch.bfloat16):
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
            bound_ms, bound_by = attention_bwd_bound_ms(b, t, h, d, dtype)
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
            flash_attention_fused.launches = flash_attention_fused_bwd.launches = 0
            t0 = time.perf_counter()
            sample_cli.main(argv)
            wall = time.perf_counter() - t0
            launches = flash_attention_fused.launches
            bwd_launches = flash_attention_fused_bwd.launches
        pngs = list(out_dir.rglob("*.png"))
    print(f"[sample] {len(pngs)} PNGs, finite before uint8 per batch {finite}, "
          f"flash_fused_fwd launches {launches} (expected {EXPECTED_LAUNCHES})")
    check(len(pngs) == NUM_SAMPLES, f"{len(pngs)} PNGs, expected {NUM_SAMPLES}")
    check(len(finite) == NUM_SAMPLES // SAMPLE_SIZE and all(finite),
          "non-finite samples before the uint8 cast")
    check(launches == EXPECTED_LAUNCHES, f"{launches} kernel launches on the "
          f"main path, expected {EXPECTED_LAUNCHES}")
    check(bwd_launches == 0, f"{bwd_launches} backward launches while sampling")
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


def phase_train(card: str) -> dict:
    """The training path through vaw_torch.cli.main.main; Trainer.step is
    wrapped to keep each step's loss (a device tensor, read after the run)
    and a CUDA event after it, so the run is timed without extra syncs."""
    losses, events = [], []
    step = Trainer.step

    def recorded_step(self, state, batch):
        state, metrics = step(self, state, batch)
        losses.append(metrics["loss"])
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return state, metrics

    with tempfile.TemporaryDirectory(prefix="vaw_chip_train_") as tmp:
        argv = TRAIN_ARGV + ["--logdir", tmp]
        with mock.patch.object(Trainer, "step", recorded_step):
            torch.cuda.reset_peak_memory_stats()
            flash_attention_fused.launches = flash_attention_fused_bwd.launches = 0
            t0 = time.perf_counter()
            train_cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"flash_fused_fwd": flash_attention_fused.launches,
                        "flash_fused_bwd": flash_attention_fused_bwd.launches}
        ckpts = glob.glob(f"{tmp}/*/checkpoint/DiT-B_EPSILON_cosine_{TRAIN_STEPS}.pt")
        check(len(ckpts) == 1, f"checkpoint of step {TRAIN_STEPS}: found {ckpts}")
        model = DiT_B(image_size=32, patch_size=2, in_channels=4,
                      class_dropout_prob=0.1, num_classes=1000, learn_sigma=False)
        ckpt_step = load_checkpoint(ckpts[0], model)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    values = [float(x) for x in losses]
    seconds = events[TRAIN_WARMUP - 1].elapsed_time(events[-1]) / 1e3
    imgs_per_s = (TRAIN_STEPS - TRAIN_WARMUP) * TRAIN_BATCH / seconds
    print(f"[train] {len(values)} steps, loss first {values[0]:.5f} last "
          f"{values[-1]:.5f}, all finite {all(map(math.isfinite, values))}; "
          f"launches {launches} (expected {TRAIN_LAUNCHES} each); checkpoint "
          f"{Path(ckpts[0]).name} (step {ckpt_step}) loads into a DiT-B")
    print(f"[train] losses {[round(v, 5) for v in values]}")
    print(f"[train] DiT-B/2 batch {TRAIN_BATCH} bf16 over f32 masters, fused "
          f"AdamW+EMA: {imgs_per_s:.2f} imgs/s over steps "
          f"{TRAIN_WARMUP + 1}-{TRAIN_STEPS} ({1e3 * seconds / (TRAIN_STEPS - TRAIN_WARMUP):.2f} "
          f"ms/step, CUDA events), CLI wall {wall:.2f} s, peak memory "
          f"{peak_gb:.2f} GiB [{card}]", flush=True)
    check(len(values) == TRAIN_STEPS and all(map(math.isfinite, values)),
          "non-finite training loss")
    check(values[-1] < values[0], f"loss did not fall: {values[0]} -> {values[-1]}")
    check(ckpt_step == TRAIN_STEPS, f"checkpoint step {ckpt_step}")
    for name, n in launches.items():
        check(n == TRAIN_LAUNCHES, f"{name}: {n} launches on the train path, "
              f"expected {TRAIN_LAUNCHES}")
    return launches


def _grad_group(name: str) -> str:
    """blocks.3.attn.qkv.weight -> blocks.attn.qkv; x_embedder.proj.bias ->
    x_embedder."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return ".".join(["blocks"] + [p for p in parts[2:-1] if not p.isdigit()])
    return parts[0]


def phase_grad(model: torch.nn.Module):
    model = model.float().train()
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((GRAD_BATCH, 32, 32, 4), generator=gen, device="cuda")
    t = torch.rand((GRAD_BATCH,), generator=gen, device="cuda") * 999
    y = torch.randint(0, 1000, (GRAD_BATCH,), generator=gen, device="cuda")
    g = torch.randn((GRAD_BATCH, 32, 32, 4), generator=gen, device="cuda")

    def grads():
        model.zero_grad(set_to_none=True)
        (model(x, t, y) * g).sum().backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    def plain(qkv2d, num_heads, scale=None):
        return flash_attention_fused_reference(qkv2d, num_heads, scale)[0]

    with mock.patch.object(model_layers, "multi_head_attention_fused", plain):
        want = grads()
    before = flash_attention_fused_bwd.launches
    got = grads()
    check(flash_attention_fused_bwd.launches == before + DEPTH,
          "the kernel route did not launch the backward kernel in every block")
    worst = {}
    for name in want:
        group = _grad_group(name)
        scale = want[name].abs().max().item()
        err = (got[name] - want[name]).abs().max().item()
        prev = worst.get(group, (0.0, 0.0))
        worst[group] = (max(prev[0], err), max(prev[1], scale))
    rel = {k: e / s if s > 0 else e for k, (e, s) in worst.items()}
    print(f"[grad] DiT-B/2 B={GRAD_BATCH} f32 kernels vs plain attention, max "
          f"rel grad error per group: "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(rel.items()))
          + f" (tol {GRAD_F32_RTOL:.0e})", flush=True)
    check(all(math.isfinite(v) and v <= GRAD_F32_RTOL for v in rel.values()),
          "f32 model gradient disagrees")
    model.zero_grad(set_to_none=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    card = phase_device()
    phase_build()
    fwd = phase_kernel(card)
    bwd = phase_bwd(card)
    model = seeded_dit_b()
    by_path = {"flash_fused_fwd": {"sample": phase_sample(card, model)},
               "flash_fused_bwd": {"sample": 0}}
    phase_model(model)
    for name, n in phase_train(card).items():
        by_path[name]["train"] = n
    phase_grad(seeded_dit_b())
    for record in (fwd, bwd):
        record["launches"] = sum(by_path[record["name"]].values())
        record["launches_by_path"] = by_path[record["name"]]
    print(json.dumps({"kernels": [fwd, bwd]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
