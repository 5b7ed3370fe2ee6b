"""Where a train step's time goes, on the card.

    python -m vaw_torch.cli.profile_train [train flags ...]
    python -m vaw_torch.cli.profile_train --model U-ViT-L --batch_size 128
    python -m vaw_torch.cli.profile_train --model LDM --batch_size 256
    VAW_PALLAS_CONV=1 python -m vaw_torch.cli.profile_train --model ADM-64 \
        --image_size 64 --in_chans 3 --batch_size 64
    python -m vaw_torch.cli.profile_train --dataset CIFAR-10 --data_dir DIR \
        --in_chans 3 --num_classes 10
    python -m vaw_torch.cli.profile_train --dataset Latent --data_dir latents.h5
    VAW_ENCODER_DIR=DIR python -m vaw_torch.cli.profile_train --dataset Shapes \
        --in_chans 3 --num_classes 10 --learn_align True \
        --enc_type dinov2-vit-b --encoder_depth 8 --gamma 0.5

Builds the trainer as ``vaw_torch.cli.main`` does, from the same flags: the
model flags (default DiT-B/2 on 32x32x4 latents, ``MODEL``) and the
flagship recipe on Gaussian latents (``RECIPE``, batch 256), either
overridden by the flags given; under --learn_align with REPA's teacher
from ``VAW_ENCODER_DIR``. Then it times
--steps steps after --warmup steps with CUDA events in two ways: on
batches already on the card, and on batches made by the loader of
--dataset (from --data_dir) and moved to the card by
``prefetch_to_device``, as the CLI's loop does. Then it traces --steps
loader-fed steps with torch.profiler and prints, per kernel category, the
device time per step and its share, and the device's busy and idle share
of the traced wall time. Exits non-zero without a CUDA card, and when the
trace holds no device time.

Under ``torchrun`` (or with a parallel flag, over a one-process group)
the trainer is laid out on the CLI's mesh (``build_mesh``: --fsdp,
--model_axis, --pp_stages, --sp_degree) and each rank times its own rows;
rank 0 prints. NCCL's kernels are a category of their own:

    torchrun --standalone --nproc_per_node 1 -m vaw_torch.cli.profile_train
    torchrun --standalone --nproc_per_node 1 -m vaw_torch.cli.profile_train --fsdp True
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict

import torch
import torch.distributed as dist

from ..data import load_dataset, prefetch_to_device, to_device
from ..encoders import initialize_encoders
from ..models import build_model
from ..parallel.distributed import cleanup_distributed, is_main_process, setup_distributed
from ..parallel.mesh import data_index
from ..train import Trainer
from .main import build_apply_fn, build_diffusion, build_mesh, parse_args, uses_mesh
from .sample import select_device

__all__ = ["MODEL", "RECIPE", "kernel_category", "main"]

MODEL = ["--model", "DiT-B", "--image_size", "32", "--patch_size", "2",
         "--in_chans", "4", "--num_classes", "1000", "--class_cond", "True"]
RECIPE = [
    "--dataset", "Gaussian", "--weight_type", "lambda", "--mean_type",
    "EPSILON", "--path_type", "cosine", "--drop_label_prob", "0.1",
    "--betas", "0.9", "0.95", "--amp", "True", "--batch_size", "256",
    "--eval", "False", "--sample_freq", "0"]

# First match wins; names are CUDA kernel names as the profiler reports them.
_CATEGORIES = (
    ("collectives (NCCL)", ("nccl",)),
    ("fused attention fwd kernel", ("flash_fused_fwd",)),
    ("fused attention bwd kernel", ("flash_fused_bwd",)),
    ("p5 attention fwd kernel", ("flash_p5_fwd",)),
    ("p5 attention bwd kernel", ("flash_p5_bwd",)),
    ("general attention fwd kernel", ("flash_fwd",)),
    ("general attention bwd kernel", ("flash_bwd",)),
    # The hand-written 3x3 conv (VAW_PALLAS_CONV=1) before cuDNN's "conv".
    ("conv3x3 fwd/dgrad kernel", ("conv3x3_fwd",)),
    ("conv3x3 wgrad kernel", ("conv3x3_wgrad",)),
    ("fused bias-act kernel", ("fused_leaky_relu",)),
    # cuDNN's implicit-GEMM convs are sm90_xmma_* kernels too: match them
    # (and its layout transposes) before cuBLAS's GEMMs.
    ("conv (cuDNN)", ("implicit_gemm", "cudnn", "conv", "winograd", "fprop", "dgrad",
                      "wgrad", "nchwtonhwc", "nhwctonchw")),
    # f32 GEMMs (REPA's f32 teacher, TF32 off) before the bf16 ones.
    ("matmul f32 (cuBLAS)", ("sgemm", "f32f32_f32f32", "tf32")),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma", "sm90_", "cublas")),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("layer norm", ("layer_norm", "layernorm")),
    ("group norm", ("group_norm", "groupnorm", "rowwisemoments", "computefusedparams",
                    "computeinternalgradients", "computebackwardfusedparams")),
    ("reductions", ("reduce",)),
    ("copies and casts", ("copy", "memcpy", "memset", "fill")),
)


def kernel_category(name: str) -> str:
    low = name.lower()
    for category, keys in _CATEGORIES:
        if any(k in low for k in keys):
            return category
    return "other elementwise"


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    own = argparse.ArgumentParser(add_help=False)
    own.add_argument("--warmup", type=int, default=5)
    own.add_argument("--steps", type=int, default=10)
    opts, rest = own.parse_known_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    cfg = parse_args(MODEL + RECIPE + rest)
    joined_before = dist.is_initialized()
    setup_distributed()
    try:
        if uses_mesh(cfg) and not dist.is_initialized():
            setup_distributed(world_size=1)
        return _build_and_profile(opts, cfg)
    finally:
        if not joined_before:
            cleanup_distributed()


def _build_and_profile(opts, cfg) -> int:
    device = select_device()
    mesh = build_mesh(cfg) if uses_mesh(cfg) else None
    data_rank, data_ranks = data_index(mesh)
    torch.manual_seed(cfg.seed)
    encoder_fn = (initialize_encoders(cfg.enc_type, cfg.image_size, device=device)[0]
                  if cfg.learn_align else None)
    model = build_model(cfg, device=device)
    trainer = Trainer(cfg, model, build_diffusion(cfg), encoder_fn=encoder_fn,
                      mesh=mesh, apply_fn=build_apply_fn(cfg, model, mesh))
    state = trainer.init_state()
    if mesh is not None and is_main_process():
        print(f"[profile] mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} "
              f"over {dist.get_backend()}, --fsdp {cfg.fsdp}; each rank's "
              f"{cfg.batch_size // data_ranks} rows", flush=True)
    loader, _ = load_dataset(cfg.data_dir, cfg.dataset, cfg.batch_size // data_ranks,
                             cfg.image_size, num_workers=cfg.num_workers,
                             seed=cfg.seed,
                             num_classes=cfg.num_classes if cfg.class_cond else 0,
                             channels=cfg.in_chans, num_shards=data_ranks,
                             shard_index=data_rank)
    resident = [to_device(b, device) for b, _ in zip(loader, range(4))]
    fed = prefetch_to_device(loader.forever(), device)
    try:
        return _profile(opts, cfg, trainer, state, resident, fed)
    finally:
        fed.close()  # stops the prefetch worker


def _profile(opts, cfg, trainer, state, resident, fed) -> int:
    def run(batches, steps):
        nonlocal state, metrics
        for _ in range(steps):
            state, metrics = trainer.step(state, next(batches))

    def timed_ms(batches):
        """(device ms per step between CUDA events, host ms per step spent
        launching the steps: near the device's, the host holds the card back)."""
        run(batches, opts.warmup)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        run(batches, opts.steps)
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / opts.steps, host_ms / opts.steps

    metrics = None
    card = _card()
    say = print if is_main_process() else (lambda *a, **k: None)
    cycle = (resident[i % len(resident)] for i in range(1 << 30))
    for name, batches in (("batches on the card", cycle), ("loader-fed", fed)):
        device_ms, host_ms = timed_ms(batches)
        say(f"[profile] {cfg.model} batch {cfg.batch_size} {cfg.dataset} "
              f"{'bf16' if cfg.amp else 'f32'}, {name}: {device_ms:.2f} ms/step "
              f"(CUDA events), host launch {host_ms:.2f} ms/step, over "
              f"{opts.steps} steps [{card}]", flush=True)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run(fed, opts.steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    by_cat = defaultdict(float)
    for evt in kernels:
        by_cat[kernel_category(evt.key)] += evt.self_device_time_total / 1e3
    busy_ms = sum(by_cat.values())
    say(f"[profile] loader-fed, traced: {wall_ms / opts.steps:.2f} ms/step "
          f"over {opts.steps} steps (profiler on)")
    if busy_ms <= 0:
        print("profile_train: the trace holds no device time", file=sys.stderr)
        return 1
    say(f"[profile] device busy {busy_ms / opts.steps:.2f} ms/step = "
          f"{busy_ms / wall_ms:.1%} of the traced wall time, idle "
          f"{1 - busy_ms / wall_ms:.1%}")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        say(f"[profile]   {cat:24s} {ms / opts.steps:9.3f} ms/step "
              f"{ms / busy_ms:6.1%}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        say(f"[profile]   top: {e.self_device_time_total / 1e3 / opts.steps:8.3f} "
              f"ms/step x{e.count // opts.steps} {e.key[:90]}")
    say(f"[profile] loss {float(metrics['loss']):.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
