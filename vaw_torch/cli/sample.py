"""Inference-only entry point (counterpart of vaw_tpu/cli/sample.py;
reference: sample.py:20-186): load an EMA checkpoint, generate N samples,
write PNGs (per-class subdirectories when conditional).

    python -m vaw_torch.cli.sample --model DiT-B --resume ckpt.pt ...

Runs on the first CUDA card. ``VAW_PLATFORM=cpu`` selects the CPU, the
same switch as the JAX package's CLI; with no card and no CPU request it
raises rather than fall back.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..models import build_model, cast_for_compute
from ..samplers import Sampler
from ..train import load_checkpoint
from ..utils import add_sample_args, config_from_args

__all__ = ["main", "parse_args", "select_device"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Sample from a checkpoint")
    add_sample_args(parser)
    return config_from_args(parser.parse_args(argv))


def select_device() -> torch.device:
    """CUDA unless VAW_PLATFORM=cpu; raise when CUDA is asked for but absent."""
    platform = os.environ.get("VAW_PLATFORM", "").lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("", "cuda", "gpu"):
        raise ValueError(f"VAW_PLATFORM={platform!r}: expected cpu, cuda or gpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; set VAW_PLATFORM=cpu "
                           "to run on the CPU")
    return torch.device("cuda")


def main(argv=None):
    from .main import build_diffusion

    cfg = parse_args(argv)
    if not cfg.resume:
        raise ValueError("--resume checkpoint path is required")
    if cfg.use_classifier:
        raise NotImplementedError(
            "classifier guidance is not ported yet: ROADMAP A15")
    device = select_device()

    model = build_model(cfg, device=device)
    if (cfg.class_cond and abs(cfg.guidance_scale - 1.0) >= 1e-8
            and not model.has_null_label):
        # CFG feeds label num_classes as the unconditional label, which
        # exists only in a table trained with label dropout.
        raise ValueError("--guidance_scale != 1 needs a model with the null-"
                         "label row: set --drop_label_prob > 0 as in training")
    step = load_checkpoint(cfg.resume, model)
    print(f"==> Loaded {cfg.resume} (step {step})")
    # One compute-dtype copy of the f32 EMA weights, made once; a head the
    # JAX model keeps in f32 stays f32.
    model = cast_for_compute(model, cfg.compute_dtype).eval()

    vae_decode_fn = None
    if cfg.in_chans == 4:
        print("[vae] decoder unavailable (the SD-VAE decode is not ported "
              "yet: ROADMAP A9)")

    def model_fn(x, t, y=None):
        return model(x, t, y)

    # The flow process for --model_mode flow (its samplers), else None: the
    # EDM path plans from the config alone.
    diffusion = build_diffusion(cfg) if cfg.model_mode == "flow" else None
    sampler = Sampler(cfg, model_fn, diffusion=diffusion,
                      vae_decode_fn=vae_decode_fn, device=device)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    samples, labels = sampler.sample(
        generator, cfg.num_samples, cfg.sample_size, cfg.image_size,
        cfg.num_classes, progress_bar=True,
    )

    # PNG dump, per-class subdirs when conditional (reference: sample.py:155-182).
    from PIL import Image

    os.makedirs(cfg.save_path, exist_ok=True)
    for i, img in enumerate(samples):
        if cfg.class_cond and labels is not None:
            sub = os.path.join(cfg.save_path, str(int(labels[i])))
            os.makedirs(sub, exist_ok=True)
            path = os.path.join(sub, f"{i:06d}.png")
        else:
            path = os.path.join(cfg.save_path, f"{i:06d}.png")
        arr = img[..., 0] if img.shape[-1] == 1 else img
        Image.fromarray(arr).save(path)
    print(f"Saved {len(samples)} samples to {cfg.save_path}")


if __name__ == "__main__":
    main()
