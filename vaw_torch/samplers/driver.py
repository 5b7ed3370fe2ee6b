"""High-level generation driver (counterpart of vaw_tpu/samplers/driver.py;
reference: tools/sampler.py:97-268), EDM path only.

One batch is: labels and latents drawn from a ``torch.Generator`` on the
device, the EDM sampler through interval CFG, the optional VAE decode, and
the uint8 conversion on the device; only uint8 images reach the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .edm import ablation_sampler, build_edm_plan
from .guidance import IntervalCFG, cfg_scale_for_time

__all__ = ["Sampler"]


def _inverse_normalize(x: torch.Tensor) -> torch.Tensor:
    """[-1,1] float -> uint8 (reference: tools/sampler.py:257-258); NHWC
    already, no permute needed."""
    return torch.clamp((x + 1) * 127.5, 0, 255).to(torch.uint8)


class Sampler:
    """Generation driver over an EMA model closure.

    model_fn(x, t, y=...) -> model output [N, H, W, C_out].
    vae_decode_fn: optional latents -> images in [-1,1] (NHWC), applied when
    in_chans == 4 (reference: tools/sampler.py:249-255).
    """

    def __init__(self, cfg, model_fn, vae_decode_fn=None, device="cuda"):
        if cfg.model_mode == "flow":
            raise NotImplementedError(
                "flow-matching sampling is not ported yet: ROADMAP A11")
        if cfg.model_mode != "diffusion":
            raise ValueError(f"Unsupported model_mode: {cfg.model_mode}")
        if cfg.solver == "ddim":
            raise NotImplementedError(
                "the DDIM/ancestral sampler is not ported yet: ROADMAP A15")
        self.cfg = cfg
        self.vae_decode_fn = vae_decode_fn
        self.device = torch.device(device)
        self.cfg_model = IntervalCFG(model_fn, cfg.num_classes, cfg.guidance_scale,
                                     tuple(cfg.interval), cfg.class_cond)
        self.plan = build_edm_plan(
            num_steps=cfg.sample_steps, solver=cfg.solver,
            discretization=cfg.discretization, schedule=cfg.schedule,
            scaling=cfg.scaling, noise_schedule=cfg.path_type,
            pred_type=cfg.mean_type,
        )
        self.g_steps = np.array([
            cfg_scale_for_time(t, cfg.guidance_scale, tuple(cfg.interval))
            for t in self.plan.c_noise_hat
        ])

    # label sampling (reference: tools/sampler.py:216-229)
    def _get_y_cond(self, generator, sample_size, num_classes):
        if not self.cfg.class_cond:
            return None
        labels = self.cfg.class_labels
        if labels is None:
            return torch.randint(0, num_classes, (sample_size,),
                                 generator=generator, device=self.device)
        labels = torch.as_tensor(labels, dtype=torch.int64, device=self.device)
        idx = torch.randint(0, len(labels), (sample_size,), generator=generator,
                            device=self.device)
        return labels[idx]

    def _decode(self, samples):
        if self.cfg.in_chans == 4 and self.vae_decode_fn is not None:
            samples = self.vae_decode_fn(samples / self.cfg.latent_scale)
        return _inverse_normalize(samples)

    def _edm_batch(self, generator, shape, y):
        """(reference: tools/sampler.py:151-188)"""
        latents = torch.randn(shape, generator=generator, device=self.device)
        samples = ablation_sampler(
            self.cfg_model, generator, latents, self.plan, class_labels=y,
            guidance_scales=self.g_steps, img_channels=self.cfg.in_chans,
        )
        return self._decode(samples)

    @torch.inference_mode()
    def sample(self, generator: torch.Generator, num_samples, sample_size,
               image_size, num_classes, progress_bar=False
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """num_samples uint8 NHWC images (and their labels, when class
        conditional), made sample_size at a time. `generator` lives on the
        sampler's device and drives labels, latents and churn noise."""
        shape = (sample_size, image_size, image_size, self.cfg.in_chans)
        all_samples: List[np.ndarray] = []
        all_labels: List[np.ndarray] = []
        pbar = None
        if progress_bar:
            from tqdm import tqdm

            pbar = tqdm(total=num_samples, desc=f"Sampling ({self.cfg.solver})")
        produced = 0
        while produced < num_samples:
            y = self._get_y_cond(generator, sample_size, num_classes)
            all_samples.append(self._edm_batch(generator, shape, y).cpu().numpy())
            if y is not None:
                all_labels.append(y.cpu().numpy())
            produced += sample_size
            if pbar is not None:
                pbar.update(sample_size)
        if pbar is not None:
            pbar.close()
        samples = np.concatenate(all_samples, axis=0)[:num_samples]
        labels = (np.concatenate(all_labels, axis=0)[:num_samples]
                  if all_labels else None)
        return samples, labels
