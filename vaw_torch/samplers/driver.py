"""High-level generation driver (counterpart of vaw_tpu/samplers/driver.py;
reference: tools/sampler.py:97-268): the EDM path of diffusion models and
the ODE/SDE samplers of flow matching.

One batch is: labels and latents drawn from a ``torch.Generator`` on the
device, the EDM sampler or the flow process's ``sample`` (with the config's
rtol/atol for dopri5) through interval CFG, the optional VAE decode, and the
uint8 conversion on the device; only uint8 images reach the host. The DDIM
and ancestral loops are ROADMAP A15.
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

    model_fn(x, t, y=...) -> model output [N, H, W, C_out] (or a tuple
    whose first element it is).
    diffusion: the FlowMatching process, for model_mode "flow".
    vae_decode_fn: optional latents -> images in [-1,1] (NHWC), applied when
    in_chans == 4 (reference: tools/sampler.py:249-255).
    ``last_dopri5`` holds the last flow dopri5 batch's accepted and rejected
    steps.
    """

    def __init__(self, cfg, model_fn, diffusion=None, vae_decode_fn=None,
                 device="cuda"):
        if cfg.model_mode not in ("diffusion", "flow"):
            raise ValueError(f"Unsupported model_mode: {cfg.model_mode}")
        if cfg.model_mode == "diffusion" and cfg.solver == "ddim":
            raise NotImplementedError(
                "the DDIM/ancestral sampler is not ported yet: ROADMAP A15")
        if cfg.model_mode == "flow" and diffusion is None:
            raise ValueError("flow sampling needs the FlowMatching process "
                             "(diffusion=)")
        self.cfg = cfg
        self.diffusion = diffusion
        self.vae_decode_fn = vae_decode_fn
        self.device = torch.device(device)
        self.last_dopri5: dict = {}
        self.cfg_model = IntervalCFG(model_fn, cfg.num_classes, cfg.guidance_scale,
                                     tuple(cfg.interval), cfg.class_cond)
        if cfg.model_mode == "flow":
            return
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

    def _flow_batch(self, generator, shape, y):
        """(reference: tools/sampler.py:190-214; vaw_tpu/samplers/driver.py:
        147-160)"""
        cfg = self.cfg
        noise = torch.randn(shape, generator=generator, device=self.device)
        model_kwargs = {"y": y} if cfg.class_cond else {}
        self.last_dopri5 = {}
        samples = self.diffusion.sample(
            self.cfg_model, generator, noise, num_steps=cfg.sample_steps,
            solver=cfg.solver, model_kwargs=model_kwargs, rtol=cfg.rtol,
            atol=cfg.atol, info=self.last_dopri5)
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
        batch_fn = self._flow_batch if self.cfg.model_mode == "flow" else self._edm_batch
        produced = 0
        while produced < num_samples:
            y = self._get_y_cond(generator, sample_size, num_classes)
            all_samples.append(batch_fn(generator, shape, y).cpu().numpy())
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
