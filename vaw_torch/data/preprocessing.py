"""Offline preprocessing (counterpart of vaw_tpu/data/preprocessing.py;
reference: preprocessing/encode_latent.py).

``encode_latents`` VAE-encodes ``{input_dir}/{split}`` image folders into
one HDF5 file in the reference's layout (preprocessing/encode_latent.py:
19-27), which ``LatentDataset`` and ``LatentWithPixelDataset`` read:

  {split}_latents float32 [N, 8, H/8, W/8]  ([mean | std], CHW)
  {split}_pixels  uint8   [N, 3, H, W]      (with save_pixels, for REPA)
  {split}_labels  uint16  [N]

The ImageNet resize, CelebA, LSUN and reference-statistics tools of the JAX
module are ROADMAP A17.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .datasets import ImageFolderDataset
from .vae import load_vae_encoder

__all__ = ["encode_latents"]


def encode_latents(input_dir: str, output_h5: str, image_size: int = 256,
                   vae: str = "ema", batch_size: int = 64,
                   save_pixels: bool = False, splits=("train", "val"),
                   device="cuda") -> str:
    """Encode each split's centre-cropped images `batch_size` at a time
    with the f32 SD-VAE on `device` (reference:
    preprocessing/encode_latent.py:60-140); a missing split is skipped.
    Returns output_h5."""
    import h5py

    encode = load_vae_encoder(vae, device=device)
    with h5py.File(output_h5, "w") as f:
        for split in splits:
            root = os.path.join(input_dir, split)
            if not os.path.isdir(root):
                print(f"[encode_latents] skipping missing split {root}")
                continue
            ds = ImageFolderDataset(root, image_size, random_crop=False, flip=False)
            n = len(ds)
            lat_h = image_size // 8
            latents_ds = f.create_dataset(f"{split}_latents", (n, 8, lat_h, lat_h),
                                          dtype="float32")
            labels_ds = f.create_dataset(f"{split}_labels", (n,), dtype="uint16")
            pixels_ds = (f.create_dataset(f"{split}_pixels",
                                          (n, 3, image_size, image_size), dtype="uint8")
                         if save_pixels else None)
            for start in range(0, n, batch_size):
                idx = np.arange(start, min(start + batch_size, n))
                batch = ds.get_batch(idx)
                x = torch.from_numpy(batch["image"]).to(device)
                lat = encode(x).float().cpu().numpy()  # NHWC [mean | std]
                latents_ds[start: start + len(idx)] = np.transpose(lat, (0, 3, 1, 2))
                labels_ds[start: start + len(idx)] = batch["label"]
                if pixels_ds is not None:
                    pix = np.clip((batch["image"] + 1) * 127.5, 0, 255).astype(np.uint8)
                    pixels_ds[start: start + len(idx)] = np.transpose(pix, (0, 3, 1, 2))
    return output_h5
