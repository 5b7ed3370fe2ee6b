"""Offline preprocessing (counterpart of vaw_tpu/data/preprocessing.py;
reference: preprocessing/*.py), with the JAX module's functions, file names
and output layouts:

- encode_latents: VAE-encode an image folder to the HDF5 latent layout
  below (reference: preprocessing/encode_latent.py), on the card.
- resize_imagenet: offline BOX + BICUBIC center-crop resize over class
  folders (reference: preprocessing/image_resizer_imagenet.py), host only.
- preprocess_celeba: CenterCrop(140) -> Resize(64) with the official
  partition file (reference: preprocessing/preprocess_celeba.py), host only.
- export_lsun: lmdb -> PNG directory (reference:
  preprocessing/lsun_bedroom.py), host only; needs the lmdb package.
- compute_ref_stats: FID mu/sigma (+ spatial) and an up-to-10k-image arr_0
  of a PNG tree -> VIRTUAL_{name}{size}.npz (reference:
  preprocessing/cal_ref_stats.py), the Inception graph on the card.

``encode_latents`` VAE-encodes ``{input_dir}/{split}`` image folders into
one HDF5 file in the reference's layout (preprocessing/encode_latent.py:
19-27), which ``LatentDataset`` and ``LatentWithPixelDataset`` read:

  {split}_latents float32 [N, 8, H/8, W/8]  ([mean | std], CHW)
  {split}_pixels  uint8   [N, 3, H, W]      (with save_pixels, for REPA)
  {split}_labels  uint16  [N]
"""

from __future__ import annotations

import glob
import io
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .datasets import ImageFolderDataset, center_crop_arr
from .vae import load_vae_encoder

__all__ = [
    "encode_latents",
    "resize_imagenet",
    "preprocess_celeba",
    "export_lsun",
    "compute_ref_stats",
    "ref_sample",
]


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


def _resize_one(src_dst_size):
    from PIL import Image

    src, dst, size = src_dst_size
    with Image.open(src) as im:
        arr = center_crop_arr(im.convert("RGB"), size)
    Image.fromarray(arr).save(dst)


def resize_imagenet(input_dir: str, output_dir: str, image_size: int = 64,
                    workers: int = 16) -> int:
    """Center-crop resize every PNG/JPEG under input_dir to image_size into
    the same tree under output_dir, same file names (reference:
    preprocessing/image_resizer_imagenet.py:19-105). Returns the count."""
    jobs = []
    for root, _, files in os.walk(input_dir):
        out_root = os.path.join(output_dir, os.path.relpath(root, input_dir))
        os.makedirs(out_root, exist_ok=True)
        for fn in files:
            if fn.lower().endswith((".png", ".jpg", ".jpeg")):
                jobs.append((os.path.join(root, fn), os.path.join(out_root, fn),
                             image_size))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(_resize_one, jobs))
    return len(jobs)


def preprocess_celeba(celeba_root: str, output_dir: str, image_size: int = 64,
                      crop: int = 140) -> str:
    """CenterCrop(crop) -> BICUBIC Resize(image_size) of
    {celeba_root}/img_align_celeba/* into {output_dir}/{train,val,test}/celeba/
    by list_eval_partition.txt (reference:
    preprocessing/preprocess_celeba.py:31-95). Returns output_dir."""
    from PIL import Image

    split_names = {0: "train", 1: "val", 2: "test"}
    with open(os.path.join(celeba_root, "list_eval_partition.txt")) as f:
        rows = [line.split() for line in f if line.strip()]
    for name, part in rows:
        out_dir = os.path.join(output_dir, split_names[int(part)], "celeba")
        os.makedirs(out_dir, exist_ok=True)
        with Image.open(os.path.join(celeba_root, "img_align_celeba", name)) as im:
            w, h = im.size
            left, top = (w - crop) // 2, (h - crop) // 2
            im = im.crop((left, top, left + crop, top + crop))
            im = im.resize((image_size, image_size), Image.BICUBIC)
            im.save(os.path.join(out_dir, name))
    return output_dir


def export_lsun(lmdb_path: str, output_dir: str, image_size: int = 256,
                limit: Optional[int] = None) -> int:
    """Every image of an LSUN lmdb, center-cropped to image_size, as
    {output_dir}/{i:07d}.png in cursor order, at most `limit` (reference:
    preprocessing/lsun_bedroom.py:14-52). Returns the count."""
    try:
        import lmdb  # type: ignore
    except ImportError as e:
        raise ImportError(f"export_lsun needs the lmdb package to read {lmdb_path}: "
                          f"{e}") from e
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    env = lmdb.open(lmdb_path, map_size=1099511627776, max_readers=100, readonly=True)
    count = 0
    with env.begin(write=False) as txn:
        for _, val in txn.cursor():
            with Image.open(io.BytesIO(val)) as im:
                arr = center_crop_arr(im.convert("RGB"), image_size)
            Image.fromarray(arr).save(os.path.join(output_dir, f"{count:07d}.png"))
            count += 1
            if limit and count >= limit:
                break
    return count


def ref_sample(images: np.ndarray, seed: int = 0, limit: int = 10000) -> np.ndarray:
    """The npz's arr_0: every image, or `limit` of them drawn without
    replacement by np.random.RandomState(seed) where there are more."""
    if len(images) <= limit:
        return images
    return images[np.random.RandomState(seed).choice(len(images), limit, replace=False)]


def compute_ref_stats(data_path: str, dataset_name: str, image_size: int,
                      batch_size: int = 64, output_path: Optional[str] = None,
                      seed: int = 0, device="cuda") -> str:
    """FID statistics of every PNG under data_path (sorted, center-cropped
    to image_size) -> an npz with mu, sigma, mu_s, sigma_s and arr_0
    (``ref_sample``), at output_path or ./VIRTUAL_{name}{size}.npz
    (reference: preprocessing/cal_ref_stats.py:32-89). The Inception graph
    runs on `device`. Returns the path."""
    from PIL import Image

    from ..evals import Evaluator

    paths = sorted(glob.glob(os.path.join(data_path, "**", "*.png"), recursive=True))
    if not paths:
        raise FileNotFoundError(f"no PNGs under {data_path}")

    def load(p):
        with Image.open(p) as im:
            return center_crop_arr(im.convert("RGB"), image_size)

    evaluator = Evaluator(batch_size=batch_size, device=device)
    batches = [np.stack([load(p) for p in paths[i: i + batch_size]]).astype(np.uint8)
               for i in range(0, len(paths), batch_size)]
    stats, stats_spatial = (evaluator.compute_statistics(a)
                            for a in evaluator.compute_activations(batches))
    arr_0 = ref_sample(np.concatenate(batches, axis=0), seed)
    output_path = output_path or f"./VIRTUAL_{dataset_name}{image_size}.npz"
    np.savez_compressed(output_path, mu=stats.mu, sigma=stats.sigma,
                        mu_s=stats_spatial.mu, sigma_s=stats_spatial.sigma,
                        arr_0=arr_0.astype(np.uint8))
    return output_path
