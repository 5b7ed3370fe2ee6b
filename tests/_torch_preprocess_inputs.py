"""Seeded inputs of the preprocessing tools, shared by
tests/test_torch_preprocessing.py and tests/test_torch_cli.py: an
ImageNet-style class tree of JPEGs, a CelebA root at 178x218 with its
partition file, a PNG tree for the reference statistics, and a stand-in
for the lmdb package (neither machine has it) that serves an LSUN-style
database of encoded images to whichever package imports it."""

from __future__ import annotations

import io
import os
import types
from pathlib import Path

import numpy as np
from PIL import Image


def _image(rng, w, h) -> Image.Image:
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def write_imagenet_tree(root: Path, per_class: int = 4, seed: int = 0) -> Path:
    """Two class folders of JPEGs of several sizes, and one PNG and one
    non-image file, which the resize copies and skips."""
    rng = np.random.default_rng(seed)
    for c, wnid in enumerate(("n01440764", "n01443537")):
        d = root / wnid
        d.mkdir(parents=True)
        for i in range(per_class):
            w, h = int(rng.integers(40, 140)), int(rng.integers(40, 140))
            _image(rng, w, h).save(d / f"{wnid}_{i}.JPEG", quality=90)
    _image(rng, 70, 50).save(root / "n01440764" / "extra.png")
    (root / "n01443537" / "notes.txt").write_text("not an image")
    return root


def write_celeba(root: Path, n: int = 16, seed: int = 0) -> Path:
    """img_align_celeba/{i:06d}.jpg at CelebA's 178x218 and
    list_eval_partition.txt spreading them over train, val and test."""
    rng = np.random.default_rng(seed)
    imgs = root / "img_align_celeba"
    imgs.mkdir(parents=True)
    rows = []
    for i in range(n):
        name = f"{i + 1:06d}.jpg"
        _image(rng, 178, 218).save(imgs / name, quality=95)
        rows.append(f"{name} {0 if i < n - 4 else (1 if i < n - 2 else 2)}")
    (root / "list_eval_partition.txt").write_text("\n".join(rows) + "\n")
    return root


def write_png_tree(root: Path, n: int = 20, size: int = 20, seed: int = 0) -> Path:
    """n RGB PNGs in two subfolders, a little larger than `size` so that
    the center crop resizes them."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        d = root / f"class{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        _image(rng, size + i % 5, size + 3).save(d / f"{i:03d}.png")
    return root


def lsun_values(n: int = 6, seed: int = 0) -> list:
    """Encoded images as an LSUN lmdb holds them (JPEG and WebP there;
    JPEG and PNG here), of several sizes."""
    rng = np.random.default_rng(seed)
    values = []
    for i in range(n):
        buf = io.BytesIO()
        _image(rng, 60 + 7 * i, 50 + 3 * i).save(buf, format="JPEG" if i % 2 else "PNG")
        values.append((f"{i:040x}".encode(), buf.getvalue()))
    return values


def fake_lmdb(databases: dict) -> types.ModuleType:
    """A module with lmdb's open/begin/cursor over {path: [(key, value)]}."""

    class _Txn:
        def __init__(self, items):
            self.items = items

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def cursor(self):
            return iter(self.items)

    class _Env:
        def __init__(self, items):
            self.items = items

        def begin(self, write=False):
            assert not write
            return _Txn(self.items)

    def open_(path, map_size=None, max_readers=None, readonly=False):
        assert readonly
        return _Env(databases[os.fspath(path)])

    module = types.ModuleType("lmdb")
    module.open = open_
    return module


def tree(root: Path) -> dict:
    """{relative path: decoded array} of every file under root."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            with Image.open(p) as im:
                out[str(p.relative_to(root))] = np.asarray(im)
    return out
