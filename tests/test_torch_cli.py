"""The port's sampling CLI end to end on the CPU, with and without an SD-VAE
decoder, its device rule, the preprocessing CLI's encode-latents against
the JAX package's encode_latents, and the port's isolation from the JAX
package."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from PIL import Image

from vaw_torch.cli import sample as cli
from vaw_torch.models.dit import DiT_S

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--model", "DiT-S", "--image_size", "8", "--patch_size", "2",
        "--in_chans", "4", "--num_classes", "10", "--class_cond", "True",
        "--drop_label_prob", "0.1", "--guidance_scale", "1.5",
        "--solver", "heun", "--discretization", "edm", "--sample_steps", "3",
        "--sample_size", "4", "--num_samples", "6"]


@pytest.fixture
def tiny_ckpt(tmp_path):
    torch.manual_seed(0)
    model = DiT_S(image_size=8, patch_size=2, in_channels=4,
                  class_dropout_prob=0.1, num_classes=10, learn_sigma=False)
    path = tmp_path / "ema.pt"
    torch.save({"ema": model.state_dict(), "step": 5}, path)
    return path


def test_cli_samples_pngs_on_cpu(tiny_ckpt, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    out = tmp_path / "samples"
    cli.main(ARGS + ["--resume", str(tiny_ckpt), "--save_path", str(out)])
    pngs = sorted(out.rglob("*.png"))
    assert len(pngs) == 6
    assert all(p.parent.name.isdigit() and int(p.parent.name) < 10 for p in pngs)
    with Image.open(pngs[0]) as img:
        assert img.size == (8, 8)
    printed = capsys.readouterr().out
    assert f"(step 5)" in printed and f"Saved 6 samples to {out}" in printed


def test_cli_raises_without_a_card_unless_cpu_is_asked(tiny_ckpt, tmp_path,
                                                       monkeypatch):
    monkeypatch.delenv("VAW_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="VAW_PLATFORM=cpu"):
        cli.main(ARGS + ["--resume", str(tiny_ckpt),
                         "--save_path", str(tmp_path / "none")])
    assert not (tmp_path / "none").exists()


def test_cli_refuses_cfg_without_null_label_row(tiny_ckpt, tmp_path, monkeypatch):
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    args = [a if a != "0.1" else "0.0" for a in ARGS]
    with pytest.raises(ValueError, match="null-label row"):
        cli.main(args + ["--resume", str(tiny_ckpt),
                         "--save_path", str(tmp_path / "s")])


_BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "vaw_tpu")


def test_every_port_module_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        f"for name in {_BLOCKED!r}: sys.modules[name] = None\n"
        "import vaw_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(vaw_torch.__path__, 'vaw_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {_BLOCKED!r} and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(' '.join(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    mods = set(res.stdout.split())
    assert len(mods) >= 20
    # the multi-GPU slice is covered too
    assert {f"vaw_torch.parallel.{m}" for m in (
        "distributed", "mesh", "partition", "ring_attention", "pipeline",
        "dit_pipeline", "sp_dit")} | {"vaw_torch.train.dryrun"} <= mods


def test_chip_smoke_imports_nothing_of_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert "vaw_torch.cli.sample" in names
    assert not [n for n in names if n.split(".")[0] in _BLOCKED], names


# The SD-VAE's layout at a small width: base 32, four levels (so latents are
# 1/8 of the image, as in the full-size VAE), one res block a level.
SMALL_VAE = dict(base_channels=32, channel_mults=(1, 1, 1, 1), num_res_blocks=1)
SMALL_CONVERT = dict(channel_mults=(1, 1, 1, 1), num_res_blocks=1, base=32)


@pytest.fixture
def small_vae(tmp_path, monkeypatch):
    """A seeded diffusers-layout .bin of the small VAE in VAW_VAE_PATH, and
    both packages' loaders set to that configuration."""
    import functools

    import numpy as np

    from vaw_torch.data import vae as tvae
    from vaw_torch.models.vae import AutoencoderKL
    from vaw_tpu.data import vae as jvae
    from vaw_tpu.models.vae import AutoencoderKL as JaxVAE

    rng = np.random.default_rng(0)
    sd = {}
    for k, v in AutoencoderKL(**SMALL_VAE).state_dict().items():
        mean = 1.0 if "norm" in k and k.endswith(".weight") else 0.0
        sd[k] = torch.from_numpy(
            (mean + 0.1 * rng.standard_normal(tuple(v.shape))).astype(np.float32))
    path = tmp_path / "diffusion_pytorch_model.bin"
    torch.save(sd, path)
    monkeypatch.setenv("VAW_VAE_PATH", str(path))
    monkeypatch.setattr(tvae, "AutoencoderKL", functools.partial(AutoencoderKL, **SMALL_VAE))
    monkeypatch.setattr(tvae, "convert_diffusers_vae",
                        functools.partial(tvae.convert_diffusers_vae, **SMALL_CONVERT))
    monkeypatch.setattr(jvae, "AutoencoderKL", functools.partial(JaxVAE, **SMALL_VAE))
    monkeypatch.setattr(jvae, "convert_diffusers_vae",
                        functools.partial(jvae.convert_diffusers_vae, **SMALL_CONVERT))
    return path


def test_cli_decodes_latents_with_a_vae(tiny_ckpt, small_vae, tmp_path, monkeypatch, capsys):
    """With VAW_VAE_PATH the sampled 8x8x4 latents are decoded, in the
    compute dtype, to 64x64 RGB PNGs."""
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    out = tmp_path / "samples"
    cli.main(ARGS + ["--resume", str(tiny_ckpt), "--save_path", str(out)])
    pngs = sorted(out.rglob("*.png"))
    assert len(pngs) == 6
    with Image.open(pngs[0]) as img:
        assert img.size == (64, 64) and img.mode == "RGB"
    assert "decoder unavailable" not in capsys.readouterr().out


def test_cli_without_a_vae_keeps_latents(tiny_ckpt, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    monkeypatch.delenv("VAW_VAE_PATH", raising=False)
    monkeypatch.chdir(tmp_path)  # no pretrained/ directory here
    cli.main(ARGS + ["--resume", str(tiny_ckpt), "--save_path", str(tmp_path / "s")])
    printed = capsys.readouterr().out
    assert "[vae] decoder unavailable (sd-vae-ft-ema checkpoint not found" in printed
    with Image.open(next((tmp_path / "s").rglob("*.png"))) as img:
        assert img.size == (8, 8)


def _image_folder(root, n=6):
    import numpy as np

    rng = np.random.default_rng(1)
    for i in range(n):
        d = root / "train" / f"c{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)).save(
            d / f"{i}.png")
    return root


def test_preprocess_encode_latents_matches_jax(small_vae, tmp_path, monkeypatch):
    """cli.preprocess encode-latents writes the HDF5 arrays JAX's
    encode_latents writes (latents within atol 1e-4; pixels and labels
    exact; the same dtypes and shapes), in batches of 4 over 6 images."""
    import h5py
    import numpy as np

    from vaw_torch.cli import preprocess
    from vaw_tpu.data.preprocessing import encode_latents as jax_encode_latents

    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    images = _image_folder(tmp_path / "images")
    want_path = jax_encode_latents(str(images), str(tmp_path / "jax.h5"), image_size=16,
                                   batch_size=4, save_pixels=True)
    got_path = preprocess.main(["encode-latents", "--input", str(images), "--output",
                                str(tmp_path / "torch.h5"), "--image_size", "16",
                                "--batch_size", "4", "--save_pixels"])
    with h5py.File(want_path) as want, h5py.File(got_path) as got:
        assert set(got) == set(want) == {"train_latents", "train_pixels", "train_labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got["train_latents"].shape == (6, 8, 2, 2)
        np.testing.assert_allclose(got["train_latents"][:], want["train_latents"][:],
                                   atol=1e-4, rtol=0)
        for k in ("train_pixels", "train_labels"):
            np.testing.assert_array_equal(got[k][:], want[k][:])


@pytest.mark.parametrize("argv", [
    ["resize-imagenet", "--input", "a", "--output", "b"],
    ["celeba", "--input", "a", "--output", "b"],
    ["lsun", "--input", "a", "--output", "b"],
    ["ref-stats", "--input", "a", "--name", "cifar10"]])
def test_preprocess_other_tools_name_roadmap_a17(argv):
    from vaw_torch.cli import preprocess

    with pytest.raises(NotImplementedError, match="ROADMAP A17"):
        preprocess.main(argv)
