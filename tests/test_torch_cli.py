"""The port's sampling CLI end to end on the CPU, its device rule, and the
port's isolation from the JAX package."""

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
        "print(len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


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
