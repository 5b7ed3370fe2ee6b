"""The port's CLIs with the U-ViT family, end to end on the CPU: two
training steps through vaw_torch.cli.main, the checkpoint's learned
pos_embed, and sampling from that checkpoint through vaw_torch.cli.sample at
CFG 1.5 (the family-neutral null-label check). The registry's U-ViT-S entry
is patched to a tiny width (embed 64, depth 5, 4 heads) so that a
checkpoint is kilobytes; the code path is the full model's."""

from __future__ import annotations

import glob

import pytest
import torch

from vaw_torch.cli import main as train_cli
from vaw_torch.cli import sample as sample_cli
from vaw_torch.models import uvit
from vaw_torch.train import load_checkpoint

MODEL = ["--model", "U-ViT-S", "--image_size", "8", "--patch_size", "2",
         "--in_chans", "4", "--num_classes", "10", "--class_cond", "True"]
TRAIN = MODEL + [
    "--drop_label_prob", "0.1", "--dataset", "Gaussian", "--batch_size", "4",
    "--weight_type", "lambda", "--mean_type", "EPSILON", "--path_type", "cosine",
    "--betas", "0.9", "0.95", "--eval", "False", "--sample_freq", "0",
    "--amp", "True", "--lr", "1e-2"]


@pytest.fixture
def tiny_uvit(monkeypatch):
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    monkeypatch.setitem(uvit.UViT_models, "U-ViT-S", uvit._make_uvit(64, 5, 4))


def _sample(ckpt, out, drop="0.1"):
    sample_cli.main(MODEL + ["--drop_label_prob", drop, "--guidance_scale", "1.5",
                             "--sample_steps", "3", "--sample_size", "4",
                             "--num_samples", "4", "--resume", ckpt,
                             "--save_path", str(out)])


def test_train_two_steps_then_sample_with_cfg(tiny_uvit, tmp_path, capsys):
    ctx = train_cli.main(TRAIN + ["--logdir", str(tmp_path / "logs"),
                                  "--total_steps", "2", "--save_step", "2"])
    assert ctx["state"].step == 2
    (ckpt,) = glob.glob(str(tmp_path / "logs" / "*" / "checkpoint" /
                            "U-ViT-S_EPSILON_cosine_2.pt"))
    payload = torch.load(ckpt, weights_only=True)
    assert payload["step"] == 2 and "pos_embed" in payload["params"]
    torch.manual_seed(123)  # a fresh init, unlike the trained table
    model = uvit.UViT_models["U-ViT-S"](image_size=8, patch_size=2, in_channels=4,
                                       num_classes=10, class_dropout_prob=0.1)
    assert not torch.equal(model.pos_embed, payload["ema"]["pos_embed"])
    assert load_checkpoint(ckpt, model) == 2
    torch.testing.assert_close(model.pos_embed.detach(), payload["ema"]["pos_embed"],
                               rtol=0, atol=0)

    _sample(ckpt, tmp_path / "samples")
    assert len(list((tmp_path / "samples").rglob("*.png"))) == 4
    assert "Saved 4 samples" in capsys.readouterr().out


def test_sample_refuses_cfg_without_the_null_label_row(tiny_uvit, tmp_path):
    torch.manual_seed(0)
    model = uvit.UViT_models["U-ViT-S"](image_size=8, patch_size=2, in_channels=4,
                                       num_classes=10, class_dropout_prob=0.0)
    path = tmp_path / "ema.pt"
    torch.save({"ema": model.state_dict(), "step": 1}, path)
    with pytest.raises(ValueError, match="null-label row"):
        _sample(str(path), tmp_path / "s", drop="0.0")
