"""The port's training CLI (vaw_torch/cli/main.py) end to end on the CPU:
two steps of a DiT-S on 8x8 Gaussian latents, its logs and checkpoint, a
resume from that checkpoint, sampling from it through vaw_torch.cli.sample,
its device rule and the features it refuses."""

from __future__ import annotations

import csv
import glob
import json
import math

import pytest
import torch

from vaw_torch.cli import main as train_cli
from vaw_torch.cli import sample as sample_cli
from vaw_torch.train import load_checkpoint
from vaw_torch.models.dit import DiT_S

ARGS = ["--model", "DiT-S", "--image_size", "8", "--patch_size", "2",
        "--in_chans", "4", "--num_classes", "10", "--class_cond", "True",
        "--drop_label_prob", "0.1", "--dataset", "Gaussian", "--batch_size", "4",
        "--weight_type", "lambda", "--path_type", "cosine", "--betas", "0.9",
        "0.95", "--eval", "False", "--sample_freq", "0", "--amp", "False"]


def _train(tmp_path, *extra):
    return train_cli.main(ARGS + ["--logdir", str(tmp_path / "logs"), *extra])


def test_two_steps_log_checkpoint_resume_and_sample(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    ctx = _train(tmp_path, "--total_steps", "2", "--save_step", "2")
    logdir = glob.glob(str(tmp_path / "logs" / "*"))[0]
    with open(f"{logdir}/progress.csv") as f:
        rows = list(csv.DictReader(f))
    with open(f"{logdir}/progress.json") as f:
        records = [json.loads(line) for line in f]
    assert [int(r["step"]) for r in rows] == [2] and records[0]["step"] == 2
    assert math.isfinite(float(rows[0]["loss"])) and records[0]["grad_norm"] > 0
    assert "mean_type: \"EPSILON\"" in open(f"{logdir}/config.yaml").read()
    ckpt = f"{logdir}/checkpoint/DiT-S_EPSILON_cosine_2.pt"
    payload = torch.load(ckpt, weights_only=True)
    assert payload["step"] == 2 and payload["opt"]["count"] == 2
    assert set(payload["params"]) == set(payload["ema"]) == set(payload["opt"]["mu"])
    assert ctx["state"].step == 2
    model = DiT_S(image_size=8, patch_size=2, in_channels=4,
                  class_dropout_prob=0.1, num_classes=10, learn_sigma=False)
    assert load_checkpoint(ckpt, model) == 2

    resumed = _train(tmp_path, "--total_steps", "3", "--save_step", "0",
                     "--resume", ckpt)
    assert resumed["state"].step == 3 and resumed["state"].count == 3
    assert "Resumed from" in capsys.readouterr().out

    out = tmp_path / "samples"
    sample_cli.main(["--model", "DiT-S", "--image_size", "8", "--patch_size", "2",
                     "--in_chans", "4", "--num_classes", "10", "--class_cond", "True",
                     "--drop_label_prob", "0.1", "--guidance_scale", "1.5",
                     "--sample_steps", "3", "--sample_size", "4", "--num_samples",
                     "4", "--resume", ckpt, "--save_path", str(out)])
    assert len(list(out.rglob("*.png"))) == 4


def test_sample_freq_writes_a_grid(tmp_path, monkeypatch):
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    _train(tmp_path, "--total_steps", "1", "--save_step", "0", "--sample_freq",
           "1", "--sample_steps", "2", "--sample_size", "4",
           "--grad_accumulation", "2")
    assert len(glob.glob(str(tmp_path / "logs" / "*" / "sample" / "1.png"))) == 1


def test_raises_without_a_card_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.delenv("VAW_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="VAW_PLATFORM=cpu"):
        _train(tmp_path, "--total_steps", "1")


@pytest.mark.parametrize("flags,match", [
    (["--eval", "True"], "ROADMAP A14"),
    (["--fsdp", "True"], "ROADMAP A16"),
    (["--model_axis", "2"], "ROADMAP A16"),
    (["--pp_stages", "2"], "ROADMAP A16"),
    (["--sp_degree", "2"], "ROADMAP A16"),
    (["--scan_blocks", "True"], "ROADMAP A4"),
    (["--dataset", "Shapes"], "ROADMAP A7"),
    (["--model_mode", "flow"], "ROADMAP A11"),
    (["--learn_sigma", "True", "--var_type", "LEARNED_RANGE"], "ROADMAP A3"),
])
def test_unported_features_name_their_roadmap_item(flags, match, tmp_path, monkeypatch):
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    with pytest.raises(NotImplementedError, match=match):
        _train(tmp_path, "--total_steps", "1", *flags)
