"""The port's training CLI on 2 gloo CPU ranks (vaw_torch/cli/main.py under
a process group; the DiT-S of the registry cut to width 64, depth 2):
each rank trains on its own shard of the data; a run stopped after 2
steps and resumed from its checkpoint ends bit for bit where the
uninterrupted 4-step run ends, in the checkpoint and in the step-4 sample
grid gathered from both ranks, as tests/test_multiprocess_integration.py
asserts for the JAX CLI; and the JAX CLI's mesh errors."""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks
from vaw_torch.cli import main as train_cli

ARGS = ["--model", "DiT-S", "--image_size", "8", "--patch_size", "2", "--in_chans", "4",
        "--num_classes", "10", "--class_cond", "True", "--drop_label_prob", "0.1",
        "--dataset", "Gaussian", "--batch_size", "8", "--grad_accumulation", "2",
        "--weight_type", "lambda", "--path_type", "cosine", "--eval", "False",
        "--amp", "False", "--sample_steps", "3", "--sample_size", "16", "--seed", "11"]


def _run(tmp_path, name, *extra, world=2):
    logdir = str(tmp_path / name)
    return run_ranks("_torch_parallel_workers:cli", world, tmp_path,
                     ARGS + ["--logdir", logdir, *extra], timeout=240)


def _equal(a, b):
    for tree in ("params", "ema"):
        for k in a[tree]:
            assert torch.equal(a[tree][k], b[tree][k]), (tree, k)
    for tree in ("mu", "nu"):
        for k in a["opt"][tree]:
            assert torch.equal(a["opt"][tree][k], b["opt"][tree][k]), (tree, k)
    assert a["step"] == b["step"] and a["opt"]["count"] == b["opt"]["count"]


def test_two_ranks_train_save_resume_and_sample(tmp_path):
    whole = _run(tmp_path, "whole", "--total_steps", "4", "--save_step", "4",
                 "--sample_freq", "4")
    # Each rank read its own shard of the data.
    assert not np.array_equal(whole[0]["first_batch"], whole[1]["first_batch"])
    assert whole[0]["first_batch"].shape[0] == 8  # 8 x 2 micro-batches / 2 ranks
    assert whole[0]["logdir"] == whole[1]["logdir"]  # rank 0's run directory
    head = _run(tmp_path, "head", "--total_steps", "2", "--save_step", "2")
    ckpt = glob.glob(os.path.join(head[0]["logdir"], "checkpoint", "*_2.pt"))[0]
    tail = _run(tmp_path, "tail", "--total_steps", "4", "--save_step", "4",
                "--sample_freq", "4", "--resume", ckpt)
    assert tail[0]["step"] == tail[1]["step"] == 4
    name = "DiT-S_EPSILON_cosine_4.pt"
    _equal(whole[0]["checkpoints"][name], tail[0]["checkpoints"][name])
    # The step-4 grid: 64 samples, 32 from each rank, gathered in rank order.
    grid = whole[0]["grids"]["4.png"]
    assert grid.shape[:2] == (8 * 10 + 2, 8 * 10 + 2)
    np.testing.assert_array_equal(grid, tail[0]["grids"]["4.png"])


@pytest.mark.parametrize("flags,match", [
    (["--pp_stages", "2", "--model_axis", "2"], "--pp_stages composes with dp, not tp"),
    (["--pp_stages", "2", "--sp_degree", "2"], "--pp_stages and --sp_degree are exclusive"),
    (["--pp_stages", "2"], "--pp_stages requires --scan_blocks"),
    (["--pp_stages", "2", "--scan_blocks", "True", "--model", "U-ViT-S"],
     "--pp_stages supports the DiT family"),
    (["--sp_degree", "2", "--model_axis", "2"], "--sp_degree composes with dp, not tp"),
    (["--sp_degree", "2", "--fsdp", "True"], "--sp_degree does not compose with --fsdp"),
    (["--sp_degree", "2", "--model", "U-ViT-S"], "--sp_degree supports the DiT family"),
    (["--sp_degree", "2"], "1 devices not divisible by --sp_degree 2"),
    (["--pp_stages", "2", "--scan_blocks", "True"], "1 devices not divisible by --pp_stages 2"),
])
def test_mesh_errors_are_the_jax_clis(flags, match, tmp_path, monkeypatch):
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    args = ARGS + ["--logdir", str(tmp_path), "--total_steps", "1"] + flags
    with pytest.raises(ValueError, match=match):
        train_cli.main(args)
    assert not torch.distributed.is_initialized()  # the one-process group is gone


@pytest.mark.parametrize("flags", [
    ["--model_axis", "2", "--fsdp", "True"],
    ["--fsdp", "True", "--async_checkpoint", "True"],
    ["--pp_stages", "2", "--scan_blocks", "True"],
    ["--sp_degree", "2"],
], ids=["tp_fsdp", "fsdp_async", "pp", "sp"])
def test_two_ranks_parallel_layouts_train_sample_and_save(flags, tmp_path):
    """Each layout trains 2 steps through the CLI, samples from the gathered
    EMA at step 2 and writes a reference-layout checkpoint that the plain
    model loads."""
    from vaw_torch.models.dit import _make_dit
    from vaw_torch.train import load_checkpoint

    out = _run(tmp_path, "run", "--total_steps", "2", "--save_step", "2",
               "--sample_freq", "2", *flags)
    assert out[0]["step"] == out[1]["step"] == 2
    ckpt = out[0]["checkpoints"]["DiT-S_EPSILON_cosine_2.pt"]
    model = _make_dit(64, 2, 4)(image_size=8, patch_size=2, in_channels=4,
                                class_dropout_prob=0.1, num_classes=10, learn_sigma=False)
    path = tmp_path / "ckpt.pt"
    torch.save(ckpt, path)
    assert load_checkpoint(str(path), model) == 2
    assert out[0]["grids"]["2.png"].shape[:2] == (82, 82)
