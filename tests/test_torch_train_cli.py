"""The port's training CLI (vaw_torch/cli/main.py) end to end on the CPU:
two steps of a DiT-S on 8x8 Gaussian latents, its logs and checkpoint, a
resume from that checkpoint, sampling from it through vaw_torch.cli.sample,
its device rule, the metric writers --log_formats chooses and the
features it refuses; every dataset of
load_dataset through the prefetcher; asynchronous checkpoints and a resume
that continues the uninterrupted run bit for bit (the model is
tests/test_cli_e2e.py:16); remat and scanned blocks, which train the same
state as the plain run."""

from __future__ import annotations

import csv
import glob
import json
import math
import pickle

import numpy as np
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


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test, restored after it: the suite runs several
    test processes side by side, and torch's default of a thread per core
    in each oversubscribes the machine, which makes these many small ops
    many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def test_log_formats_choose_the_metric_writers(tmp_path, monkeypatch, capsys):
    """--log_formats adds the human table (stdout and log.txt) and the
    TensorBoard events to progress.csv/json; every record carries
    wait_data, the loop's wait on the prefetcher."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    _train(tmp_path, "--total_steps", "2", "--save_step", "0",
           "--log_formats", "stdout,log,csv,json,tensorboard")
    logdir = glob.glob(str(tmp_path / "logs" / "*"))[0]
    table = open(f"{logdir}/log.txt").read()
    assert "| step " in table and "| wait_data " in table and "| loss " in table
    assert table in capsys.readouterr().out
    with open(f"{logdir}/progress.json") as f:
        record = json.loads(f.readline())
    assert record["step"] == 2 and 0 <= record["wait_data"] < 60
    with open(f"{logdir}/progress.csv") as f:
        assert "wait_data" in next(csv.reader(f))
    events = EventAccumulator(f"{logdir}/tb")
    events.Reload()
    assert [e.step for e in events.Scalars("loss")] == [2]
    assert events.Scalars("loss")[0].value == pytest.approx(record["loss"], rel=1e-6)


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
])
def test_unported_features_name_their_roadmap_item(flags, match, tmp_path, monkeypatch):
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    with pytest.raises(NotImplementedError, match=match):
        _train(tmp_path, "--total_steps", "1", *flags)


def _states_equal(a, b):
    return a.step == b.step and a.count == b.count and all(
        torch.equal(getattr(a, tree)[k], getattr(b, tree)[k])
        for tree in ("params", "ema", "mu", "nu") for k in a.params)


def _write_datasets(root):
    """A small CIFAR-10 archive, an image folder and a latent HDF5 file."""
    from PIL import Image
    import h5py

    rng = np.random.default_rng(0)
    cifar = root / "cifar" / "cifar-10-batches-py"
    cifar.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(cifar / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (8, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, 8).tolist()}, f)
    for i in range(8):
        (root / "images" / f"c{i % 2}").mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (12, 12, 3), dtype=np.uint8)).save(
            root / "images" / f"c{i % 2}" / f"{i}.png")
    with h5py.File(root / "latents.h5", "w") as f:
        f["train_latents"] = rng.standard_normal((24, 8, 8, 8)).astype(np.float32)
        f["train_labels"] = rng.integers(0, 10, 24).astype(np.uint16)
        f["train_pixels"] = rng.integers(0, 256, (24, 3, 64, 64), dtype=np.uint8)
    return {"CIFAR-10": root / "cifar", "ImageNet": root / "images",
            "Latent": root / "latents.h5", "Latent_Pixel": root / "latents.h5"}


@pytest.mark.parametrize("dataset", ["Shapes", "CIFAR-10", "ImageNet", "Latent",
                                     "Latent_Pixel"])
def test_every_dataset_trains_through_the_prefetcher(dataset, tmp_path, monkeypatch):
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    dirs = _write_datasets(tmp_path)
    latent = dataset.startswith("Latent")
    image_size = "32" if dataset == "CIFAR-10" else "8"
    args = [a for a in ARGS]
    args[args.index("--dataset") + 1] = dataset
    args[args.index("--image_size") + 1] = image_size
    args[args.index("--in_chans") + 1] = "4" if latent else "3"
    ctx = train_cli.main(args + ["--logdir", str(tmp_path / "logs"), "--total_steps",
                                 "3", "--save_step", "0", "--num_workers", "2",
                                 "--data_dir", str(dirs.get(dataset, tmp_path))])
    assert ctx["state"].step == 3
    assert type(ctx["train_loader"]).__name__ == (
        "SlabShuffleLoader" if latent else "BatchLoader")


def test_async_checkpoints_and_resume_continue_the_uninterrupted_run(
        tmp_path, monkeypatch):
    """Shapes, four steps with --async_checkpoint True; a run resumed from
    the step-2 file (the loader fast-forwarded before the prefetcher reads
    ahead) ends in the state of the uninterrupted run, bit for bit."""
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    args = [a for a in ARGS]
    args[args.index("--dataset") + 1] = "Shapes"
    args[args.index("--in_chans") + 1] = "3"
    args += ["--total_steps", "4", "--save_step", "2", "--async_checkpoint", "True"]
    full = train_cli.main(args + ["--logdir", str(tmp_path / "a")])
    ckpts = sorted(glob.glob(str(tmp_path / "a" / "*" / "checkpoint" / "*.pt")))
    assert [c.rsplit("_", 1)[1] for c in ckpts] == ["2.pt", "4.pt"]
    final = torch.load(ckpts[1], weights_only=True)
    for k, p in full["state"].params.items():
        assert torch.equal(final["params"][k], p)
        assert torch.equal(final["opt"]["nu"][k], full["state"].nu[k])
    resumed = train_cli.main(args + ["--logdir", str(tmp_path / "b"),
                                     "--resume", ckpts[0]])
    assert resumed["state"].step == 4
    assert _states_equal(resumed["state"], full["state"])


@pytest.mark.parametrize("flags", [
    ["--use_checkpoint", "True", "--remat_policy", "full"],
    ["--use_checkpoint", "True", "--remat_policy", "dots"],
    ["--scan_blocks", "True"],
    ["--scan_blocks", "True", "--use_checkpoint", "True"],
], ids=["full", "dots", "scan", "scan-full"])
def test_remat_and_scanned_blocks_train_the_plain_state(flags, tmp_path, monkeypatch):
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    args = ARGS + ["--total_steps", "2", "--save_step", "0"]
    plain = train_cli.main(args + ["--logdir", str(tmp_path / "a")])
    other = train_cli.main(args + flags + ["--logdir", str(tmp_path / "b")])
    model = other["trainer"].model
    assert model.use_checkpoint == ("--use_checkpoint" in flags)
    assert other["trainer"].cfg.scan_blocks == ("--scan_blocks" in flags)
    assert _states_equal(other["state"], plain["state"])


# The slice of ViT, MM-DiT, flow matching, the loss-aware resampler and
# learned variance: each through the training CLI and then the sample CLI.
# The registry's ViT-S and MM-DiT-S entries are patched to a tiny width
# (ViT: embed 64, depth 2, 4 heads; MM-DiT: depth 2, hence hidden 64 and 2
# heads of 32); the code paths are the full models'.

SAMPLE = ["--image_size", "8", "--patch_size", "2", "--in_chans", "4",
          "--num_classes", "10", "--class_cond", "True", "--drop_label_prob", "0.1",
          "--sample_steps", "3", "--sample_size", "4", "--num_samples", "4"]


@pytest.fixture
def tiny_families(monkeypatch):
    from vaw_torch.models import registry, vit

    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    monkeypatch.setitem(vit.ViT_models, "ViT-S", vit._make_vit(64, 2, 4))
    monkeypatch.setitem(registry.MMDiT_models, "MM-DiT-S", dict(depth=2))


@pytest.fixture
def tiny_dit(monkeypatch):
    """DiT-S patched to hidden 64, depth 2, 2 heads: checkpoints of
    kilobytes rather than the full size's 520 MB each."""
    from vaw_torch.models import dit

    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    monkeypatch.setitem(dit.DiT_models, "DiT-S", dit._make_dit(64, 2, 2))


def _model_args(model):
    args = [a for a in ARGS]
    args[args.index("--model") + 1] = model
    return args


def _ckpt(tmp_path, name):
    (path,) = glob.glob(str(tmp_path / "logs" / "*" / "checkpoint" / name))
    return path


def _sample_from(ckpt, out, *flags):
    sample_cli.main(SAMPLE + ["--resume", ckpt, "--save_path", str(out), *flags])
    return list(out.rglob("*.png"))


@pytest.mark.parametrize("model", ["ViT-S", "MM-DiT-S"])
def test_vit_and_mmdit_train_then_sample(model, tiny_families, tmp_path):
    ctx = train_cli.main(_model_args(model) + ["--logdir", str(tmp_path / "logs"),
                                               "--total_steps", "2", "--save_step", "2"])
    assert ctx["state"].step == 2
    assert type(ctx["trainer"].model).__name__ == ("ViT" if model == "ViT-S" else "MMDiT")
    ckpt = _ckpt(tmp_path, f"{model}_EPSILON_cosine_2.pt")
    pngs = _sample_from(ckpt, tmp_path / "s", "--model", model, "--guidance_scale", "1.5")
    assert len(pngs) == 4


FLOW = ["--model_mode", "flow", "--mean_type", "VECTOR", "--path_type", "linear",
        "--weight_type", "lambda"]


@pytest.fixture(scope="module")
def flow_checkpoint(tmp_path_factory):
    """Two flow-matching steps of the tiny MM-DiT-S; its step-2 file."""
    from vaw_torch.models import registry

    tmp = tmp_path_factory.mktemp("flow")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VAW_PLATFORM", "cpu")
        mp.setitem(registry.MMDiT_models, "MM-DiT-S", dict(depth=2))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            args = _model_args("MM-DiT-S")
            args = [a for a in args if a not in ("--weight_type", "lambda",
                                                 "--path_type", "cosine")]
            ctx = train_cli.main(args + FLOW + ["--logdir", str(tmp / "logs"),
                                                "--total_steps", "2", "--save_step", "2"])
        finally:
            torch.set_num_threads(threads)
    assert type(ctx["trainer"].process).__name__ == "FlowMatching"
    assert ctx["state"].resampler is None
    return _ckpt(tmp, "MM-DiT-S_VECTOR_linear_2.pt")


@pytest.mark.parametrize("sampler_type,solver", [
    ("sde", "euler"), ("sde", "heun"), ("ode", "euler"), ("ode", "heun"),
    ("ode", "dopri5")])
def test_flow_samples_with_each_sampler(sampler_type, solver, flow_checkpoint,
                                        tiny_families, tmp_path):
    pngs = _sample_from(flow_checkpoint, tmp_path / "s", "--model", "MM-DiT-S",
                        *FLOW, "--sampler_type", sampler_type, "--solver", solver,
                        "--guidance_scale", "1.5", "--rtol", "1e-2", "--atol", "1e-4")
    assert len(pngs) == 4


def test_loss_aware_resampler_resume_continues_the_uninterrupted_run(
        tiny_dit, tmp_path):
    """--time_sampler loss-second-moment over 4 diffusion steps: the history
    warms up within the run, the checkpoint holds it, and a run resumed from
    step 2 ends in the uninterrupted run's state, history included."""
    args = ARGS + ["--time_sampler", "loss-second-moment", "--diffusion_steps", "4",
                   "--total_steps", "4", "--save_step", "2"]
    args[args.index("--batch_size") + 1] = "16"
    full = train_cli.main(args + ["--logdir", str(tmp_path / "a")])
    res = full["state"].resampler
    assert res is not None and res.loss_counts.tolist() == [10] * 4
    ckpts = sorted(glob.glob(str(tmp_path / "a" / "*" / "checkpoint" / "*.pt")))
    payload = torch.load(ckpts[0], weights_only=True)
    assert set(payload["resampler"]) == {"loss_history", "loss_counts"}
    resumed = train_cli.main(args + ["--logdir", str(tmp_path / "b"),
                                     "--resume", ckpts[0]])
    assert _states_equal(resumed["state"], full["state"])
    assert torch.equal(resumed["state"].resampler.loss_history, res.loss_history)
    assert torch.equal(resumed["state"].resampler.loss_counts, res.loss_counts)


@pytest.mark.parametrize("flags", [
    ["--learn_sigma", "True", "--var_type", "LEARNED_RANGE"],
    ["--learn_sigma", "True", "--var_type", "LEARNED_RANGE", "--loss_type", "KL"],
], ids=["learned_range_mse", "kl"])
def test_learned_variance_trains_and_samples(flags, tiny_dit, tmp_path):
    ctx = train_cli.main(ARGS + flags + ["--logdir", str(tmp_path / "logs"),
                                         "--total_steps", "2", "--save_step", "2"])
    assert ctx["trainer"].model.out_channels == 8
    logdir = glob.glob(str(tmp_path / "logs" / "*"))[0]
    with open(f"{logdir}/progress.json") as f:
        record = json.loads(f.readline())
    assert math.isfinite(record["loss"])
    if "KL" not in flags:
        assert math.isfinite(record["vb"]) and record["vb"] > 0
    ckpt = _ckpt(tmp_path, "DiT-S_EPSILON_cosine_2.pt")
    pngs = _sample_from(ckpt, tmp_path / "s", "--model", "DiT-S", *flags,
                        "--guidance_scale", "1.5")
    assert len(pngs) == 4


def test_first_training_batch_is_the_jax_clis(tiny_dit, tmp_path, monkeypatch):
    """ROADMAP C7: both CLIs draw one shape-init batch before training, so
    the port trains from the loader's second epoch as the JAX CLI does
    (vaw_tpu/cli/main.py:184-229 and its _rebatched), and a resumed run
    still reads the uninterrupted run's batches."""
    from vaw_torch.train import Trainer
    from vaw_tpu.cli.main import _rebatched as jax_rebatched
    from vaw_tpu.data import load_dataset as jax_load_dataset

    args = [a for a in ARGS]
    args[args.index("--dataset") + 1] = "Shapes"
    args[args.index("--in_chans") + 1] = "3"
    seen = []
    step = Trainer.step

    def recorded(self, state, batch):
        seen.append({k: v.numpy().copy() for k, v in batch.items()})
        return step(self, state, batch)

    monkeypatch.setattr(Trainer, "step", recorded)
    args += ["--total_steps", "2", "--save_step", "1"]
    train_cli.main(args + ["--logdir", str(tmp_path / "a")])
    # The JAX CLI's loader for these flags (seed 42, the default of both).
    loader, _ = jax_load_dataset("", "Shapes", 4, 8, seed=42, num_classes=10, channels=3)
    next(iter(loader))  # the JAX CLI's shape-init batch
    want = jax_rebatched(loader, 4)
    for got in seen:
        expected = next(want)
        np.testing.assert_array_equal(got["image"], expected["image"])
        np.testing.assert_array_equal(got["label"], expected["label"])
    fresh, _ = jax_load_dataset("", "Shapes", 4, 8, seed=42, num_classes=10, channels=3)
    assert not np.array_equal(seen[0]["image"], next(iter(fresh))["image"])
    (ckpt,) = glob.glob(str(tmp_path / "a" / "*" / "checkpoint" / "*_1.pt"))
    uninterrupted = seen[1]
    seen.clear()
    train_cli.main(args + ["--logdir", str(tmp_path / "b"), "--resume", ckpt])
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0]["image"], uninterrupted["image"])
