"""--eval True through the port's training CLI (vaw_torch/cli/main.py) on
the CPU: a DiT-S on 8x8 RGB Gaussian images trains two steps, samples
--num_samples images from its EMA weights, and the evaluator (the
composite graph of tests/test_tf_graph.py as VAW_INCEPTION_PB, read by the
port's GraphDef reader) writes one metrics.csv row. Its IS, FID, sFID,
precision and recall equal the JAX package's Evaluator's (vaw_tpu/evals,
backend "jax") on the same npz files within 1e-4 relative (the features
are f32 on both sides in another summation order); the CSV holds them to
two decimals. Then the degrade policy of the JAX CLI: with the default
--ref_batch an absent file or graph turns evaluation off; an explicit one
must work; a latent run needs the VAE decoder; --eval without --train
needs --resume, and with it evaluates once at the checkpoint's step.
"""

from __future__ import annotations

import csv
import glob
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("tensorflow")

from vaw_torch.cli import main as train_cli  # noqa: E402
from vaw_tpu.evals.evaluator import Evaluator as JaxEvaluator  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
from test_tf_graph import _build_inception_composite_pb  # noqa: E402

ARGS = ["--model", "DiT-S", "--image_size", "8", "--patch_size", "2",
        "--in_chans", "3", "--num_classes", "10", "--class_cond", "True",
        "--drop_label_prob", "0.1", "--dataset", "Gaussian", "--batch_size", "4",
        "--weight_type", "lambda", "--path_type", "cosine", "--sample_freq", "0",
        "--amp", "False", "--sample_steps", "3", "--solver", "heun",
        "--discretization", "edm"]
EVAL = ["--eval", "True", "--eval_step", "2", "--num_samples", "24",
        "--sample_size", "12"]
KEYS = ("IS (EMA)", "FID (EMA)", "sFID (EMA)", "Pre. (EMA)", "Rec. (EMA)")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def graph(tmp_path, monkeypatch):
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    monkeypatch.delenv("VAW_INCEPTION_BACKEND", raising=False)
    pb = _build_inception_composite_pb(tmp_path)
    monkeypatch.setenv("VAW_INCEPTION_PB", pb)
    return pb


def _ref_batch(tmp_path) -> str:
    rng = np.random.default_rng(0)
    low = rng.integers(0, 256, (32, 4, 4, 3)).astype(np.float32)
    arr = np.repeat(np.repeat(low, 2, 1), 2, 2).astype(np.uint8)  # 8x8, blocky
    path = str(tmp_path / "ref.npz")
    np.savez(path, arr)
    return path


def test_eval_true_writes_the_jax_evaluators_metrics(graph, tmp_path, monkeypatch):
    ref = _ref_batch(tmp_path)
    results = []
    evaluate = train_cli.evaluate
    monkeypatch.setattr(train_cli, "evaluate",
                        lambda *a: results.append(evaluate(*a)) or results[-1])
    train_cli.main(ARGS + EVAL + ["--total_steps", "2", "--save_step", "0",
                                  "--ref_batch", ref, "--logdir", str(tmp_path / "logs")])
    (run,) = glob.glob(str(tmp_path / "logs" / "*"))
    with open(f"{run}/metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and rows[0]["Step"] == "2"
    (npz,) = glob.glob(f"{run}/generate_sample/Gaussian_8x8_samples.npz")
    with np.load(npz) as saved:
        assert saved["arr_0"].shape == (24, 8, 8, 3) and saved["arr_0"].dtype == np.uint8
        assert saved["arr_1"].shape == (24,)
    (got,) = results
    jax_ev = JaxEvaluator(batch_size=12, pb_path=graph, backend="jax")
    ref_acts = jax_ev.read_activations(ref)
    ref_stats, ref_sp = jax_ev.read_statistics(ref, ref_acts)
    acts = jax_ev.read_activations(npz)
    stats, sp = (jax_ev.compute_statistics(a) for a in acts)
    pre, rec = jax_ev.compute_prec_recall(ref_acts[0], acts[0])
    want = dict(zip(KEYS, (jax_ev.compute_inception_score(acts[0]),
                           stats.frechet_distance(ref_stats), sp.frechet_distance(ref_sp),
                           pre, rec)))
    assert want["FID (EMA)"] > 0.01
    for key in KEYS:
        assert got[key] == pytest.approx(want[key], rel=1e-4, abs=1e-6), key
        assert rows[0][key] == f"{got[key]:.2f}", key


def test_degrade_policy_with_the_default_ref_batch(graph, tmp_path, capsys):
    # The default --ref_batch is not on this machine: evaluation is off,
    # training goes on.
    ctx = train_cli.main(ARGS + EVAL + ["--total_steps", "2", "--save_step", "0",
                                        "--logdir", str(tmp_path / "logs")])
    assert ctx["evaluator"] is None and ctx["state"].step == 2
    out = capsys.readouterr().out
    assert "FID eval disabled" in out and "[eval] skipped" in out
    assert not glob.glob(str(tmp_path / "logs" / "*" / "metrics.csv"))


def test_degrade_policy_with_an_explicit_ref_batch(graph, tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="was given but the evaluator failed"):
        train_cli.main(ARGS + EVAL + ["--total_steps", "2", "--ref_batch",
                                      str(tmp_path / "missing.npz"),
                                      "--logdir", str(tmp_path / "logs")])
    ref = _ref_batch(tmp_path)
    monkeypatch.setenv("VAW_INCEPTION_PB", str(tmp_path / "no_graph.pb"))
    monkeypatch.chdir(tmp_path)  # no classify_image_graph_def.pb here either
    with pytest.raises(RuntimeError, match="InceptionV3 frozen graph not found"):
        train_cli.main(ARGS + EVAL + ["--total_steps", "2", "--ref_batch", ref,
                                      "--logdir", str(tmp_path / "logs")])


def test_latent_eval_needs_the_vae_decoder(graph, tmp_path, monkeypatch):
    monkeypatch.setenv("VAW_VAE_PATH", str(tmp_path / "absent.bin"))
    latent = ARGS[:ARGS.index("--in_chans") + 1] + ["4"] + ARGS[ARGS.index("--in_chans") + 2:]
    with pytest.raises(RuntimeError, match="needs the VAE decoder"):
        train_cli.main(latent + EVAL + ["--total_steps", "2",
                                        "--logdir", str(tmp_path / "logs")])


def test_eval_without_training_reads_the_checkpoint(graph, tmp_path):
    with pytest.raises(ValueError, match="--resume"):
        train_cli.main(ARGS + EVAL + ["--train", "False", "--logdir", str(tmp_path)])
    train_cli.main(ARGS + ["--eval", "False", "--total_steps", "3", "--save_step", "3",
                           "--logdir", str(tmp_path / "train")])
    (ckpt,) = glob.glob(str(tmp_path / "train" / "*" / "checkpoint" / "*.pt"))
    ref = _ref_batch(tmp_path)
    train_cli.main(ARGS + EVAL + ["--train", "False", "--resume", ckpt, "--ref_batch", ref,
                                  "--logdir", str(tmp_path / "eval")])
    (metrics,) = glob.glob(str(tmp_path / "eval" / "*" / "metrics.csv"))
    with open(metrics) as f:
        rows = list(csv.DictReader(f))
    assert [r["Step"] for r in rows] == ["3"]
    assert all(np.isfinite(float(rows[0][k])) for k in KEYS)
