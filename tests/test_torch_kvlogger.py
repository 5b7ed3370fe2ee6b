"""The port's metric logger (vaw_torch/utils/kvlogger.py) against the JAX
package's (vaw_tpu/utils/kvlogger.py): the human table (stdout and
log.txt) byte for byte, logkv_mean's running mean and profile_kv's
sections as JAX computes them, and TensorBoard scalars read back with
tensorboard's EventAccumulator equal to those JAX's TF writer wrote."""

from __future__ import annotations

import io
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from vaw_torch.utils import kvlogger as tk
from vaw_tpu.utils import kvlogger as jk

RECORDS = [
    {"step": 50, "loss": 0.123456789, "mse": 1.5e-7, "name": "dit", "n": 3},
    {"step": 100, "loss": 12345.678, "a_very_long_key_name": float("nan"),
     "grad_norm": np.float32(0.25)},
    {},
]


def test_human_output_is_byte_equal_to_jax():
    got, want = io.StringIO(), io.StringIO()
    tw, jw = tk.HumanOutputFormat(got), jk.HumanOutputFormat(want)
    for kvs in RECORDS:
        tw.writekvs(kvs)
        jw.writekvs(kvs)
    assert got.getvalue() == want.getvalue() and got.getvalue().count("|") > 10


def test_stdout_and_log_formats_match_jax(tmp_path, capsys):
    for pkg, sub in ((tk, "torch"), (jk, "jax")):
        logger = pkg.Logger(str(tmp_path / sub), ["stdout", "log", "json"])
        for kvs in RECORDS[:2]:
            for k, v in kvs.items():
                logger.logkv(k, v)
            logger.dumpkvs()
        logger.close()
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:]
    for name in ("log.txt", "progress.json"):
        assert ((tmp_path / "torch" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


def test_logkv_mean_and_profile_match_jax(tmp_path, monkeypatch):
    dumps = {}
    for pkg, sub in ((tk, "torch"), (jk, "jax")):
        clock = iter([10.0, 10.25, 20.0, 20.5, 30.0, 30.125])
        monkeypatch.setattr(time, "time", lambda: next(clock))
        pkg.configure(str(tmp_path / sub), formats=("json",))
        for v in (1.0, 2.5, np.float32(4.0), 7):
            pkg.logkv_mean("loss", v)
        pkg.logkv_mean("other", 3)
        with pkg.profile_kv("data"):
            pass
        with pkg.profile_kv("data"):
            pass
        pkg.profile("step")(lambda: None)()
        dumps[sub] = pkg.dumpkvs()
        pkg.logkv_mean("loss", 5.0)  # a dump resets the counts
        dumps[sub + "2"] = pkg.dumpkvs()
        pkg.get_current().close()
    assert dumps["torch"] == dumps["jax"]
    assert dumps["torch"]["wait_data"] == 0.75 and dumps["torch"]["wait_step"] == 0.125
    assert dumps["torch2"] == dumps["jax2"] == {"loss": 5.0}


def test_make_output_format_knows_the_five_formats(tmp_path):
    writers = [tk.make_output_format(f, str(tmp_path)) for f in ("stdout", "log", "json", "csv")]
    assert [type(w).__name__ for w in writers] == [
        "HumanOutputFormat", "HumanOutputFormat", "JSONOutputFormat", "CSVOutputFormat"]
    for w in writers:
        w.close()
    with pytest.raises(ValueError, match="Unknown format"):
        tk.make_output_format("xml", str(tmp_path))


def test_tensorboard_needs_tensorboard_only_when_asked(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("No module named 'tensorboard'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    tk.Logger(str(tmp_path), ["csv", "json"]).close()  # other formats need nothing
    with pytest.raises(ImportError, match="tensorboard"):
        tk.make_output_format("tensorboard", str(tmp_path))


def _scalars_torch(path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(path))
    acc.Reload()
    return {tag: [(e.step, np.float32(e.value)) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def _scalars_tf(path):
    import tensorflow as tf
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(path))
    acc.Reload()
    return {tag: [(e.step, np.float32(tf.make_ndarray(e.tensor_proto)))
                  for e in acc.Tensors(tag)]
            for tag in acc.Tags()["tensors"]}


_JAX_TB_WRITER = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from vaw_tpu.utils import kvlogger
writer = kvlogger.make_output_format("tensorboard", sys.argv[2])
for kvs in RECORDS:
    writer.writekvs(kvs)
writer.close()
"""


def test_tensorboard_scalars_match_jax_tf_writer(tmp_path):
    pytest.importorskip("tensorboard")
    pytest.importorskip("tensorflow")
    records = ('[{"step": 50, "loss": 0.5, "mse": 0.25, "name": "skipped"}, '
               '{"loss": 0.375, "imgs": 1000}, '  # no step: one past the last
               '{"step": 200, "loss": np.float32(0.125)}]')
    writer = tk.make_output_format("tensorboard", str(tmp_path / "torch"))
    for kvs in eval(records, {"np": np}):
        writer.writekvs(kvs)
    writer.close()
    # JAX's writer is TF's, in a process of its own: TF's summaries write
    # nothing in a process where another test turned eager execution off.
    root = str(Path(__file__).resolve().parents[1])
    res = subprocess.run(
        [sys.executable, "-c", _JAX_TB_WRITER.replace("RECORDS", records), root,
         str(tmp_path / "jax")],
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    got = _scalars_torch(tmp_path / "torch" / "tb")
    want = _scalars_tf(tmp_path / "jax" / "tb")
    assert got == want
    assert got["loss"] == [(50, 0.5), (51, 0.375), (200, 0.125)]
    assert "name" not in got
