"""The port's asynchronous checkpoint writer (vaw_torch/train/checkpoint.py
AsyncCheckpointWriter) on the CPU: it writes the file save_checkpoint
writes, from a snapshot taken before the next in-place update, joins the
write before it when a new one starts, and lets a synchronous save follow a
wait. The pinned, event-ordered snapshot of CUDA tensors runs on the card
in chip_smoke.py's async-snapshot and data-cifar phases."""

from __future__ import annotations

import threading
from types import SimpleNamespace

import pytest
import torch

from vaw_torch.train import checkpoint as ckpt_mod
from vaw_torch.train import (
    AsyncCheckpointWriter,
    TrainState,
    load_train_state,
    save_checkpoint,
)

CFG = SimpleNamespace(model="DiT-S", mean_type="EPSILON", path_type="cosine")


def _state(seed=0, moments=torch.float32):
    g = torch.Generator().manual_seed(seed)
    names = {"a.weight": (3, 4), "b.bias": (5,)}
    rand = {k: torch.randn(s, generator=g) for k, s in names.items()}
    return TrainState(step=7, params=rand, count=7,
                      ema={k: v * 0.5 for k, v in rand.items()},
                      mu={k: (v * 0.1).to(moments) for k, v in rand.items()},
                      nu={k: (v * v).to(moments) for k, v in rand.items()})


def _assert_file_holds(path, state, step):
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert saved["step"] == step and saved["opt"]["count"] == state.count
    for name, tree in (("params", saved["params"]), ("ema", saved["ema"]),
                       ("mu", saved["opt"]["mu"]), ("nu", saved["opt"]["nu"])):
        live = getattr(state, name)
        assert set(tree) == set(live)
        for k in live:
            assert tree[k].dtype == live[k].dtype
            assert torch.equal(tree[k], live[k]), (name, k)


@pytest.mark.parametrize("built_with_state", [False, True])
@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_round_trip_writes_what_save_checkpoint_writes(tmp_path, moments, built_with_state):
    state = _state(moments=moments)
    with AsyncCheckpointWriter(state if built_with_state else None) as writer:
        path = writer.save(CFG, 7, state, logdir=str(tmp_path / "a"))
    sync = save_checkpoint(CFG, 7, state, logdir=str(tmp_path / "s"))
    assert path.endswith("checkpoint/DiT-S_EPSILON_cosine_7.pt")
    a = torch.load(path, weights_only=True)
    s = torch.load(sync, weights_only=True)
    assert a.keys() == s.keys() and a["opt"].keys() == s["opt"].keys()
    _assert_file_holds(path, state, 7)
    restored = load_train_state(path, _state(seed=1, moments=moments))
    assert restored.step == 7 and restored.count == 7
    for k in state.params:
        assert torch.equal(restored.params[k], state.params[k])
        assert torch.equal(restored.nu[k], state.nu[k])


def test_the_snapshot_is_taken_before_an_in_place_update(tmp_path, monkeypatch):
    """The write is held back until after the state is updated in place:
    the file must still hold the state of the save."""
    state = _state()
    before = {n: {k: v.clone() for k, v in getattr(state, n).items()}
              for n in ("params", "ema", "mu", "nu")}
    release = threading.Event()
    write = ckpt_mod._write

    def held_write(payload, path):
        release.wait(timeout=30)
        write(payload, path)

    monkeypatch.setattr(ckpt_mod, "_write", held_write)
    writer = AsyncCheckpointWriter()
    path = writer.save(CFG, 7, state, logdir=str(tmp_path))
    for trees in (state.params, state.ema, state.mu, state.nu):
        for t in trees.values():
            t.add_(1.0)  # the next step, in place
    release.set()
    writer.close()
    saved = torch.load(path, weights_only=True)
    disk = {"params": saved["params"], "ema": saved["ema"], "mu": saved["opt"]["mu"],
            "nu": saved["opt"]["nu"]}
    for n, tree in before.items():
        for k, t in tree.items():
            assert torch.equal(disk[n][k], t), (n, k)
            assert not torch.equal(getattr(state, n)[k], t)


def test_a_save_first_joins_the_write_before_it(tmp_path, monkeypatch):
    order = []
    write = ckpt_mod._write

    def slow_write(payload, path):
        order.append(("start", payload["step"]))
        if payload["step"] == 1:
            threading.Event().wait(0.3)
        write(payload, path)
        order.append(("end", payload["step"]))

    monkeypatch.setattr(ckpt_mod, "_write", slow_write)
    with AsyncCheckpointWriter() as writer:
        writer.save(CFG, 1, _state(), logdir=str(tmp_path))
        writer.save(CFG, 2, _state(), logdir=str(tmp_path))
    assert order == [("start", 1), ("end", 1), ("start", 2), ("end", 2)]


def test_wait_then_a_synchronous_save_of_the_same_step(tmp_path):
    """The preemption path: an asynchronous write of this step may be in
    flight to the same file; after wait() the synchronous save is the
    file's last writer."""
    state = _state()
    writer = AsyncCheckpointWriter()
    path = writer.save(CFG, 7, state, logdir=str(tmp_path))
    writer.wait()
    for t in state.params.values():
        t.mul_(2.0)
    assert save_checkpoint(CFG, 7, state, logdir=str(tmp_path)) == path
    writer.close()
    _assert_file_holds(path, state, 7)
    assert not list((tmp_path / "checkpoint").glob("*.tmp"))


def test_a_failed_write_raises_in_wait(tmp_path, monkeypatch):
    def failing_write(payload, path):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "_write", failing_write)
    writer = AsyncCheckpointWriter()
    writer.save(CFG, 3, _state(), logdir=str(tmp_path))
    with pytest.raises(RuntimeError, match="asynchronous checkpoint write failed") as info:
        writer.wait()
    assert isinstance(info.value.__cause__, OSError)
    writer.close()  # the error was reported once
