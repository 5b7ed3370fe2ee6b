"""The port's prefetcher (vaw_torch/data/pipeline.py) on the CPU: batches
arrive in order as tensors (labels int64), the worker reads `size` batches
ahead and no further, an error in the worker is raised in the consumer
(never a clean end of data; the model is tests/test_data_config.py:216),
and closing the consumer stops the worker. The CUDA copy path (pinned
memory, the copy stream and its events) runs on the card in chip_smoke.py's
train phases."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from vaw_torch.data import BatchLoader, GaussianDataset, prefetch_to_device


def _batches(n, record=None):
    for i in range(n):
        if record is not None:
            record.append(i)
        yield {"image": np.full((2, 3, 3, 1), i, np.float32),
               "label": np.full((2,), i, np.int32)}


@pytest.mark.parametrize("size", [1, 2, 4, 7, 9])
def test_batches_arrive_in_order_as_tensors(size):
    got = list(prefetch_to_device(_batches(7), "cpu", size=size))
    assert [int(b["image"][0, 0, 0, 0]) for b in got] == list(range(7))
    for b in got:
        assert b["image"].dtype == torch.float32 and b["image"].device.type == "cpu"
        assert b["label"].dtype == torch.int64


def test_a_loader_through_the_prefetcher_matches_the_loader():
    ds = GaussianDataset(image_size=4, channels=2, num_classes=3, length=20)
    want = list(BatchLoader(ds, 4, seed=1))
    got = list(prefetch_to_device(iter(BatchLoader(ds, 4, seed=1)), torch.device("cpu")))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"].numpy(), w["image"])
        np.testing.assert_array_equal(g["label"].numpy(), w["label"].astype(np.int64))


@pytest.mark.parametrize("size", [1, 2, 3])
def test_the_worker_reads_size_batches_ahead(size):
    """Once the consumer holds batch 0, the worker has produced batch 0,
    filled the queue with `size` more and holds at most one more that waits
    for room: never further."""
    produced = []
    gen = prefetch_to_device(_batches(50, produced), "cpu", size=size)
    first = next(gen)
    deadline = time.monotonic() + 10
    while len(produced) < size + 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)  # would the worker run further ahead?
    assert int(first["image"][0, 0, 0, 0]) == 0
    assert size + 1 <= len(produced) <= size + 2
    gen.close()


@pytest.mark.parametrize("size", [1, 2, 4])
def test_worker_errors_reach_the_consumer(size):
    def bad_iter():
        yield from _batches(3)
        raise OSError("disk exploded")

    gen = prefetch_to_device(bad_iter(), "cpu", size=size)
    got = [int(next(gen)["image"][0, 0, 0, 0]) for _ in range(3)]
    assert got == [0, 1, 2]  # the batches before the error still arrive
    with pytest.raises(RuntimeError, match="prefetch worker failed") as info:
        next(gen)
    assert isinstance(info.value.__cause__, OSError)


def test_an_error_on_the_first_batch_is_not_an_empty_stream():
    def failing():
        raise ValueError("corrupt image")
        yield  # pragma: no cover

    with pytest.raises(RuntimeError, match="prefetch worker failed"):
        next(prefetch_to_device(failing(), "cpu"))


def test_closing_the_consumer_stops_the_worker():
    produced = []
    gen = prefetch_to_device(_batches(10 ** 6, produced), "cpu", size=2)
    next(gen)
    gen.close()  # the worker waits on a full queue until it sees the stop flag
    workers = [t for t in threading.enumerate() if t.name == "vaw-prefetch"]
    for t in workers:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in workers)
    count = len(produced)
    time.sleep(0.2)
    assert len(produced) == count < 10


def test_an_empty_source_ends_cleanly():
    assert list(prefetch_to_device(iter(()), "cpu")) == []
