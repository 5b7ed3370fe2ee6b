"""Host -> device prefetch: keep the card fed (counterpart of
vaw_tpu/data/pipeline.py).

``prefetch_to_device`` yields batches `size` steps ahead, in order. A
worker thread assembles each batch (disk reads, crops, the native gather)
and starts its copy to the card while the card computes the steps before
it, as the JAX package's thread does (its ``background=True``, the only
setting its callers use). The
reference feeds its GPUs from pinned-memory DataLoader workers
(reference: main.py:171-177).

On a CUDA device the worker pins each array and copies it with
``non_blocking=True`` on a copy stream of its own, then records an event.
The consumer makes its current stream wait on that event and marks each
tensor as used on that stream (``record_stream``), so the caching allocator
does not hand the memory to the copy stream again while the step reads it.
Each pinned source stays referenced until its copy's event has completed.
On the CPU the same thread runs with no copy. Labels become int64, images
and latents stay f32.

The multi-process branch of the JAX function waits for the parallel
layouts (ROADMAP A16).
"""

from __future__ import annotations

import collections
import queue as queue_mod
import threading
from typing import Dict, Iterator

import numpy as np
import torch

__all__ = ["prefetch_to_device"]

# How long a blocked queue operation waits before it looks at the stop flag.
_POLL_S = 0.1


class _Copier:
    """Moves one numpy batch to `device`: on CUDA through pinned memory on
    a dedicated stream, returning the device tensors, the event that
    completes the copy and the pinned sources; on the CPU as tensors."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def __call__(self, batch: Dict[str, np.ndarray]):
        host = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            host[k] = t.long() if k == "label" else t
        if self.stream is None:
            return host, None, None
        pinned = {k: t.pin_memory() for k, t in host.items()}
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = {k: t.to(self.device, non_blocking=True) for k, t in pinned.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event, pinned


def prefetch_to_device(iterator: Iterator[Dict[str, np.ndarray]], device,
                       size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the batches of `iterator` as tensors on `device`, `size` steps
    ahead. A worker thread assembles and copies them; an exception there is
    raised here, as RuntimeError("data prefetch worker failed") from it,
    never as a clean end of data. Closing the generator stops the worker."""
    device = torch.device(device)
    copy = _Copier(device)
    in_flight = collections.deque()  # (event, pinned sources) of copies not yet known done

    def handover(item):
        out, event, pinned = item
        if event is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            for t in out.values():
                t.record_stream(stream)
            in_flight.append((event, pinned))
            while in_flight and in_flight[0][0].query():
                in_flight.popleft()
        return out

    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    sentinel = object()
    err: list = []
    stop = threading.Event()

    def put(item) -> bool:
        """Queue `item` unless the consumer has gone; False once it has."""
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        # An exception here (an HDF5 read error, a corrupt image, a failed
        # native build, a failed copy) must reach the consumer: the sentinel
        # alone would look like a clean end of data and stop training
        # mid-run without a word.
        try:
            for batch in iterator:
                if not put(copy(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 - raised in the consumer
            err.append(e)
        put(sentinel)

    thread = threading.Thread(target=worker, name="vaw-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise RuntimeError("data prefetch worker failed") from err[0]
                return
            yield handover(item)
    finally:
        stop.set()
        # The worker sees the flag within _POLL_S unless it is inside the
        # source iterator; it is a daemon, so it never holds up the exit.
        thread.join(timeout=10 * _POLL_S)
