"""Process setup and host-side collection (counterpart of
vaw_tpu/parallel/distributed.py; reference: tools/dist_util.py:20-102).

One process per GPU, started by ``torchrun --nproc_per_node N``, which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``. The backend is NCCL on the card, process ``r`` on
``cuda:{LOCAL_RANK}``, and gloo only under ``VAW_PLATFORM=cpu``: a failed
NCCL start raises, it never falls back to gloo.

  dist.init_process_group("nccl", "env://") -> setup_distributed()
  is_main_process (dist_util.py:20-27)       -> rank 0, or no process group
  dist_barrier (dist_util.py:29-31)          -> barrier (host-side I/O order)
  all_gather of samples (sampler.py:232-247) -> process_allgather
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["setup_distributed", "is_main_process", "barrier",
           "process_allgather", "cleanup_distributed", "backend",
           "comm_device", "world_size", "rank"]

# The environment torchrun gives every process it starts.
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE")


def backend() -> str:
    """gloo under VAW_PLATFORM=cpu, NCCL otherwise."""
    return "gloo" if os.environ.get("VAW_PLATFORM", "").lower() == "cpu" else "nccl"


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def setup_distributed(init_method: Optional[str] = None,
                      world_size: Optional[int] = None,
                      rank: Optional[int] = None,
                      timeout_s: Optional[float] = None) -> bool:
    """Join the process group; True once one exists.

    Without arguments the launcher's environment decides: with no
    ``RANK``/``WORLD_SIZE`` this is a single process and a no-op that
    returns False, as the JAX function is. Where the environment announces
    several processes and joining fails, this raises rather than let N
    processes each train alone on the whole dataset and write their own
    logdir (the rule of vaw_tpu/parallel/distributed.py:46-66). Explicit
    arguments join ``init_method`` (a ``tcp://`` or ``file://`` URL) as
    ``rank`` of ``world_size``; ``world_size=1`` with no URL makes a
    one-process group on an in-memory store."""
    if dist.is_initialized():
        return True
    if init_method is None and world_size is None and not all(
            k in os.environ for k in _LAUNCHER_ENV):
        return False
    kind = backend()
    if kind == "nccl":
        # The launcher's local rank picks the card before NCCL starts.
        torch.cuda.set_device(_local_rank())
    timeout = (None if timeout_s is None
               else datetime.timedelta(seconds=timeout_s))
    kwargs = {} if timeout is None else {"timeout": timeout}
    if init_method is None and world_size is None:
        announced = int(os.environ["WORLD_SIZE"])
        try:
            dist.init_process_group(kind, init_method="env://", **kwargs)
        except Exception as e:
            raise RuntimeError(
                f"joining the process group ({kind}, WORLD_SIZE={announced}) "
                "failed although the launcher's environment is set; refusing "
                "to run as a single process") from e
        return True
    if init_method is None:
        if world_size != 1:
            raise ValueError(f"world_size={world_size} needs an init_method URL")
        dist.init_process_group(kind, store=dist.HashStore(), rank=0,
                                world_size=1, **kwargs)
        return True
    dist.init_process_group(kind, init_method=init_method, world_size=world_size,
                            rank=rank, **kwargs)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def comm_device() -> torch.device:
    """Where this process's collectives' tensors live: its card under NCCL,
    the CPU under gloo."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def is_main_process() -> bool:
    """Host-side I/O gating (reference: tools/dist_util.py:20-27)."""
    return rank() == 0


def barrier():
    """Host-side I/O ordering across processes (reference:
    tools/dist_util.py:29-31); the train step needs none."""
    if world_size() > 1:
        dist.barrier()


def process_allgather(x: np.ndarray) -> np.ndarray:
    """Every process's `x` (the same shape and dtype on each), stacked in
    rank order on a new leading axis; `x` itself in a single process
    (replaces dist.all_gather of samples, reference:
    tools/sampler.py:232-247)."""
    n = world_size()
    if n == 1:
        return x
    x = np.asarray(x)
    local = torch.from_numpy(np.ascontiguousarray(x).reshape(-1)).to(comm_device())
    out = torch.empty(n * local.numel(), dtype=local.dtype, device=local.device)
    dist.all_gather_into_tensor(out, local)
    return out.cpu().numpy().reshape((n,) + x.shape)


def cleanup_distributed():
    """Leave the process group (reference: tools/dist_util.py cleanup)."""
    if dist.is_initialized():
        dist.destroy_process_group()
