"""Checkpoints of the train state (counterpart of vaw_tpu/train/checkpoint.py).

A checkpoint of the port is one ``torch.save`` file,
``{logdir}/checkpoint/{model}_{mean_type}_{path_type}_{step}.pt``, holding

    {"params": state_dict, "ema": state_dict,
     "opt": {"count": int, "mu": state_dict, "nu": state_dict},
     "step": int}

and, only when the run samples t with the loss-aware resampler,
``"resampler": {"loss_history", "loss_counts"}`` (so the files of runs
without it are as before), with every tensor under the model's state-dict names (the reference
model's names, which vaw_torch.models use) and on the CPU. ``load_checkpoint`` reads the EMA
weights into a model (the sample CLI; a file holding only ``{"ema",
"step"}`` works too); ``load_train_state`` restores the whole state for
--resume. ``AsyncCheckpointWriter`` writes the same file on a thread from
a snapshot taken on the calling thread. The JAX package's Orbax
checkpoints cannot be read without JAX; carry their state across with
vaw_torch.models.convert.

Under a device mesh (the ``trainer`` argument) the file is the same
whatever the layout, as Orbax's are: every rank joins the gather of the
full tensors (DTensors gathered, the tensor-parallel qkv rows put back in
reference order, another pipeline stage's blocks sent by their owner,
a DDP ``module.`` prefix stripped), rank 0 writes, and every rank waits
for the file. Every rank reads the file and takes its own share, so a
file written at world 4 under dp x tp x fsdp loads at world 1 and the
other way round. The asynchronous writer snapshots after the gather.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import torch

from ..parallel.distributed import barrier, is_main_process
from ..parallel.partition import to_local
from .state import TrainState

__all__ = ["checkpoint_name", "save_checkpoint", "load_checkpoint",
           "load_train_state", "AsyncCheckpointWriter"]


def checkpoint_name(cfg, step: int) -> str:
    """(reference: tools/utils.py:101-103)"""
    return f"{cfg.model}_{cfg.mean_type}_{cfg.path_type}_{step}"


def _cpu(name: str, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    del name
    return {k: v.detach().cpu() for k, v in tree.items()}


def _reference_name(k: str) -> str:
    return k[len("module."):] if k.startswith("module.") else k


def _gathered(trainer, tree_fn):
    """tree_fn with every tensor dict first made full (a collective under
    a mesh) and keyed by reference names."""
    def tree(name: str, t: Dict[str, torch.Tensor]):
        if trainer is not None and trainer.mesh is not None and name != "resampler":
            t = trainer.full(t)
        return tree_fn(name, {_reference_name(k): v for k, v in t.items()})
    return tree


def _checkpoint_path(cfg, step: int, logdir: Optional[str], make: bool = True) -> str:
    ckpt_dir = os.path.abspath(os.path.join(logdir or cfg.logdir, "checkpoint"))
    if make:
        os.makedirs(ckpt_dir, exist_ok=True)
    return os.path.join(ckpt_dir, checkpoint_name(cfg, step) + ".pt")


def _payload(state: TrainState, step: int, tree) -> dict:
    """The checkpoint's layout, each tensor dict of `state` through
    tree(name, tensors)."""
    payload = {
        "params": tree("params", state.params), "ema": tree("ema", state.ema),
        "opt": {"count": int(state.count), "mu": tree("mu", state.mu),
                "nu": tree("nu", state.nu)},
        "step": int(step),
    }
    if state.resampler is not None:
        payload["resampler"] = tree("resampler", {
            "loss_history": state.resampler.loss_history,
            "loss_counts": state.resampler.loss_counts})
    return payload


def _write(payload: dict, path: str):
    """torch.save to a per-process temporary name, then os.replace: a
    reader never sees half a file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(cfg, step: int, state: TrainState,
                    logdir: Optional[str] = None, trainer=None) -> str:
    """Write `state` to {logdir}/checkpoint/<name>.pt (atomically: a
    reader never sees half a file) and return the path. Under `trainer`'s
    mesh every rank calls this; rank 0 writes."""
    main = is_main_process()
    path = _checkpoint_path(cfg, step, logdir, make=main)
    payload = _payload(state, step, _gathered(trainer, _cpu))
    if main:
        _write(payload, path)
    barrier()
    return path


class AsyncCheckpointWriter:
    """Checkpoint writes that do not hold up training (counterpart of
    vaw_tpu/train/checkpoint.py:39-70): ``save`` snapshots the state and a
    thread serialises the snapshot into the file ``save_checkpoint``
    writes while the next steps run. ``wait`` joins the write in flight
    (and raises its error); starting a save joins the one before it first.

    The snapshot is taken on the calling thread, before the next step's
    kernels are queued: the fused optimizer updates params, EMA and moments
    in place, so a write that read the live tensors, or copied them on
    another stream, would save a mix of steps. CUDA tensors are copied into
    pinned host buffers (kept and reused from save to save) by non-blocking
    copies on the current stream, which then records an event; the thread
    waits on that event before it calls torch.save. CPU tensors are
    cloned.

    Page-locking the buffers takes a while (about 2 GiB for DiT-B/2's
    params, EMA and moments), so pass the train state to the constructor
    to allocate them then, before the step loop, rather than in the first
    ``save``."""

    def __init__(self, state: Optional[TrainState] = None):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._buffers: Dict[str, torch.Tensor] = {}
        # A sharded state's buffers take the full shapes at the first save.
        if state is not None and is_main_process():
            _payload(state, 0, self._reserve)

    def _buffer(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """The pinned host buffer for `key`, made for `t` if it has none or
        one of another shape or dtype."""
        buf = self._buffers.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buffers[key] = buf
        return buf

    def _reserve(self, name: str, tree: Dict[str, torch.Tensor]) -> None:
        for k, t in tree.items():
            if t.device.type == "cuda" and not hasattr(t, "placements"):
                self._buffer(f"{name}/{k}", t)

    def _snapshot(self, name: str, tree: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        out = {}
        for k, t in tree.items():
            t = t.detach()
            if t.device.type != "cuda":
                out[k] = t.clone()
                continue
            out[k] = self._buffer(f"{name}/{k}", t).copy_(t, non_blocking=True)
        return out

    def save(self, cfg, step: int, state: TrainState,
             logdir: Optional[str] = None, trainer=None) -> str:
        """Snapshot `state` now and write it on a thread to the path
        ``save_checkpoint`` would use; return that path. Under `trainer`'s
        mesh every rank joins the gather, and rank 0 alone snapshots and
        writes."""
        self.wait()  # the buffers are free again once the last write is done
        if not is_main_process():
            _payload(state, step, _gathered(trainer, lambda name, t: t))
            return _checkpoint_path(cfg, step, logdir, make=False)
        path = _checkpoint_path(cfg, step, logdir)
        payload = _payload(state, step, _gathered(trainer, self._snapshot))
        event = None
        if any(to_local(t).is_cuda for t in state.params.values()):
            event = torch.cuda.Event()
            event.record()  # on the current stream, after the copies

        def write():
            try:
                if event is not None:
                    event.synchronize()
                _write(payload, path)
            except BaseException as e:  # noqa: BLE001 - raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, name="vaw-checkpoint")
        self._thread.start()
        return path

    def wait(self):
        """Join the write in flight; raise if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("asynchronous checkpoint write failed") from error

    def close(self):
        """Finish the write in flight and free the snapshot buffers."""
        try:
            self.wait()
        finally:
            self._buffers.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _read(path: str) -> dict:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"checkpoint {path} not found")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "ema" not in ckpt or "step" not in ckpt:
        raise ValueError(f"{path} is not a vaw_torch checkpoint "
                         "({'ema': state_dict, 'step': int, ...})")
    return ckpt


def load_checkpoint(path: str, model: torch.nn.Module) -> int:
    """Load the EMA weights at `path` into `model` (strictly: every tensor
    must match by name and shape) and return the checkpoint's step."""
    ckpt = _read(path)
    state = dict(ckpt["ema"])
    if "pos_embed" not in model.state_dict():
        # The reference DiT stores its frozen sin-cos table, which the
        # port's DiT recomputes; a learned table (U-ViT's) is loaded.
        state.pop("pos_embed", None)
    model.load_state_dict(state, strict=True)
    return int(ckpt["step"])


@torch.no_grad()
def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor],
               what: str, trainer=None):
    """Copy the file's full tensors `src` into `dst`; under `trainer`'s
    mesh each rank takes its share (and a pipeline stage its blocks)."""
    src = {_reference_name(k): v for k, v in src.items()}
    subset = trainer is not None and trainer.holds_subset
    if (set(dst) - set(src)) or (set(src) - set(dst) and not subset):
        raise ValueError(f"checkpoint {what} names differ from the model's: "
                         f"{sorted(set(dst) ^ set(src))[:8]}")
    for k, t in dst.items():
        if t.shape != src[k].shape:
            raise ValueError(f"checkpoint {what} {k}: shape "
                             f"{tuple(src[k].shape)}, expected {tuple(t.shape)}")
        if trainer is None:
            t.copy_(src[k])
        else:
            to_local(t).copy_(trainer.local(k, src[k], t))


def load_train_state(path: str, state: TrainState, trainer=None) -> TrainState:
    """Restore params, EMA, Adam count and moments, the step and, where both
    have one, the resampler's history from the checkpoint at `path` into
    `state` (in place, in its dtypes and on its device) for --resume, each
    rank its share under `trainer`'s mesh. A state with a resampler keeps
    its fresh history when the file has none (a run started with uniform
    t)."""
    ckpt = _read(path)
    if "params" not in ckpt or "opt" not in ckpt:
        raise ValueError(f"{path} holds EMA weights only, not a train state")
    _copy_into(state.params, ckpt["params"], "params", trainer)
    _copy_into(state.ema, ckpt["ema"], "ema", trainer)
    _copy_into(state.mu, ckpt["opt"]["mu"], "mu", trainer)
    _copy_into(state.nu, ckpt["opt"]["nu"], "nu", trainer)
    state.count = int(ckpt["opt"]["count"])
    state.step = int(ckpt["step"])
    if state.resampler is not None and "resampler" in ckpt:
        _copy_into({"loss_history": state.resampler.loss_history,
                    "loss_counts": state.resampler.loss_counts},
                   ckpt["resampler"], "resampler")
    return state
