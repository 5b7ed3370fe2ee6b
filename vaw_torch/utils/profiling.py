"""Profiling and FLOP accounting (counterpart of vaw_tpu/utils/profiling.py).

``trace`` records a torch.profiler trace of the host and the card and
writes it as Chrome-trace JSON; ``summarize_trace`` reads that JSON back
into device time by kernel category, the counterpart of JAX's
``summarize_xplane``, with no TensorFlow. ``compiled_flops`` counts a
call's FLOPs with ``FlopCounterMode`` plus what the hand-written kernels
record where they launch (``ops/flops.py``). ``StepTimer`` is JAX's
imgs/s window, closed by a host readback.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from collections import Counter, defaultdict
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from ..ops import flops as kernel_flops

__all__ = ["trace", "compiled_flops", "estimate_train_flops", "StepTimer",
           "summarize_trace", "kernel_category"]


@contextlib.contextmanager
def trace(logdir: str):
    """Record the host and, where there is one, the card with
    torch.profiler for the block, then write the Chrome-trace JSON under
    `logdir` (TensorBoard's torch profiler plugin reads it too). Yields the
    profiler; its ``trace_path`` names the file once the block has ended."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        logdir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(prof.trace_path)


def compiled_flops(fn: Callable, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call fn(*args, **kwargs): what FlopCounterMode counts
    (matmuls, convolutions, attention; two a multiply-add) plus what the
    hand-written kernels record where they launch, so that a function
    counts the same on the card and on the CPU. Runs fn. None where the
    count fails, as JAX's cost analysis does."""
    try:
        with kernel_flops.counting() as kernels, FlopCounterMode(display=False) as mode:
            fn(*args, **kwargs)
        return float(mode.get_total_flops() + kernels.total)
    except Exception:  # noqa: BLE001 - the count is best-effort, as JAX's
        return None


def estimate_train_flops(n_params: int, tokens_per_img: int) -> float:
    """Analytic fallback: fwd 2*P*T, train ~3x fwd (the standard transformer
    accounting; replaces count_flops_attn, reference models/unet.py:309-326).
    """
    return 6.0 * n_params * tokens_per_img


class StepTimer:
    """imgs/sec (/chip) over a sliding window; `lap` must be called with a
    scalar whose materialization closes the step chain (``float`` of a CUDA
    scalar waits for the card). The per-chip rate divides by the cards the
    run uses: the process group's world size, else 1 (JAX's divides by
    ``len(jax.devices())``, every visible device)."""

    def __init__(self, batch_size: int, window: int = 50):
        self.batch_size = batch_size
        self.window = window
        self.count = 0
        self.t0 = None
        self.last_rate = 0.0

    def lap(self, readback_scalar=None) -> Optional[Dict[str, float]]:
        self.count += 1
        if self.t0 is None:
            self.t0 = time.perf_counter()
            self.count = 0
            return None
        if self.count >= self.window:
            if readback_scalar is not None:
                float(readback_scalar)  # close the async chain
            dt = time.perf_counter() - self.t0
            n_chips = dist.get_world_size() if dist.is_initialized() else 1
            rate = self.batch_size * self.count / dt
            self.last_rate = rate
            self.t0 = time.perf_counter()
            self.count = 0
            return {
                "imgs_per_sec": rate,
                "imgs_per_sec_chip": rate / n_chips,
                "step_ms": dt / self.window * 1000,
            }
        return None


# First match wins; names are CUDA kernel names as the profiler reports them.
_CATEGORIES = (
    ("collectives (NCCL)", ("nccl",)),
    ("fused attention fwd kernel", ("flash_fused_fwd",)),
    ("fused attention bwd kernel", ("flash_fused_bwd",)),
    ("p5 attention fwd kernel", ("flash_p5_fwd",)),
    ("p5 attention bwd kernel", ("flash_p5_bwd",)),
    ("general attention fwd kernel", ("flash_fwd",)),
    ("general attention bwd kernel", ("flash_bwd",)),
    # The hand-written 3x3 conv (VAW_PALLAS_CONV=1) before cuDNN's "conv".
    ("conv3x3 fwd/dgrad kernel", ("conv3x3_fwd",)),
    ("conv3x3 wgrad kernel", ("conv3x3_wgrad",)),
    ("fused bias-act kernel", ("fused_leaky_relu",)),
    # cuDNN's implicit-GEMM convs are sm90_xmma_* kernels too: match them
    # (and its layout transposes) before cuBLAS's GEMMs.
    ("conv (cuDNN)", ("implicit_gemm", "cudnn", "conv", "winograd", "fprop", "dgrad",
                      "wgrad", "nchwtonhwc", "nhwctonchw")),
    # f32 GEMMs (REPA's f32 teacher, TF32 off) before the bf16 ones.
    ("matmul f32 (cuBLAS)", ("sgemm", "f32f32_f32f32", "tf32")),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma", "sm90_", "cublas")),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("layer norm", ("layer_norm", "layernorm")),
    ("group norm", ("group_norm", "groupnorm", "rowwisemoments", "computefusedparams",
                    "computeinternalgradients", "computebackwardfusedparams")),
    ("reductions", ("reduce",)),
    ("copies and casts", ("copy", "memcpy", "memset", "fill")),
)


def kernel_category(name: str) -> str:
    low = name.lower()
    for category, keys in _CATEGORIES:
        if any(k in low for k in keys):
            return category
    return "other elementwise"


# Chrome-trace categories of work on the card (kineto's names).
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize_trace(path: str, top: int = 25):
    """Aggregate a Chrome-trace JSON (``trace``'s file, or
    ``export_chrome_trace``'s) into per-category and per-kernel
    device time. Returns {"categories": {...}, "ops": [(name, ms), ...],
    "busy_ms": float, "span_ms": float}, times in ms over the traced
    window, as JAX's ``summarize_xplane`` does.

    Device events are the kernels, memcpys and memsets on every card and
    stream. ``categories`` and ``ops`` sum their durations, so work that
    overlaps on two streams counts in both. ``busy_ms`` is the union of
    their intervals on each card, summed over cards; ``span_ms`` the
    longest first-start-to-last-end of a card. Raises ValueError where the
    trace holds no device event."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_device = defaultdict(list)
    bycat: Counter = Counter()
    byop: Counter = Counter()
    for ev in events:
        if ev.get("ph") != "X" or str(ev.get("cat", "")).lower() not in _DEVICE_CATEGORIES:
            continue
        start, dur = float(ev["ts"]), float(ev.get("dur", 0.0))  # us
        by_device[ev.get("args", {}).get("device", ev.get("pid"))].append(
            (start, start + dur))
        bycat[kernel_category(ev["name"])] += dur / 1e3
        byop[ev["name"]] += dur / 1e3
    if not by_device:
        raise ValueError(f"{path}: the trace holds no device event (cat in "
                         f"{_DEVICE_CATEGORIES})")
    busy_us = span_us = 0.0
    for intervals in by_device.values():
        intervals.sort()
        span_us = max(span_us, max(e for _, e in intervals) - intervals[0][0])
        cur_s, cur_e = intervals[0]
        for s, e in intervals[1:]:
            if s <= cur_e:
                cur_e = max(cur_e, e)
            else:
                busy_us += cur_e - cur_s
                cur_s, cur_e = s, e
        busy_us += cur_e - cur_s
    return {"categories": dict(bycat.most_common()), "ops": byop.most_common(top),
            "busy_ms": busy_us / 1e3, "span_ms": span_us / 1e3}
