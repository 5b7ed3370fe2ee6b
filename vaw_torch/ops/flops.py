"""FLOPs of the hand-written kernels, for ``utils.profiling.compiled_flops``.

``torch.utils.flop_counter.FlopCounterMode`` counts the aten ops it sees.
A kernel launched through ``ctypes`` is not one, so on a CUDA tensor each
kernel wrapper adds its own work to every active counter (``record``) where
it launches the kernel. The work is what FlopCounterMode counts for the
kernel's plain version at the same shapes (its matmuls, two FLOPs a
multiply-add; elementwise ops count nothing): the same function then
counts the same on the card and on the CPU, where the plain versions run
in the open and nothing is recorded. The fused bias + leaky ReLU is
elementwise, so its wrapper records nothing.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["attention_fwd_flops", "attention_bwd_flops", "conv3x3_flops",
           "KernelFlops", "counting", "record"]


def attention_fwd_flops(b: int, tq: int, tk: int, h: int, d: int) -> int:
    """S = Q K^T and O = P V."""
    return 4 * b * h * tq * tk * d


def attention_bwd_flops(b: int, tq: int, tk: int, h: int, d: int) -> int:
    """S again from lse, dV = P^T dO, dP = dO V^T, dK = dS^T Q, dQ = dS K."""
    return 10 * b * h * tq * tk * d


def conv3x3_flops(n: int, h: int, w: int, cin: int, cout: int) -> int:
    """Nine [N*H*W, Cin] x [Cin, Cout] products: the forward, the dgrad (the
    forward on the rotated filter) and the wgrad alike."""
    return 18 * n * h * w * cin * cout


class KernelFlops:
    """FLOPs recorded by kernel launches while it is active."""

    def __init__(self):
        self.total = 0


_lock = threading.Lock()
_active: list = []


@contextlib.contextmanager
def counting():
    """Activate a KernelFlops for the block. The autograd engine runs a
    backward on its own thread, so the counters are process-wide: a launch
    from any thread of the process counts."""
    counter = KernelFlops()
    with _lock:
        _active.append(counter)
    try:
        yield counter
    finally:
        with _lock:
            _active.remove(counter)


def record(flops: int):
    with _lock:
        for counter in _active:
            counter.total += flops
