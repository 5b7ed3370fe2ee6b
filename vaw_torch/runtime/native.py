"""ctypes bindings for the native batch-assembly library (counterpart of
vaw_tpu/runtime/native.py).

``batch_ops.cpp`` has a plain C interface. It is compiled with ``g++`` at
first use into the port's build directory (``vaw_torch.ops._build.build_dir``,
the one the CUDA kernels use), under a name keyed by the hash of its source,
so an edited source is rebuilt and an unchanged one reused. Concurrent first
builds (several test workers, several processes) each write a per-process
temporary file and publish it with ``os.replace``. Nothing runs at import.

Unlike the JAX package, a failed build or load does not fall back to numpy:
``gather_normalize`` and ``normalize_u8`` raise, quoting the compiler. The
numpy versions are ``gather_normalize_reference`` and
``normalize_u8_reference``, the plain versions the tests hold the library
against. ``gather_normalize.calls`` and ``normalize_u8.calls`` count the
calls that ran the library, as the kernel wrappers count their launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..ops._build import build_dir

__all__ = ["SOURCE", "library_path", "build", "get_lib", "native_available",
           "gather_normalize", "gather_normalize_reference", "normalize_u8",
           "normalize_u8_reference"]

SOURCE = Path(__file__).resolve().with_name("batch_ops.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LOCK = threading.Lock()
_LIBS: Dict[Path, ctypes.CDLL] = {}


def library_path(source: Optional[Path] = None) -> Path:
    """The library of `source` (default: ``batch_ops.cpp``), named by the
    hash of the source."""
    source = Path(source or SOURCE)
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return build_dir() / f"{source.stem}-{digest}.so"


def build(source: Optional[Path] = None) -> Path:
    """Compile `source` unless its library exists; return the library's
    path. Raises RuntimeError with the compiler's output if g++ fails."""
    source = Path(source or SOURCE)
    target = library_path(source)
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {source.name} failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {source.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    return target


def get_lib(source: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library of `source` (default: ``batch_ops.cpp``), built
    first if needed; raises if it cannot be built or loaded."""
    source = Path(source or SOURCE)
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            lib.vaw_gather_normalize.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64]
            lib.vaw_gather_normalize.restype = None
            lib.vaw_normalize_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
            lib.vaw_normalize_u8.restype = None
            _LIBS[source] = lib
        return lib


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _check_gather(images: np.ndarray, idx: np.ndarray,
                  flips: Optional[np.ndarray]) -> np.ndarray:
    if images.dtype != np.uint8 or images.ndim != 4 or not images.flags.c_contiguous:
        raise ValueError("images must be a C-contiguous uint8 [N, h, w, c] array, got "
                         f"{images.dtype} {images.shape}")
    idx = np.ascontiguousarray(idx, np.int64)
    if idx.ndim != 1:
        raise ValueError(f"idx must be 1-D, got shape {idx.shape}")
    if len(idx) and (idx.min() < 0 or idx.max() >= len(images)):
        raise IndexError(f"idx outside [0, {len(images)})")
    if flips is not None and np.shape(flips) != idx.shape:
        raise ValueError(f"flips shape {np.shape(flips)} != idx shape {idx.shape}")
    return idx


def gather_normalize_reference(images: np.ndarray, idx: np.ndarray,
                               flips: Optional[np.ndarray] = None) -> np.ndarray:
    """The plain numpy version of ``gather_normalize`` (the JAX package's
    fallback path)."""
    idx = _check_gather(images, idx, flips)
    out = images[idx]
    if flips is not None:
        out = np.where(np.asarray(flips).astype(bool)[:, None, None, None],
                       out[:, :, ::-1], out)
    return out.astype(np.float32) / 127.5 - 1.0


def gather_normalize(images: np.ndarray, idx: np.ndarray,
                     flips: Optional[np.ndarray] = None,
                     num_threads: int = 8) -> np.ndarray:
    """images [N, h, w, c] uint8, idx [B] -> [B, h, w, c] f32 in [-1, 1],
    row b mirrored along w where flips[b] is set: one pass of the native
    library over `num_threads` threads. Raises if the library is not
    available."""
    idx = _check_gather(images, idx, flips)
    lib = get_lib()
    b = len(idx)
    _, h, w, c = images.shape
    out = np.empty((b, h, w, c), np.float32)
    flips_arr = None if flips is None else np.ascontiguousarray(flips, np.uint8)
    lib.vaw_gather_normalize(
        images.ctypes.data, idx.ctypes.data,
        None if flips_arr is None else flips_arr.ctypes.data,
        out.ctypes.data, b, h, w, c, num_threads)
    gather_normalize.calls += 1
    return out


gather_normalize.calls = 0


def normalize_u8_reference(src: np.ndarray) -> np.ndarray:
    """The plain numpy version of ``normalize_u8``."""
    return np.asarray(src, np.uint8).astype(np.float32) / 127.5 - 1.0


def normalize_u8(src: np.ndarray, num_threads: int = 8) -> np.ndarray:
    """uint8 array -> f32 in [-1, 1] through the native library; raises if
    the library is not available."""
    src = np.ascontiguousarray(src, np.uint8)
    lib = get_lib()
    out = np.empty(src.shape, np.float32)
    lib.vaw_normalize_u8(src.ctypes.data, out.ctypes.data, src.size, num_threads)
    normalize_u8.calls += 1
    return out


normalize_u8.calls = 0
