"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` (Hopper) into a shared library in the build
directory (``build_dir``), named by the hash of its source together with
every shared header (``csrc/*.cuh``), so an edited source or header is
rebuilt and an unchanged one is reused. The library is loaded with
``ctypes``. Nothing here runs at import time: the CPU tests import every
module, and a machine without the CUDA toolkit has no ``nvcc``.

The build directory is ``$VAW_TORCH_BUILD_DIR`` when that is set. Otherwise
it is ``build/vaw_torch_kernels/`` at the root of the checkout when the
package sits in one (``build/`` is git-ignored), and the user's cache
(``$XDG_CACHE_HOME`` or ``~/.cache``, then ``vaw_torch/kernels``) when the
package is installed: the sources and headers ship inside the package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["KERNEL_SOURCES", "build", "build_dir", "load_library", "library_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
# The directory that holds the package: a checkout's root, or site-packages.
PACKAGE_PARENT = Path(__file__).resolve().parents[2]
KERNEL_SOURCES = ("flash_fused_fwd", "flash_fused_bwd", "flash_fwd", "flash_bwd",
                  "flash_p5_fwd", "flash_p5_bwd", "conv3x3_fwd", "conv3x3_wgrad",
                  "fused_act")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    """Where the libraries are built: ``$VAW_TORCH_BUILD_DIR``, else
    ``build/vaw_torch_kernels`` in the checkout the package sits in (one
    with a ``pyproject.toml`` beside the package), else the user's cache."""
    env = os.environ.get("VAW_TORCH_BUILD_DIR")
    if env:
        return Path(env).expanduser()
    if (PACKAGE_PARENT / "pyproject.toml").is_file():
        return PACKAGE_PARENT / "build" / "vaw_torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "vaw_torch" / "kernels"


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by the hash of that source
    and of every header under ``csrc/`` (any of which it may include)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    return build_dir() / f"{name}-{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of vaw_torch are "
                       "built on first use and need the CUDA toolkit")


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    process per source, all started together. Returns the compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) by name;
    raises if any build fails."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    path = library_path(name)
    if not path.exists():
        t0 = time.perf_counter()
        build([name])
        print(f"[vaw_torch] built {path.name} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return ctypes.CDLL(str(path))
