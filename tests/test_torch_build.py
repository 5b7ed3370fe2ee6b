"""The kernel build (vaw_torch/ops/_build.py) and the port's packaging: a
library is named by its source and every shared header under csrc/, so an
edit to a header rebuilds each kernel that may include it; the build goes
to $VAW_TORCH_BUILD_DIR, else to the checkout's git-ignored build/, else to
the user's cache; and pyproject.toml ships every file a kernel source
includes. Runs on the CPU: it only hashes and reads files, nothing is
compiled."""

from __future__ import annotations

import fnmatch
import re
import shutil
import tomllib
from pathlib import Path

from vaw_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]


def test_library_path_follows_sources_and_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert sorted(p.name for p in csrc.glob("*.cuh")) == ["flash_common.cuh",
                                                          "hopper_common.cuh"]
    before = {name: _build.library_path(name) for name in _build.KERNEL_SOURCES}
    assert before == {name: _build.library_path(name) for name in _build.KERNEL_SOURCES}

    header = csrc / "flash_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.KERNEL_SOURCES}
    assert all(after[n] != before[n] for n in _build.KERNEL_SOURCES)

    source = csrc / "flash_fwd.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    again = {name: _build.library_path(name) for name in _build.KERNEL_SOURCES}
    assert again["flash_fwd"] != after["flash_fwd"]
    assert again["flash_bwd"] == after["flash_bwd"]


def test_every_kernel_source_is_built():
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert sources == set(_build.KERNEL_SOURCES)
    assert {"flash_fwd", "flash_bwd"} <= sources


def _package_globs():
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)
    return data["tool"]["setuptools"]["package-data"]["vaw_torch.ops"]


def test_package_data_ships_every_source_and_included_header():
    """An installed vaw_torch builds its kernels from the files that ship
    inside it: each csrc/*.cu and every file one of them includes by a
    quoted #include must match a package-data glob of vaw_torch.ops."""
    globs = _package_globs()
    ops = _build.CSRC.parent
    needed = set()
    for source in sorted(_build.CSRC.glob("*.cu*")):
        needed.add(source.relative_to(ops).as_posix())
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', source.read_text(),
                               flags=re.M):
            path = (source.parent / name).resolve()
            assert path.is_file(), (source.name, name)
            needed.add(path.relative_to(ops).as_posix())
    assert "csrc/hopper_common.cuh" in needed and "csrc/flash_common.cuh" in needed
    unshipped = [f for f in sorted(needed)
                 if not any(fnmatch.fnmatch(f, g) for g in globs)]
    assert not unshipped, f"not in package-data {globs}: {unshipped}"


def test_build_dir_follows_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("VAW_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
    assert _build.build_dir() == tmp_path / "kernels"
    for name in _build.KERNEL_SOURCES:
        assert _build.library_path(name).parent == tmp_path / "kernels"


def test_checkout_default_is_the_ignored_build_dir(monkeypatch):
    monkeypatch.delenv("VAW_TORCH_BUILD_DIR", raising=False)
    assert _build.PACKAGE_PARENT == ROOT
    assert _build.build_dir() == ROOT / "build" / "vaw_torch_kernels"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert _build.library_path("flash_fwd").is_relative_to(ROOT / "build")


def test_installed_default_is_the_user_cache(tmp_path, monkeypatch):
    """Outside a checkout (no pyproject.toml beside the package, as in
    site-packages) the libraries go to the user's cache."""
    monkeypatch.delenv("VAW_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setattr(_build, "PACKAGE_PARENT", tmp_path / "site-packages")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_dir() == tmp_path / "cache" / "vaw_torch" / "kernels"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build.build_dir() == tmp_path / "home" / ".cache" / "vaw_torch" / "kernels"
