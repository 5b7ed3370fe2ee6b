"""The kernel build (vaw_torch/ops/_build.py) and the port's packaging: a
library is named by its source and every shared header under csrc/, so an
edit to a header rebuilds each kernel that may include it; the build goes
to $VAW_TORCH_BUILD_DIR, else to the checkout's git-ignored build/, else to
the user's cache; pyproject.toml ships every file a kernel source
includes, and every source on Hopper's TMA and wgmma among them; and each
warpgroup product of hopper_common.cuh binds its accumulators and operands
as the PTX instruction numbers them. Runs on the CPU: it only hashes and
reads files, nothing is compiled."""

from __future__ import annotations

import fnmatch
import re
import shutil
import tomllib
from pathlib import Path

import pytest

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


# The sources on Hopper's TMA and wgmma, each built from csrc/ and shipped.
HOPPER_SOURCES = ("flash_fused_fwd", "flash_p5_fwd", "conv3x3_fwd", "conv3x3_wgrad")


@pytest.mark.parametrize("name", HOPPER_SOURCES)
def test_every_hopper_source_is_built_and_shipped(name):
    text = (_build.CSRC / f"{name}.cu").read_text()
    assert re.search(r'^#include "hopper_common\.cuh"', text, flags=re.M)
    assert name in _build.KERNEL_SOURCES
    assert any(fnmatch.fnmatch(f"csrc/{name}.cu", g) for g in _package_globs())
    including = {p.stem for p in _build.CSRC.glob("*.cu")
                 if '#include "hopper_common.cuh"' in p.read_text()}
    assert including == set(HOPPER_SOURCES)


# The products the kernels use: both operands in shared memory at the
# scores' and the convs' widths, A from registers at every padded head dim.
WGMMA_PRODUCTS = [(n, "ss") for n in (64, 128, 192)] + [
    (n, "rs") for n in range(16, 129, 16)]


def _wgmma_products():
    """{(N, "ss" or "rs"): asm text} of hopper_common.cuh's Wgmma<N>."""
    text = (_build.CSRC / "hopper_common.cuh").read_text()
    found = {}
    for m in re.finditer(r"struct Wgmma<(\d+)> \{(.*?)\n\};", text, flags=re.S):
        for f in re.finditer(r"void (ss|rs)\(.*?\);\n  \}", m.group(2), flags=re.S):
            found[int(m.group(1)), f.group(1)] = f.group(0)
    return found


@pytest.mark.parametrize("n,kind", WGMMA_PRODUCTS)
def test_wgmma_products_bind_every_accumulator(n, kind):
    """No compiler here: read each m64nNk16 product as ptxas would. The
    instruction names the width, its braces list operands %0..%(N/2 - 1),
    each bound to d[i] in order, and the operands after them (descriptors
    or A's four registers, then the scale-d predicate and the transposes)
    are numbered on."""
    products = _wgmma_products()
    assert sorted(products) == sorted(WGMMA_PRODUCTS)
    r = n // 2
    asm = products[n, kind]
    assert f"m64n{n}k16.f32.bf16.bf16" in asm
    assert f"float (&d)[{r}]" in asm
    listed = re.search(r'"\{"\s*(.*?)"\}, ', asm, flags=re.S).group(1)
    assert re.findall(r"%(\d+)", listed) == [str(i) for i in range(r)]
    assert re.findall(r'"\+f"\(d\[(\d+)\]\)', asm) == [str(i) for i in range(r)]
    tail = re.search(r'"\}, (.*?);\\n\}\\n"', asm).group(1)
    if kind == "ss":
        assert tail == f"%{r}, %{r + 1}, p, 1, 1, %{r + 3}, %{r + 4}", tail
        assert f"setp.ne.b32 p, %{r + 2}, 0" in asm
        assert '"r"(accumulate), "n"(TRANS_A), "n"(TRANS_B)' in asm
    else:
        assert tail == f"{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1, %{r + 6}", tail
        assert f"setp.ne.b32 p, %{r + 5}, 0" in asm
        assert '"l"(db), "r"(accumulate),\n          "n"(TRANS_B)' in asm
