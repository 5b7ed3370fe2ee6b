"""The port's native batch assembly (vaw_torch/runtime) against the JAX
package's (vaw_tpu/runtime) and against the port's numpy versions: the
native gather and normalize are bit-equal to both, threaded and single.
A source that does not compile raises, quoting the compiler; it does not
fall back to numpy."""

from __future__ import annotations

import numpy as np
import pytest

from vaw_torch.runtime import native
from vaw_tpu import runtime as jax_runtime


@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("shape,flip", [((40, 8, 8, 3), True), ((40, 8, 8, 3), False),
                                        ((10, 5, 7, 1), True), ((3, 32, 32, 3), True)])
def test_gather_normalize_bit_equal(shape, flip, threads):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, shape, dtype=np.uint8)
    idx = rng.permutation(shape[0])[: max(1, shape[0] // 2)]
    flips = (rng.random(len(idx)) < 0.5).astype(np.uint8) if flip else None
    before = native.gather_normalize.calls
    got = native.gather_normalize(images, idx, flips, num_threads=threads)
    assert native.gather_normalize.calls == before + 1
    assert got.dtype == np.float32 and got.shape == (len(idx), *shape[1:])
    np.testing.assert_array_equal(got, native.gather_normalize_reference(images, idx, flips))
    np.testing.assert_array_equal(
        got, jax_runtime.gather_normalize(images, idx, flips, num_threads=threads))


@pytest.mark.parametrize("size,threads", [(75, 1), (75, 8), (1 << 17, 1), (1 << 17, 8)])
def test_normalize_u8_bit_equal(size, threads):
    src = np.random.default_rng(1).integers(0, 256, size, dtype=np.uint8)
    before = native.normalize_u8.calls
    got = native.normalize_u8(src, num_threads=threads)
    assert native.normalize_u8.calls == before + 1
    np.testing.assert_array_equal(got, native.normalize_u8_reference(src))
    np.testing.assert_array_equal(got, jax_runtime.normalize_u8(src, num_threads=threads))


def test_gather_checks_its_inputs():
    images = np.zeros((4, 2, 2, 3), np.uint8)
    with pytest.raises(IndexError):
        native.gather_normalize(images, np.array([0, 4]))
    with pytest.raises(IndexError):
        native.gather_normalize(images, np.array([-1]))
    with pytest.raises(ValueError, match="uint8"):
        native.gather_normalize(images.astype(np.float32), np.array([0]))
    with pytest.raises(ValueError, match="C-contiguous"):
        native.gather_normalize(images[:, :, ::-1], np.array([0]))
    with pytest.raises(ValueError, match="flips"):
        native.gather_normalize(images, np.array([0, 1]), np.array([1], np.uint8))


def test_library_builds_into_the_port_build_dir_keyed_by_source(tmp_path, monkeypatch):
    monkeypatch.setenv("VAW_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
    path = native.library_path()
    assert path.parent == tmp_path / "kernels"
    assert path.name.startswith("batch_ops-") and path.suffix == ".so"
    assert native.build() == path and path.exists()
    edited = tmp_path / "batch_ops.cpp"
    edited.write_text(native.SOURCE.read_text() + "\n// edited\n")
    assert native.library_path(edited) != path  # another source, another library
    assert native.native_available()


def test_a_broken_source_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    monkeypatch.setenv("VAW_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
    broken = tmp_path / "batch_ops.cpp"
    broken.write_text('extern "C" void vaw_gather_normalize( { not c++ }\n')
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        native.get_lib(broken)
    assert "error" in str(info.value)  # the compiler's own message
    monkeypatch.setattr(native, "SOURCE", broken)
    images = np.zeros((2, 2, 2, 3), np.uint8)
    calls = native.gather_normalize.calls
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.gather_normalize(images, np.array([1, 0]))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.normalize_u8(images)
    assert native.gather_normalize.calls == calls
    assert not native.native_available()
    assert not list((tmp_path / "kernels").glob("*.tmp"))  # no half-built file left
