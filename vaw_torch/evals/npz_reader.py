"""Streaming .npz array reader: reads batches without loading 50k images
into memory at once (the port's own copy of vaw_tpu/evals/npz_reader.py;
reference: evaluations/evaluator.py:434-571)."""

from __future__ import annotations

import io
import zipfile
from contextlib import contextmanager
from typing import Iterator, Optional

import numpy as np

__all__ = ["open_npz_array", "NpzArrayReader"]


class NpzArrayReader:
    """Batch reader over one array inside an npz archive."""

    def __init__(self, arr_f, shape, dtype):
        self.arr_f = arr_f
        self.shape = shape
        self.dtype = dtype
        self.idx = 0

    def remaining(self) -> int:
        return max(0, self.shape[0] - self.idx)

    def read_batch(self, batch_size: int) -> Optional[np.ndarray]:
        bs = min(batch_size, self.remaining())
        if bs <= 0:
            return None
        row_size = int(np.prod(self.shape[1:]))
        count = bs * row_size
        data = self.arr_f.read(count * self.dtype.itemsize)
        arr = np.frombuffer(data, dtype=self.dtype, count=count)
        self.idx += bs
        return arr.reshape(bs, *self.shape[1:])

    def read_batches(self, batch_size: int) -> Iterator[np.ndarray]:
        while True:
            batch = self.read_batch(batch_size)
            if batch is None:
                return
            yield batch


@contextmanager
def open_npz_array(path: str, arr_name: str):
    with open(path, "rb") as f:
        with zipfile.ZipFile(f, "r") as zip_f:
            name = f"{arr_name}.npy"
            if name not in zip_f.namelist():
                raise ValueError(f"missing {arr_name} in npz file")
            with zip_f.open(name, "r") as arr_f:
                version = np.lib.format.read_magic(arr_f)
                if version == (1, 0):
                    header = np.lib.format.read_array_header_1_0(arr_f)
                elif version == (2, 0):
                    header = np.lib.format.read_array_header_2_0(arr_f)
                else:
                    raise ValueError(f"unsupported npy version: {version}")
                shape, fortran, dtype = header
                if fortran or dtype.hasobject:
                    raise ValueError("unsupported npy array layout")
                yield NpzArrayReader(arr_f, shape, dtype)
