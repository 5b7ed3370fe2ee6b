"""Structured key-value metric logger with human, JSON, CSV and TensorBoard
writers (counterpart of vaw_tpu/utils/kvlogger.py).

logkv / logkv_mean / dumpkvs write one record per dump through each
configured format: "stdout" and "log" ({log_dir}/log.txt) as the JAX
module's aligned table, "json" ({log_dir}/progress.json), "csv"
({log_dir}/progress.csv) and "tensorboard" (events under {log_dir}/tb,
through torch.utils.tensorboard, imported only when that format is asked
for). ``profile_kv`` and ``profile`` add the wall time of a named section
to the next dump as ``wait_{name}``.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import os
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

__all__ = ["KVWriter", "HumanOutputFormat", "JSONOutputFormat", "CSVOutputFormat",
           "TensorBoardOutputFormat", "Logger", "make_output_format", "configure",
           "get_current", "logkv", "logkv_mean", "dumpkvs", "profile_kv", "profile"]


class KVWriter:
    def writekvs(self, kvs: Dict):
        raise NotImplementedError

    def close(self):
        pass


class HumanOutputFormat(KVWriter):
    """An aligned key | value table per dump, to a file path or an open
    stream (the JAX module's layout, byte for byte)."""

    def __init__(self, path_or_file):
        if isinstance(path_or_file, str):
            self.file = open(path_or_file, "a")
            self.own = True
        else:
            self.file = path_or_file
            self.own = False

    def writekvs(self, kvs):
        items = sorted(kvs.items())
        if not items:
            return
        key_w = max(len(str(k)) for k, _ in items)
        val_strs = [(k, f"{v:.5g}" if isinstance(v, float) else str(v))
                    for k, v in items]
        val_w = max(len(v) for _, v in val_strs)
        dashes = "-" * (key_w + val_w + 7)
        lines = [dashes]
        for k, v in val_strs:
            lines.append(f"| {k:<{key_w}} | {v:<{val_w}} |")
        lines.append(dashes)
        self.file.write("\n".join(lines) + "\n")
        self.file.flush()

    def close(self):
        if self.own:
            self.file.close()


class JSONOutputFormat(KVWriter):
    """One JSON object per dump, one per line."""

    def __init__(self, path: str):
        self.file = open(path, "a")

    def writekvs(self, kvs):
        clean = {k: (float(v) if hasattr(v, "item") or isinstance(v, float) else v)
                 for k, v in kvs.items()}
        self.file.write(json.dumps(clean) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


class CSVOutputFormat(KVWriter):
    """One row per dump. A key seen for the first time adds a column: the
    file is rewritten with the wider header and the old rows padded.
    Appending to an existing file (a resumed run) keeps its header."""

    def __init__(self, path: str):
        self.path = path
        self.keys: List[str] = []
        if os.path.isfile(path):
            with open(path, newline="") as f:
                header = next(csv.reader(f), [])
            self.keys = list(header)
        self.file = open(path, "a", newline="")

    def writekvs(self, kvs):
        extra = [k for k in kvs if k not in self.keys]
        if extra:
            self.file.close()
            with open(self.path, newline="") as f:
                rows = list(csv.reader(f))[1:]
            self.keys.extend(extra)
            with open(self.path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(self.keys)
                for row in rows:
                    w.writerow(row + [""] * (len(self.keys) - len(row)))
            self.file = open(self.path, "a", newline="")
        buf = io.StringIO()
        csv.writer(buf).writerow([kvs.get(k, "") for k in self.keys])
        self.file.write(buf.getvalue())
        self.file.flush()

    def close(self):
        self.file.close()


class TensorBoardOutputFormat(KVWriter):
    """Each numeric value as a TensorBoard scalar. The step is the record's
    "step" value, else one past the last record's step (the JAX writer's
    rule)."""

    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError("the tensorboard log format needs the 'tensorboard' "
                              f"package: {e}") from e
        self.writer = SummaryWriter(log_dir)
        self.step = 0

    def writekvs(self, kvs):
        step = int(kvs.get("step", self.step))
        for k, v in kvs.items():
            if isinstance(v, (int, float)) or hasattr(v, "item"):
                self.writer.add_scalar(k, float(v), global_step=step)
        self.writer.flush()
        self.step = step + 1

    def close(self):
        self.writer.close()


def make_output_format(fmt: str, log_dir: str) -> KVWriter:
    os.makedirs(log_dir, exist_ok=True)
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout)
    if fmt == "log":
        return HumanOutputFormat(os.path.join(log_dir, "log.txt"))
    if fmt == "tensorboard":
        return TensorBoardOutputFormat(os.path.join(log_dir, "tb"))
    if fmt == "json":
        return JSONOutputFormat(os.path.join(log_dir, "progress.json"))
    if fmt == "csv":
        return CSVOutputFormat(os.path.join(log_dir, "progress.csv"))
    raise ValueError(f"Unknown format: {fmt}")


class Logger:
    def __init__(self, log_dir: str, formats: List[str]):
        self.log_dir = log_dir
        self.writers = [make_output_format(f, log_dir) for f in formats]
        self.name2val: Dict = {}
        self.name2cnt: Dict = defaultdict(int)

    def logkv(self, key, val):
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        """Running mean of `val` under `key` between dumps."""
        old, cnt = self.name2val.get(key, 0.0), self.name2cnt[key]
        self.name2val[key] = old * cnt / (cnt + 1) + float(val) / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self):
        out = dict(self.name2val)
        for w in self.writers:
            w.writekvs(out)
        self.name2val.clear()
        self.name2cnt.clear()
        return out

    def close(self):
        for w in self.writers:
            w.close()


_CURRENT: Optional[Logger] = None


def configure(log_dir: str, formats=("csv", "json")) -> Logger:
    """Make a new current logger writing `formats` under log_dir (the
    previous one is closed)."""
    global _CURRENT
    if _CURRENT is not None:
        _CURRENT.close()
    _CURRENT = Logger(log_dir, list(formats))
    return _CURRENT


def get_current() -> Optional[Logger]:
    return _CURRENT


def logkv(key, val):
    if _CURRENT:
        _CURRENT.logkv(key, val)


def logkv_mean(key, val):
    if _CURRENT:
        _CURRENT.logkv_mean(key, val)


def dumpkvs():
    if _CURRENT:
        return _CURRENT.dumpkvs()
    return {}


@contextlib.contextmanager
def profile_kv(name: str):
    """Add the wall time of the block to 'wait_{name}' of the next dump."""
    start = time.time()
    try:
        yield
    finally:
        if _CURRENT:
            key = f"wait_{name}"
            _CURRENT.name2val[key] = _CURRENT.name2val.get(key, 0.0) + time.time() - start


def profile(name: str):
    """Decorator form of ``profile_kv``."""

    def decorator(fn):
        def wrapped(*args, **kwargs):
            with profile_kv(name):
                return fn(*args, **kwargs)

        return wrapped

    return decorator
