"""Structured key-value metric logger with JSON and CSV writers
(counterpart of vaw_tpu/utils/kvlogger.py, whose formats ("csv", "json")
the training CLI configures).

logkv / dumpkvs write one record per dump to {log_dir}/progress.csv and
{log_dir}/progress.json. The JAX module's human-readable and TensorBoard
writers, and its profiling sections, are not ported: no caller uses them.
"""

from __future__ import annotations

import csv
import io
import json
import os
from typing import Dict, List, Optional

__all__ = ["KVWriter", "JSONOutputFormat", "CSVOutputFormat", "Logger",
           "configure", "get_current", "logkv", "dumpkvs"]


class KVWriter:
    def writekvs(self, kvs: Dict):
        raise NotImplementedError

    def close(self):
        pass


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


def make_output_format(fmt: str, log_dir: str) -> KVWriter:
    os.makedirs(log_dir, exist_ok=True)
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

    def logkv(self, key, val):
        self.name2val[key] = val

    def dumpkvs(self):
        out = dict(self.name2val)
        for w in self.writers:
            w.writekvs(out)
        self.name2val.clear()
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


def dumpkvs():
    if _CURRENT:
        return _CURRENT.dumpkvs()
    return {}
