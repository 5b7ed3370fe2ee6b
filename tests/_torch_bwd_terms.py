"""The general wgmma attention backward's widths and bf16 terms, read from
its source (vaw_torch/ops/csrc/flash_bwd.cu): the padded head dims its C
entry vaw_flash_bwd_wgmma dispatches to, and ``kBwdTerms``, the terms P^T
and dS enter the pair's tensor-core products as (one, rounded to bf16 once;
two, hi + lo). Both are constants of the kernels, not of a call, so the CPU
emulations of the pair take them from the source they emulate.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

SOURCE = (Path(__file__).resolve().parents[1] / "vaw_torch" / "ops" / "csrc"
          / "flash_bwd.cu")


@functools.cache
def _text() -> str:
    return SOURCE.read_text()


@functools.cache
def widths() -> tuple[int, ...]:
    """The padded head dims of vaw_flash_bwd_wgmma, narrowest first."""
    entry = _text().split('extern "C" int vaw_flash_bwd_wgmma(', 1)[1].split("\n}\n", 1)[0]
    return tuple(int(w) for w in re.findall(r"launch_wgmma<(\d+)>\(", entry))


def padded(d: int) -> int:
    """The width the pair pads head dim d to."""
    return next(w for w in widths() if d <= w)


@functools.cache
def bwd_terms() -> int:
    """flash_bwd.cu:kBwdTerms."""
    match = re.search(r"^constexpr int kBwdTerms = (\d+);$", _text(), re.M)
    assert match, "flash_bwd.cu: kBwdTerms not found in the form read here"
    return int(match.group(1))
