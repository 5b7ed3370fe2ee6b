"""The port's multi-rank dry run (vaw_torch/train/dryrun.py): every leg at 4
gloo CPU ranks (dp+tp and dp+tp+fsdp on DiT-S geometry with their
collective census and the one-rank loss, pp and sp against the plain-dp
baseline), and the 8-rank run, marked slow as tests/test_train.py:106
marks JAX's."""

from __future__ import annotations

import pytest

from vaw_torch.train.dryrun import dryrun_multichip


def test_dryrun_four_ranks(capfd):
    dryrun_multichip(4, timeout_s=240)
    out = capfd.readouterr().out
    for leg in ("dp+tp", "dp+tp+fsdp", "pp", "sp"):
        assert f"[leg] {leg} start" in out and f"[leg] {leg} done" in out, out
    assert "CORE OK" in out and "dryrun_multichip(4)" in out and out.rstrip().endswith("OK")


@pytest.mark.slow
def test_dryrun_eight_ranks(capfd):
    dryrun_multichip(8)
    assert capfd.readouterr().out.rstrip().endswith("OK")
