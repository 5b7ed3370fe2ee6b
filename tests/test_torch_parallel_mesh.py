"""The port's process setup and meshes (vaw_torch/parallel/distributed.py,
mesh.py): the single-process no-op, the refusal to run alone when the
launcher's environment announces several processes and the group cannot
be joined, the meshes' shapes, names and rank layout (the minor axis on
consecutive ranks), each rank's rows of a batch and process_allgather's
rank order, on 4 gloo CPU ranks."""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from _torch_ranks import ROOT, run_ranks
from vaw_torch.parallel import distributed


def test_single_process_setup_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    assert distributed.setup_distributed() is False
    assert distributed.is_main_process() and distributed.world_size() == 1
    x = np.arange(6).reshape(2, 3)
    assert distributed.process_allgather(x) is x
    distributed.barrier()


def test_world_one_group_on_an_in_memory_store(monkeypatch):
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    try:
        assert distributed.setup_distributed(world_size=1) is True
        assert distributed.world_size() == 1 and distributed.rank() == 0
        from vaw_torch.parallel.mesh import make_mesh

        mesh = make_mesh()
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="not divisible by --model_axis 2"):
            make_mesh(model_axis=2)
    finally:
        distributed.cleanup_distributed()


def test_announced_processes_that_cannot_join_raise(tmp_path):
    """WORLD_SIZE=2 from the launcher and no one listening on MASTER_PORT:
    setup_distributed raises instead of training alone."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = ("from vaw_torch.parallel.distributed import setup_distributed\n"
            "try:\n"
            "    setup_distributed(timeout_s=3)\n"
            "except RuntimeError as e:\n"
            "    print('RAISED', e)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"VAW_PLATFORM": "cpu", "RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
                "MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "PYTHONPATH": ROOT})
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert "RAISED" in res.stdout and "refusing to run as a single process" in res.stdout, (
        res.stdout + res.stderr)


def test_meshes_rows_and_allgather_on_four_ranks(tmp_path):
    out = run_ranks("_torch_parallel_workers:mesh_layout", 4, tmp_path, 2, 2, 2, 4)
    for r, o in enumerate(out):
        dp_tp = o["dp_tp"]
        assert dp_tp["names"] == ("data", "model") and dp_tp["shape"] == (2, 2)
        # row-major: the model axis takes consecutive ranks
        assert dp_tp["ranks"] == [[0, 1], [2, 3]]
        assert dp_tp["coords"] == [r // 2, r % 2]
        assert dp_tp["rows"] == list(range(8))[4 * (r // 2):4 * (r // 2) + 4]
        assert dp_tp["slice"] == f"rows {r // 2} of 2"
        assert o["pp"]["names"] == ("data", "stage") and o["pp"]["shape"] == (2, 2)
        assert o["pp"]["coords"] == [r // 2, r % 2]
        assert o["sp"]["names"] == ("data", "sp") and o["sp"]["shape"] == (1, 4)
        assert o["sp"]["rows"] == list(range(8))  # one data row: every rank all rows
        np.testing.assert_array_equal(
            o["gathered"], np.stack([np.full((2, 3), i) for i in range(4)]))
        np.testing.assert_array_equal(o["scalar"], [0.0, 10.0, 20.0, 30.0])
