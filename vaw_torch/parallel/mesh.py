"""Device meshes and this rank's slice of a batch (counterpart of
vaw_tpu/parallel/mesh.py).

A ``torch.distributed.device_mesh.DeviceMesh`` over every process of the
group, with the JAX package's axis names: ("data", "model") for data and
tensor parallelism, ("data", "stage") for pipelines, ("data", "sp") for
sequence parallelism. Ranks fill the mesh row-major, so the minor axis
(model, stage or sp) takes consecutive ranks: the GPUs of one node, the
NVLink peers, as ``_topology_grid`` puts the minor axis on ICI neighbours
(vaw_tpu/parallel/mesh.py:38-61). Where the JAX package places a global
array with the batch sharded over "data", each process here holds its own
rows: ``shard_batch`` takes them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .distributed import comm_device, world_size

__all__ = ["make_mesh", "make_pp_mesh", "make_sp_mesh", "batch_sharding",
           "replicated_sharding", "shard_batch", "local_device_count",
           "data_index"]


def local_device_count() -> int:
    """Devices attached to this process: one card each under the launcher,
    every visible card otherwise (1 on the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _mesh(shape: Tuple[int, int], names: Tuple[str, str]) -> DeviceMesh:
    return init_device_mesh(comm_device().type, shape, mesh_dim_names=names)


def make_mesh(data_axis: int = -1, model_axis: int = 1) -> DeviceMesh:
    """('data', 'model') mesh over every process; data_axis == -1 puts the
    rest on the data axis."""
    n = world_size()
    if data_axis == -1:
        if n % model_axis:
            raise ValueError(f"{n} devices not divisible by --model_axis {model_axis}")
        data_axis = n // model_axis
    if data_axis * model_axis != n:
        raise ValueError(f"--data_axis {data_axis} x --model_axis {model_axis} "
                         f"!= {n} devices")
    return _mesh((data_axis, model_axis), ("data", "model"))


def make_pp_mesh(pp_stages: int) -> DeviceMesh:
    """('data', 'stage') mesh for data x pipeline parallelism."""
    n = world_size()
    if n % pp_stages:
        raise ValueError(f"{n} devices not divisible by --pp_stages {pp_stages}")
    return _mesh((n // pp_stages, pp_stages), ("data", "stage"))


def make_sp_mesh(sp_degree: int) -> DeviceMesh:
    """('data', 'sp') mesh for data x sequence parallelism, with the JAX
    CLI's error (vaw_tpu/cli/main.py:165-171)."""
    n = world_size()
    if n % sp_degree:
        raise ValueError(f"{n} devices not divisible by --sp_degree {sp_degree}")
    return _mesh((n // sp_degree, sp_degree), ("data", "sp"))


def data_index(mesh: DeviceMesh) -> Tuple[int, int]:
    """(this rank's row on the data axis, the data axis' size); (0, 1)
    without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank("data"), mesh.size(mesh.mesh_dim_names.index("data"))


def batch_sharding(mesh: DeviceMesh) -> "_DataSlice":
    """The slice of a global batch's rows that this rank holds: its data
    row's contiguous share (replaces DistributedSampler, reference
    main.py:166-180); ranks that differ only on the minor axis hold the
    same rows."""
    return _DataSlice(*data_index(mesh))


def replicated_sharding(mesh: DeviceMesh) -> "_DataSlice":
    """The whole batch, held by every rank."""
    del mesh
    return _DataSlice(0, 1)


class _DataSlice:
    """Row `index` of `count` equal shares of a leading axis."""

    def __init__(self, index: int, count: int):
        self.index, self.count = index, count

    def __call__(self, x):
        n = x.shape[0]
        if n % self.count:
            raise ValueError(f"batch of {n} does not split over {self.count} data ranks")
        size = n // self.count
        return x[self.index * size:(self.index + 1) * size]

    def __repr__(self):
        return f"rows {self.index} of {self.count}"


def shard_batch(mesh: DeviceMesh, batch: Dict[str, object]) -> Dict[str, object]:
    """This rank's rows of every array of a global batch."""
    take = batch_sharding(mesh)
    return {k: take(v) for k, v in batch.items()}
