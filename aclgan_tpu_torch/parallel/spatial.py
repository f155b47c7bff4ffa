"""Spatial (image-height) sharding on a (data, spatial) grid of processes.

Port of `aclgan_tpu/parallel/spatial.py`. The JAX package lays a 2-D mesh
('data', 'spatial') over its devices, places image batches with N over
'data' and H over 'spatial', replicates the parameters, and lets XLA's GSPMD
partitioner insert the conv halo exchanges and the cross-shard reductions
into the unchanged model. The port runs one process a device and does the
exchanges itself, in the layers that need them:

- `make_mesh_2d(n_data, n_spatial)` is this rank's place on the grid: rank
  r is data index r // n_spatial and spatial index r % n_spatial (data-major,
  as JAX's `reshape(n_data, n_spatial)`), over the first
  n_data * n_spatial processes;
- `spatial_batch_sharding` is this rank's (rows, H rows) of a global batch;
- the model's layers read the mesh that `ACLGAN` sets on them: convs take
  their halo rows from the neighbouring spatial ranks
  (`parallel/halo.py`), IN / AdaIN / LN statistics and the style encoder's
  global pool are all-reduced over the spatial group, the discriminator's
  3x3/s2 pool takes one halo row a side, and bn's batch statistics cover
  the whole grid.

The halo moves point to point (`parallel/halo.py`) over NCCL and over gloo
on the CPU; every other collective is an `all_reduce` (or a `broadcast`),
which gloo with CUDA tensors (two ranks sharing one card) also supports.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch.distributed as dist

from aclgan_tpu_torch.parallel.mesh import nccl_groups


@dataclass(frozen=True, eq=False)
class SpatialMesh:
    """This rank on an n_data x n_spatial grid, with the grid's groups:
    `world_group` (every rank of the grid; None when that is every process),
    `spatial_group` (the ranks sharing this rank's images) and `data_group`
    (the ranks holding the same rows of other images)."""

    n_data: int
    n_spatial: int
    rank: int
    world_group: Any
    spatial_group: Any
    data_group: Any

    @property
    def world(self) -> int:
        return self.n_data * self.n_spatial

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_rank(self) -> int:
        return self.rank % self.n_spatial

    def capturable(self) -> bool:
        """Whether a CUDA graph can record this mesh's collectives: every
        group on NCCL."""
        return nccl_groups(self.world_group, self.spatial_group, self.data_group)


def sharded(mesh) -> bool:
    """Whether `mesh` (None, a `DataMesh` or a `SpatialMesh`) splits H."""
    return mesh is not None and mesh.n_spatial > 1


def make_mesh_2d(n_data: int, n_spatial: int) -> Optional[SpatialMesh]:
    """The grid over the first n_data * n_spatial processes of the default
    group. Every process calls it, in the same order as its other calls that
    make groups: each group is made on every process. Returns None on a
    process outside the grid, and without a process group (a 1 x 1 grid)."""
    if n_data < 1 or n_spatial < 1:
        raise ValueError(f"mesh {n_data}x{n_spatial}: both sizes must be >= 1")
    need = n_data * n_spatial
    world = dist.get_world_size() if dist.is_initialized() else 1
    if need > world:
        raise ValueError(f"mesh {n_data}x{n_spatial} needs {need} devices, have {world}")
    if not dist.is_initialized():
        return None
    world_group = None if need == world else dist.new_group(list(range(need)))
    spatial = [dist.new_group([d * n_spatial + s for s in range(n_spatial)])
               for d in range(n_data)]
    data = [dist.new_group([d * n_spatial + s for d in range(n_data)])
            for s in range(n_spatial)]
    rank = dist.get_rank()
    if rank >= need:
        return None
    return SpatialMesh(n_data, n_spatial, rank, world_group, spatial[rank // n_spatial],
                       data[rank % n_spatial])


def _part(size: int, parts: int, index: int, what: str, axis: str) -> slice:
    if size % parts:
        raise ValueError(f"{what} {size} not divisible by {parts} {axis} ranks")
    n = size // parts
    return slice(index * n, (index + 1) * n)


def data_rows(mesh: SpatialMesh, batch: int) -> slice:
    """This rank's rows of a global batch of `batch` rows."""
    return _part(batch, mesh.n_data, mesh.data_rank, "batch", "data")


def spatial_batch_sharding(mesh: SpatialMesh, batch: int, height: int
                           ) -> Tuple[slice, slice]:
    """This rank's (rows, H rows) of a global batch of `batch` images of
    height `height`: N over 'data', H over 'spatial'."""
    return (data_rows(mesh, batch),
            _part(height, mesh.n_spatial, mesh.spatial_rank, "height", "spatial"))
