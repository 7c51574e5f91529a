"""The device mesh of data- and spatially parallel training and rate.

Port of ``llicti_tpu/parallel/mesh.py``.  The mesh is the process group:
``data`` x ``spatial`` ranks laid out row-major (rank = d * spatial + s).

* ``data``: the batch splits over the data index, the parameters stay
  replicated and the gradients are summed over every rank after the
  backward (``parallel/train.py``).
* ``spatial``: a rank's images are a block of rows; the layer-0 convs
  read their neighbours' boundary rows through :func:`halo.halo_rows` in
  the rank's spatial subgroup (GSPMD inserts those exchanges in JAX).

:func:`batch_sharding` cuts a global host batch to this rank's part;
:func:`replicated` makes tensors equal across the mesh by a broadcast
from rank 0.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist

from .distributed import broadcast_, rank, world_size
from .halo import halo_rows


@dataclass(frozen=True)
class Mesh:
    """A (data, spatial) layout of the process group's ranks."""
    data: int
    spatial: int
    rank: int
    spatial_group: Optional[object]  # this rank's spatial subgroup

    @property
    def size(self) -> int:
        return self.data * self.spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    @property
    def halo(self) -> Optional[Callable]:
        """The models' halo exchange over this rank's spatial subgroup, or
        None without spatial sharding (the single-device pads)."""
        if self.spatial == 1:
            return None
        return functools.partial(halo_rows, group=self.spatial_group)


def make_mesh(data: Optional[int] = None, spatial: int = 1) -> Mesh:
    """A (data, spatial) mesh over the process group (one process alone is
    a mesh of one); ``data`` defaults to world // spatial.  ValueError
    unless data x spatial is the world size.  Every rank must call it, in
    the same order as its other meshes (it makes the spatial subgroups)."""
    world = world_size()
    if spatial < 1 or world % spatial:
        raise ValueError(f"spatial={spatial} does not divide the "
                         f"{world} ranks")
    if data is None:
        data = world // spatial
    if data * spatial != world:
        raise ValueError(
            f"a data={data} x spatial={spatial} mesh needs {data * spatial} "
            f"ranks, the process group has {world} (start one process a "
            "card with torchrun --nproc_per_node=N)")
    group = None
    if spatial > 1 and world > 1:
        for d in range(data):  # every rank makes every subgroup
            g = dist.new_group([d * spatial + s for s in range(spatial)])
            if d == rank() // spatial:
                group = g
    return Mesh(data, spatial, rank(), group)


def batch_sharding(mesh: Mesh, has_acc_axis: bool = False
                   ) -> Callable[[object], object]:
    """A function that cuts a global ``[*(acc), B, H, W, C]`` batch (numpy
    or tensor) to this rank's part: B over the data index, H over the
    spatial index.  ValueError unless both divide evenly."""
    b_axis = 1 if has_acc_axis else 0

    def cut(batch):
        B, H = batch.shape[b_axis], batch.shape[b_axis + 1]
        if B % mesh.data or H % mesh.spatial:
            raise ValueError(f"a batch of {B} images of {H} rows does not "
                             f"split over data={mesh.data} x "
                             f"spatial={mesh.spatial}")
        b, h = B // mesh.data, H // mesh.spatial
        idx = [slice(None)] * batch.ndim
        idx[b_axis] = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
        idx[b_axis + 1] = slice(mesh.spatial_index * h,
                                (mesh.spatial_index + 1) * h)
        return batch[tuple(idx)]

    return cut


def replicated(mesh: Mesh) -> Callable[[Iterable[torch.Tensor]], None]:
    """A function that makes tensors replicated over the mesh: each is
    overwritten in place with rank 0's."""
    del mesh  # every rank of the process group is in the mesh

    def put(tensors: Iterable[torch.Tensor]) -> None:
        with torch.no_grad():
            for t in tensors:
                broadcast_(t, 0)

    return put
