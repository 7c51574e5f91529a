"""Sharded rate estimation for large images (the context-parallel
analogue).

Port of ``llicti_tpu/parallel/eval.py``.  A batch's differentiable rate
with B split over the mesh's ``data`` ranks and H over its ``spatial``
ranks: each rank runs the rate forward on its part, its layer-0 convs
reading the neighbouring ranks' boundary rows (``halo.halo_rows``), and
the self-information sums are added up over every rank, normalised by the
global number of subpixels, as ``rate_loss_list`` normalises the whole
batch's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..training.loss import rate_loss_list
from .distributed import all_reduce_sum
from .mesh import Mesh, batch_sharding


def make_sharded_rate_fn(model, mesh: Mesh):
    """Returns run(x) -> (total, breakdown [S, 9]) for a global batch
    ``x`` ``[B, H, W, 3]`` in [0, 1] (numpy or a tensor), the same on
    every rank; every rank of the mesh calls it with the same batch.  B
    must split over the data ranks and H over the spatial ranks into
    blocks of a multiple of the coarsest stride (ValueError)."""
    cut = batch_sharding(mesh)
    device = next(model.parameters()).device

    def run(x):
        numel = int(np.prod(x.shape))
        local = cut(x)
        local = (torch.from_numpy(np.ascontiguousarray(local))
                 if isinstance(local, np.ndarray) else local)
        with torch.no_grad():
            si = model(local.to(device), mesh.halo)
            total, breakdown = rate_loss_list(numel, si)
            both = all_reduce_sum(torch.cat((total[None],
                                             breakdown.reshape(-1))))
        return both[0], both[1:].reshape(breakdown.shape)

    return run
