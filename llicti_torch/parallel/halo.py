"""Halo rows of a spatially sharded image: the boundary rows a rank's
layer-0 convs read from its neighbours.

GSPMD inserts these exchanges in the JAX package; here they are written
out.  Only layer 0 of an interpolator has a kernel taller than one row
(Ev x Ev, Od x Ev, Ev x Od; every later layer is 1x1), and its replicate
pads are at most Ev // 2 rows a side, so one exchange of that many rows
a side per band is the whole halo.  At the image's top and bottom the
halo is the replicate rows ``F.pad(..., mode="replicate")`` gives the
single-device model, so a sharded forward reads exactly the values the
unsharded one reads.

:func:`halo_rows` is differentiable: its backward sends each halo row's
gradient back to the rank that owns the row and adds it there (the
replicate rows' into the image's first and last rows).  Each call is
the span ``llicti.halo`` (its host time includes the collective's waits
for the other ranks).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..tracing import span
from .distributed import all_gather_rows, all_reduce_sum, rank, world_size


def _sources(r: int, n: int, h: int, edge: int, top: int,
             bottom: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where rank ``r``'s halo rows lie in the gathered edges: index into
    the rows of ``[n, 2 (head, tail), edge]``, for the ``top`` rows above
    its block and the ``bottom`` rows below it (clamped to the image: the
    replicate rows)."""
    def src(j: int) -> int:
        q, l = divmod(min(max(j, 0), n * h - 1), h)
        if l < edge:
            return (2 * q) * edge + l
        return (2 * q + 1) * edge + l - (h - edge)

    return (torch.tensor([src(j) for j in range(r * h - top, r * h)],
                         dtype=torch.long),
            torch.tensor([src(j) for j in range((r + 1) * h,
                                                (r + 1) * h + bottom)],
                         dtype=torch.long))


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top: int, bottom: int, group):
        n, r, h = world_size(group), rank(group), x.shape[1]
        edge = min(h, max(top, bottom))
        # every rank's first and last ``edge`` rows: [B, 2n * edge, ...]
        edges = all_gather_rows(torch.cat((x[:, :edge], x[:, h - edge:]),
                                          dim=1), dim=1, group=group)
        up, down = _sources(r, n, h, edge, top, bottom)
        up, down = up.to(x.device), down.to(x.device)
        ctx.save_for_backward(up, down)
        ctx.meta = (n, r, h, edge, top, group)
        return torch.cat((edges[:, up], x, edges[:, down]), dim=1)

    @staticmethod
    def backward(ctx, g):
        up, down = ctx.saved_tensors
        n, r, h, edge, top, group = ctx.meta
        gx = g[:, top:top + h].clone()
        # each halo row's gradient at its source row, summed over the
        # group: rank r's sources are rows [2r * edge, (2r + 2) * edge)
        sent = torch.zeros(g.shape[:1] + (2 * n * edge,) + g.shape[2:],
                           dtype=g.dtype, device=g.device)
        sent.index_add_(1, up, g[:, :top])
        sent.index_add_(1, down, g[:, top + h:])
        all_reduce_sum(sent, group)
        mine = sent[:, 2 * r * edge:(2 * r + 2) * edge]
        gx[:, :edge] += mine[:, :edge]
        gx[:, h - edge:] += mine[:, edge:]
        return gx, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int,
              group=None) -> torch.Tensor:
    """This rank's row block ``x`` ``[B, h, W, C]`` with ``top`` rows of
    the block above it and ``bottom`` rows of the block below it:
    ``[B, top + h + bottom, W, C]``.  The group's ranks hold consecutive
    blocks of one height, in rank order; above the first block and below
    the last come replicate rows.  A group of one (or no process group)
    exchanges nothing and equals ``F.pad`` replicate on the rows.  Every
    rank of the group must call it with the same shapes."""
    if top < 0 or bottom < 0 or x.dim() != 4 or x.shape[1] < 1:
        raise ValueError("halo_rows takes [B, h >= 1, W, C] and rows >= 0")
    with span("llicti.halo"):
        if world_size(group) == 1:
            h = x.shape[1]
            rows = torch.arange(-top, h + bottom,
                                device=x.device).clamp_(0, h - 1)
            return x[:, rows]
        return _Halo.apply(x, top, bottom, group)
