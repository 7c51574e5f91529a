"""Process-group bootstrap and the collectives of the multi-device path.

Port of ``llicti_tpu/parallel/distributed.py``.  A JAX mesh is a list of
devices driven by one controller; here it is a ``torch.distributed``
process group with one process a card (``torchrun --nproc_per_node=N``),
or one process alone, which holds every shard itself.

The device is this process's card unless the caller asks for ``"cpu"``;
without a card :func:`initialize` and :func:`default_device` raise, as
``Codec`` and ``Trainer`` do.  Backends: ``nccl`` when the device is
CUDA, ``gloo`` on the CPU, unless the caller names one.  gloo has no
CUDA ``all_gather``, ``send`` or ``recv``, so under gloo every helper
here copies a CUDA tensor to pinned host memory, runs the collective
there and copies the result back (an explicit branch on the backend, not
a fallback).  Without a process group (or in a group of one) every
helper returns its input unchanged.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# how long a collective may wait for its peers before the group aborts
TIMEOUT = datetime.timedelta(minutes=10)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: str = "cuda") -> bool:
    """Join the process group, as ``jax.distributed.initialize`` does.

    With arguments, ``coordinator_address`` ("host:port") is rank 0's
    rendezvous, ``num_processes`` the world size and ``process_id`` this
    rank; without them ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) says the same.  With
    neither there is nothing to join: returns False, a single process.
    ``device`` is the card unless the caller passes "cpu"; without a
    card RuntimeError, before any group is made.  ``backend`` defaults to
    ``nccl`` on the card and ``gloo`` on the CPU; a CUDA process takes
    card ``LOCAL_RANK`` (or its rank modulo the cards it sees).  A
    collective that waits longer than :data:`TIMEOUT` for its peers
    fails.
    Re-entry is a no-op.  Returns True when the world has more than one
    process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(
            "initialize() joins on the CUDA card by default and none is "
            "available; pass device='cpu' to join on the CPU (gloo)")
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=num_processes, rank=process_id)
        rank = process_id
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init = dict(init_method="env://")
        rank = int(os.environ["RANK"])
    else:
        log.debug("no process group to join; single process")
        return False
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend=backend, timeout=TIMEOUT, **init)
    return dist.get_world_size() > 1


def world_size(group=None) -> int:
    """Processes in ``group`` (the world by default); 1 without a group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in ``group``; 0 without a group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def default_device(device="cuda") -> torch.device:
    """This process's card (the one :func:`initialize` selected), or the
    CPU when the caller asks for "cpu"; RuntimeError without a card."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def comm_device(group=None) -> torch.device:
    """Where a collective on host values runs: this process's card under
    nccl, the CPU otherwise."""
    if not _single(group) and dist.get_backend(group) == "nccl":
        return default_device()
    return torch.device("cpu")


def local_batch_slice(global_batch: int) -> slice:
    """The slice of a global batch owned by this process (even split)."""
    n, i = world_size(), rank()
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


# ---- collectives ---------------------------------------------------------

def _single(group) -> bool:
    return world_size(group) == 1


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a collective on ``t`` goes through host memory: CUDA
    tensors under gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if _single(group):
        return t
    if _staged(t, group):
        h = _host(t)
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the group, in place; returns ``t``."""
    return _reduce(t, dist.ReduceOp.SUM, group)


def all_reduce_minmax(mins: Sequence[int], maxs: Sequence[int],
                      group=None) -> Tuple[List[int], List[int]]:
    """(the smallest of each of ``mins``, the largest of each of
    ``maxs``) over the group, as host ints."""
    dev = comm_device(group)
    lo = torch.tensor(list(mins), dtype=torch.int64, device=dev)
    hi = torch.tensor(list(maxs), dtype=torch.int64, device=dev)
    _reduce(lo, dist.ReduceOp.MIN, group)
    _reduce(hi, dist.ReduceOp.MAX, group)
    return lo.tolist(), hi.tolist()


def all_gather_rows(x: torch.Tensor, dim: int = 1,
                    group=None) -> torch.Tensor:
    """The group's tensors of one shape concatenated along ``dim`` in rank
    order (each rank's row block -> the whole image)."""
    if _single(group):
        return x
    src = _host(x) if _staged(x, group) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def all_gather_bytes(blobs: Sequence[bytes], group=None) -> List[bytes]:
    """Every rank's ``blobs`` (any count and lengths, the same count on
    every rank), concatenated in rank order: the lengths first, then one
    gather of the blobs zero-padded to the longest rank's bytes."""
    if _single(group):
        return list(blobs)
    dev = comm_device(group)
    lens = torch.tensor([len(b) for b in blobs], dtype=torch.int64,
                        device=dev)
    all_lens = all_gather_rows(lens[None], 0, group).cpu().numpy()
    width = int(all_lens.sum(axis=1).max())
    buf = np.zeros((1, max(width, 1)), np.uint8)
    flat = b"".join(blobs)
    buf[0, :len(flat)] = np.frombuffer(flat, np.uint8)
    rows = all_gather_rows(torch.from_numpy(buf).to(dev), 0,
                           group).cpu().numpy()
    out = []
    for row, sizes in zip(rows, all_lens):
        ends = np.cumsum(sizes)
        out += [row[e - s:e].tobytes() for s, e in zip(sizes, ends)]
    return out


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` overwritten, in place, with rank ``src``'s."""
    if _single(group):
        return t
    if _staged(t, group):
        h = _host(t)
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t


def broadcast_float(v: float, src: int = 0, group=None) -> float:
    """Rank ``src``'s value of a host float."""
    t = torch.tensor([v], dtype=torch.float64, device=comm_device(group))
    return float(broadcast_(t, src, group)[0])
