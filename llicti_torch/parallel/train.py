"""Data- and spatially parallel training step over ``torch.distributed``.

Port of ``llicti_tpu/parallel/train.py``, where GSPMD inserts the
gradient reduction and the halo exchanges.  Here the step is the port's
single-device step (``training/steps.py``) on this rank's part of each
microbatch (B over the data ranks, H over the spatial ranks): the local
rate is normalised by the *global* subpixel count, so after the
microbatch loop the gradients of every rank summed over the world are
the whole batch's; they are all-reduced (SUM) in one flat buffer, divided
by the number of microbatches as JAX orders it, clipped, and Adam takes
its step on every rank alike.  The metrics are all-reduced too, so every
rank sees the same loss.  The step builder puts the model in
channels-last, as the single-device one does; the flat buffer holds each
gradient in its logical order.  (DDP averages over its group, which does
not express the spatial ranks' partial sums.)
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from ..tracing import entry, span
from ..training.steps import accumulate, apply_gradients, to_channels_last
from .distributed import all_reduce_sum
from .mesh import Mesh, replicated


def shard_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                mesh: Mesh) -> None:
    """Replicate the parameters and the optimiser's state across the mesh:
    rank 0's, broadcast, in place.  Call it before the step is built, while
    the tensors are contiguous."""
    put = replicated(mesh)
    put(model.parameters())
    put(t for state in optimizer.state.values() for t in state.values()
        if torch.is_tensor(t))


def make_parallel_train_step(model: nn.Module,
                             optimizer: torch.optim.Optimizer, mesh: Mesh,
                             clip_value: float = 5.0
                             ) -> Callable[[torch.Tensor],
                                           Dict[str, torch.Tensor]]:
    """Returns step(batch) -> metrics, which updates the model in place.

    batch: this rank's part ``[acc, B / data, H / spatial, W, 3]`` of the
    global batch (``mesh.batch_sharding(mesh, has_acc_axis=True)`` cuts
    it), on the model's device; every rank of the mesh calls the step.
    metrics: {"loss", "breakdown"} of the global batch, equal on every
    rank.  Puts the model and the optimiser's state in channels-last
    (``training.steps.to_channels_last``).
    """
    to_channels_last(model, optimizer)
    params = list(model.parameters())

    def step(batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        with entry("llicti.step"):
            acc = batch.shape[0]
            optimizer.zero_grad(set_to_none=True)
            loss_sum, bd_sum = accumulate(model, batch, batch[0].numel()
                                          * mesh.size, mesh.halo)
            with span("llicti.allreduce"), torch.no_grad():
                grads = [p.grad if p.grad is not None
                         else torch.zeros_like(p) for p in params]
                flat = all_reduce_sum(torch.cat([g.reshape(-1)
                                                 for g in grads]))
                for p, g, f in zip(params, grads,
                                   flat.split([g.numel() for g in grads])):
                    p.grad = g.copy_(f.view_as(g)).div_(acc)
                metrics = all_reduce_sum(torch.cat((loss_sum[None],
                                                    bd_sum.reshape(-1))))
            with span("llicti.optimizer", batch.device):
                apply_gradients(optimizer, clip_value)
            return {"loss": metrics[0] / acc,
                    "breakdown": metrics[1:].reshape(bd_sum.shape) / acc}

    return step
