"""Train and eval steps: grad accumulation, value clipping, Adam.

Port of ``llicti_tpu/training/steps.py``.  Semantics match the reference
agent (agents/llicti_agent.py:48-83): per-microbatch gradients of the
total rate are summed, then divided by the number of microbatches (the
JAX package's order), gradient values clipped element-wise at
``clip_value`` (torch ``clip_grad_value_``, reference
llicti_agent.py:65), then one Adam step (beta 0.9 / 0.999, eps 1e-8: the
optax defaults).  A Python loop over the leading microbatch axis takes the
place of the JAX package's ``lax.scan``.  The learning rate lives on the
optimiser's parameter group, so the plateau scheduler sets it between
steps (:func:`set_learning_rate`).

The step builders put the model in channels-last memory format
(:func:`to_channels_last`): the bands are NHWC, so cuDNN then runs the
interpolator's convs on them as they are, with no NCHW <-> NHWC
transposes around each conv.  The forward and backward run with cuDNN's
TF32 off (:func:`fp32_convs`), whatever the caller's flags: float32
convs, as the codec's (``codec.exact_math``).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Tuple

import torch
from torch import nn

from ..tracing import entry, span
from .loss import rate_loss_list


def make_optimizer(model: nn.Module,
                   learning_rate: float) -> torch.optim.Adam:
    """Adam over the model's parameters, with optax's defaults."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def to_channels_last(model: nn.Module,
                     optimizer: torch.optim.Optimizer) -> None:
    """Put the model's conv kernels, and the Adam state already held for
    them, in ``torch.channels_last``, in place.  The ``Parameter`` objects
    stay, so an optimiser built over them still holds them."""
    model.to(memory_format=torch.channels_last)
    for state in optimizer.state.values():
        for key, value in state.items():
            if torch.is_tensor(value) and value.dim() == 4:
                state[key] = value.contiguous(
                    memory_format=torch.channels_last)


@contextlib.contextmanager
def fp32_convs() -> Iterator[None]:
    """cuDNN's TF32 off for the duration; the caller's value comes back on
    exit, also after an exception.  cuDNN picks a conv's kernel when the
    conv is enqueued, so the context covers the backward's enqueue too."""
    cudnn = torch.backends.cudnn
    tf32 = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = tf32


def apply_gradients(optimizer: torch.optim.Optimizer,
                    clip_value: float = 5.0) -> None:
    """Clip the gradients (``.grad``) of the optimiser's parameters
    element-wise at +-``clip_value``, then take its step: optax's
    ``chain(clip(clip_value), adam(lr))``."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    with torch.no_grad():
        for p in params:
            if p.grad is None:  # optax updates every leaf, zeros too
                p.grad = torch.zeros_like(p)
        torch.nn.utils.clip_grad_value_(params, clip_value)
    optimizer.step()


def accumulate(model: nn.Module, batch: torch.Tensor, numel: int,
               halo=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of each microbatch of ``batch`` ``[acc, B, H, W, 3]``:
    its rate over ``numel`` subpixels (a microbatch's own, or the global
    batch's when ``batch`` is a rank's part of it, with ``halo`` the
    rank's row exchange), its gradients summed into ``.grad``, in float32
    convs (:func:`fp32_convs`).  -> (the rates' sum, the breakdowns' sum),
    detached."""
    cfg = model.cfg
    # breakdown width: 3 bands x colors (9 for clrchs=3, 3 for the
    # single-channel clrchs<3 variants)
    width = 9 if cfg.clrchs == 3 else 3
    loss_sum = torch.zeros((), device=batch.device)
    bd_sum = torch.zeros((cfg.num_scales, width), device=batch.device)
    with fp32_convs():
        for xb in batch:
            with span("llicti.forward", xb.device):
                total, bd = rate_loss_list(numel, model(xb, halo))
            with span("llicti.backward", xb.device):
                total.backward()  # sums into .grad across microbatches
            loss_sum = loss_sum + total.detach()
            bd_sum = bd_sum + bd.detach()
    return loss_sum, bd_sum


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    clip_value: float = 5.0
                    ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """Returns step(batch) -> metrics, which updates the model in place.

    batch: [acc, B, H, W, 3] on the model's device; the leading axis is
    the grad-accumulation microbatch (acc=1 for plain steps).
    metrics: {"loss": scalar mean rate, "breakdown": [S, 9] mean}, device
    tensors (reading them waits for the step).  Puts the model and the
    optimiser's state in channels-last (:func:`to_channels_last`).
    """
    to_channels_last(model, optimizer)
    params = list(model.parameters())

    def step(batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        with entry("llicti.step"):
            acc = batch.shape[0]
            optimizer.zero_grad(set_to_none=True)
            loss_sum, bd_sum = accumulate(model, batch, batch[0].numel())
            with span("llicti.optimizer", batch.device):
                with torch.no_grad():
                    for p in params:
                        if p.grad is not None:
                            p.grad.div_(acc)
                apply_gradients(optimizer, clip_value)
            return {"loss": loss_sum / acc, "breakdown": bd_sum / acc}

    return step


def make_eval_step(model: nn.Module
                   ) -> Callable[[torch.Tensor],
                                 Tuple[torch.Tensor, torch.Tensor]]:
    """Returns eval_step(batch [B, H, W, 3]) -> (total, breakdown), with no
    gradient recorded."""

    def eval_step(batch: torch.Tensor):
        with torch.no_grad():
            return rate_loss_list(batch.numel(), model(batch))

    return eval_step
