"""Lower-bound op with compressai's straight-through-ish gradient.

Port of ``llicti_tpu/ops/bounds.py``.  Forward: ``max(x, bound)``.
Backward: the gradient passes where ``x >= bound``, or where it is
negative (a descent step would then push x back up to the bound), and is
0 elsewhere.  ``torch.clamp_min``'s own gradient drops the negative
gradients below the bound, so the op is a ``torch.autograd.Function``.
Where no gradient is recorded (inference mode, ``no_grad``, a tensor that
does not require one: the codec's passes) it is ``clamp_min`` alone.
"""
from __future__ import annotations

import torch


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, bound: float) -> torch.Tensor:
        ctx.save_for_backward(x >= bound)
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (passes,) = ctx.saved_tensors
        return torch.where(passes | (g < 0), g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _LowerBound.apply(x, bound)
    return torch.clamp_min(x, bound)
