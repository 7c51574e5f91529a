"""The lower-bound op (forward value).

Port of ``llicti_tpu/ops/bounds.py``: ``lower_bound(x, bound)`` is
``max(x, bound)``.  Its custom gradient (pass where ``x >= bound`` or the
gradient is negative) is training code and is not ported yet.
"""
from __future__ import annotations

import torch


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    return torch.clamp_min(x, bound)
