"""Exact integer YCoCg-R lifting (JVT-I014r3) for the codec path.

Port of ``llicti_tpu/ops/color.py:41-81``.  Channels last: ``[..., 3]`` is
(R, G, B) or (Y, Co, Cg).  Floor-division lifting, so every value is
exact on any device.  The float (training) transform is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch


def _half(x: torch.Tensor) -> torch.Tensor:
    return torch.div(x, 2, rounding_mode="floor")


def rgb_int_to_ycocg_r_int(x: torch.Tensor) -> torch.Tensor:
    """Integer RGB in [0, 255] -> (Y, Co, Cg) int32; Y in [0, 255],
    Co and Cg in [-255, 255]."""
    x = x.to(torch.int32)
    R, G, B = x[..., 0], x[..., 1], x[..., 2]
    Co = R - B
    t = B + _half(Co)
    Cg = G - t
    Y = t + _half(Cg)
    return torch.stack((Y, Co, Cg), dim=-1)


def ycocg_r_int_to_rgb_int(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rgb_int_to_ycocg_r_int` (int32 RGB)."""
    x = x.to(torch.int32)
    Y, Co, Cg = x[..., 0], x[..., 1], x[..., 2]
    t = Y - _half(Cg)
    G = Cg + t
    B = t - _half(Co)
    R = B + Co
    return torch.stack((R, G, B), dim=-1)


def rgb_int_to_ycocg_r_int_np(x) -> np.ndarray:
    """Host twin of :func:`rgb_int_to_ycocg_r_int`, used for the container
    header (per-colour min/max) without touching the device."""
    x = np.asarray(x, dtype=np.int32)
    R, G, B = x[..., 0], x[..., 1], x[..., 2]
    Co = R - B
    t = B + Co // 2
    Cg = G - t
    Y = t + Cg // 2
    return np.stack((Y, Co, Cg), axis=-1)
