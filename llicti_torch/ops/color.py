"""YCoCg-R lifting colour transform (JVT-I014r3).

Port of ``llicti_tpu/ops/color.py``.  Channels last: ``[..., 3]`` is
(R, G, B) or (Y, Co, Cg).  The codec path uses the exact integer lifting
(floor division, exact on any device); the rate estimate uses the float
lifting, rounded to ``rndfactor`` steps half to even as ``jnp.round``
rounds.
"""
from __future__ import annotations

import numpy as np
import torch


def ieee_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as one IEEE division on every device.  PyTorch's
    CUDA kernels multiply by the reciprocal of a Python-number divisor,
    which can land an ulp off the quotient, and a value an ulp off a
    rounding tie (of the lifting, of a quantised mean) then rounds the
    other way than on the CPU and in the JAX package."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def rgb_to_ycocg_r(x: torch.Tensor,
                   rndfactor: float = 255.0) -> torch.Tensor:
    """Float forward lifting of RGB in [0, 1]."""
    R, G, B = x[..., 0], x[..., 1], x[..., 2]
    Co = R - B
    t = B + ieee_div(torch.round(Co * rndfactor / 2), rndfactor)
    Cg = G - t
    Y = t + ieee_div(torch.round(Cg * rndfactor / 2), rndfactor)
    return torch.stack((Y, Co, Cg), dim=-1)


def ycocg_r_to_rgb(x: torch.Tensor, rndfactor: float = 255.0) -> torch.Tensor:
    """Float inverse lifting of :func:`rgb_to_ycocg_r`."""
    Y, Co, Cg = x[..., 0], x[..., 1], x[..., 2]
    t = Y - ieee_div(torch.round(Cg * rndfactor / 2), rndfactor)
    G = Cg + t
    B = t - ieee_div(torch.round(Co * rndfactor / 2), rndfactor)
    R = B + Co
    return torch.stack((R, G, B), dim=-1)


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
