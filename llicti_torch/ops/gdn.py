"""GDN1 activation (l1 generalized divisive normalization).

Port of ``llicti_tpu/ops/gdn.py``:  y_c = x_c / (beta_c + sum_k gamma_ck |x_k|).
beta and gamma are stored through compressai's non-negative
parametrisation, param = sqrt(value + pedestal) and value =
lower_bound(param, bound)^2 - pedestal, with pedestal = eps^2 and bound =
sqrt(minimum + pedestal), so the Flax parameters carry over as they are.
The channel axis is dim 1 (NCHW), where the JAX module's is the last.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .bounds import lower_bound

_PEDESTAL = (2 ** -18) ** 2


def gdn_init(channels: int,
             gamma_init: float = 0.1) -> Tuple[np.ndarray, np.ndarray]:
    """Stored (beta, gamma) of a fresh GDN1, float32 as the JAX init makes
    them: the parametrisation of beta = 1 and gamma = gamma_init * I."""
    ped = np.float32(_PEDESTAL)

    def param(value):
        return np.sqrt(np.maximum(value + ped, ped)).astype(np.float32)

    return (param(np.ones((channels,), np.float32)),
            param(np.float32(gamma_init) * np.eye(channels,
                                                  dtype=np.float32)))


def _reparam(param: torch.Tensor, minimum: float) -> torch.Tensor:
    bound = (minimum + _PEDESTAL) ** 0.5
    return lower_bound(param, bound) ** 2 - _PEDESTAL


class GDN1(nn.Module):
    """l1-GDN over the channels of an NCHW tensor."""

    def __init__(self, channels: int, beta_min: float = 1e-6,
                 gamma_init: float = 0.1):
        super().__init__()
        self.beta_min = beta_min
        beta, gamma = gdn_init(channels, gamma_init)
        self.beta = nn.Parameter(torch.from_numpy(beta))
        self.gamma = nn.Parameter(torch.from_numpy(gamma))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta = _reparam(self.beta, self.beta_min)
        gamma = _reparam(self.gamma, 0.0)
        # |x| @ gamma.T + beta over the channel axis, as a 1x1 conv
        norm = F.conv2d(torch.abs(x), gamma[:, :, None, None], beta)
        return x / norm
