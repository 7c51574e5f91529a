"""GDN1 activation (l1 generalized divisive normalization).

Port of ``llicti_tpu/ops/gdn.py``:  y_c = x_c / (beta_c + sum_k gamma_ck |x_k|).
beta and gamma are stored through compressai's non-negative
parametrisation, param = sqrt(value + pedestal) and value =
lower_bound(param, bound)^2 - pedestal, with pedestal = eps^2 and bound =
sqrt(minimum + pedestal), so the Flax parameters carry over as they are.
The channel axis is dim 1 (NCHW), where the JAX module's is the last.

The effective beta and gamma are constants of a pass that records no
gradient: the codec computes them once, when it is built
(:meth:`GDN1.hold`), where a call would redo the lower bound, the square
and the subtraction over the C x C gamma each time.  A forward that
records a gradient (training) computes them from the stored parameters
in every call, so that the gradient reaches them through
``lower_bound``.  Each application is the span ``llicti.gdn``, timed on
the device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..tracing import span
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
        # (beta, gamma as a 1x1 conv kernel), held by :meth:`hold`
        self.held: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def effective(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The effective beta ``[C]`` and gamma as a 1x1 conv kernel ``[C,
        C, 1, 1]``, from the stored parameters."""
        return (_reparam(self.beta, self.beta_min),
                _reparam(self.gamma, 0.0)[:, :, None, None])

    def hold(self) -> None:
        """Compute the effective beta and gamma once, on the parameters'
        device, for every later call that records no gradient; call it
        after the module is on its device and its parameters are final."""
        with torch.no_grad():
            self.held = self.effective()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("llicti.gdn", x.device):
            if self.held is not None and not torch.is_grad_enabled():
                beta, gamma = self.held
            else:
                beta, gamma = self.effective()
            # |x| @ gamma.T + beta over the channel axis, as a 1x1 conv
            norm = F.conv2d(torch.abs(x), gamma, beta)
            return x / norm
