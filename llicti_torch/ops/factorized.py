"""Fully-factorized learned prior (lossless EntropyBottleneck analog).

Port of ``llicti_tpu/ops/factorized.py``.  The reference subclasses
compressai's EntropyBottleneck with quantization disabled
(graphs/layers/entropy_layer_nets.py:12-56); it is vestigial in the live
model but part of the capability surface.  This is the univariate
monotone-MLP density of Balle et al. 2018, evaluated as a discrete
interval mass over the /255 grid.

Per channel c, the cumulative is
  c(x) = sigmoid(f_K(...f_1(x)))   with
  f_k(x) = x @ softplus(H_k) + b_k + tanh(a_k) * tanh(x @ softplus(H_k) + b_k)
which is monotone in x for any parameters.  The parameters carry the
Flax names: ``quantiles`` [C, 1, 3], ``H{k}`` [C, d_{k+1}, d_k], ``b{k}``
[C, d_{k+1}, 1] and ``a{k}`` [C, d_{k+1}, 1].
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .bounds import lower_bound
from .gmm import _sigmoid

HALF = 0.5 / 255.0
LIKELIHOOD_BOUND = 1e-9


class FactorizedPrior(nn.Module):
    """``seed`` draws the biases U(-0.5, 0.5) from
    ``np.random.default_rng(seed)``; the global RNG is not touched."""

    def __init__(self, channels: int, filters: Tuple[int, ...] = (3, 3, 3, 3),
                 init_scale: float = 10.0, tail_mass: float = 1e-9,
                 seed: int = 0):
        super().__init__()
        self.channels = channels
        self.filters = tuple(filters)
        self.tail_mass = tail_mass
        rng = np.random.default_rng(seed)
        C = channels
        self.quantiles = nn.Parameter(torch.tensor(
            [[[-init_scale, 0.0, init_scale]]] * C, dtype=torch.float32))
        dims = (1,) + self.filters + (1,)
        scale = init_scale ** (1 / (len(self.filters) + 1))
        self.K = len(dims) - 1
        for k in range(self.K):
            init_m = math.log(math.expm1(1.0 / scale / dims[k + 1]))
            self.register_parameter(f"H{k}", nn.Parameter(torch.full(
                (C, dims[k + 1], dims[k]), init_m)))
            self.register_parameter(f"b{k}", nn.Parameter(torch.from_numpy(
                rng.uniform(-0.5, 0.5, (C, dims[k + 1], 1)).astype(
                    np.float32))))
            if k < self.K - 1:
                self.register_parameter(f"a{k}", nn.Parameter(torch.zeros(
                    C, dims[k + 1], 1)))

    def _logits_cumulative(self, x: torch.Tensor,
                           stop_density: bool = False) -> torch.Tensor:
        """x: [C, 1, N] -> logits [C, 1, N]; with ``stop_density`` no
        gradient reaches the density parameters (H, b, a)."""
        sg = (lambda t: t.detach()) if stop_density else (lambda t: t)
        v = x
        for k in range(self.K):
            H = F.softplus(sg(getattr(self, f"H{k}")))
            v = torch.bmm(H, v) + sg(getattr(self, f"b{k}"))
            if k < self.K - 1:
                v = v + torch.tanh(sg(getattr(self, f"a{k}"))) * torch.tanh(v)
        return v

    def likelihood(self, x: torch.Tensor) -> torch.Tensor:
        """Discrete interval mass of x: [..., C] in the /255 domain."""
        C = self.channels
        flat = x.reshape(-1, C).T[:, None, :]  # [C, 1, N]
        upper = _sigmoid(self._logits_cumulative(flat + HALF))
        lower = _sigmoid(self._logits_cumulative(flat - HALF))
        p = (upper - lower)[:, 0, :]
        return lower_bound(p.T.reshape(x.shape), LIKELIHOOD_BOUND)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Self-information map: -log2 p(x)."""
        return -torch.log2(self.likelihood(x))

    def cdf_table(self, points: torch.Tensor) -> torch.Tensor:
        """Cumulative evaluated on a [P] grid -> [C, P] (for coding)."""
        C = self.channels
        pts = points[None, None, :].expand(C, 1, points.shape[0])
        return _sigmoid(self._logits_cumulative(pts))[:, 0, :]

    def loss(self) -> torch.Tensor:
        """Quantile aux loss (EntropyBottleneck.loss analog): pulls the
        learned quantiles to where the cumulative hits tail_mass/2, 0.5,
        and 1-tail_mass/2.  Density params are stopped so only the
        quantiles move (they only feed range estimation, not the rate)."""
        t = math.log(2.0 / self.tail_mass - 1.0)
        target = torch.tensor([-t, 0.0, t], dtype=torch.float32,
                              device=self.quantiles.device)
        logits = self._logits_cumulative(self.quantiles, stop_density=True)
        return torch.sum(torch.abs(logits - target[None, None, :]))

    def medians(self) -> torch.Tensor:
        """Learned per-channel median positions [C]."""
        return self.quantiles[:, 0, 1]
