"""GMM bound constants and the CDF sampling grid.

Port of ``llicti_tpu/ops/gmm.py:28-33,87-98``.  Pixel values live in the
/255 domain.
"""
from __future__ import annotations

import numpy as np
import torch

HALF = 0.5 / 255.0
SCALE_BOUND_NORMAL = 0.11 / 255.0
SCALE_BOUND_LOGISTIC = 0.04
WEIGHT_BOUND = 1e-6
LIKELIHOOD_BOUND = 1e-9


def cdf_sampling_points(min_val: int, max_val: int,
                        tail: float = 20.0) -> torch.Tensor:
    """float32 ``[P]`` grid, P = max_val - min_val + 2: points at
    (k - 0.5)/255 for k in [min_val, max_val + 1], the two endpoints pushed
    out by ``tail``/255 to take in the tail mass.

    Computed in float32 as ``jnp.linspace`` writes it (start*(1-step) +
    stop*step, step = iota/div).  XLA reassociates and contracts that
    expression, so the JAX package's grid can differ from this one at some
    interior points, by up to two ulps of the grid's largest magnitude;
    the endpoints are equal.
    """
    n = max_val - min_val + 2
    start = np.float32(min_val - 0.5)
    stop = np.float32(max_val + 0.5)
    step = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
    pts = start * (np.float32(1.0) - step) + stop * step
    pts = np.concatenate([pts, [stop]]).astype(np.float32) / np.float32(255.0)
    pts[0] = np.float32((min_val - 0.5 - tail) / 255.0)
    pts[-1] = np.float32((max_val + 0.5 + tail) / 255.0)
    return torch.from_numpy(pts)
