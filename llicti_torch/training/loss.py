"""Rate losses with per-(scale, band, color) breakdown.

Port of ``llicti_tpu/training/loss.py`` (reference
graphs/losses/rate_dist.py:79-135).  Rates are "bits per subpixel x 3"
(numel counts all 3 subpixels), matching the reference's logging
convention so numbers are directly comparable.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def rate_loss_list(numel_x: int, si_list: Sequence[torch.Tensor]):
    """Differentiable total rate + per-scale/band/color breakdown.

    Returns (total_rate scalar, breakdown [S, 9] tensor; [S, 3] for one
    colour).  The breakdown is differentiable too; callers detach it for
    logging (reference rate_dist.py:97-104 detaches via .item()).
    """
    rows = [si.sum(dim=(0, 1, 2)) / numel_x * 3 for si in si_list]
    total = rows[0].sum()
    for row in rows[1:]:
        total = total + row.sum()
    return total, torch.stack(rows)


def rate_distortion_loss(x, x_hat, si_list, lambda_: float):
    """Legacy lossy R + lambda*D objective (reference rate_dist.py:14-58,
    kept for capability parity; the lossless path uses rate_loss_list)."""
    rate, _ = rate_loss_list(x.numel(), si_list)
    mse = torch.mean((x - x_hat) ** 2)
    return rate + lambda_ * mse, mse, rate


def compression_rate_list(numel_x: int, streams) -> np.ndarray:
    """Actual bpp breakdown from bytestream lengths (incl. header row).

    Reference: rate_dist.py:125-135.  Returns [S+1, 9]; row 0 is the
    header group.
    """
    rows = []
    for group in streams:
        rows.append([len(s) * 8 / numel_x * 3 for s in group])
    return np.asarray(rows)
