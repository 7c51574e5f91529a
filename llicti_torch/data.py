"""Deterministic synthetic images for tests, smoke runs and measurements.

The port's own copy of ``synthetic_image`` from
``llicti_tpu/data/dataset.py:54-69``: the same seed gives the same bytes
in both packages.
"""
from __future__ import annotations

import numpy as np


def synthetic_image(h: int, w: int, seed: int) -> np.ndarray:
    """Natural-ish deterministic image: smooth fields + texture + noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f1, f2, f3 = rng.uniform(9, 31, 3)
    ph = rng.uniform(0, 6.28, 4)
    base = (
        120
        + 70 * np.sin(yy / f1 + ph[0]) * np.cos(xx / f2 + ph[1])
        + 45 * np.sin((xx + yy) / f3 + ph[2])
    )
    tex = 10 * np.sin(xx * 1.3 + ph[3]) * np.sin(yy * 1.7)
    img = np.stack(
        [base + tex, 0.85 * base + 25 + tex, 0.7 * base + 45], axis=-1)
    img = img + rng.normal(0, 5, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)
