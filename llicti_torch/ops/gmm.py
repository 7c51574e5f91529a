"""Discrete Gaussian (or logistic) mixture model of a pixel value.

Port of ``llicti_tpu/ops/gmm.py``.  Pixel values live in the /255 domain;
a value v has the probability mass of [v - 0.5/255, v + 0.5/255] under the
mixture.  Scales are lower-bounded at 0.11/255 (normal) or 0.04
(logistic), mixture weights at 1e-6 and then renormalised (not a
softmax), the likelihood at 1e-9.  The CDF tables of the host backend's
range coder are evaluated on :func:`cdf_sampling_points` and quantised to
its uint16 contract by :func:`cdf_float_to_uint16`.  The bounds pass
gradients as the JAX package's ``lower_bound`` does (``ops/bounds.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from .bounds import lower_bound

HALF = 0.5 / 255.0
SCALE_BOUND_NORMAL = 0.11 / 255.0
SCALE_BOUND_LOGISTIC = 0.04
WEIGHT_BOUND = 1e-6
LIKELIHOOD_BOUND = 1e-9
_SQRT2_INV = 2 ** -0.5


def standardized_cumulative(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF as 0.5 * erfc(-x / sqrt 2)."""
    return 0.5 * torch.special.erfc(-_SQRT2_INV * x)


def _sigmoid(z: torch.Tensor) -> torch.Tensor:
    # jax.nn.sigmoid lowers to 1 / (1 + exp(-z)) (stablehlo negate,
    # exponential, add, divide); torch.sigmoid rounds differently
    return 1.0 / (1.0 + torch.exp(-z))


def _sum(t: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """Sum over the mixtures of ``dim`` one by one, left to right, the
    order of XLA's reduce, so that the host backend's uint16 tables round
    like the JAX package's wherever the two frameworks' exp and erfc
    agree (torch.sum's order doubles the entries that differ)."""
    acc = t.select(dim, 0)
    for x in range(1, t.shape[dim]):
        acc = acc + t.select(dim, x)
    return acc.unsqueeze(dim) if keepdim else acc


def _mix_likelihood(values, scales, weights, logistic: bool = False):
    """Mixture-weighted interval mass: values (y - mu), scales and weights
    ``[..., M, X]`` -> ``[..., M]``; weights normalised by their plain
    sum."""
    if logistic:
        scales = lower_bound(scales, SCALE_BOUND_LOGISTIC)
        upper = _sigmoid((values + HALF) / scales)
        lower = _sigmoid((values - HALF) / scales)
    else:
        scales = lower_bound(scales, SCALE_BOUND_NORMAL)
        values = torch.abs(values)
        upper = standardized_cumulative((HALF - values) / scales)
        lower = standardized_cumulative((-HALF - values) / scales)
    w = lower_bound(weights, WEIGHT_BOUND)
    w = w / _sum(w, -1, keepdim=True)
    return _sum(w * (upper - lower), -1)


def gmm_self_information(y: torch.Tensor, scales: torch.Tensor,
                         means: torch.Tensor, weights: torch.Tensor,
                         num_mix: int, *,
                         logistic: bool = False) -> torch.Tensor:
    """-log2 p(y) under the discrete mixture.  y ``[..., M]``;
    scales / means / weights ``[..., M * X]`` m-major (channel m holds slots
    m*X .. (m+1)*X - 1), X = ``num_mix``."""
    shape = y.shape + (num_mix,)
    values = y[..., None] - means.reshape(shape)
    p = _mix_likelihood(values, scales.reshape(shape),
                        weights.reshape(shape), logistic)
    return -torch.log2(lower_bound(p, LIKELIHOOD_BOUND))


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


def gmm_cdf_table(points: torch.Tensor, scales: torch.Tensor,
                  means: torch.Tensor, weights: torch.Tensor, *,
                  logistic: bool = False) -> torch.Tensor:
    """Float mixture CDF at ``points`` [P] for every pixel: scales / means /
    weights ``[..., X]`` (one colour) -> ``[..., P]``.  The weights are
    normalised by 1e-9 + their sum (unlike :func:`_mix_likelihood`)."""
    scales = lower_bound(
        scales, SCALE_BOUND_LOGISTIC if logistic else SCALE_BOUND_NORMAL)
    w = lower_bound(weights, WEIGHT_BOUND)
    w = w / (1e-9 + _sum(w, -1, keepdim=True))
    z = (points - means[..., None]) / scales[..., None]  # [..., X, P]
    cdf_mix = _sigmoid(z) if logistic else standardized_cumulative(z)
    return _sum(w[..., None] * cdf_mix, -2)


def cdf_float_to_uint16(cdf: torch.Tensor) -> torch.Tensor:
    """Quantise a float CDF ``[..., P]`` in [0, 1] to the range coder's
    uint16 contract: round(cdf * (2^16 - (P - 1))), a running max (against
    a one-ulp dip of the float CDF, which would give an empty interval),
    plus the column index, modulo 2^16; the last entry wraps to 0 and is
    read as 2^16."""
    P = cdf.shape[-1]
    new_max = float(2 ** 16 - (P - 1))
    q = torch.round(cdf.clamp(0.0, 1.0) * new_max).to(torch.int32)
    q = torch.cummax(q, dim=-1).values
    q = q + torch.arange(P, dtype=torch.int32, device=q.device)
    return (q & 0xFFFF).to(torch.uint16)


def cdf_float_to_cum_int32(cdf: torch.Tensor) -> torch.Tensor:
    """Quantise a float CDF ``[..., P]`` to the device coder's int32 table
    (``llicti_tpu/coder/rans_device.py:45``): the uint16 contract's
    quantisation, running max and column index, kept in int32 with the last
    entry exactly 2^16."""
    P = cdf.shape[-1]
    new_max = float(2 ** 16 - (P - 1))
    q = torch.round(cdf.clamp(0.0, 1.0) * new_max).to(torch.int32)
    q = torch.cummax(q, dim=-1).values
    q = q + torch.arange(P, dtype=torch.int32, device=q.device)
    q[..., -1] = 1 << 16
    return q


def cum_start_freq(cum: torch.Tensor, y: torch.Tensor, minv: int):
    """The encoder's (start, freq) int32 ``[n]`` from int32 tables ``cum``
    ``[n, P]`` at the symbols of values ``y`` ``[n]`` (/255 domain, range
    minimum ``minv``), each symbol clipped to [0, P - 2] as the JAX
    package's one-hot lookup clips it (``llicti_tpu/codec.py:372-381``)."""
    sym = (torch.round(y * 255.0).to(torch.int32) - minv).clamp(
        0, cum.shape[-1] - 2).long()[:, None]
    lo = cum.gather(1, sym)[:, 0]
    return lo, cum.gather(1, sym + 1)[:, 0] - lo
