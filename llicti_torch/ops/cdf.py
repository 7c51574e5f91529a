"""Kernels 1 and 4: quantised GMM CDF tables.

Kernel 1 ports ``llicti_tpu/ops/cdf_pallas.py:gmm_cdf_from_pmap_pallas``
(normal and logistic mixtures, the codec's table + the encoder's (start,
freq)); Kernel 4 ports ``gmm_cdf_table_int32_pallas`` (normal mixtures,
pre-sliced parameters, the table alone).  :func:`gmm_cdf_from_pmap` and
:func:`gmm_cdf_table_int32` run ``csrc/cdf_pmap.cu`` and
``csrc/cdf_table.cu`` (device code in ``csrc/cdf.cuh``) on CUDA tensors;
the ``*_plain`` versions, the same computations in plain PyTorch, run on
CPU tensors.  Kernel and plain version agree within one quantisation step:
they evaluate ``exp`` with different libraries.  Encoder and decoder
always share one of them, so each side's tables are identical.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from .bounds import lower_bound
from .gmm import (SCALE_BOUND_LOGISTIC, SCALE_BOUND_NORMAL, WEIGHT_BOUND,
                  _sigmoid, cdf_float_to_cum_int32, cum_start_freq)

_SQRT2_INV = np.float32(2 ** -0.5)
# Abramowitz-Stegun 7.1.26 erf coefficients (|err| < 1.5e-7)
_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_P = 0.3275911


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32, device=like.device)


def _erf_as(x: torch.Tensor) -> torch.Tensor:
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + _f32(_P, x) * ax)
    poly = _f32(_A[4], x)
    for a in (_A[3], _A[2], _A[1], _A[0]):
        poly = _f32(a, x) + t * poly
    poly = t * poly
    return s * (1.0 - poly * torch.exp(-ax * ax))


def _phi(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + _erf_as(z * _f32(_SQRT2_INV, z)))


def _normalise(w: torch.Tensor) -> torch.Tensor:
    """w / (1e-9 + sum w) along the last axis, summed left to right."""
    wsum = w[:, 0]
    for x in range(1, w.shape[1]):
        wsum = wsum + w[:, x]
    return w / (_f32(1e-9, w) + wsum)[:, None]


def _spec_ints(upd: Sequence[Tuple[int, int]]):
    if len(upd) > 2:
        raise ValueError(f"at most 2 mean updates, got {len(upd)}")
    flat = [v for pair in upd for v in pair]
    return len(upd), flat + [0] * (4 - len(flat))


def _check_f32(device, **tensors):
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")


def _check_points(points):
    if points.dim() != 1 or points.shape[0] < 2:
        raise ValueError(f"points must be [P >= 2], got {tuple(points.shape)}")


def _check(points, pmap, y, M, std0, mean0, w0, upd, sym_ch):
    _check_f32(pmap.device, points=points, pmap=pmap, y=y)
    _check_points(points)
    if pmap.dim() != 2 or y.dim() != 2 or pmap.shape[0] != y.shape[0]:
        raise ValueError(f"pmap [n, CO] and y [n, YC] expected, got "
                         f"{tuple(pmap.shape)} and {tuple(y.shape)}")
    CO, YC = pmap.shape[1], y.shape[1]
    cols = [std0 + M, mean0 + M, w0 + M] + [c + M for c, _ in upd]
    if min([std0, mean0, w0] + [c for c, _ in upd]) < 0 or max(cols) > CO:
        raise ValueError(f"pmap columns out of range for CO={CO}")
    if not all(0 <= ch < YC for ch in [sym_ch] + [h for _, h in upd]):
        raise ValueError(f"y channel out of range for YC={YC}")


def gmm_cdf_from_pmap_plain(points, pmap, y, M, std0, mean0, w0, upd,
                            logistic, sym_ch, minv):
    """Plain PyTorch version of :func:`gmm_cdf_from_pmap` (same operations
    in the same order)."""
    bound = SCALE_BOUND_LOGISTIC if logistic else SCALE_BOUND_NORMAL
    std = lower_bound(pmap[:, std0:std0 + M], bound)
    w = _normalise(lower_bound(pmap[:, w0:w0 + M], WEIGHT_BOUND))
    mean = pmap[:, mean0:mean0 + M]
    for coef0, ych in upd:
        mean = mean + pmap[:, coef0:coef0 + M] * y[:, ych:ych + 1]
    inv = 1.0 / std
    cdf = _sigmoid if logistic else _phi
    acc = torch.zeros((pmap.shape[0], points.shape[0]), dtype=torch.float32,
                      device=pmap.device)
    for x in range(M):
        z = (points[None, :] - mean[:, x:x + 1]) * inv[:, x:x + 1]
        acc = acc + w[:, x:x + 1] * cdf(z)
    q = cdf_float_to_cum_int32(acc)
    return (q,) + cum_start_freq(q, y[:, sym_ch], minv)


def gmm_cdf_from_pmap(points: torch.Tensor, pmap: torch.Tensor,
                      y: torch.Tensor, M: int, std0: int, mean0: int,
                      w0: int, upd: Sequence[Tuple[int, int]] = (),
                      logistic: bool = False, sym_ch: int = 0,
                      minv: int = 0):
    """int32 cum table and encoder (start, freq) from the conv's param map.

    points ``[P]`` float32; pmap ``[n, CO]`` float32, channel-minor rows as
    the conv gives them; y ``[n, YC]`` float32, the conditioning tensor.
    ``M`` mixtures whose std, mean and weight start at columns ``std0``,
    ``mean0`` and ``w0``; ``upd`` holds up to two (coef_col, y_channel)
    pairs, each doing ``mean += pmap[:, coef_col:coef_col+M] * y[:, ych]``.
    ``logistic`` selects logistic mixtures (scale bound 0.04) over normal
    ones (scale bound 0.11/255).

    Returns (cum ``[n, P]`` int32, strictly increasing rows with
    ``cum[:, -1] == 2**16``; start ``[n]``; freq ``[n]``), the latter two
    looked up at symbol ``round(y[:, sym_ch]*255) - minv`` clipped to
    ``[0, P-2]``.  CPU tensors take the plain version; CUDA tensors launch
    the kernel.
    """
    upd = tuple(upd)
    _check(points, pmap, y, M, std0, mean0, w0, upd, sym_ch)
    if pmap.device.type == "cpu":
        return gmm_cdf_from_pmap_plain(points, pmap, y, M, std0, mean0, w0,
                                       upd, logistic, sym_ch, minv)
    n, CO = pmap.shape
    P = points.shape[0]
    if n * P >= 1 << 31:
        # a batch's rows (K images' pixels) stay below 2^31 table entries
        raise ValueError(f"{n} rows x {P} points: one launch takes fewer "
                         "than 2^31 table entries")
    cum = torch.empty((n, P), dtype=torch.int32, device=pmap.device)
    start = torch.empty((n,), dtype=torch.int32, device=pmap.device)
    freq = torch.empty((n,), dtype=torch.int32, device=pmap.device)
    n_upd, (c0, h0, c1, h1) = _spec_ints(upd)
    bound = SCALE_BOUND_LOGISTIC if logistic else SCALE_BOUND_NORMAL
    err = _kernels.lib().llicti_cdf_pmap(
        points.data_ptr(), pmap.data_ptr(), y.data_ptr(), cum.data_ptr(),
        start.data_ptr(), freq.data_ptr(), n, P, CO, y.shape[1], M, std0,
        mean0, w0, n_upd, c0, h0, c1, h1, sym_ch, minv, int(logistic),
        ctypes.c_float(np.float32(bound)), _kernels.stream_ptr(pmap.device))
    _kernels.check(err, "llicti_cdf_pmap")
    if n > 0:
        gmm_cdf_from_pmap.launches += 1
        gmm_cdf_from_pmap.logistic_launches += int(logistic)
        gmm_cdf_from_pmap.launches_by_mixtures[M] += 1
    return cum, start, freq


gmm_cdf_from_pmap.launches = 0            # every launch of Kernel 1
gmm_cdf_from_pmap.logistic_launches = 0   # those of its logistic branch
# launches by mixture terms M (clr_joint_mode 1 codes Y with 2M):
# reset with ``.clear()``
gmm_cdf_from_pmap.launches_by_mixtures = collections.Counter()


def gmm_cdf_table_int32_plain(points, stdevs, means, weights):
    """Plain PyTorch version of :func:`gmm_cdf_table_int32` (same
    operations in the same order)."""
    X = stdevs.shape[-1]
    lead = stdevs.shape[:-1]
    std = lower_bound(stdevs.reshape(-1, X), SCALE_BOUND_NORMAL)
    w = _normalise(lower_bound(weights.reshape(-1, X), WEIGHT_BOUND))
    mean = means.reshape(-1, X)
    acc = torch.zeros((std.shape[0], points.shape[0]), dtype=torch.float32,
                      device=std.device)
    for x in range(X):
        z = (points[None, :] - mean[:, x:x + 1]) / std[:, x:x + 1]
        acc = acc + w[:, x:x + 1] * _phi(z)
    return cdf_float_to_cum_int32(acc).reshape(lead + (points.shape[0],))


def gmm_cdf_table_int32(points: torch.Tensor, stdevs: torch.Tensor,
                        means: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """int32 cum table of normal mixtures with pre-sliced parameters.

    points ``[P]`` float32; stdevs, means, weights ``[..., X]`` float32.
    Returns ``[..., P]`` int32 with strictly increasing rows and
    ``cum[..., -1] == 2**16``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel.
    """
    _check_f32(stdevs.device, points=points, stdevs=stdevs, means=means,
               weights=weights)
    _check_points(points)
    if (not stdevs.dim() or stdevs.shape[-1] < 1
            or not stdevs.shape == means.shape == weights.shape):
        raise ValueError(f"stdevs, means, weights [..., X] expected, got "
                         f"{tuple(stdevs.shape)}, {tuple(means.shape)}, "
                         f"{tuple(weights.shape)}")
    if stdevs.device.type == "cpu":
        return gmm_cdf_table_int32_plain(points, stdevs, means, weights)
    X = stdevs.shape[-1]
    n = stdevs.numel() // X
    P = points.shape[0]
    cum = torch.empty(stdevs.shape[:-1] + (P,), dtype=torch.int32,
                      device=stdevs.device)
    err = _kernels.lib().llicti_cdf_table(
        points.data_ptr(), stdevs.data_ptr(), means.data_ptr(),
        weights.data_ptr(), cum.data_ptr(), n, P, X,
        _kernels.stream_ptr(stdevs.device))
    _kernels.check(err, "llicti_cdf_table")
    if n > 0:
        gmm_cdf_table_int32.launches += 1
    return cum


gmm_cdf_table_int32.launches = 0


def saturation_mismatches(device) -> int:
    """Float inputs, of all 2^32, on which the kernels' shortcut for a
    saturated normal mixture term (Phi exactly 0 or 1) differs from the full
    formula on the card ``device``; 0 for the kernels to be exact."""
    bad = torch.zeros((1,), dtype=torch.int64, device=device)
    _kernels.check(_kernels.lib().llicti_cdf_check_saturation(
        bad.data_ptr(), _kernels.stream_ptr(bad.device)),
        "llicti_cdf_check_saturation")
    return int(bad[0])


def pmap_occupancy(M: int, logistic: bool) -> Tuple[int, int]:
    """(resident blocks per SM, threads per block) of Kernel 1 at ``M``."""
    threads = ctypes.c_int(0)
    blocks = _kernels.lib().llicti_cdf_pmap_occupancy(
        M, int(logistic), ctypes.addressof(threads))
    return blocks, threads.value
