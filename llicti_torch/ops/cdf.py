"""Kernel 1: the quantised GMM CDF table + the encoder's (start, freq).

Port of ``llicti_tpu/ops/cdf_pallas.py:gmm_cdf_from_pmap_pallas`` (normal
mixtures).  :func:`gmm_cdf_from_pmap` runs ``csrc/cdf_pmap.cu`` on CUDA
tensors and :func:`gmm_cdf_from_pmap_plain`, the same computation in
plain PyTorch, on CPU tensors.  The two agree within one quantisation
step: they evaluate ``exp`` with different libraries.  Encoder and
decoder always share one of them, so each side's tables are identical.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from .gmm import SCALE_BOUND_NORMAL, WEIGHT_BOUND

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


def _spec_ints(upd: Sequence[Tuple[int, int]]):
    if len(upd) > 2:
        raise ValueError(f"at most 2 mean updates, got {len(upd)}")
    flat = [v for pair in upd for v in pair]
    return len(upd), flat + [0] * (4 - len(flat))


def _check(points, pmap, y, M, std0, mean0, w0, upd, sym_ch):
    for name, t in (("points", points), ("pmap", pmap), ("y", y)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != pmap.device:
            raise ValueError(f"{name} on {t.device}, pmap on {pmap.device}")
    if points.dim() != 1 or points.shape[0] < 2:
        raise ValueError(f"points must be [P >= 2], got {tuple(points.shape)}")
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
                            sym_ch, minv):
    """Plain PyTorch version of :func:`gmm_cdf_from_pmap` (same operations
    in the same order)."""
    P = points.shape[0]
    std = torch.clamp_min(pmap[:, std0:std0 + M], SCALE_BOUND_NORMAL)
    w = torch.clamp_min(pmap[:, w0:w0 + M], WEIGHT_BOUND)
    wsum = w[:, 0]
    for x in range(1, M):
        wsum = wsum + w[:, x]
    w = w / (_f32(1e-9, w) + wsum)[:, None]
    mean = pmap[:, mean0:mean0 + M]
    for coef0, ych in upd:
        mean = mean + pmap[:, coef0:coef0 + M] * y[:, ych:ych + 1]
    inv = 1.0 / std
    acc = torch.zeros((pmap.shape[0], P), dtype=torch.float32,
                      device=pmap.device)
    for x in range(M):
        z = (points[None, :] - mean[:, x:x + 1]) * inv[:, x:x + 1]
        acc = acc + w[:, x:x + 1] * _phi(z)
    new_max = float(2 ** 16 - (P - 1))
    q = torch.round(acc.clamp(0.0, 1.0) * new_max).to(torch.int32)
    q = torch.cummax(q, dim=1).values
    q = q + torch.arange(P, dtype=torch.int32, device=q.device)
    q[:, -1] = 1 << 16
    sym = torch.round(y[:, sym_ch] * 255.0).to(torch.int32) - minv
    sym = sym.clamp(0, P - 2).long()[:, None]
    lo = q.gather(1, sym)[:, 0]
    hi = q.gather(1, sym + 1)[:, 0]
    return q, lo, hi - lo


def gmm_cdf_from_pmap(points: torch.Tensor, pmap: torch.Tensor,
                      y: torch.Tensor, M: int, std0: int, mean0: int,
                      w0: int, upd: Sequence[Tuple[int, int]] = (),
                      sym_ch: int = 0, minv: int = 0):
    """int32 cum table and encoder (start, freq) from the conv's param map.

    points ``[P]`` float32; pmap ``[n, CO]`` float32, channel-minor rows as
    the conv gives them; y ``[n, YC]`` float32, the conditioning tensor.
    ``M`` mixtures whose std, mean and weight start at columns ``std0``,
    ``mean0`` and ``w0``; ``upd`` holds up to two (coef_col, y_channel)
    pairs, each doing ``mean += pmap[:, coef_col:coef_col+M] * y[:, ych]``.

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
                                       upd, sym_ch, minv)
    if pmap.device.type != "cuda":
        raise ValueError(f"no kernel for device {pmap.device}")
    n, CO = pmap.shape
    P = points.shape[0]
    cum = torch.empty((n, P), dtype=torch.int32, device=pmap.device)
    start = torch.empty((n,), dtype=torch.int32, device=pmap.device)
    freq = torch.empty((n,), dtype=torch.int32, device=pmap.device)
    n_upd, (c0, h0, c1, h1) = _spec_ints(upd)
    err = _kernels.lib().llicti_cdf_pmap(
        points.data_ptr(), pmap.data_ptr(), y.data_ptr(), cum.data_ptr(),
        start.data_ptr(), freq.data_ptr(), n, P, CO, y.shape[1], M, std0,
        mean0, w0, n_upd, c0, h0, c1, h1, sym_ch, minv,
        _kernels.stream_ptr(pmap.device))
    _kernels.check(err, "llicti_cdf_pmap")
    if n > 0:
        gmm_cdf_from_pmap.launches += 1
    return cum, start, freq


gmm_cdf_from_pmap.launches = 0
