"""Lazy wavelet (polyphase split) with pad flags, and its inverse.

Port of ``llicti_tpu/ops/wavelet.py:21-143``.  NHWC layout.  Bands per
scale are (x00, x11, x01, x10), concatenated channel-wise; odd sizes
replicate-pad x01/x10/x11 up to x00's size and record 2 bits per scale.
Every function here only slices, copies and concatenates, so results
equal the JAX package's bit for bit.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def _pad_edge(x: torch.Tensor, left: int, right: int, top: int,
              bottom: int) -> torch.Tensor:
    """Replicate-pad H and W of an NHWC tensor."""
    if left == right == top == bottom == 0:
        return x
    H, W = x.shape[1], x.shape[2]
    hi = torch.arange(-top, H + bottom, device=x.device).clamp_(0, H - 1)
    wi = torch.arange(-left, W + right, device=x.device).clamp_(0, W - 1)
    return x[:, hi][:, :, wi]


def lazy_dwt(x: torch.Tensor, levels: Sequence[int], pad: bool = False):
    """[B, H, W, C] -> y_list of [B, h, w, 4C] per level; with ``pad`` also
    (pad_flags per level, packed pad int)."""
    y_list = []
    pad_flags: List[Tuple[bool, bool]] = []
    pad_int = 0
    for lev in range(0, max(levels) + 1):
        if lev not in levels:
            continue
        st = 2 ** (lev + 1)
        of = st // 2
        x00 = x[:, 0::st, 0::st, :]
        x01 = x[:, 0::st, of::st, :]
        x10 = x[:, of::st, 0::st, :]
        x11 = x[:, of::st, of::st, :]
        if pad:
            padH = x00.shape[1] > x11.shape[1]
            padW = x00.shape[2] > x11.shape[2]
            pad_flags.append((padH, padW))
            pad_int = 4 * pad_int + 2 * int(padH) + int(padW)
            if padH and padW:
                x01 = _pad_edge(x01, 0, 1, 0, 0)
                x10 = _pad_edge(x10, 0, 0, 0, 1)
                x11 = _pad_edge(x11, 0, 1, 0, 1)
            elif padW:
                x01 = _pad_edge(x01, 0, 1, 0, 0)
                x11 = _pad_edge(x11, 0, 1, 0, 0)
            elif padH:
                x10 = _pad_edge(x10, 0, 0, 0, 1)
                x11 = _pad_edge(x11, 0, 0, 0, 1)
        y_list.append(torch.cat((x00, x11, x01, x10), dim=-1))
    if not pad:
        return y_list
    return y_list, pad_flags, pad_int


def interleave_bands(x00, x11, x01, x10) -> torch.Tensor:
    """Inverse polyphase interleave: [B,h,w,C] x4 -> [B,2h,2w,C]."""
    B, h, w, C = x00.shape
    top = torch.stack((x00, x01), dim=3).reshape(B, h, 2 * w, C)
    bot = torch.stack((x10, x11), dim=3).reshape(B, h, 2 * w, C)
    return torch.stack((top, bot), dim=2).reshape(B, 2 * h, 2 * w, C)


def interleave_scale(y_lev: torch.Tensor, c: int, crop_h: int = 0,
                     crop_w: int = 0) -> torch.Tensor:
    """[B,h,w,4c] (x00,x11,x01,x10 groups) -> [B,2h-crop_h,2w-crop_w,c]."""
    out = interleave_bands(y_lev[..., 0:c], y_lev[..., c:2 * c],
                           y_lev[..., 2 * c:3 * c], y_lev[..., 3 * c:4 * c])
    H, W = out.shape[1], out.shape[2]
    return out[:, :H - crop_h, :W - crop_w, :]


def unpack_pad_flags(pad_int: int,
                     num_scales: int) -> List[Tuple[bool, bool]]:
    """Unpack the 2-bit-per-scale pad flags of the container header."""
    flags = []
    v = int(pad_int)
    for _ in range(num_scales):
        padW = bool(v % 2)
        v //= 2
        padH = bool(v % 2)
        v //= 2
        flags.append((padH, padW))
    flags.reverse()
    return flags


def pad_decoded_band(x: torch.Tensor, band: int, padH: bool,
                     padW: bool) -> torch.Tensor:
    """Replicate-pad a decoded band (0 = x11, 1 = x01, 2 = x10) back to
    x00's size."""
    if padH and padW:
        if band == 1:
            return _pad_edge(x, 0, 1, 0, 0)
        if band == 2:
            return _pad_edge(x, 0, 0, 0, 1)
        return _pad_edge(x, 0, 1, 0, 1)
    if padW and band in (0, 1):
        return _pad_edge(x, 0, 1, 0, 0)
    if padH and band in (0, 2):
        return _pad_edge(x, 0, 0, 0, 1)
    return x


def band_coded_shape(h: int, w: int, band: int, padH: bool,
                     padW: bool) -> Tuple[int, int]:
    """Coded (h, w) of a band given x00's: the padded row/col is not
    entropy-coded."""
    ch = h - 1 if (padH and band in (0, 2)) else h
    cw = w - 1 if (padW and band in (0, 1)) else w
    return ch, cw
