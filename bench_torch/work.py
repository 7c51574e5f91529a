"""The work each hand kernel needs, and the least time the card could take.

The one definition of the kernels' work counts in the repository:
``chip_smoke.py`` and the benchmark's traced run both count with these
functions.  A count is of what the function needs on its inputs, whatever
the kernel re-reads: each input byte read once, each output byte written
once, and the float operations the arithmetic needs.  Where the work
depends on the data (a mixture term whose erf saturates, the words a
stream holds), the caller passes what these inputs need.

:func:`bound` turns (bytes, operations) into milliseconds over the H100
SXM's published peaks (NVIDIA's data sheet, dense, at the 700 W limit):
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores
(495 TFLOP/s in TF32 on them).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from llicti_torch.ops import cdf
from llicti_torch.ops.bounds import lower_bound
from llicti_torch.ops.gmm import SCALE_BOUND_NORMAL

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# float operations of one mixture term: the normal one in full and with
# its saturation shortcut taken (z, the add; csrc/cdf.cuh); the logistic one
NORMAL_OPS, NORMAL_SAT_OPS = 24, 4
LOGISTIC_OPS = 8
ENTRY_OPS = 3  # clamp, scale, round of each table entry
STATE_BYTES = 16  # a lane's int64 state, read and written


def bound(nbytes: float, flops: float,
          flop_per_s: float = F32_FLOP_PER_S) -> Tuple[float, str]:
    """(least ms the card could take, what sets it: "bytes" or
    "operations")."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / flop_per_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def cdf_pmap_saturated(pts: torch.Tensor, pm: torch.Tensor,
                       y2: torch.Tensor, spec) -> int:
    """Normal mixture terms of Kernel 1 on these inputs whose erf
    saturates (|z| / sqrt(2) > 10.5, the shortcut of csrc/cdf.cuh)."""
    M, s0, m0, _, upd = spec
    std = lower_bound(pm[:, s0:s0 + M], SCALE_BOUND_NORMAL)
    mean = pm[:, m0:m0 + M]
    for coef0, ych in upd:
        mean = mean + pm[:, coef0:coef0 + M] * y2[:, ych:ych + 1]
    inv = 1.0 / std
    sat = 0
    for x in range(M):
        z = (pts[None, :] - mean[:, x:x + 1]) * inv[:, x:x + 1]
        sat += int(((z * cdf._SQRT2_INV).abs() > 10.5).sum())
    return sat


def cdf_pmap_work(rows: int, P: int, spec, sym_ch: int, saturated: int,
                  logistic: bool) -> Tuple[int, int]:
    """(bytes, float operations) of Kernel 1 on ``rows`` pixels at ``P``
    points: per pixel the M * (3 + n_upd) parameter channels and the y
    channels it reads, the table row and (start, freq) it writes, and the
    points; each normal term in full unless it saturates, each logistic
    term in full, and each entry's quantisation."""
    M, _, _, _, upd = spec
    entries = rows * P
    if logistic:
        flops = entries * (M * LOGISTIC_OPS + ENTRY_OPS)
    else:
        flops = ((entries * M - saturated) * NORMAL_OPS
                 + saturated * NORMAL_SAT_OPS + entries * ENTRY_OPS)
    y_read = len({ych for _, ych in upd} | {sym_ch})
    nbytes = 4 * (rows * (M * (3 + len(upd)) + y_read + P + 2) + P)
    return nbytes, flops


def cdf_table_saturated(pts: torch.Tensor, stdevs: torch.Tensor,
                        means: torch.Tensor) -> int:
    """Saturated normal terms of Kernel 4 on pre-sliced parameters."""
    z = (pts[None, None, None, None, :] - means[..., None]) \
        / lower_bound(stdevs, SCALE_BOUND_NORMAL)[..., None]
    return int(((z * cdf._SQRT2_INV).abs() > 10.5).sum())


def cdf_table_work(rows: int, P: int, X: int,
                   saturated: int) -> Tuple[int, int]:
    """(bytes, float operations) of Kernel 4: three parameters of each of
    the X mixtures a pixel read, the points read, the table written."""
    flops = ((rows * P * X - saturated) * NORMAL_OPS
             + saturated * NORMAL_SAT_OPS + rows * P * ENTRY_OPS)
    return 4 * (3 * rows * X + P + rows * P), flops


def rans_decode_bytes(symbols: int, P: int, words: int, lanes: int) -> int:
    """Kernel 2: per symbol the ceil(log2(P + 1)) table entries a search
    reads and the symbol written; the words read; each lane's state read
    and written (``lanes`` = K images x N)."""
    return (4 * symbols * (math.ceil(math.log2(P + 1)) + 1) + 4 * words
            + STATE_BYTES * lanes)


def rans_encode_bytes(symbols: int, words: int, lanes: int) -> int:
    """Kernel 3: each symbol's (start, freq) read, the words written, each
    lane's state read and written."""
    return 8 * symbols + 4 * words + STATE_BYTES * lanes

