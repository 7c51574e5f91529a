"""The work of the codec's hand kernels and of the model's forward, and the
least time one H100 could take for it.

A frozen copy of the port's work counts (``bench_torch/work.py`` at the
commit that added this benchmark), with the three constants it took from
the port written out here.  A count is of what the computation needs on
its inputs, whatever a kernel reads again: each input byte read once,
each output byte written once, and the float operations the arithmetic
needs.  Where the work depends on the data (a mixture term whose erf
saturates, the words a stream holds), the caller passes what the
reference counted on the same images.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): 3.35
TB/s of HBM3, 67 TFLOP/s of float32 outside the tensor cores, 495
TFLOP/s of TF32 on them.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# float operations of one normal mixture term, in full and with its
# saturation shortcut taken (z and the add)
NORMAL_OPS, NORMAL_SAT_OPS = 24, 4
ENTRY_OPS = 3  # clamp, scale and round of each table entry
STATE_BYTES = 16  # a lane's state, read and written as int64


def bound_s(nbytes: float, flops: float,
            flop_per_s: float = F32_FLOP_PER_S) -> float:
    """The least seconds the card could take: the larger of bytes over
    the memory's rate and operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)


def cdf_work(rows: int, P: int, spec, sym_ch: int,
             saturated: int) -> Tuple[int, int]:
    """(bytes, float operations) of Kernel 1 on ``rows`` pixels at ``P``
    points: per pixel the M (3 + updates) parameter columns and the y
    channels it reads, the table row and (start, freq) it writes, and the
    points; each normal term in full unless it saturates, and each
    entry's quantisation."""
    M, _, _, _, upd = spec
    entries = rows * P
    flops = ((entries * M - saturated) * NORMAL_OPS
             + saturated * NORMAL_SAT_OPS + entries * ENTRY_OPS)
    y_read = len({ych for _, ych in upd} | {sym_ch})
    nbytes = 4 * (rows * (M * (3 + len(upd)) + y_read + P + 2) + P)
    return nbytes, flops


def rans_decode_bytes(symbols: int, P: int, words: int, lanes: int) -> int:
    """Kernel 2 on one slice: per symbol the ceil(log2(P + 1)) table
    entries a binary search reads and the symbol written; the words read;
    each lane's state read and written (``lanes`` = K images x N)."""
    return (4 * symbols * (math.ceil(math.log2(P + 1)) + 1) + 4 * words
            + STATE_BYTES * lanes)


def rans_encode_bytes(symbols: int, words: int, lanes: int) -> int:
    """Kernel 3 on a chain: each symbol's (start, freq) read, the words
    written, each lane's state read and written."""
    return 8 * symbols + 4 * words + STATE_BYTES * lanes


def conv_flops(h: int, w: int, cin: int, cout: int, kh: int, kw: int,
               groups: int) -> int:
    """2 x multiply-adds of a stride-1 conv with an h x w output."""
    return 2 * h * w * cout * (cin // groups) * kh * kw


def forward_flops(keys: dict, H: int, W: int) -> int:
    """Float operations of the interpolators' convs over one H x W image
    (padded up to the coarsest stride), as one rate forward or one codec
    pass runs them: per scale and band, layer 0's convs on the band's
    conditioning units, then the grouped 1x1 trunk.  From the
    configuration's published widths alone (three joint colours: units of
    3 channels, 4 trunk groups of chs channels, 12 M parameters)."""
    levels: Sequence[int] = keys["dwtlevels"]
    M, c, grps = keys["num_mixtures"], 3, 4
    owner = levels[0]
    total = 0
    for s, lev in enumerate(levels):
        if s > 0 and not keys["useprevlevNN"][s]:
            owner = lev
        st = 2 ** (lev + 1)
        h, w = -(-H // st), -(-W // st)
        Ch, Co = grps * keys["chs"][owner], 12 * M
        Ev, Od = keys["evens"][owner], keys["odds"][owner]
        kernels = {0: [(Ev, Ev)], 1: [(Od, Ev), (Ev, Od)],
                   2: [(Ev, Od), (Od, Ev), (Ev, Ev)]}
        for b in range(3):
            for kh, kw in kernels[b]:
                total += conv_flops(h, w, c, Ch, kh, kw, 1)
            for _ in range(keys["conv_layers"] - 2):
                total += conv_flops(h, w, Ch, Ch, 1, 1, grps)
            total += conv_flops(h, w, Ch, Co, 1, 1, grps)
    return total
