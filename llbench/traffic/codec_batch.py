"""One client in a closed loop coding same-size tiles: ``compress_batch``
of K distinct images into one batch container, then
``decompress_batch``.  The generator and its checks are
:mod:`llbench.traffic.codec_roundtrip`'s with ``batch`` = K."""
from __future__ import annotations

from ..cell import Context, Outcome
from . import codec_roundtrip


def run(ctx: Context) -> Outcome:
    if ctx.params["batch"] < 2:
        raise ValueError("a batch container cell codes K >= 2 images a call")
    return codec_roundtrip.run(ctx)
