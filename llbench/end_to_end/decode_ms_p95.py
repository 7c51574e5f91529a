"""The 95th percentile (nearest rank) of every decompress call of the
window (a 20 s window holds some 400, so about 20 lie beyond it),
host clock, the card synchronised on both sides."""
from llbench.trace import percentile


def read(o):
    if "decode_ms" not in o.window:
        return None
    return percentile(o.window["decode_ms"], 0.95)
