"""The 95th percentile (nearest rank) of every compress call of the
window (a 20 s window holds some 400, so about 20 lie beyond it):
the benchmark's synchronised host spans around each call."""
from llbench.trace import percentile


def read(o):
    if "encode_ms" not in o.window:
        return None
    return percentile(o.window["encode_ms"], 0.95)
