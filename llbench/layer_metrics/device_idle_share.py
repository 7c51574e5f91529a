"""The share (%) of the traced units' wall time in which no kernel ran:
1 - the union of the kernels' intervals over the traced stretch."""


def read(o):
    t = o.trace
    if t is None or not t.window_s:
        return None
    return 100 * (1 - t.busy_s / t.window_s)
