"""Kernel launches (no copies or fills) in the traced round trips, over
the images they coded."""


def read(o):
    t = o.trace
    if t is None or "batch" not in o.extra or not t.launches():
        return None
    return t.launches() / t.units
