"""Median host milliseconds of the encoder's host header (YCoCg min / max
and the coarsest raw band, ``llicti_torch.codec.host_header``) on the
cell's first image, over 20 calls after the window."""
import statistics
import time

CALLS = 20


def read(o):
    img = o.extra.get("image")
    if img is None:
        return None
    try:
        from llicti_torch.codec import host_header
    except ImportError:
        return None
    levels = o.extra["config"]["model"]["dwtlevels"]
    times = []
    for _ in range(CALLS):
        t0 = time.perf_counter()
        host_header(img[None], levels)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)
