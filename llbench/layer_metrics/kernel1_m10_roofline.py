"""The share (%) of their roofline of Kernel 1's launches of ten mixture
terms in the traced round trips: the least time of their work
(``llbench/work.py``'s ``cdf_work`` on the reference's counts of the ten
-term slices of the same images, ``work_m10``) over those launches'
device time.  None where either is missing."""
from llbench.layer_metrics.kernel1_m10_ms import KERNEL1_M10


def read(o):
    least = o.extra.get("work_m10")
    if o.trace is None or not least:
        return None
    s, n = o.trace.group_s(KERNEL1_M10)
    if not n:
        return None
    return 100 * sum(least) / s
