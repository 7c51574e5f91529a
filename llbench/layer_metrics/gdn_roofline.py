"""GDN1's share (%) of its roofline in the traced round trips: the least
time of the GDN1 layers' work there (``gdn_work``: the reference's
operations and bytes on the same images; the larger of operations over
67 TFLOP/s and bytes over 3.35 TB/s) over the device time the program
timed inside ``llicti.gdn``.  None where either is missing."""
from llbench import spans, work


def read(o):
    units = o.extra.get("gdn_work")
    ms = spans.device_ms(o, "llicti.gdn")
    if not units or not ms:
        return None
    least_s = sum(work.bound_s(nbytes, flops) for flops, nbytes in units)
    return 100 * 1e3 * least_s / o.trace.units / ms
