"""Device milliseconds an image inside ``llicti.seq`` (clrjnt0seqmd): each
colour's sequential convs and trunk pass (``Interpolator.params_from_base``)
in both directions, timed by the program's CUDA events at the span's two
ends.  None where the program times no such span."""
from llbench import spans


def read(o):
    return spans.device_ms(o, "llicti.seq")
