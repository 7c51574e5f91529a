"""Device milliseconds an image inside ``llicti.gdn`` (activfun GDN1): each
GDN1 application of the band nets (|x|, the dense 1x1 conv of the norm,
the division) in both directions, timed by the program's CUDA events at
the span's two ends.  None where the program times no such span."""
from llbench import spans


def read(o):
    return spans.device_ms(o, "llicti.gdn")
