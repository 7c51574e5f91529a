"""Host milliseconds an image inside ``llicti.halo``, on rank 0: each
exchange of the boundary rows a rank's layer-0 convs read from its
neighbours (``parallel/halo.py``), the collective's waits for the other
ranks included.  None where the program has no such span."""
from llbench import spans


def read(o):
    return spans.host_ms(o.trace, "llicti.halo")
