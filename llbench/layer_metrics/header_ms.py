"""Host milliseconds an image inside ``llicti.host_header`` (YCoCg min /
max and the coarsest raw band) in the traced round trips: the program's
own timing of what ``host_header_ms`` times from outside."""
from llbench import spans


def read(o):
    return spans.host_ms(o.trace, "llicti.host_header")
