"""Host milliseconds an image inside ``llicti.wait``: the codec's waits
for the card (the synchronisation of each fetch)."""
from llbench import spans


def read(o):
    return spans.host_ms(o.trace, "llicti.wait")
