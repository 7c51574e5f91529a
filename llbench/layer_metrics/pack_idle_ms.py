"""Idle milliseconds of the card an image while the host was packing the
container (``llicti.pack``: the cursor check, the streams, the header)."""
from llbench import spans


def read(o):
    return spans.idle_ms(o.trace, "pack")
