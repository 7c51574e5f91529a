"""Idle milliseconds of the card a unit of work (an image, or a step)
that no layer's span names: the innermost program span open is an entry
span (``llicti.compress``, ``llicti.decompress``, ``llicti.step``), or
none is open."""
from llbench import spans


def read(o):
    return spans.idle_ms(o.trace, "unspanned")
