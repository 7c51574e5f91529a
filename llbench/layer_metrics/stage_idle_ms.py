"""Idle milliseconds of the card an image while the host was in the
codec's staging: ``llicti.stage`` (its host header included),
``llicti.unpack`` and ``llicti.upload``, the innermost program span open."""
from llbench import spans


def read(o):
    return spans.idle_ms(o.trace, "stage")
