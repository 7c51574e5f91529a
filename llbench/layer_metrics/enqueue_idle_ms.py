"""Idle milliseconds of the card an image while the host was enqueueing
the codec's device work or waiting for it: ``llicti.band``,
``llicti.interp``, ``llicti.kernel1`` to ``llicti.kernel3``,
``llicti.wavelet``, ``llicti.fetch`` or ``llicti.wait``, the innermost
program span open."""
from llbench import spans


def read(o):
    return spans.idle_ms(o.trace, "enqueue")
