"""Idle milliseconds of the card an image while ``llicti.seq`` was the
innermost program span open: the host enqueueing a colour's sequential
convs and trunk.  ``spans.layer`` charges it to the band loop, so in a
cell that takes the sequential path it is a part of ``enqueue_idle_ms``.
None where the traced stretch holds no such span."""
from llbench import spans

SPAN = "llicti.seq"


def read(o):
    by_span = spans.idle_by_span(o.trace)
    if by_span is None or not any(n == SPAN for n, _, _
                                  in spans.program_spans(o.trace)):
        return None
    return by_span.get(SPAN, 0.0) / 1e3 / o.trace.units
