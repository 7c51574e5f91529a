"""Arithmetic of the metrics that read the program's own spans
(``llicti.*``, ``llicti_torch/tracing.py``): the device's idle time put
down to the innermost span the host was in, host time inside a span, and
the device time the program timed for a span.

Every quantity is a unit's (an image, or a step): over ``trace.units``.
A reader finds nothing, and gives None, where the traced stretch holds no
``llicti.*`` span (a program without them).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

PREFIX = "llicti."
# the spans of a public call: idle time under one of them and no child
# lies outside every layer's span
ENTRY = ("llicti.compress", "llicti.decompress", "llicti.step")
# the codec's host work on the container before its device work
STAGE = ("llicti.stage", "llicti.host_header", "llicti.unpack",
         "llicti.upload")
# the codec's host work on the container after its device work
PACK = ("llicti.pack",)


def program_spans(trace) -> List[Tuple[str, float, float]]:
    """The program's spans that overlap the traced stretch."""
    return [(n, a, b) for n, a, b in trace.host
            if n.startswith(PREFIX) and b > trace.start_us
            and a < trace.end_us]


def idle_intervals(trace) -> List[Tuple[float, float]]:
    """The stretch's instants at which no kernel runs: the complement of
    the busy intervals inside it."""
    out, t = [], trace.start_us
    for a, b in trace.busy_intervals():
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if trace.end_us > t:
        out.append((t, trace.end_us))
    return out


def innermost(spans, start: float, end: float
              ) -> List[Tuple[float, float, Optional[str]]]:
    """[start, end] cut at every span edge inside it: (from, to, name of
    the innermost span open there, None where none is).  The innermost of
    the spans open is the one opened last (of two opened together, the
    shorter)."""
    edges = sorted({start, end} | {x for _, a, b in spans for x in (a, b)
                                   if start < x < end})
    opens = sorted(spans, key=lambda s: s[1])
    active: list = []
    i, out = 0, []
    for a, b in zip(edges, edges[1:]):
        while i < len(opens) and opens[i][1] <= a:
            active.append(opens[i])
            i += 1
        active = [s for s in active if s[2] > a]
        inner = max(active, key=lambda s: (s[1], -s[2]), default=None)
        out.append((a, b, inner[0] if inner else None))
    return out


def idle_by_span(trace) -> Optional[Dict[Optional[str], float]]:
    """{innermost span's name (None: no span): idle microseconds of the
    stretch}; each idle interval split exactly at the spans' edges.  None
    without a trace or without a program span in it."""
    if trace is None:
        return None
    spans = program_spans(trace)
    if not spans:
        return None
    segs = innermost(spans, trace.start_us, trace.end_us)
    out: Dict[Optional[str], float] = {}
    j = 0
    for a, b in idle_intervals(trace):
        while segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                out[segs[k][2]] = out.get(segs[k][2], 0.0) + hi - lo
            k += 1
    return out


def layer(name: Optional[str]) -> str:
    """The codec layer a span's idle time is charged to: ``stage``,
    ``pack``, ``unspanned`` (an entry span, or none) or ``enqueue`` (every
    other span of a pass: the band loop and its kernels, the wavelet, the
    fetches and their waits)."""
    if name is None or name in ENTRY:
        return "unspanned"
    if name in STAGE:
        return "stage"
    if name in PACK:
        return "pack"
    return "enqueue"


def idle_ms(trace, which: str) -> Optional[float]:
    """Idle milliseconds a unit charged to layer ``which`` (see
    :func:`layer`)."""
    by_span = idle_by_span(trace)
    if by_span is None:
        return None
    return sum(us for name, us in by_span.items()
               if layer(name) == which) / 1e3 / trace.units


def host_ms(trace, name: str) -> Optional[float]:
    """Host milliseconds a unit inside span ``name``, or None where the
    stretch has no such span."""
    if trace is None:
        return None
    inside = [(a, b) for n, a, b in program_spans(trace) if n == name]
    if not inside:
        return None
    return sum(min(b, trace.end_us) - max(a, trace.start_us)
               for a, b in inside) / 1e3 / trace.units


def device_ms(o, name: str) -> Optional[float]:
    """Device milliseconds a unit the program timed for span ``name`` in
    the traced stretch (``llicti_torch.tracing.device_ms``), or None where
    the program times none."""
    if o.trace is None:
        return None
    try:
        from llicti_torch import tracing
    except ImportError:
        return None
    ms = tracing.device_ms().get(name)
    return sum(ms) / o.trace.units if ms else None
