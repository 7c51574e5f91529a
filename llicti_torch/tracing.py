"""Named spans at the codec's and the training step's layer boundaries.

A span is recorded only while a ``torch.profiler`` records, and costs
one check otherwise: :func:`span` then returns one shared no-op context.
While a profiler records, a span enters ``torch.profiler.record_function``,
so it lands on the profiler's own clock beside the device's kernels, and
every idle stretch of the device can be put down to the span the host was
in (``export_chrome_trace`` shows them on one timeline).  There is no
other switch.

Entry spans (:func:`entry`) mark the outermost public call: a codec pass
(``llicti.compress``, ``llicti.decompress``) or a training step
(``llicti.step``); a pass called from another pass opens none of its own.
The spans of the codec's layers are ``llicti.stage``,
``llicti.host_header``, ``llicti.unpack``, ``llicti.upload``,
``llicti.wavelet``, ``llicti.band``, ``llicti.interp`` (and inside it,
with clrjnt0seqmd, ``llicti.seq``: one colour's sequential convs and
trunk, timed on the device; for a batch of K > 1 on the card,
``llicti.stack``: the band's interpolator with its trunk at batch 1;
and, with activfun GDN1, ``llicti.gdn``: one application of GDN1, timed
on the device, two a band net at conv_layers 3;
and, for a rank's block of rows, ``llicti.halo``: one exchange of the
boundary rows its layer-0 convs read from the neighbouring ranks),
``llicti.kernel1``, ``llicti.kernel2``,
``llicti.kernel3``, ``llicti.fetch``, ``llicti.wait`` and
``llicti.pack``; those of the step ``llicti.forward``,
``llicti.backward``, ``llicti.optimizer`` and, across cards,
``llicti.allreduce``.

A span given a CUDA ``device`` also records a pair of timing events on the
device's current stream at its two ends; :func:`device_ms` reads them.
They hold the latest traced stretch only: the first span that finds the
profiler recording after finding it off clears them.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Tuple

import torch

_recording = torch.autograd._profiler_enabled
# the context of every span while no profiler records
OFF = contextlib.nullcontext()


class _State:
    """Whether the last span found the profiler off, the entry span open
    on each thread, and the device timings of the traced stretch."""

    def __init__(self):
        self.was_off = True
        self.local = threading.local()
        self.events: Dict[str, List[Tuple[torch.cuda.Event,
                                          torch.cuda.Event]]] = {}


_state = _State()


class _Span:
    __slots__ = ("name", "stream", "entry", "fn", "start")

    def __init__(self, name: str, stream, entry: bool):
        self.name, self.stream, self.entry = name, stream, entry

    def __enter__(self):
        if self.entry:
            _state.local.entry = True
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        return None

    def __exit__(self, *exc):
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            _state.events.setdefault(self.name, []).append((self.start, end))
        self.fn.__exit__(*exc)
        if self.entry:
            _state.local.entry = False
        return False


def _on() -> None:
    """A span found the profiler recording: a new traced stretch clears the
    device timings of the last."""
    if _state.was_off:
        _state.was_off = False
        _state.events.clear()


def span(name: str, device: Optional[torch.device] = None):
    """The context of span ``name``; ``device``: the device of the span's
    work, whose current stream a CUDA span times (:func:`device_ms`)."""
    if not _recording():
        _state.was_off = True
        return OFF
    _on()
    stream = (torch.cuda.current_stream(device)
              if device is not None and device.type == "cuda" else None)
    return _Span(name, stream, False)


def entry(name: str):
    """The context of the entry span ``name`` of a public call: a span, or
    while another entry span is open on this thread, none."""
    if not _recording():
        _state.was_off = True
        return OFF
    _on()
    if getattr(_state.local, "entry", False):
        return OFF
    return _Span(name, None, True)


def device_ms() -> Dict[str, List[float]]:
    """{span name: [device ms of each span given a CUDA device]} of the
    latest traced stretch, after one synchronisation; empty without one."""
    if not _state.events:
        return {}
    torch.cuda.synchronize()
    return {name: [a.elapsed_time(b) for a, b in pairs]
            for name, pairs in _state.events.items()}
