"""Percentiles, and the device trace of a traced run: ``torch.profiler``
over a few units of work (round trips or steps), reduced to kernels by
name, the device's busy time (the union of its kernels' intervals) and
the idle gaps, each named by what the host was doing.

The nearest-rank percentile and the union of intervals are copies of
the port's own benchmark arithmetic (``bench_torch/measure.py`` at the
commit that added this benchmark).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

WINDOW_SPAN = "llbench.traced"


def percentile(xs: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank ``q`` quantile of ``xs`` (None for none)."""
    xs = sorted(xs)
    return xs[max(0, math.ceil(q * len(xs)) - 1)] if xs else None


def span(name: str):
    """A host span the trace names idle gaps by (``llbench.<name>``)."""
    return torch.profiler.record_function(f"llbench.{name}")


class Trace:
    """What a traced stretch of ``units`` units of work put on the device:
    ``kernels`` [(name, start_us, end_us)] (copies and fills included),
    ``host`` [(name, start_us, end_us)] the host's operations and spans,
    and the stretch itself (``start_us``, ``end_us``)."""

    def __init__(self, kernels, host, start_us: float, end_us: float,
                 units: int):
        self.kernels = [k for k in kernels if k[2] > start_us
                        and k[1] < end_us]
        self.host = host
        self.start_us, self.end_us = start_us, end_us
        self.units = units

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the kernels' intervals inside the stretch."""
        merged: List[List[float]] = []
        for a, b in sorted((max(a, self.start_us), min(b, self.end_us))
                           for _, a, b in self.kernels):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def launches(self) -> int:
        """Kernel launches, without copies and fills."""
        return sum(1 for name, _, _ in self.kernels
                   if not name.lower().startswith(("memcpy", "memset")))

    def group_s(self, patterns: Iterable[str],
                exclude: Iterable[str] = ()) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose lower-case name
        holds one of ``patterns`` and none of ``exclude``."""
        pats, excl = tuple(patterns), tuple(exclude)
        s, n = 0.0, 0
        for name, a, b in self.kernels:
            low = name.lower()
            if any(p in low for p in pats) and not any(e in low for e in excl):
                s += (b - a) / 1e6
                n += 1
        return s, n

    def _host_at(self, t: float) -> str:
        """The innermost host operation running at ``t``, under the
        benchmark's span around it."""
        inner, outer = None, None
        for name, a, b in self.host:
            if a <= t <= b:
                if name.startswith("llbench.") and name != WINDOW_SPAN:
                    if outer is None or b - a < outer[2] - outer[1]:
                        outer = (name, a, b)
                elif not name.startswith("llbench."):
                    if inner is None or b - a < inner[2] - inner[1]:
                        inner = (name, a, b)
        parts = [p[0] for p in (outer, inner) if p is not None]
        return " > ".join(parts) if parts else "host outside any operation"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time (seconds summed by
        name) and the longest idle gaps (seconds, named by the host)."""
        by_name: Dict[str, float] = {}
        for name, a, b in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        edges = [self.start_us]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.end_us)
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        gaps.sort(key=lambda g: g[0] - g[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self._host_at((a + b) / 2), (b - a) / 1e6]
                              for a, b in gaps[:top]]}


@contextlib.contextmanager
def capture(units: int, out: list, device: torch.device):
    """Profile the body, ``units`` units of work on ``device``; appends a
    :class:`Trace` to ``out`` on exit.  A CUDA body is synchronised at
    both ends."""
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            yield
            if cuda:
                torch.cuda.synchronize(device)
    kernels, host, window = [], [], None
    for ev in prof.events():
        rng = (ev.time_range.start, ev.time_range.end)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # annotations (the benchmark's spans, the optimiser's, NCCL's)
            # also show on the device's timeline, over the kernels they hold
            if not (getattr(ev, "is_user_annotation", False)
                    or "annotation" in str(getattr(ev, "activity_type", ""))
                    or ev.name.startswith(("llbench.", "nccl:"))):
                kernels.append((ev.name,) + rng)
        elif ev.name == WINDOW_SPAN:
            window = rng
        else:
            host.append((ev.name,) + rng)
    if window is None:
        raise RuntimeError("the profiler recorded no traced stretch")
    out.append(Trace(kernels, host, window[0], window[1], units))
