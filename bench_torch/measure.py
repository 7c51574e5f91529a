"""Clocks, percentiles and the device trace of the benchmark."""
from __future__ import annotations

import math
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

# a percentile is reported only with at least this many samples beyond it
TAIL_SAMPLES = 10


def percentile(xs: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank ``q`` quantile of ``xs`` (0 < q < 1), or None when
    fewer than ``TAIL_SAMPLES`` samples lie beyond it."""
    xs = sorted(xs)
    k = max(0, math.ceil(q * len(xs)) - 1)
    if not xs or len(xs) - 1 - k < TAIL_SAMPLES:
        return None
    return xs[k]


def summary(xs: Sequence[float], q: float) -> Dict[str, object]:
    """{median, p<q>, n} of a timing's samples."""
    return {"median": statistics.median(xs),
            f"p{round(100 * q)}": percentile(xs, q), "n": len(xs)}


class CudaClock:
    """Times work on the CUDA card."""

    now = staticmethod(time.perf_counter)

    @staticmethod
    def host(fn: Callable):
        """(fn(), host ms around it, ``torch.cuda.synchronize()`` on both
        sides)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    @staticmethod
    def events(fn: Callable, calls: int):
        """(the last call's result, ms of each of ``calls`` back-to-back
        calls of ``fn``): CUDA events recorded before every call and after
        the last, one synchronisation at the end; their sum is the
        window's."""
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(calls + 1)]
        torch.cuda.synchronize()
        out = None
        for i in range(calls):
            marks[i].record()
            out = fn()
        marks[-1].record()
        torch.cuda.synchronize()
        return out, [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


class NoClock:
    """Runs the same calls and measures nothing (NaN): the traffic on the
    CPU, where no device time exists."""

    @staticmethod
    def now() -> float:
        return math.nan

    @staticmethod
    def host(fn: Callable):
        return fn(), math.nan

    @staticmethod
    def events(fn: Callable, calls: int):
        out = None
        for _ in range(calls):
            out = fn()
        return out, [math.nan] * calls


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch measures the CUDA card and none is "
                           "available")


# kernel name fragments of each group of a profile
KERNEL_GROUPS = (("kernel1", ("cdf_pmap_kernel",)),
                 ("kernel2", ("rans_decode",)),
                 ("kernel3", ("rans_encode_",)),
                 ("cudnn_transpose", ("generictranspose",)),
                 ("conv", ("conv", "sgemm", "gemm", "implicit")))


def profile(fn: Callable) -> Dict[str, object]:
    """One run of ``fn`` under ``torch.profiler`` (host clock around it,
    synchronised): wall ms, device busy ms (the union of the device
    intervals), idle share, kernel launches (no copies or fills), and ms
    and launches of each of ``KERNEL_GROUPS``."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        _, wall = CudaClock.host(fn)
    spans: List[Tuple[float, float]] = []
    groups = {name: [0.0, 0] for name, _ in KERNEL_GROUPS}
    launches = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        name = ev.name.lower()
        if name.startswith(("memcpy", "memset")):
            continue
        launches += 1
        for group, keys in KERNEL_GROUPS:
            if any(k in name for k in keys):
                groups[group][0] += (ev.time_range.end
                                     - ev.time_range.start) / 1e3
                groups[group][1] += 1
                break
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e3
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "launches": launches,
            "groups": {k: {"ms": v[0], "launches": v[1]}
                       for k, v in groups.items()}}
