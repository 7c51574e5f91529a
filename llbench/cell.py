"""What a traffic generator is given and what it gives back."""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from .trace import Trace


@dataclasses.dataclass
class Context:
    """One run of one cell: its workload and configuration files, the
    run's arguments, and when the process started (epoch seconds)."""
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float
    rank: int = 0
    world: int = 1
    port: int = 0
    ranks: List[Any] = dataclasses.field(default_factory=list)

    @property
    def params(self) -> Dict[str, Any]:
        return self.workload["params"]

    def limit(self, check: str) -> float:
        return self.workload["limits"][check]

    def note(self, what: str) -> None:
        """Print to standard error how far set-up has come."""
        print(f"llbench: {time.time() - self.started:.3f} s {what}",
              file=sys.stderr, flush=True)

    def setup_done(self) -> float:
        """Seconds from the process's start to now: the set-up time, when
        the window starts now."""
        return time.time() - self.started


@dataclasses.dataclass
class Outcome:
    """A run's result.  ``window``: what the end-to-end readers read;
    ``checks``: (name, number, limit) of the comparison; ``extra``: what
    the per-layer readers read besides the trace."""
    attempted: int
    failed: int
    setup_s: float
    window: Dict[str, Any]
    checks: List[Tuple[str, float, float]]
    memory_peak_bytes: int
    devices: int = 1
    trace: Optional[Trace] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def process_start() -> float:
    """The epoch second this process started (Linux's /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def host_times() -> dict:
    """The host's CPU seconds so far: this process's, and the machine's
    stolen by its hypervisor (``/proc/stat``'s steal column)."""
    out = {"process": time.process_time(), "steal": float("nan")}
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        out["steal"] = int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        pass
    return out


def free_memory() -> None:
    """Return the memory of what the caller dropped to the card."""
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
