"""The other ranks of a cell of several cards: processes of the same
command, started by rank 0 as early as its run allows, so that their
start-up overlaps its own."""
from __future__ import annotations

import ctypes
import signal
import socket
import subprocess
import sys
from typing import List


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    """A rank ends when rank 0 does (Linux's parent-death signal)."""
    ctypes.CDLL(None).prctl(1, signal.SIGTERM)


def start(module: str, argv: List[str], world: int, port: int,
          root: str) -> List[subprocess.Popen]:
    """Ranks 1..world-1 of ``python -m module argv``, each a process in
    the checkout ``root``, rendezvous at ``localhost:port``.  They print
    to standard error only: the last line of standard output is rank
    0's."""
    return [subprocess.Popen(
        [sys.executable, "-m", module] + argv
        + ["--port", str(port), "--rank", str(r)],
        cwd=root, stdout=2, preexec_fn=_die_with_parent)
        for r in range(1, world)]


def wait(procs: List[subprocess.Popen], timeout: float = 120) -> None:
    """Wait for every rank (killing one that outlives ``timeout``);
    RuntimeError if one failed."""
    for p in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    bad = [p.returncode for p in procs if p.returncode]
    if bad:
        raise RuntimeError(f"a rank exited with {bad}")
