"""The numbers that decide ``correct``: each is compared with its limit,
which the workload file states, and a run is correct when every number
is at or below its limit."""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch


def bytes_off(got: bytes, want: bytes) -> int:
    """Bytes of ``got`` that differ from ``want`` at the same offset, plus
    the difference of their lengths."""
    n = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, n)
    b = np.frombuffer(want, np.uint8, n)
    return int((a != b).sum()) + abs(len(got) - len(want))


def wrong_subpixels(got: np.ndarray, want: np.ndarray) -> int:
    """Subpixels of a decoded image ``got`` that differ from its input
    (all of them when the shapes differ)."""
    got = np.asarray(got)
    if got.ndim == want.ndim + 1 and got.shape[0] == 1:
        got = got[0]
    if got.shape != want.shape or got.dtype != want.dtype:
        return int(want.size)
    return int((got != want).sum())


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def norm_gaps(got: Dict[str, float], want: Dict[str, float],
              names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap |got[n] - want[n]| over the leaves ``names`` (all by
    default), against the larger of want[n] and the median leaf's want."""
    names = list(want if names is None else names)
    med = statistics.median(want[n] for n in names)
    return {n: abs(got[n] - want[n]) / max(want[n], med) for n in names}


def moving_leaves(ref_grads: Dict[str, float], share: float = 1e-3
                  ) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding: at
    least ``share`` of the median leaf's norm.  A leaf below it (a bias a
    softmax cancels, say) moves under Adam by round-off alone."""
    med = statistics.median(ref_grads.values())
    return [n for n, g in ref_grads.items() if g >= share * med]


def step_numbers(prog: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """The training comparison, each number with what it was read at: the
    first checked step's loss against the reference's, relative
    (``loss_gap_first``), and the worst step's (``loss_gap``); the first
    gradient's norm gap by the worst leaf (``grad_norm_gap``) and the
    median leaf's gap (``grad_norm_gap_median``); the same of the
    parameters' change over the checked steps, over the leaves that move
    (``update_norm_gap``, ``update_norm_gap_median``).  ``prog`` and
    ``ref`` hold "losses", "grads" (norms of the first step's clipped
    gradients by leaf) and "delta" (norms of the change)."""
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                 ref["losses"])]
    out = {"loss_gap_first": (steps[0], "step 1"),
           "loss_gap": (max(steps), f"step {1 + steps.index(max(steps))}")}
    for key, names in (("grad", None),
                       ("update", moving_leaves(ref["grads"]))):
        gaps = norm_gaps(prog["grads" if key == "grad" else "delta"],
                         ref["grads" if key == "grad" else "delta"], names)
        worst = max(gaps, key=gaps.get)
        out[f"{key}_norm_gap"] = (gaps[worst], worst)
        out[f"{key}_norm_gap_median"] = (statistics.median(gaps.values()),
                                         "median leaf")
    return out
