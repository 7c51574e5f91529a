"""Experiment logging: rotating-file setup + the rate-matrix logger.

The port's own copy of ``llicti_tpu/utils/logging_utils.py``: the same
handlers and the same table text, character for character.  It mirrors
the reference's observability surface:
* setup_logging — console INFO + exp_debug.log (DEBUG, 1MB x5) +
  exp_error.log (WARNING), pathname:lineno in the file format
  (utils/config.py:24-47),
* RateLogger — accumulates per-iteration [S, 9] rate matrices and renders
  the scale x band x color table with per-band/per-scale/grand totals
  (loggers/rate.py:7-168), including the 'te' variant where row 0 is the
  header group.
"""
from __future__ import annotations

import logging
import os
from datetime import datetime
from logging.handlers import RotatingFileHandler
from typing import List, Optional

import numpy as np

_CURRENT_DIR = None


def setup_logging(log_dir: str) -> None:
    """Install console + rotating-file handlers for ``log_dir``.

    Re-pointable: calling again with a different dir swaps the file
    handlers, so every sweep value logs into its own experiment dir —
    the reference's @run_once setup sends all sweep values into the
    first dir (utils/config.py:24, SURVEY.md §3.5), a quirk we fix.
    """
    global _CURRENT_DIR
    if _CURRENT_DIR == log_dir:
        return
    _CURRENT_DIR = log_dir
    os.makedirs(log_dir, exist_ok=True)
    file_fmt = ("[%(levelname)s] - %(asctime)s - %(name)s - : %(message)s "
                "in %(pathname)s:%(lineno)d")
    console_fmt = "[%(levelname)s]: %(message)s"
    main = logging.getLogger()
    main.setLevel(logging.INFO)
    # drop pre-existing root handlers so every record renders exactly once
    for h in list(main.handlers):
        main.removeHandler(h)
    ch = logging.StreamHandler()
    ch.setLevel(logging.INFO)
    ch.setFormatter(logging.Formatter(console_fmt))
    fh = RotatingFileHandler(os.path.join(log_dir, "exp_debug.log"),
                             maxBytes=10 ** 6, backupCount=5)
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(logging.Formatter(file_fmt))
    eh = RotatingFileHandler(os.path.join(log_dir, "exp_error.log"),
                             maxBytes=10 ** 6, backupCount=5)
    eh.setLevel(logging.WARNING)
    eh.setFormatter(logging.Formatter(file_fmt))
    main.addHandler(ch)
    main.addHandler(fh)
    main.addHandler(eh)


class RateLogger:
    """Accumulate [S, 9] rate matrices; render mean tables on display()."""

    def __init__(self, name: str = "Rate Loss"):
        self.logger = logging.getLogger(name)
        self.rates: List[np.ndarray] = []
        self.current_iteration = 0
        self.current_epoch = 0

    def __call__(self, rate_matrix) -> None:
        self.current_iteration += 1
        self.rates.append(np.asarray(rate_matrix))

    def reset(self) -> None:
        self.rates = []

    def mean(self) -> np.ndarray:
        m = np.stack(self.rates).mean(axis=0)
        self.reset()
        return m

    def state_dict(self) -> dict:
        return {
            "rate": [r.tolist() for r in self.rates],
            "it": self.current_iteration,
            "ep": self.current_epoch,
        }

    def load_state_dict(self, d: dict) -> None:
        self.rates = [np.asarray(r) for r in d["rate"]]
        self.current_iteration = d["it"]
        self.current_epoch = d["ep"]

    def display(self, lr: float = 0.0, typ: str = "tr",
                epoch: Optional[int] = None):
        """Render the accumulated mean table.  ``epoch`` labels the header;
        when omitted, epoch-typed displays bump an internal counter (the
        reference bumped it on EVERY display, so per-N-iteration 'it'
        tables inflated the epoch label — fixed here)."""
        rate = self.mean()
        if epoch is None and typ != "it":
            self.current_epoch += 1
        label = self.current_epoch if epoch is None else epoch
        self._log_table(label, rate, lr, typ)
        return float(np.sum(rate)), 0.0

    def _log_table(self, cur_iter: int, rate: np.ndarray, lr: float,
                   typ: str) -> None:
        # reference loggers/rate.py:120-168
        if rate.shape[1] != 9:
            raise ValueError(f"the table needs [S, 9] rates, got "
                             f"{rate.shape}")
        heads = {
            "tr": f"  Train Epoch: {cur_iter:3d}  Rates: scl",
            "te": f"   Test Epoch: {cur_iter:3d}  Rates: hdr ",
            "va": f"  Valid Epoch: {cur_iter:3d}  Rates: scl",
            "it": f"Train Itera: {cur_iter:3d}  Rates: scl",
        }
        cont = {"it": " " * 33 + "scl"}.get(typ, " " * 35 + "scl")
        text = heads[typ]
        sum_all = 0.0
        for s in range(rate.shape[0]):
            if typ == "te":
                text += "-> " if s == 0 else f"{s - 1:d}-> "
            else:
                text += f"{s:d}-> "
            sum_scl = 0.0
            for b in range(3):
                rr, gg, bb = rate[s][3 * b:3 * b + 3]
                srgb = rr + gg + bb
                text += f"{rr:.2f}+{gg:.2f}+{bb:.2f}(b{b:d}={srgb:.3f}) "
                sum_scl += srgb
            if typ == "te":
                text += (f"(hd={sum_scl:.3f}) " if s == 0
                         else f"(s{s - 1:d}={sum_scl:.3f}) ")
            else:
                text += f"(s{s:d}={sum_scl:.3f}) "
            sum_all += sum_scl
            if s < rate.shape[0] - 1:
                text += "\n" + cont
            else:
                text += f"(({sum_all:.3f})) "
        now = datetime.now().strftime("%H:%M:%S")
        if typ in ("tr", "it"):
            text += f"  (lr: {lr:.6f}) ({now})"
        else:
            text += f" ({now})"
        self.logger.info(text)
