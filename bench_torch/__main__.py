"""python3 -m bench_torch [--cell NAME ...] [--seed S] [--trace]

Runs each named cell (default: both) on the CUDA card and prints, after
the card's name and power limit, torch's and CUDA's versions and the
seed, every metric by name with its unit, samples and bound; the last
line is one JSON object with all of it.  A failed gate raises and the
command exits non-zero.  ``--trace`` runs the cells' traced windows and
prints the per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from llicti_torch import _kernels

from . import codec_cell, train_cell
from .measure import CudaClock, card_line, require_card
from .metrics import CELLS, CODEC, LAYER_METRICS, METRICS, names


def describe(name: str, entry: Dict) -> str:
    """One metric's line: value and unit, then what is printed beside it."""
    spec = METRICS.get(name) or LAYER_METRICS[name]
    beside = ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else
                       f"{k} {v}" for k, v in entry.items() if k != "value")
    bound = ""
    if name in METRICS:
        m = METRICS[name]
        bound = (f"; {m.better} is better, bound "
                 + (f"{100 * m.bound:g} %" if m.bound is not None
                    else "not set"))
    value = entry["value"]
    value = f"{value:.6g}" if isinstance(value, float) else str(value)
    return f"metric {name} = {value} {spec.unit} ({beside}{bound})"


def report(cell: str, setup: Dict, out: Dict, traced: bool) -> None:
    """Print a cell's set-up numbers and its metrics, in the table's order;
    raise if the run measured other metrics than the table names."""
    expected = names(cell, traced)
    if sorted(out) != sorted(expected):
        raise RuntimeError(f"{cell}: measured {sorted(out)}, the metric "
                           f"table names {sorted(expected)}")
    for key, v in setup.items():
        print(f"setup {cell} {key} {v:.6g}" if isinstance(v, float)
              else f"setup {cell} {key} {v}")
    for name in expected:
        print(f"{cell} {describe(name, out[name])}")


def run_cell(cell: str, seed: int, trace: bool):
    """-> (set-up numbers, {metric: entry})."""
    mod = codec_cell if cell == CODEC else train_cell
    if trace:
        t0 = time.perf_counter()
        out = mod.trace(seed)
        return {"traced_run_s": time.perf_counter() - t0}, out
    return mod.run(seed, CudaClock)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python3 -m bench_torch",
        description="The port's benchmark on one CUDA card.")
    ap.add_argument("--cell", action="append", choices=CELLS,
                    help="a cell to run (repeatable; default: all)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--trace", action="store_true",
                    help="the traced run: per-layer metrics")
    args = ap.parse_args(argv)
    require_card()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
          f"seed {args.seed}, {'traced' if args.trace else 'untraced'}")
    t0 = time.perf_counter()
    _kernels.lib()
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "seed": args.seed, "trace": args.trace,
              "kernels_ready_s": time.perf_counter() - t0, "cells": {}}
    print(f"setup kernels built or loaded in {result['kernels_ready_s']:.2f} s")
    for cell in args.cell or CELLS:
        t0 = time.perf_counter()
        setup, out = run_cell(cell, args.seed, args.trace)
        report(cell, setup, out, args.trace)
        result["cells"][cell] = {"setup": setup, "metrics": out,
                                 "s": time.perf_counter() - t0}
        torch.cuda.empty_cache()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
