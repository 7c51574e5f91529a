"""python3 -m llbench --workload CELL --seed N --seconds S --trace 0|1

Runs one cell of ``BENCHMARK.json`` once on this machine's CUDA cards and
prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown`` and ``missing``, and last ``checks``, each number that decides ``correct``
beside its limit (also the last lines of standard error).

Everything is found by name: the cell's workload file
``llbench/workloads/<cell>.json`` names its configuration
(``llbench/configs/<config>.json``), its traffic generator
(``llbench/traffic/<generator>.py``) and the generator's parameters and
limits; each metric is read by ``llbench/end_to_end/<metric>.py`` or
``llbench/layer_metrics/<metric>.py``, or where there is no such file by
the reader of the part of its name before the first dot (one reader for
``conv_ms.codec`` and ``conv_ms.train``).  A per-layer reader that finds
nothing to read returns None: its metric is left out of ``metrics`` and
named under ``missing``.

Exits non-zero and prints no result without the cards the cell asks
for, without the program, or when a process of the run (rank 0, or any
other rank of a cell of several cards) has loaded JAX or the JAX
package by the window's end.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "llicti_tpu")


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer metrics (those whose ``workloads`` name
    the cell; without that key, those that move an end-to-end metric the
    cell reports)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def reader_path(kind: str, name: str) -> str:
    """``llbench/<kind>/<name>.py``, or where there is none the reader of
    the name's part before the first dot."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        path = os.path.join(HERE, kind, name.split(".", 1)[0] + ".py")
    return path


def reader(kind: str, name: str):
    """The ``read`` function of the reader of metric ``name``."""
    path = reader_path(kind, name)
    spec = importlib.util.spec_from_file_location(
        f"llbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules (of ``modules``, by default ``sys.modules``) whose
    top-level name is JAX's or the JAX package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names
                   if m.split(".", 1)[0] in FORBIDDEN})


def check_modules(who: str) -> None:
    """Exit 5 if this process has loaded JAX or the JAX package."""
    loaded = forbidden_modules()
    if loaded:
        fail(f"{who} loaded {', '.join(loaded)}", 5)


def fail(msg: str, code: int) -> None:
    print(f"llbench: {msg}", file=sys.stderr)
    sys.exit(code)


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m llbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a multi-card cell, started by the cell's rank 0
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    # the CPU in place of the cards, for the benchmark's own tests
    ap.add_argument("--device", choices=("cpu",), help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def prepare(args, device: Optional[str] = None):
    """-> (the cell's Context, its BENCHMARK.json entry, the benchmark).
    ``device`` None asks for the CUDA cards the cell needs (exit 3
    without them); tests pass "cpu"."""
    import torch

    from .cell import Context, process_start
    started = process_start()
    print(f"llbench: {time.time() - started:.3f} s torch imported",
          file=sys.stderr, flush=True)
    bench = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        fail(f"no workload {args.workload!r} in BENCHMARK.json", 2)
    if device is None:
        if not torch.cuda.is_available():
            fail("no CUDA card is available", 3)
        if torch.cuda.device_count() < entry["chips"]:
            fail(f"{args.workload} needs {entry['chips']} cards, "
                 f"{torch.cuda.device_count()} are visible", 3)
    if importlib.util.find_spec("llicti_torch") is None:
        fail("the program (llicti_torch) is not in this checkout", 4)
    ranks = []
    if (entry["chips"] > 1 and not args.rank
            and getattr(args, "spawn", True)):  # start the others first
        from . import ranks as rank_procs
        args.port = rank_procs.free_port()
        argv = ["--workload", args.workload, "--seed", str(args.seed),
                "--seconds", str(args.seconds), "--trace", str(args.trace)]
        if args.device:
            argv += ["--device", args.device]
        ranks = rank_procs.start("llbench", argv, entry["chips"], args.port,
                                 ROOT)
    if device is None:
        torch.cuda.set_device(args.rank)
        device = f"cuda:{args.rank}"
        # one process with one intra-op thread: the host's share of a
        # run stays as steady as the machine lets it
        torch.set_num_threads(1)
    wl = load_json(HERE, "workloads", args.workload + ".json")
    cfg = load_json(HERE, "configs", wl["config"] + ".json")
    ctx = Context(args.workload, wl, cfg, args.seed, args.seconds,
                  bool(args.trace), torch.device(device), started,
                  rank=args.rank, world=entry["chips"], port=args.port,
                  ranks=ranks)
    return ctx, entry, bench


def result(ctx, outcome, bench: Dict) -> Dict:
    """The result line's object: metrics read from ``outcome`` by name."""
    import torch
    metrics, missing = {}, []
    for m in cell_metrics(bench, ctx.name, ctx.trace):
        kind = "layer_metrics" if ctx.trace else "end_to_end"
        value = reader(kind, m["name"])(outcome)
        if value is None:
            if not ctx.trace:
                raise RuntimeError(f"{ctx.name} measured no {m['name']}")
            missing.append(m["name"])
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": outcome.devices,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    out = {"correct": (all(v <= lim for _, v, lim in outcome.checks)
                       and outcome.failed == 0 and outcome.attempted > 0),
           "attempted": outcome.attempted, "failed": outcome.failed,
           "metrics": metrics, "device": device}
    if ctx.trace and outcome.trace is not None:
        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.window_s
        out["breakdown"] = outcome.trace.breakdown()
    if ctx.trace:  # metrics the cell lists whose reader found nothing
        out["missing"] = missing
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in outcome.checks}
    return out


def main(argv=None, device: Optional[str] = None) -> Dict:
    """Run the cell; print and return the result.  ``device`` as in
    :func:`prepare`."""
    from .cell import process_start
    args = parse(argv)
    print(f"llbench: {time.time() - process_start():.3f} s interpreter up",
          file=sys.stderr, flush=True)
    cache = os.path.join(ROOT, ".llbench_cache")
    # the program's build and kernel caches, at fixed places in the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    args.device = device or args.device
    ctx, entry, bench = prepare(args, args.device)
    ctx.note("torch and the card ready")
    generator = importlib.import_module(
        f"llbench.traffic.{ctx.workload['generator']}")
    if args.rank:  # a failed rank fails rank 0's run: no result
        generator.worker(ctx)
        check_modules(f"rank {args.rank}")
        return {}
    outcome = generator.run(ctx)
    check_modules("rank 0")
    out = result(ctx, outcome, bench)
    for name in out.get("missing", []):
        print(f"missing {name}: its reader found nothing to read",
              file=sys.stderr)
    for name, v in outcome.extra.get("readings", {}).items():
        if name not in out["checks"]:
            print(f"reading {name} = {v!r} (not compared)", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return out
