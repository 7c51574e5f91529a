#!/usr/bin/env python3
"""The benchmark's training gate and its margins, on the card.

Usage: python3 tools/train_gate_probe.py [--seeds 42 7]

For each seed, the ``paper_a_train_step`` cell's model after its warm-up
steps takes the first timed step on each of the cell's pinned loader
batches (from a copy of the model and Adam state each time), under
PyTorch's default flags and under ``exact_math()`` (TF32 off), and prints
the step's loss distance (relative), its largest gradient distance
(relative L2, over the parameters) from the same step in float64 on the
card (``bench_torch.gates.float64_step``) and its largest parameter
update distance from Adam's on those float64 gradients
(``bench_torch.gates.adam_update``) and on the step's own gradients
("own"), beside the gate's bounds and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from bench_torch import gates, train_cell  # noqa: E402
from bench_torch.measure import card_line, require_card  # noqa: E402
from llicti_torch.codec import exact_math  # noqa: E402
from llicti_torch.training import make_optimizer, make_train_step  # noqa


def distances(model, opt, x, clip: float, ctx):
    """(loss distance, largest gradient distance, largest update distance,
    the same against Adam on the step's own gradients) of one step on
    ``x`` from a copy of ``model`` and ``opt``, against float64 (the
    update against Adam's on the float64 gradients)."""
    m = copy.deepcopy(model)
    o = make_optimizer(m, opt.param_groups[0]["lr"])
    o.load_state_dict(opt.state_dict())
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    adam = gates.adam_snapshot(m, o)
    with ctx():
        loss = float(make_train_step(m, o, clip)(x)["loss"])
    grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
    after = {n: p.detach() for n, p in m.named_parameters()}
    loss64, grads64 = gates.float64_step(model, x, clip)
    worst = max(float((grads[n].double() - g).norm() / g.norm())
                for n, g in grads64.items() if g.norm() > 0)

    def upd(g):
        update = gates.adam_update(adam, g)
        return max(float((after[n].double() - before[n].double() - u).norm()
                         / u.norm()) for n, u in update.items()
                   if u.norm() > 0)
    return (abs(loss - loss64) / abs(loss64), worst, upd(grads64),
            upd({n: g.double() for n, g in grads.items()}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 7])
    args = ap.parse_args()
    require_card()
    cfg = train_cell.paper_a()
    clip = cfg.train.grad_clip_value
    for seed in args.seeds:
        hosts = train_cell._hosts(train_cell.loader_batches(
            cfg, seed, train_cell.PINNED), "cuda")
        model, opt = train_cell._model(cfg, "cuda")
        step = make_train_step(model, opt, clip)
        for i in range(train_cell.WARMUP):
            step(hosts[i % train_cell.PINNED].to("cuda"))
        for label, ctx in (("default flags", contextlib.nullcontext),
                           ("exact_math", exact_math)):
            rows = [distances(model, opt, h.to("cuda"), clip, ctx)
                    for h in hosts]
            print(f"seed {seed}, {label}: loss " + " ".join(
                f"{r[0]:.3g}" for r in rows) + " | gradients " + " ".join(
                f"{r[1]:.3g}" for r in rows) + " | updates " + " ".join(
                f"{r[2]:.3g}" for r in rows) + " | own " + " ".join(
                f"{r[3]:.3g}" for r in rows) + f" (bounds {gates.LOSS_REL:g}"
                f", {gates.GRAD_L2_BOUND:g}, {gates.UPDATE_L2_BOUND:g}, "
                f"{gates.ADAM_L2_BOUND:g})", flush=True)
    print(card_line())


if __name__ == "__main__":
    main()
