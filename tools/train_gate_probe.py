#!/usr/bin/env python3
"""The benchmark's training gate and the step rule, and their margins,
on the card.

Usage: python3 tools/train_gate_probe.py [--seeds 42 7 1 2]

For each seed, the ``paper_a_train_step`` cell's model (which
``make_train_step`` puts in channels-last) after its warm-up steps takes
the first timed step on each of the cell's pinned loader batches, from a
copy of the model and Adam state each time, under PyTorch's default
flags (the timed step) and under ``exact_math()`` (gate (i)'s step).
Prints each step's distances, as ``bench_torch.gates`` reads them: (i)
the exact step's loss (relative), largest gradient distance (relative
L2, over the parameters) from the step in float64 and largest update
distance from a plain Adam's on the float64 gradients; (ii) the timed
step's loss, gradients and update against (i)'s, and its update against
Adam on its own gradients ("own"); then the worst of each over every
step beside its bound.

Then chip_smoke.py's phase 11 (a) (the trained flagship, one step on its
[2, 2, 160, 160, 3] batch under ``exact_math()``, card against CPU):
each of its checks' readings beside its bound, and the step rule's
(``dryrun.step_rule``) beside the old 99.9 %-within-1e-3-lr share.  The
last line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from bench_torch import gates, train_cell  # noqa: E402
from bench_torch.measure import card_line, require_card  # noqa: E402
from llicti_torch import ModelConfig, load_npz  # noqa: E402
from llicti_torch.codec import exact_math  # noqa: E402
from llicti_torch.parallel import dryrun  # noqa: E402
from llicti_torch.training import make_optimizer, make_train_step  # noqa

# (reading, its bound) in the order printed
BOUNDS = {"(i) loss": gates.LOSS_REL, "(i) gradients": gates.GRAD_L2_BOUND,
          "(i) update": gates.UPDATE_L2_BOUND,
          "(ii) loss": gates.TIMED_LOSS_REL,
          "(ii) gradients": gates.TIMED_GRAD_L2_BOUND,
          "(ii) update": gates.TIMED_UPDATE_L2_BOUND,
          "(ii) own": gates.ADAM_L2_BOUND}


def one_step(model, opt, x, clip: float, exact: bool):
    """One step on ``x`` from a copy of ``model`` and ``opt`` -> (loss,
    gradients, parameters after it)."""
    m = copy.deepcopy(model)
    o = make_optimizer(m, opt.param_groups[0]["lr"])
    o.load_state_dict(copy.deepcopy(opt.state_dict()))  # no shared moments
    if exact:
        with exact_math():
            loss = float(make_train_step(m, o, clip)(x)["loss"])
    else:
        loss = float(make_train_step(m, o, clip)(x)["loss"])
    return (loss, {n: p.grad.detach().clone() for n, p in m.named_parameters()},
            {n: p.detach().clone() for n, p in m.named_parameters()})


def worst(got, want):
    """(the largest relative L2 distance over the parameters, its name)."""
    return max((float((got[n].double() - w).norm() / w.norm()), n)
               for n, w in want.items() if w.norm() > 0)


def distances(model, opt, x, clip: float) -> dict:
    """Gate (i)'s and (ii)'s readings of the first step on ``x``."""
    before = {n: p.detach().double() for n, p in model.named_parameters()}
    adam = gates.adam_snapshot(model, opt)
    loss_t, grads_t, after_t = one_step(model, opt, x, clip, False)
    loss_x, grads_x, after_x = one_step(model, opt, x, clip, True)
    loss64, grads64 = gates.float64_step(model, x, clip)

    def change(after):
        return {n: after[n].double() - before[n] for n in before}
    out = {"(i) loss": abs(loss_x - loss64) / abs(loss64),
           "(ii) loss": abs(loss_t - loss_x) / abs(loss_x)}
    for key, got, want in (
            ("(i) gradients", grads_x, grads64),
            ("(i) update", change(after_x), gates.adam_update(adam, grads64)),
            ("(ii) gradients", grads_t, grads_x),
            ("(ii) update", change(after_t), change(after_x)),
            ("(ii) own", change(after_t), gates.adam_update(adam, {
                n: g.double() for n, g in grads_t.items()}))):
        out[key], out[key + " at"] = worst(got, want)
    return out


def gate_probe(seeds) -> None:
    cfg = train_cell.paper_a()
    clip = cfg.train.grad_clip_value
    rows = []
    for seed in seeds:
        hosts = train_cell._hosts(train_cell.loader_batches(
            cfg, seed, train_cell.PINNED), "cuda")
        model, opt = train_cell._model(cfg, "cuda")
        step = make_train_step(model, opt, clip)
        for i in range(train_cell.WARMUP):
            step(hosts[i % train_cell.PINNED].to("cuda"))
        got = [distances(model, opt, h.to("cuda"), clip) for h in hosts]
        rows += got
        print(f"gate, seed {seed}, the first step on each of the "
              f"{len(hosts)} pinned batches: " + " | ".join(
                  f"{k} " + " ".join(f"{r[k]:.3g}" for r in got)
                  for k in BOUNDS) + " | (ii) gradients' worst tensor "
              + " ".join(r["(ii) gradients at"] for r in got), flush=True)
    worst_of = {k: max(r[k] for r in rows) for k in BOUNDS}
    print(f"gate, worst of {len(rows)} first steps: " + ", ".join(
        f"{k} {v:.3g} (bound {BOUNDS[k]:g}, {BOUNDS[k] / max(v, 1e-300):.3g}x)"
        for k, v in worst_of.items()), flush=True)


def phase_11a_probe() -> None:
    cfg, params = ModelConfig(), load_npz()
    batch = cs.train_compare_batch()
    cpu = cs.one_train_step(cfg, params, batch, "cpu")
    g64 = cs.float64_grads(cfg, params, batch)
    r = cs.card_cpu_readings(cs.one_train_step(
        cfg, params, batch, "cuda"), cpu, g64)
    rule = r["rule"]
    print(f"phase 11 (a), card against the CPU: loss {r['loss_rel']:.3g} "
          f"(bound 1e-5, {1e-5 / max(r['loss_rel'], 1e-300):.3g}x); breakdown "
          f"{r['breakdown_rel']:.3g} (1e-4, "
          f"{1e-4 / max(r['breakdown_rel'], 1e-300):.3g}x); gradient "
          f"deviation {r['grad_dev']:.3g} of max|g_cpu| "
          f"({r['grad_dev_tensor']}; 1e-2, {1e-2 / r['grad_dev']:.3g}x); "
          f"gradients against float64 at worst "
          f"{r['float64_l2_worst']:.3g} (GRAD_L2_BOUND "
          f"{gates.GRAD_L2_BOUND:g}, "
          f"{gates.GRAD_L2_BOUND / r['float64_l2_worst']:.3g}x); Adam "
          f"steps {r['adam_steps']}; step rule (NOISE_SIGMAS "
          f"{dryrun.NOISE_SIGMAS:g}): {dryrun.rule_line(rule)}; margins "
          f"gradients {rule['grad_bound'] / rule['grad_rel_l2']:.3g}x, "
          f"noise {1 / max(rule['beyond_signal_ratio'], 1e-300):.3g}x; "
          f"passes: {rule['ok']}", flush=True)
    print("phase 11 (a), card, each gradient against float64 (card, "
          "CPU): " + ", ".join(f"{n} {a:.3g} {b:.3g}" for n, (a, b)
                               in r["float64_l2"].items()), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 7, 1, 2])
    args = ap.parse_args()
    require_card()
    gate_probe(args.seeds)
    phase_11a_probe()
    print(card_line())


if __name__ == "__main__":
    main()
