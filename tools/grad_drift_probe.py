#!/usr/bin/env python3
"""Where the card's training gradients drift from float64: the backward
of band 2's layer-0 convs of the flagship, on the CUDA card.

Usage: python3 tools/grad_drift_probe.py [--runs 5]

Runs ``chip_smoke.py``'s phase 11 (a) step: the trained flagship, one
clip + Adam step on a [2, 2, 160, 160, 3] TrainLoader batch (synthetic
set, seed 1337), under ``exact_math()``.  Prints:

* the kernels of every ``aten::convolution_backward`` whose weight is a
  layer-0 conv's ([352, 3, kh, kw]) in a ``torch.profiler`` trace of one
  card step (record_shapes): kernel names, launches, device ms, and the
  shapes of grad_output, input and weight; then the kernels of band 2's
  three layer-0 convs' backward alone, on the inputs and output
  gradients the step gave them (``aten.convolution_backward``, the same
  shapes and flags), each marked data-gradient (dgrad) or weight-gradient
  (wgrad) by its name;
* for each of band 2's layer-0 weights, the relative L2 distance of its
  gradient from the step's float64 gradient (``dryrun.float64_step``)
  when the step runs: on the card as it is (``make_train_step`` puts the
  model in channels-last); on the card with
  ``torch.backends.cudnn.enabled = False`` for that call only (PyTorch's
  own direct convolution, a yardstick); and on the CPU;
* the same conv's weight gradient alone, summed over its calls in the
  card step from the inputs and output gradients of that step: cuDNN in
  float32, PyTorch's direct convolution in float32, and cuDNN in float64
  on the card, each against float64 on the CPU of the same inputs (the
  conv's own summation error, apart from what reaches it); and the
  gradients reaching the outputs of the layer-0 convs and of band 2's
  two trunk convs (the last gives the pmap), card and CPU, against the
  float64 step's;
* ms an optimiser step of paper_a's batch (2 x 32 patches of 160^2,
  random weights from seed 1337) under each setting (CUDA events, median
  of ``--runs`` after a warm-up).

The last line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from llicti_torch import ModelConfig, load_npz  # noqa: E402
from llicti_torch.codec import exact_math  # noqa: E402
from llicti_torch.data import ImageDataset, TrainLoader  # noqa: E402
from llicti_torch.parallel.dryrun import float64_step  # noqa: E402
from llicti_torch.training import make_optimizer, make_train_step  # noqa
from llicti_torch.weights import init_params, params_from_flax  # noqa: E402

BAND2 = ("models.0.2.conv_00_10", "models.0.2.conv_11_10",
         "models.0.2.conv_01_10")
# band 2's trunk: the 1x1 conv after layer 0 and the one giving the pmap
TRUNK = ("models.0.2.trunk.0", "models.0.2.trunk.2")


@contextlib.contextmanager
def no_cudnn():
    """PyTorch's own convolution (no cuDNN), TF32 off, inside exact_math."""
    with exact_math(), torch.backends.cudnn.flags(
            enabled=False, benchmark=False, deterministic=True,
            allow_tf32=False):
        yield


SETTINGS = {"as is": exact_math, "cudnn off": no_cudnn}


def rel_l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.double().cpu() - ref).norm() / ref.norm())


class Capture:
    """The inputs and output gradients of the named convs' calls."""

    def __init__(self, model, names):
        self.calls = {n: [] for n in names}
        mods = dict(model.named_modules())
        self.handles = [mods[n].register_forward_hook(self._hook(n))
                        for n in names]

    def _hook(self, name):
        def hook(mod, inp, out):
            rec = {"input": inp[0].detach()}
            self.calls[name].append(rec)
            if out.requires_grad:
                out.register_hook(lambda g: rec.__setitem__("grad",
                                                             g.detach()))
        return hook

    def remove(self):
        for h in self.handles:
            h.remove()


def train_step(cfg, params, batch, device, ctx, capture=()):
    """One clip + Adam step of the trained flagship under ``ctx`` -> (the
    gradients on the CPU, Capture)."""
    model = params_from_flax(params, cfg).to(device).train()
    cap = Capture(model, capture)
    step = make_train_step(model, make_optimizer(model, cs.TRAIN_LR))
    with ctx():
        step(torch.from_numpy(batch).to(device))
    cap.remove()
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}, \
        cap


def float64_capture(cfg, params, batch):
    """The step's float64 reference (``dryrun.float64_step``) with band 2's
    convs' calls captured -> (its gradients, Capture of their inputs and
    output gradients in float64).  The hooks go with the model into the
    step's float64 copy."""
    model = params_from_flax(params, cfg)
    cap = Capture(model, BAND2 + TRUNK)
    _, grads = float64_step(model, torch.from_numpy(batch), 5.0)
    cap.remove()
    return grads, cap


def wgrad(rec, weight, dtype, device, ctx):
    g, x = rec["grad"].to(device, dtype), rec["input"].to(device, dtype)
    w = weight.detach().to(device, dtype)
    with ctx():
        return torch.ops.aten.convolution_backward(
            g, x, w, [w.shape[0]], [1, 1], [0, 0], [1, 1], False, [0, 0],
            1, [False, True, False])[1]


def kernels_under(ev):
    """(name, device us) of every kernel launched by ev or below it."""
    out = [(k.name, k.duration) for k in ev.kernels]
    for child in ev.cpu_children:
        out += kernels_under(child)
    return out


def conv_backward_kernels(fn, layer0_only=True):
    """Profile ``fn``; -> {(shapes, kernel name): [launches, ms]} over the
    aten::convolution_backward ops (of layer-0 weights [352, 3, kh, kw])."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    table, ops = {}, 0
    for ev in prof.events():
        if ev.name != "aten::convolution_backward":
            continue
        shapes = tuple(tuple(s) for s in ev.input_shapes[:3])
        if layer0_only and not (len(shapes) == 3 and len(shapes[2]) == 4
                                and shapes[2][1] == 3):
            continue
        ops += 1
        for name, us in kernels_under(ev):
            entry = table.setdefault((shapes, name), [0, 0.0])
            entry[0] += 1
            entry[1] += us / 1e3
    return table, ops


def print_kernels(label, found):
    table, ops = found
    print(f"{label}: {ops} aten::convolution_backward ops")
    if not table:
        print(f"{label}: no kernel found under them")
    for (shapes, name), (count, ms) in sorted(table.items()):
        kind = ("wgrad" if "wgrad" in name.lower() else
                "dgrad" if "dgrad" in name.lower() else "other")
        print(f"{label}: {kind} {name} x{count}, {ms:.4f} ms; grad_output "
              f"{list(shapes[0])}, input {list(shapes[1])}, weight "
              f"{list(shapes[2])}")


def step_ms(ctx, runs):
    """ms an optimiser step of paper_a's batch under ctx (CUDA events)."""
    cfg = ModelConfig()
    ds = ImageDataset(synthetic_len=64, synthetic_size=160,
                      seed=cs.TRAIN_SEED)
    x = torch.from_numpy(next(iter(TrainLoader(
        ds, 32, 160, grad_acc=2, seed=cs.TRAIN_SEED)))).cuda()
    model = params_from_flax(init_params(cfg, cs.TRAIN_SEED), cfg).cuda()
    step = make_train_step(model, make_optimizer(model, cs.TRAIN_LR))
    times = []
    with ctx():
        for _ in range(runs + 1):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            step(x)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
    return statistics.median(times[1:]), min(times[1:]), max(times[1:])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("grad_drift_probe: CUDA is not available")
    cfg = ModelConfig()
    params = load_npz()
    ds = ImageDataset(synthetic_len=4, synthetic_size=160, seed=cs.TRAIN_SEED)
    batch = next(iter(TrainLoader(ds, 2, 160, grad_acc=2,
                                  seed=cs.TRAIN_SEED)))
    g64, f64 = float64_capture(cfg, params, batch)
    weights = [n + ".weight" for n in BAND2]

    # 1. the kernels of the layer-0 convs' backward in one card step
    train_step(cfg, params, batch, "cuda", exact_math)  # warm-up
    print_kernels("step profile, layer-0 conv backward", conv_backward_kernels(
        lambda: train_step(cfg, params, batch, "cuda", exact_math)))

    # 2. band 2's layer-0 gradients against float64 under each setting
    grads = {}
    for label, ctx in SETTINGS.items():
        grads[label], cap = train_step(cfg, params, batch, "cuda", ctx,
                                       capture=BAND2 + TRUNK
                                       if label == "as is" else ())
        if label == "as is":
            card_cap = cap
    grads["CPU"], cpu_cap = train_step(cfg, params, batch, "cpu", exact_math,
                                       capture=BAND2 + TRUNK)
    for w in weights:
        print(f"step gradient of {w} against float64, relative L2: "
              + ", ".join(f"{label} {rel_l2(g[w], g64[w]):.4g}"
                          for label, g in grads.items()))
    for label, g in grads.items():
        worst = max(rel_l2(g[n], g64[n]) for n in g64)
        print(f"step gradients, {label}: largest relative L2 over all "
              f"{len(g64)} tensors {worst:.4g}")

    # 3. the conv's own weight gradient on the step's inputs and output
    # gradients, and how far those output gradients already are
    model = params_from_flax(params, cfg)
    mods = dict(model.named_modules())
    print_kernels("band 2 layer-0 backward alone", conv_backward_kernels(
        lambda: [wgrad(rec, mods[n].weight, torch.float32, "cuda",
                       exact_math)
                 for n in BAND2 for rec in card_cap.calls[n]],
        layer0_only=False))
    for n in BAND2:
        calls = card_cap.calls[n]
        ref = sum(wgrad(r, mods[n].weight, torch.float64, "cpu",
                        contextlib.nullcontext) for r in calls)
        rows = {
            "cuDNN f32": sum(wgrad(r, mods[n].weight, torch.float32, "cuda",
                                   exact_math) for r in calls),
            "direct f32": sum(wgrad(r, mods[n].weight, torch.float32,
                                    "cuda", no_cudnn) for r in calls),
            "cuDNN f64 on the card": sum(wgrad(
                r, mods[n].weight, torch.float64, "cuda", exact_math)
                for r in calls)}
        print(f"{n}.weight alone ({len(calls)} calls, inputs "
              f"{[list(r['input'].shape) for r in calls]}), relative L2 "
              f"against float64 on the CPU of the same inputs: " + ", ".join(
                  f"{k} {rel_l2(v, ref):.4g}" for k, v in rows.items()))
    # the gradients reaching each conv's output, card and CPU, against the
    # float64 step's (the three layer-0 convs' outputs are summed, so they
    # share one output gradient)
    def joined(cap, n):
        return torch.cat([r["grad"].flatten().cpu() for r in cap.calls[n]])

    for n in (BAND2[0],) + TRUNK:
        ref = joined(f64, n).double()
        print(f"output gradient of {n} over its {len(f64.calls[n])} calls "
              f"against the float64 step's, relative L2: card "
              f"{rel_l2(joined(card_cap, n), ref):.4g}, CPU "
              f"{rel_l2(joined(cpu_cap, n), ref):.4g}")

    # 4. ms a paper_a step under each setting
    for label, ctx in SETTINGS.items():
        med, lo, hi = step_ms(ctx, args.runs)
        print(f"paper_a step (2 x 32 of 160^2), {label}: {med:.2f} ms "
              f"(min {lo:.2f}, max {hi:.2f}, median of {args.runs}); "
              f"{cs.card_line()}")
    print(cs.card_line())


if __name__ == "__main__":
    main()
