"""Optimiser steps as a trainer takes them: ``make_train_step`` with
``make_optimizer`` on the configuration's batch, patch size and
gradient accumulation, under PyTorch's default flags (cuDNN may use
TF32, as the Trainer leaves it).  Parameters: ``pinned`` distinct
batches made from the seed, held in pinned host memory and uploaded
without blocking in each step, cycled; ``checked`` steps; ``traced``
steps profiled in a traced run.

Set-up builds the step, with its model from weights made from the seed,
and drives it through its first ``checked`` steps, each on a different
batch through the window's own call; the window then goes on with the
same object.  After the window the reference takes the same steps from
the same weights on the same batches, and the comparison reads each
step's loss (``loss_gap``), the first gradient as Adam holds it after
one step (``grad_norm_gap``, by the worst leaf) and the parameters'
change over the checked steps (``update_norm_gap``, by the worst leaf
that moves).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List

import torch

from .. import checks, trace, work
from ..cell import Context, Outcome, free_memory
from ..data import random_weights, training_batches
from ..reference import model as ref_model
from ..reference import train as ref_train
from . import memory_peak, port_config, sync

BETA1 = 0.9  # Adam's first-moment decay, the program's as published


def program_readings(model, opt, call: Callable, checked: int) -> Dict:
    """Drive the step ``call(i)`` through steps 0..checked-1 and read the
    program's side of the comparison: each step's loss, the first
    step's gradients as Adam's moment holds them (m = (1 - beta1) g after
    one step from zero), and each parameter's change."""
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    losses, grads = [], None
    for i in range(checked):
        losses.append(float(call(i)["loss"]))
        if grads is None:  # no moment: Adam took no step
            grads = checks.norms({
                n: opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                / (1 - BETA1) for n, p in named.items()})
    delta = checks.norms({n: p.detach() - before[n]
                          for n, p in named.items()})
    return {"losses": losses, "grads": grads, "delta": delta}


def setup(ctx: Context):
    """The configuration's step on this device, its weights and batches
    made from the seed: -> (model, optimiser, step, reference config,
    weights, device batches, pinned host batches)."""
    from llicti_torch.models.llicti import LLICTIModel
    from llicti_torch.training import make_optimizer, make_train_step
    t, p, dev = ctx.config["train"], ctx.params, ctx.device
    rcfg = ref_model.Config(ctx.config["model"])
    state = random_weights(ref_model.leaves(rcfg), ctx.seed, dev)
    batches = training_batches(p["pinned"], t["grad_acc_iters"],
                               t["batch_size"], t["patch_size"],
                               ctx.seed + 1, dev)
    hosts = [b.cpu().pin_memory() if dev.type == "cuda" else b.cpu()
             for b in batches]
    ctx.note("weights and batches made")
    model = LLICTIModel(port_config(ctx.config)).to(dev)
    model.load_state_dict(state, strict=True)
    model.train()
    opt = make_optimizer(model, t["learning_rate"])
    step = make_train_step(model, opt, t["grad_clip_value"])
    ctx.note("step built")
    return model, opt, step, rcfg, state, batches, hosts


def window(ctx: Context, call: Callable, first: int, traces: List):
    """Steps from ``first`` on for the run's seconds; -> (steps, seconds,
    losses).  A traced run then profiles the next steps."""
    dev = ctx.device
    losses = []
    sync(dev)
    t0 = time.perf_counter()
    i = first
    while time.perf_counter() - t0 < ctx.seconds:
        with trace.span("step"):
            losses.append(call(i)["loss"])
        i += 1
    sync(dev)
    seconds = time.perf_counter() - t0
    if ctx.trace:
        n = ctx.params["traced"]
        with trace.capture(n, traces, dev):
            for j in range(i, i + n):
                with trace.span("step"):
                    losses.append(call(j)["loss"])
    return i - first, seconds, losses


def run(ctx: Context) -> Outcome:
    p, t, dev = ctx.params, ctx.config["train"], ctx.device
    model, opt, step, rcfg, state, batches, hosts = setup(ctx)

    def call(i: int):
        return step(hosts[i % len(hosts)].to(dev, non_blocking=True))

    prog = program_readings(model, opt, call, p["checked"])
    ctx.note("checked steps taken")
    setup_s = ctx.setup_done()
    traces: List[trace.Trace] = []
    steps, seconds, losses = window(ctx, call, p["checked"], traces)
    peak = memory_peak(dev)
    bad = int((~torch.isfinite(torch.stack(losses))).sum())
    del model, opt, step, hosts
    free_memory()
    ref = ref_train.run_steps(rcfg, state, batches[:p["checked"]],
                              t["learning_rate"], t["grad_clip_value"], dev)
    ref = {"losses": ref["losses"], "grads": checks.norms(ref["grads"]),
           "delta": checks.norms(ref["delta"])}
    nums = checks.step_numbers(prog, ref)
    return outcome(ctx, len(losses) + p["checked"], bad, setup_s, steps, seconds,
                   nums, peak, traces, 1)


def outcome(ctx: Context, attempted: int, failed: int, setup_s: float,
            steps: int, seconds: float, nums: Dict, peak: int,
            traces: List, chips: int) -> Outcome:
    t = ctx.config["train"]
    patches = t["grad_acc_iters"] * t["batch_size"]
    return Outcome(
        attempted=attempted, failed=failed, setup_s=setup_s,
        window={"seconds": seconds, "steps": steps},
        checks=[(name, nums[name][0], limit)
                for name, limit in ctx.workload["limits"].items()],
        memory_peak_bytes=peak, devices=chips,
        trace=traces[0] if traces else None,
        extra={"config": ctx.config, "chips": chips,
               "flops_per_step": patches * work.forward_flops(
                   ctx.config["model"], t["patch_size"], t["patch_size"]),
               "readings": {n: v[0] for n, v in nums.items()},
               "worst_leaves": {n: v[1] for n, v in nums.items()}})
