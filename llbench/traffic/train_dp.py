"""Data-parallel optimiser steps over the cell's cards, one rank a card:
``make_parallel_train_step`` on a data-parallel ``Mesh`` of every rank,
each rank stepping on its part of the configuration's global batch (the
batch axis split over the ranks), its gradients all-reduced.  Parameters
as :mod:`llbench.traffic.train_step`'s.

Rank 0 is the command's own process: it starts the other ranks as
processes of the same command (``--rank R --port P``) and joins them in
one process group over ``localhost``.  Every rank makes the weights and
the global batches from the seed, keeps its part, and takes the checked
steps; then the window.  The ranks agree on when the window ends by an
all-reduce of rank 0's stop flag after every step, read one step later,
so that the host stays a step ahead of the cards.  After the window
every rank compares its own checked steps with the reference's (the
whole global batch on one card), so the all-reduced gradients and the
update are judged on every rank; rank 0 reports the worst rank's numbers.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from .. import checks, ranks, trace
from ..cell import Context, Outcome, free_memory
from ..data import random_weights, training_batches
from ..reference import model as ref_model
from ..reference import train as ref_train
from . import memory_peak, port_config, sync
from .train_step import outcome, program_readings


def run(ctx: Context) -> Outcome:
    """Rank 0: its own rank, then the others' ends (the command started
    them)."""
    try:
        return _rank(ctx)
    finally:
        ranks.wait(ctx.ranks)


def worker(ctx: Context) -> None:
    _rank(ctx)


def build(ctx: Context):
    """The rank's step, in the process group of every rank (joined on
    first use), its model and optimiser from weights made from the seed:
    -> (model, optimiser, step, call, reference config, weights, the
    global batches on this device).  ``call(i)`` takes a step on the
    rank's part of pinned batch i."""
    from llicti_torch.models.llicti import LLICTIModel
    from llicti_torch.parallel.distributed import initialize
    from llicti_torch.parallel.mesh import batch_sharding, make_mesh
    from llicti_torch.parallel.train import (make_parallel_train_step,
                                             shard_state)
    from llicti_torch.training import make_optimizer
    t, p, dev = ctx.config["train"], ctx.params, ctx.device
    rcfg = ref_model.Config(ctx.config["model"])
    state = random_weights(ref_model.leaves(rcfg), ctx.seed, dev)
    batches = training_batches(p["pinned"], t["grad_acc_iters"],
                               t["batch_size"], t["patch_size"],
                               ctx.seed + 1, dev)
    model = LLICTIModel(port_config(ctx.config)).to(dev)
    model.load_state_dict(state, strict=True)
    model.train()
    opt = make_optimizer(model, t["learning_rate"])
    ctx.note("model and optimiser built")
    if not dist.is_initialized():
        # join once the rank's own set-up is done: the ranks start apart
        initialize(f"localhost:{ctx.port}", ctx.world, ctx.rank,
                   device=dev.type)
        ctx.note(f"rank {ctx.rank} of {ctx.world} joined")
    mesh = make_mesh(data=ctx.world)
    cut = batch_sharding(mesh, has_acc_axis=True)
    hosts = [cut(b).contiguous().cpu() for b in batches]
    if dev.type == "cuda":
        hosts = [h.pin_memory() for h in hosts]
    shard_state(model, opt, mesh)
    step = make_parallel_train_step(model, opt, mesh, t["grad_clip_value"])
    ctx.note("step built")

    def call(i: int):
        return step(hosts[i % len(hosts)].to(dev, non_blocking=True))

    return model, opt, step, call, rcfg, state, batches


def worst_numbers(ctx: Context, prog: Dict, rcfg, state, batches,
                  more: List[float] = ()) -> Tuple[Dict, List[float]]:
    """The reference's checked steps on the whole global batch, compared
    with this rank's ``prog``; -> (every number of the comparison, and
    ``more``, each the worst over the ranks).  Call it on every rank."""
    t = ctx.config["train"]
    ref = ref_train.run_steps(rcfg, state, batches, t["learning_rate"],
                              t["grad_clip_value"], ctx.device)
    ref = {"losses": ref["losses"], "grads": checks.norms(ref["grads"]),
           "delta": checks.norms(ref["delta"])}
    nums = checks.step_numbers(prog, ref)
    names = sorted(nums)
    worst = torch.tensor([nums[n][0] for n in names] + list(more),
                         dtype=torch.float64, device=ctx.device)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    vals = worst.tolist()
    return ({n: (v, nums[n][1]) for n, v in zip(names, vals)},
            vals[len(names):])


def _rank(ctx: Context):
    p, dev = ctx.params, ctx.device
    model, opt, step, call, rcfg, state, batches = build(ctx)
    prog = program_readings(model, opt, call, p["checked"])
    ctx.note("checked steps taken")
    setup_s = ctx.setup_done()
    losses = []
    sync(dev)
    t0 = time.perf_counter()
    i, seen = p["checked"], None
    while True:
        with trace.span("step"):
            losses.append(call(i)["loss"])
        i += 1
        flag = torch.tensor([float(ctx.rank == 0 and time.perf_counter() - t0
                                   >= ctx.seconds)], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if seen is not None and seen.item() > 0:
            break
        seen = flag
    sync(dev)
    seconds = time.perf_counter() - t0
    steps = i - p["checked"]
    traces: List[trace.Trace] = []
    if ctx.trace:
        n = p["traced"]
        with trace.capture(n, traces, dev):
            for j in range(i, i + n):
                with trace.span("step"):
                    losses.append(call(j)["loss"])
    peak = memory_peak(dev)
    bad = int((~torch.isfinite(torch.stack(losses))).sum())
    del model, opt, step, call
    free_memory()
    # the worst rank's numbers, memory and failures
    nums, (peak, bad) = worst_numbers(ctx, prog, rcfg, state,
                                      batches[:p["checked"]], [peak, bad])
    dist.barrier()
    dist.destroy_process_group()
    if ctx.rank:
        return None
    return outcome(ctx, len(losses) + p["checked"], int(bad), setup_s,
                   steps, seconds, nums, int(peak), traces, ctx.world)
