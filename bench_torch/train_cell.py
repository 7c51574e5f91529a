"""Cell ``paper_a_train_step``: one optimiser step, as a trainer runs it.

``configs/paper_a.json``: the flagship model from ``init_params(cfg,
1337)``, batch 32, patch 160, grad-acc 2, Adam at 1e-4, under the
Trainer's flags (PyTorch's defaults).  Synthetic patches from the seed.
(a) ``make_train_step`` on 8 pinned loader batches, cycled and uploaded
non-blocking in each step; (b) the Trainer's own loop over its loader.
"""
from __future__ import annotations

import copy
import math
import os
import statistics
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from llicti_torch.codec import exact_math
from llicti_torch.config import LLICTIConfig, config_from_json, replace
from llicti_torch.data import ImageDataset, TrainLoader
from llicti_torch.training import (Trainer, apply_gradients, make_optimizer,
                                   make_train_step)
from llicti_torch.training.loss import rate_loss_list
from llicti_torch.weights import init_params, params_from_flax

from . import gates, work
from .codec_cell import forward_flops
from .measure import profile, summary

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "paper_a.json")
INIT_SEED = 1337  # the model's weights, whatever the traffic's seed
PINNED = 8  # distinct loader batches, cycled
WARMUP, STEPS, TRAINER_STEPS = 5, 100, 40
SPLIT_STEPS = 5  # steps split by CUDA events in the traced run
LOADER_BATCHES = 8


def paper_a() -> LLICTIConfig:
    return config_from_json(CONFIG)


def loader_batches(cfg: LLICTIConfig, seed: int, count: int
                   ) -> List[np.ndarray]:
    """The first ``count`` batches [acc, B, P, P, 3] of a TrainLoader over
    a synthetic set made from ``seed``, at the config's batch, patch and
    grad-acc."""
    tc = cfg.train
    per = tc.batch_size * tc.grad_acc_iters
    ds = ImageDataset(synthetic_len=per * count,
                      synthetic_size=tc.patch_size, seed=seed)
    it = iter(TrainLoader(ds, tc.batch_size, tc.patch_size,
                          grad_acc=tc.grad_acc_iters, seed=seed))
    return [next(it) for _ in range(count)]


def _model(cfg: LLICTIConfig, device):
    model = params_from_flax(init_params(cfg.model, INIT_SEED),
                             cfg.model).to(device).train()
    return model, make_optimizer(model, cfg.train.learning_rate)


def _hosts(batches, device) -> List[torch.Tensor]:
    hosts = [torch.from_numpy(b) for b in batches]
    if torch.device(device).type == "cuda":
        hosts = [h.pin_memory() for h in hosts]
    return hosts


GATE_I = "gate (i), the first timed step's code path under exact_math()"
GATE_II = "gate (ii), the first timed step"


def _params(model) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _grads(model) -> Dict[str, torch.Tensor]:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def train_steps(cfg: LLICTIConfig, seed: int, clock, device="cuda",
                steps: int = STEPS, warmup: int = WARMUP,
                pinned: int = PINNED) -> Dict:
    """(a) ``warmup`` then ``steps`` timed optimiser steps of
    ``make_train_step``, each uploading its pinned batch non-blocking;
    gates: every loss finite, and the first timed step in two halves
    (``bench_torch.gates``): (i) the same code path from the same state
    and batch again under ``exact_math()``, outside the timed window, its
    loss and gradients against the step in float64 and its update against
    a plain Adam's on the float64 gradients from the optimiser's state
    before the step; (ii) the timed step's loss, gradients and update
    against (i)'s, and its update against a plain Adam's on its own
    gradients."""
    tc = cfg.train
    hosts = _hosts(loader_batches(cfg, seed, pinned), device)
    model, opt = _model(cfg, device)
    step = make_train_step(model, opt, tc.grad_clip_value)

    def run(i):
        return step(hosts[i % pinned].to(device, non_blocking=True))

    for i in range(warmup):
        run(i)
    # the state the first timed step starts in: the model and Adam's moments
    ref, adam = copy.deepcopy(model), gates.adam_snapshot(model, opt)
    opt_state = copy.deepcopy(opt.state_dict())
    times, losses, grads, after = [], [], None, None
    for i in range(warmup, warmup + steps):
        m, ms = clock.host(lambda: run(i))
        times.append(ms)
        losses.append(float(m["loss"]))
        if grads is None:  # the step's clipped gradients and its update
            grads, after = _grads(model), _params(model)
    bad = [i for i, v in enumerate(losses) if not math.isfinite(v)]
    gates.gate(not bad, f"train step: timed steps {bad[:5]} have losses "
               f"{[losses[i] for i in bad[:5]]}")
    first = hosts[warmup % pinned].to(device)
    before = _params(ref)
    # (i) the function: the same step under exact_math()
    exact = copy.deepcopy(ref)
    exact_opt = make_optimizer(exact, tc.learning_rate)
    exact_opt.load_state_dict(opt_state)
    with exact_math():
        exact_loss = float(make_train_step(exact, exact_opt,
                                           tc.grad_clip_value)(first)["loss"])
    exact_grads, exact_after = _grads(exact), _params(exact)
    del exact, exact_opt
    loss64, grads64 = gates.float64_step(ref, first, tc.grad_clip_value)
    loss_rel, grad_l2, worst = gates.step_matches(
        exact_loss, exact_grads, loss64, grads64, gates.LOSS_REL,
        gates.GRAD_L2_BOUND, GATE_I, "the float64 step")
    upd_l2, upd_worst = gates.update_matches(
        before, exact_after, gates.adam_update(adam, grads64),
        gates.UPDATE_L2_BOUND, GATE_I + " (Adam on the float64 gradients)")
    # (ii) the timed step: (i)'s computation, and Adam on its own gradients
    timed_loss_rel, timed_grad_l2, timed_worst = gates.step_matches(
        losses[0], grads, exact_loss, exact_grads, gates.TIMED_LOSS_REL,
        gates.TIMED_GRAD_L2_BOUND, GATE_II, "(i)")
    timed_upd_l2, _ = gates.update_matches(
        before, after, {n: exact_after[n].double() - before[n].double()
                        for n in before},
        gates.TIMED_UPDATE_L2_BOUND, GATE_II + " (against (i)'s update)")
    adam_l2, _ = gates.update_matches(
        before, after, gates.adam_update(adam, {
            n: g.double() for n, g in grads.items()}),
        gates.ADAM_L2_BOUND, GATE_II + " (Adam on its own gradients)")
    return {"step_ms": times, "losses": losses, "loss64": loss64,
            "loss_rel": loss_rel, "grad_l2": grad_l2, "grad_l2_worst": worst,
            "update_l2": upd_l2, "update_l2_worst": upd_worst,
            "timed_loss_rel": timed_loss_rel, "timed_grad_l2": timed_grad_l2,
            "timed_grad_l2_worst": timed_worst,
            "timed_update_l2": timed_upd_l2, "adam_l2": adam_l2}


def trainer_loop(cfg: LLICTIConfig, seed: int, clock, device="cuda",
                 steps: int = TRAINER_STEPS, warmup: int = WARMUP) -> Dict:
    """(b) the Trainer's own loop at the config's settings over a
    synthetic set made from ``seed``, one epoch of ``warmup + steps + 1``
    steps: ms from one step's start to the next's (host clock; the loop
    waits for each step's breakdown), the last ``steps`` intervals
    (validation and checkpoints come after the window)."""
    tc = cfg.train
    per = tc.batch_size * tc.grad_acc_iters
    total = warmup + steps + 1
    starts, losses = [], []
    with tempfile.TemporaryDirectory() as root:
        tr = Trainer(replace(
            cfg, experiments_root=root,
            train=replace(tc, seed=seed, max_epoch=1),
            data=replace(cfg.data, synthetic=True,
                         synthetic_len=per * total)), device=device)
        inner = tr.train_step

        def timed_step(batch):
            starts.append(clock.now())
            m = inner(batch)
            losses.append(m["loss"])
            return m

        tr.train_step = timed_step
        tr.train(max_steps=total)
    gates.gate(len(starts) == total, f"the Trainer took {len(starts)} "
               f"steps, expected {total}")
    losses = [float(v) for v in losses]
    gates.gate(all(math.isfinite(v) for v in losses),
               f"a Trainer loss is not finite: {losses}")
    ms = [1e3 * (b - a) for a, b in zip(starts[warmup:], starts[warmup + 1:])]
    return {"step_ms": ms, "losses": losses}


def step_peak() -> float:
    """The peak rate of the math mode a training step runs under: cuDNN's
    TF32 is PyTorch's default and the Trainer sets no flag."""
    return (work.TF32_FLOP_PER_S if torch.backends.cudnn.allow_tf32
            else work.F32_FLOP_PER_S)


def metrics(steps: Dict, loop: Dict, flops: int) -> Dict[str, Dict]:
    step_ms = statistics.median(steps["step_ms"])
    peak = step_peak()
    return {
        "train_step_ms": dict(summary(steps["step_ms"], 0.9), value=step_ms,
                              loss_rel_float64=steps["loss_rel"],
                              grad_l2_float64=steps["grad_l2"],
                              grad_l2_worst=steps["grad_l2_worst"],
                              update_l2_float64=steps["update_l2"],
                              update_l2_worst=steps["update_l2_worst"],
                              timed_loss_rel=steps["timed_loss_rel"],
                              timed_grad_l2=steps["timed_grad_l2"],
                              timed_grad_l2_worst=steps[
                                  "timed_grad_l2_worst"],
                              timed_update_l2=steps["timed_update_l2"],
                              adam_l2_own_gradients=steps["adam_l2"]),
        "trainer_step_ms": dict(summary(loop["step_ms"], 0.75),
                                value=statistics.median(loop["step_ms"])),
        "train_mfu": {
            "value": 3 * flops / (step_ms / 1e3) / peak,
            "flops_per_step": 3 * flops, "peak_flop_per_s": peak,
            "peak": ("TF32 on the tensor cores: "
                     "torch.backends.cudnn.allow_tf32 is True (PyTorch's "
                     "default; the Trainer sets no flag)")
            if peak == work.TF32_FLOP_PER_S else
            "float32 without tensor cores: cuDNN's TF32 is off"},
    }


def run(seed: int, clock, device="cuda", cfg: LLICTIConfig = None,
        steps: int = STEPS, warmup: int = WARMUP,
        trainer_steps: int = TRAINER_STEPS, pinned: int = PINNED):
    """The cell's traffic, gates and metrics.  -> (set-up numbers,
    metrics)."""
    cfg = cfg or paper_a()
    t0 = time.perf_counter()
    st = train_steps(cfg, seed, clock, device, steps, warmup, pinned)
    setup = {"train_steps_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    loop = trainer_loop(cfg, seed, clock, device, trainer_steps, warmup)
    setup["trainer_s"] = time.perf_counter() - t0
    tc = cfg.train
    model, _ = _model(cfg, device)
    flops = forward_flops(model, tc.patch_size, tc.patch_size,
                          tc.batch_size * tc.grad_acc_iters)
    return setup, metrics(st, loop, flops)


# ---- the traced run -------------------------------------------------------

def _split_step(model, opt, x, clip: float):
    """``make_train_step``'s phases with a CUDA event between each: (ms of
    the forwards, the backwards, the division, clip and Adam step)."""
    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    opt.zero_grad(set_to_none=True)
    marks = []
    for xb in x:
        a = event()
        total, _ = rate_loss_list(xb.numel(), model(xb))
        b = event()
        total.backward()
        marks.append((a, b, event()))
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(x.shape[0])
    apply_gradients(opt, clip)
    end = event()
    torch.cuda.synchronize()
    return (sum(a.elapsed_time(b) for a, b, _ in marks),
            sum(b.elapsed_time(c) for _, b, c in marks),
            marks[-1][2].elapsed_time(end))


def trace(seed: int) -> Dict[str, Dict]:
    """The per-layer metrics of the training cell: a profiled step, the
    step split by CUDA events, and the loader alone."""
    cfg = paper_a()
    tc = cfg.train
    hosts = _hosts(loader_batches(cfg, seed, PINNED), "cuda")
    model, opt = _model(cfg, "cuda")
    step = make_train_step(model, opt, tc.grad_clip_value)
    for i in range(WARMUP):
        step(hosts[i % PINNED].to("cuda", non_blocking=True))
    prof = profile(lambda: step(hosts[0].to("cuda", non_blocking=True)))
    x = hosts[1].to("cuda")
    parts = [_split_step(model, opt, x, tc.grad_clip_value)
             for _ in range(SPLIT_STEPS)]
    out = {"conv_ms": {"value": prof["groups"]["conv"]["ms"],
                       "launches": prof["groups"]["conv"]["launches"]},
           "cudnn_transpose_ms": {
               "value": prof["groups"]["cudnn_transpose"]["ms"],
               "launches": prof["groups"]["cudnn_transpose"]["launches"]},
           "device_idle_share": {"value": prof["idle_share"],
                                 "busy_ms": prof["busy_ms"],
                                 "wall_ms": prof["wall_ms"],
                                 "launches": prof["launches"]}}
    for i, name in enumerate(("fwd_ms", "bwd_ms", "optimizer_ms")):
        out[name] = {"value": statistics.median(p[i] for p in parts),
                     "n": len(parts)}
    per = tc.batch_size * tc.grad_acc_iters
    ds = ImageDataset(synthetic_len=per * LOADER_BATCHES,
                      synthetic_size=tc.patch_size, seed=seed)
    loader = TrainLoader(ds, tc.batch_size, tc.patch_size,
                         grad_acc=tc.grad_acc_iters, seed=seed,
                         num_threads=max(1, cfg.data.dl_numworkers))
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    out["loader_ms_per_batch"] = {
        "value": 1e3 * (time.perf_counter() - t0) / n, "n": n,
        "threads": max(1, cfg.data.dl_numworkers)}
    return out
