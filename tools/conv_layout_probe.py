#!/usr/bin/env python3
"""Time the flagship interpolator at a batch of K images in the port's
NCHW layout and in channels-last, on the CUDA card.

Usage: python3 tools/conv_layout_probe.py [--k 1 8] [--iters 10]

For each K: the three bands' ``band_params`` of the finest scale of K
512x768 images (conditioning tensors [K, 256, 384, 12] drawn from a
seeded generator), with the codec's cuDNN settings (TF32 off,
deterministic, no autotune) and the trained weights.  Prints, per layout,
ms a call and an image by CUDA events over ``--iters`` calls after a
warm-up, the share of one call's device time spent in cuDNN's
layout-transpose kernels (``torch.profiler``), and the largest difference
between the two layouts' parameter maps.  The codec itself runs NCHW;
this measures what a channels-last model would change.  The last line is
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import copy
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from llicti_torch import ModelConfig, load_npz, params_from_flax  # noqa: E402
from llicti_torch.codec import exact_math  # noqa: E402


def band_params_all(model, y):
    return [model.band_params(y[..., :3 * (b + 1)].contiguous(), 0, b)
            for b in range(3)]


def events_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def transpose_share(fn) -> float:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = moved = 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.end - ev.time_range.start
        total += us
        if "transpose" in ev.name.lower():
            moved += us
    return moved / total if total else float("nan")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_layout_probe: CUDA is not available")
    nchw = params_from_flax(load_npz(), ModelConfig()).cuda()
    last = copy.deepcopy(nchw).to(memory_format=torch.channels_last)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    with torch.inference_mode(), exact_math():
        for K in args.k:
            y = torch.rand((K, 256, 384, 12), generator=gen,
                           device="cuda") * 0.8 - 0.4
            outs = {}
            for label, model in (("NCHW", nchw), ("channels-last", last)):
                def fn(model=model):
                    return band_params_all(model, y)
                ms = events_ms(fn, args.iters)
                share = transpose_share(fn)
                outs[label] = fn()
                print(f"K={K} {label}: {ms:.3f} ms a call (three bands), "
                      f"{ms / K:.3f} ms an image; {100 * share:.1f}% of "
                      f"device time in layout transposes")
            err = max(float((a - b).abs().max()) for a, b in
                      zip(outs["NCHW"], outs["channels-last"]))
            print(f"K={K}: max |NCHW - channels-last| over the pmaps "
                  f"{err:.3e}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
