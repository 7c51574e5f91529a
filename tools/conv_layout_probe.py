#!/usr/bin/env python3
"""Time the flagship interpolator at a batch of K images in the port's
NCHW layout and in channels-last, or at batch 1, on the CUDA card.

Usage: python3 tools/conv_layout_probe.py [--k 1 8] [--iters 10]
       python3 tools/conv_layout_probe.py --batch1 [--k 8] [--iters 10]

For each K: the three bands' ``band_params`` of the finest scale of K
512x768 images (conditioning tensors [K, 256, 384, 12] drawn from a
seeded generator), with the codec's cuDNN settings (TF32 off,
deterministic, no autotune) and the trained weights.  Prints, per layout,
ms a call and an image by CUDA events over ``--iters`` calls after a
warm-up, the share of one call's device time spent in cuDNN's
layout-transpose kernels (``torch.profiler``), and the largest difference
between the two layouts' parameter maps.  The codec itself runs NCHW;
this measures what a channels-last model would change.

``--batch1``: for each (scale, band) of K synthetic 512x768 images
(``data.synthetic_image``, seeds 42 ...; the codec's own wavelet bands),
the codec's two interpolator paths: ``band_params`` at batch K and
``band_params_batched`` (the trunk at batch 1, what a batch of K > 1
runs on the card).  Prints ms a call of each, the ms of cuDNN's
transpose kernels under each conv, by the conv's weight shape, the
device ms outside any conv, and whether the two parameter maps are
bit-equal (``torch.equal``).  The last line is the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import copy
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from llicti_torch import ModelConfig, load_npz, params_from_flax  # noqa: E402
from llicti_torch.codec import Codec, exact_math  # noqa: E402
from llicti_torch.data.dataset import synthetic_image  # noqa: E402


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


def profiled(fn, record_shapes: bool = False):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.events()


def is_transpose(name: str) -> bool:
    return "transpose" in name.lower()


def transpose_share(fn) -> float:
    total = moved = 0.0
    for ev in profiled(fn):
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.end - ev.time_range.start
        total += us
        if is_transpose(ev.name):
            moved += us
    return moved / total if total else float("nan")


def kernels_under(ev):
    """(name, device us) of every kernel launched by ev or below it."""
    out = [(k.name, k.duration) for k in ev.kernels]
    for child in ev.cpu_children:
        out += kernels_under(child)
    return out


def conv_transposes(fn):
    """Profile one call of ``fn``. -> ({conv weight shape: transpose ms
    under its convs}, transpose ms outside any conv, device ms)."""
    by_weight, in_convs, every, device = defaultdict(float), 0.0, 0.0, 0.0
    for ev in profiled(fn, record_shapes=True):
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.time_range.end - ev.time_range.start
            device += us / 1e3
            every += us / 1e3 if is_transpose(ev.name) else 0.0
        elif ev.name == "aten::cudnn_convolution":
            weight = tuple(ev.input_shapes[1])
            for name, us in kernels_under(ev):
                if is_transpose(name):
                    by_weight[weight] += us / 1e3
                    in_convs += us / 1e3
    return dict(by_weight), every - in_convs, device


def layout_probe(args) -> None:
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


def batch1_probe(args) -> None:
    codec = Codec(ModelConfig(), load_npz(), num_lanes=1024)
    model = codec.model
    with torch.inference_mode(), exact_math():
        for K in args.k:
            rgb = torch.from_numpy(np.stack(
                [synthetic_image(512, 768, seed=42 + k) for k in range(K)]))
            y_list = codec._front(rgb.cuda())
            totals = defaultdict(float)
            all_equal = True
            for scl in range(codec.cfg.num_scales):
                for b in range(3):
                    c = codec.cfg.cond_channels
                    y = y_list[scl][..., :c * (b + 1)].contiguous()
                    paths = {"batch K": lambda: model.band_params(y, scl, b),
                             "batch 1": lambda: model.band_params_batched(
                                 y, scl, b)}
                    maps = {}
                    for label, fn in paths.items():
                        ms = events_ms(fn, args.iters)
                        by_w, outside, dev = conv_transposes(fn)
                        maps[label] = fn()
                        moved = sum(by_w.values())
                        totals[label, "ms"] += ms
                        totals[label, "transpose"] += moved + outside
                        shapes = ", ".join(
                            f"w{list(w)} {v:.3f}"
                            for w, v in sorted(by_w.items())) or "none"
                        print(f"K={K} scale {scl} band {b} {label}: "
                              f"{ms:.3f} ms a call; transposes under convs "
                              f"{moved:.3f} ms ({shapes}); outside convs "
                              f"{outside:.3f} ms; device {dev:.3f} ms")
                    same = torch.equal(maps["batch K"], maps["batch 1"])
                    all_equal &= same
                    print(f"K={K} scale {scl} band {b}: shapes "
                          f"{list(y.shape)}, maps bit-equal {same}")
            for label in ("batch K", "batch 1"):
                print(f"K={K} {label}: {totals[label, 'ms']:.3f} ms over "
                      f"the 15 bands ({totals[label, 'ms'] / K:.3f} an "
                      f"image), transposes {totals[label, 'transpose']:.3f} "
                      f"ms")
            print(f"K={K}: every (scale, band) bit-equal: {all_equal}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, nargs="+", default=None)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch1", action="store_true",
                    help="the codec's batch-K and batch-1 paths")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_layout_probe: CUDA is not available")
    if args.batch1:
        args.k = args.k or [8]
        batch1_probe(args)
    else:
        args.k = args.k or [1, 8]
        layout_probe(args)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
