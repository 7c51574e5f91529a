#!/usr/bin/env python3
"""Round-trip times, container hash and a device profile of the port.

Usage: python3 tools/profile_torch_codec.py [--tree DIR] [--runs 15]
                                            [--no-profile] [--batch K]
                                            [--two-stage] [--stages]
                                            [--host-backend] [--rate]
       python3 tools/profile_torch_codec.py --train [--tree DIR] [--runs 15]

Imports ``llicti_torch`` from ``DIR`` (default: this repository; give an
unpacked older tree to compare two versions in one run) and round-trips
``synthetic_image(512, 768, seed=42)`` with the trained flagship weights
and 1024 lanes on the CUDA card: prints the container's sha256, size and
bpsp, the encode and decode times of ``--runs`` round trips (host clock
around work that ends in ``torch.cuda.synchronize()``, after one warm-up;
min / median / max), Kernel 3's CUDA-event time and launches per encode
(:func:`encode_kernel_ms`), and, unless ``--no-profile``, one ``torch.profiler``
run of each direction: wall time, device busy time (the union of the
kernels' intervals), idle share, device time and launches per kernel
group (:func:`group_of`: the benchmark's groups), and the three
costliest kernels of "other".  Trees with the decoder's staging block
(not older ones) also give, with ``--stages``, the median host ms of
each stage of a single-image decode and encode (parse and stage,
upload; the encode's staging, which uploads the image and fetches its
colour ranges;
queueing the device work, the final fetch with its wait for the card);
with ``--batch K``, the times of ``compress_batch`` /
``decompress_batch`` of K images
(seeds 42, 43, ...) and a profile of each and of the resident closures
(``prepare_decode``, ``prepare_encode``, ``prepare_decode_batch``); with
``--two-stage``, the decode times of a ``two_stage`` codec and the fused
one in turns, and a profile of the two-stage decode.  Trees with the host
backend and the rate forward also give, with ``--host-backend``, the
encode and decode times of a ``backend="host"`` codec and a profile of
each direction, and with ``--rate``, the times of the flagship's rate
forward (``LLICTIModel.forward`` under ``exact_math``) and its profile.
``--train`` (trees with ``llicti_torch.training``) instead profiles the
flagship's training: one optimiser step of ``configs/paper_a.json`` (2
microbatches of 32 synthetic 160x160 patches, random weights from seed
1337, Adam at 1e-4) timed over ``--runs`` steps with PyTorch's default
flags and under ``exact_math``; the step split on the device timeline by
CUDA events into upload, forward, backward and optimiser; and a profile
of one step (busy time, idle share, kernel groups, the costliest kernels
of "other").  The last line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from llbench import readers  # noqa: E402
from llbench.trace import capture  # noqa: E402

# the benchmark's kernel groups (llbench/readers.py), in the order a name
# is filed: the hand kernels, cuDNN's layout changes and NCCL before the
# convs, whose patterns ("cudnn") the layout changes also match
GROUP_ORDER = (("kernel1", readers.KERNEL1), ("kernel2", readers.KERNEL2),
          ("kernel3", readers.KERNEL3), ("transpose", readers.TRANSPOSE),
          ("nccl", readers.NCCL), ("conv", readers.CONV))


def group_of(kernel_name: str) -> str:
    """The group of the benchmark's that ``kernel_name`` is filed under:
    the first of :data:`GROUP_ORDER` whose patterns it holds, else "other"."""
    low = kernel_name.lower()
    return next((group for group, patterns in GROUP_ORDER
                 if any(p in low for p in patterns)), "other")


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def encode_kernel_ms(codec, img, iters: int = 20):
    """(CUDA-event ms of Kernel 3 per encode of ``img``, its launches per
    encode): the encoder's inputs are captured from one ``compress``, then
    encoded ``iters`` times from fresh states the way this tree's
    ``compress`` calls the encoder: one chain call, or in older trees one
    call per slice.  CPU tensors would run the plain version: the caller
    gives a CUDA codec."""
    from llicti_torch import codec as cmod
    name = ("rans_encode_chain" if hasattr(cmod, "rans_encode_chain")
            else "rans_encode")
    fn = getattr(cmod, name)
    calls = []

    def record(*args):
        calls.append(args)
        return fn(*args)

    setattr(cmod, name, record)
    try:
        codec.compress(img)
    finally:
        setattr(cmod, name, fn)
    states, cursor, buf = calls[0][-3:]
    carries = [(torch.full_like(states, 1 << 16), torch.zeros_like(cursor),
                torch.zeros_like(buf)) for _ in range(iters + 1)]

    def encode(carry):
        for args in calls:
            fn(*args[:-3], *carry)

    encode(carries[0])
    torch.cuda.synchronize()
    launches = fn.launches
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    # queued behind a ~10 ms device-side wait, so that the wrappers' host
    # work does not show in the kernels' time
    torch.cuda._sleep(20_000_000)
    t0.record()
    for carry in carries[1:]:
        encode(carry)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters, (fn.launches - launches) // iters


def profile(fn, label: str, top: int = 3) -> None:
    """One call of ``fn`` under the benchmark's trace (``llbench.trace``):
    wall ms, device busy ms and idle share, ms and launches of each kernel
    group, and the ``top`` costliest kernels of "other"."""
    traces = []
    with capture(1, traces, torch.device("cuda")):
        _, wall = timed(fn)
    trace = traces[0]
    busy = 1e3 * trace.busy_s
    print(f"profile {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {1 - busy / wall:.3f}")
    groups = {group: [0.0, 0] for group, _ in GROUP_ORDER}
    groups["other"] = [0.0, 0]
    other = {}  # kernel name -> [ms, launches] within "other"
    for name, a, b in trace.kernels:
        group = group_of(name)
        entries = [groups[group]]
        if group == "other":
            entries.append(other.setdefault(name, [0.0, 0]))
        for entry in entries:
            entry[0] += (b - a) / 1e3
            entry[1] += 1
    for group, (ms, count) in groups.items():
        print(f"profile {label}: {group}: {ms:.3f} ms, {count} kernels")
    for name, (ms, count) in sorted(other.items(),
                                    key=lambda kv: -kv[1][0])[:top]:
        print(f"profile {label}: other: {ms:.3f} ms in {count} x {name[:70]}")


def medians(label: str, xs, per: int = 1) -> None:
    print(f"{label} ms over {len(xs)} runs: min {min(xs):.2f}, median "
          f"{statistics.median(xs):.2f}, max {max(xs):.2f}"
          + (f"; median per image {statistics.median(xs) / per:.2f}"
             if per > 1 else ""))


def serving(codec, img, args) -> None:
    """The batch container and the resident closures."""
    from llicti_torch import synthetic_image
    K = args.batch
    imgs = [synthetic_image(512, 768, seed=42 + k) for k in range(K)]
    bstreams = codec.compress_batch(imgs)
    codec.decompress_batch(bstreams)
    enc, dec = [], []
    for _ in range(args.runs):
        bstreams, ms = timed(lambda: codec.compress_batch(imgs))
        enc.append(ms)
        _, ms = timed(lambda: codec.decompress_batch(bstreams))
        dec.append(ms)
    medians(f"batch encode K={K}", enc, K)
    medians(f"batch decode K={K}", dec, K)
    streams = codec.compress(img)
    closures = (("resident decode", codec.prepare_decode(streams)),
                ("resident encode", codec.prepare_encode(img)),
                (f"resident batch decode K={K}",
                 codec.prepare_decode_batch(bstreams)))
    for label, fn in closures:
        fn()
        medians(label, [timed(fn)[1] for _ in range(args.runs)])
    if not args.no_profile:
        profile(lambda: codec.compress_batch(imgs), f"batch encode K={K}")
        profile(lambda: codec.decompress_batch(bstreams),
                f"batch decode K={K}")
        for label, fn in closures:
            profile(fn, label)


def stages(codec, img, args) -> None:
    """Host ms of each stage of a single-image decode and encode, through
    the codec's own stage functions (the order ``decompress`` and
    ``compress`` call them in)."""
    from llicti_torch import codec as cmod
    streams = codec.compress(img)
    times = {}

    def lap(key, t0):
        t = time.perf_counter()
        times.setdefault(key, []).append(1e3 * (t - t0))
        return t

    for _ in range(args.runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        hdr = cmod.parse_container(streams, codec.cfg.dwtlevels)
        staged, = codec._decode_stage([[streams[1][0]]])
        t = lap("decode: parse and stage", t)
        d = codec._decode_upload(hdr, staged, split=True)
        t = lap("decode: upload", t)
        _, rgb = codec._decode_queue(d)
        t = lap("decode: queue", t)
        codec._fetch([rgb])
        lap("decode: fetch (waits for the card)", t)
        torch.cuda.synchronize()
        t = time.perf_counter()
        (st,), (dev,) = codec._stage([[img]])
        t = lap("encode: stage (upload, colour ranges on the card)", t)
        cursors, lanes, buf, ideal = codec._encode_queue(dev, st)
        t = lap("encode: queue", t)
        small = codec._fetch([cursors, lanes, ideal])
        codec._fetch([buf[0, :int(small[0][0, -1])]])
        lap("encode: fetches (wait for the card)", t)
    for key, xs in times.items():
        print(f"stage {key}: median {statistics.median(xs):.3f} ms")


def two_stage(codec, img, args) -> None:
    """Decode times of a two_stage codec and the fused one, in turns."""
    from llicti_torch import Codec, ModelConfig, load_npz
    split = Codec(ModelConfig(), load_npz(), device="cuda", num_lanes=codec.N,
                  two_stage=True)
    streams = codec.compress(img)
    split.decompress(streams)
    fused, staged = [], []
    for _ in range(args.runs):
        fused.append(timed(lambda: codec.decompress(streams))[1])
        staged.append(timed(lambda: split.decompress(streams))[1])
    medians("fused decode (in turns)", fused)
    medians("two-stage decode (in turns)", staged)
    if not args.no_profile:
        profile(lambda: split.decompress(streams), "two-stage decode")


def host_backend(img, args) -> None:
    """Round trips of a host-backend codec: times and profiles."""
    from llicti_torch import Codec, ModelConfig, load_npz
    host = Codec(ModelConfig(), load_npz(), device="cuda", num_lanes=1024,
                 backend="host")
    streams = host.compress(img)
    host.decompress(streams)
    enc, dec = [], []
    for _ in range(args.runs):
        streams, ms = timed(lambda: host.compress(img))
        enc.append(ms)
        dec.append(timed(lambda: host.decompress(streams))[1])
    print(f"host backend: {Codec.num_bytes(streams)} bytes, bpsp "
          f"{Codec.num_bytes(streams) * 8 / img.size:.4f}")
    medians("host-backend encode", enc)
    medians("host-backend decode", dec)
    if not args.no_profile:
        profile(lambda: host.compress(img), "host-backend encode")
        profile(lambda: host.decompress(streams), "host-backend decode")


def rate(codec, img, args) -> None:
    """The flagship's rate forward on the card: times and a profile."""
    from llicti_torch.codec import exact_math
    x = torch.from_numpy(img[None].astype("float32") / 255.0).cuda()

    def forward():
        with torch.inference_mode(), exact_math():
            return codec.model(x)

    forward()
    medians("rate forward", [timed(forward)[1] for _ in range(args.runs)])
    if not args.no_profile:
        profile(forward, "rate forward")


def train(args) -> None:
    """The flagship's optimiser step: times, a split by phase, a
    profile."""
    from llicti_torch import ModelConfig
    from llicti_torch.codec import exact_math
    from llicti_torch.data import ImageDataset, TrainLoader
    from llicti_torch.training import (apply_gradients, make_optimizer,
                                       make_train_step)
    from llicti_torch.training.loss import rate_loss_list
    from llicti_torch.weights import init_params, params_from_flax

    cfg = ModelConfig()
    ds = ImageDataset(synthetic_len=64, synthetic_size=160, seed=1337)
    batch = next(iter(TrainLoader(ds, 32, 160, grad_acc=2, seed=1337)))
    host = torch.from_numpy(batch).pin_memory()
    model = params_from_flax(init_params(cfg, 1337), cfg).cuda()
    opt = make_optimizer(model, 1e-4)
    step = make_train_step(model, opt)

    def full():
        return step(host.to("cuda", non_blocking=True))

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def split():
        """make_train_step's phases with an event between each."""
        marks = [event()]
        x = host.to("cuda", non_blocking=True)
        marks.append(event())
        opt.zero_grad(set_to_none=True)
        fwd = []
        for xb in x:
            a = event()
            total, _ = rate_loss_list(xb.numel(), model(xb))
            b = event()
            total.backward()
            fwd.append((a, b, event()))
        for p in model.parameters():
            p.grad.div_(x.shape[0])
        apply_gradients(opt, 5.0)
        marks.append(event())
        torch.cuda.synchronize()
        return (marks[0].elapsed_time(marks[1]),
                sum(a.elapsed_time(b) for a, b, _ in fwd),
                sum(b.elapsed_time(c) for _, b, c in fwd),
                fwd[-1][2].elapsed_time(marks[2]))

    for label, ctx in (("default flags", contextlib.nullcontext),
                       ("exact_math", exact_math)):
        with ctx():
            full()
            torch.cuda.reset_peak_memory_stats()
            medians(f"train step ({label})",
                    [timed(full)[1] for _ in range(args.runs)])
            parts = [split() for _ in range(5)]
        print(f"train step ({label}) peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB; "
              "device-timeline medians of 5 split steps: " + ", ".join(
                  f"{name} {statistics.median(p[i] for p in parts):.2f} ms"
                  for i, name in enumerate(("upload", "forward", "backward",
                                            "optimiser"))))
    if not args.no_profile:
        profile(full, "train step (default flags)", top=8)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--runs", type=int, default=15)
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--two-stage", action="store_true")
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--host-backend", action="store_true")
    ap.add_argument("--rate", action="store_true")
    ap.add_argument("--train", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_codec: CUDA is not available")
    sys.path.insert(0, os.path.abspath(args.tree))
    if args.train:
        train(args)
        print(card_line())
        return
    from llicti_torch import Codec, ModelConfig, load_npz, synthetic_image

    codec = Codec(ModelConfig(), load_npz(), device="cuda", num_lanes=1024)
    img = synthetic_image(512, 768, seed=42)
    blob = Codec.serialize(codec.compress(img))
    back = codec.decompress(Codec.deserialize(blob))
    if not (back[0] == img).all():
        raise SystemExit("profile_torch_codec: round trip is lossy")
    bpsp = Codec.num_bytes(Codec.deserialize(blob)) * 8 / img.size
    print(f"tree {args.tree}: container sha256 "
          f"{hashlib.sha256(blob).hexdigest()}, {len(blob)} bytes, bpsp "
          f"{bpsp:.4f}")
    enc, dec = [], []
    for _ in range(args.runs):
        streams, ms = timed(lambda: codec.compress(img))
        enc.append(ms)
        _, ms = timed(lambda: codec.decompress(streams))
        dec.append(ms)
    for label, xs in (("encode", enc), ("decode", dec)):
        print(f"{label} ms over {args.runs} round trips: min {min(xs):.2f}, "
              f"median {statistics.median(xs):.2f}, max {max(xs):.2f}")
    ms, launches = encode_kernel_ms(codec, img)
    print(f"Kernel 3 per encode (CUDA events, 20 encodes of the captured "
          f"slices): {ms:.5f} ms, {launches} launches")
    if not args.no_profile:
        profile(lambda: codec.compress(img), "encode")
        streams = codec.compress(img)
        profile(lambda: codec.decompress(streams), "decode")
    if args.stages:
        stages(codec, img, args)
    if args.batch:
        serving(codec, img, args)
    if args.two_stage:
        two_stage(codec, img, args)
    if args.host_backend:
        host_backend(img, args)
    if args.rate:
        rate(codec, img, args)
    print(card_line())


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


if __name__ == "__main__":
    main()
