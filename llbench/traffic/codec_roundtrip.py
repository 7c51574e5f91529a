"""One client in a closed loop coding images: compress, then decompress,
each call timed on the host clock with the card synchronised on both
sides.  Parameters: ``height``, ``width``, ``lanes`` (rANS lanes),
``batch`` (1: one image a call, single containers; K > 1: K images a
call, batch containers), ``pool`` distinct images made from
``pool_seed`` (the same set for every run seed; the seed orders them),
``sample`` calls whose containers the reference re-encodes, and
``traced`` calls profiled in a traced run.

Checked after the window, on the calls of a sample of the pool drawn
from the seed (every call of the window that codes a sampled image):
each decoded image against its input (``wrong_subpixels``), and each
container byte for byte against the reference encoder's on the same
images (``container_bytes_off``).
"""
from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np

from .. import checks, trace, work
from ..cell import Context, Outcome, free_memory, host_times
from ..data import synthetic_images, trained_weights
from ..reference import codec as ref_codec
from ..reference import model as ref_model
from . import memory_peak, permutation, port_config, sync


def container_bytes(streams) -> int:
    return sum(len(s) for group in streams for s in group)


def run(ctx: Context) -> Outcome:
    from llicti_torch import Codec
    p, dev = ctx.params, ctx.device
    H, W, K = p["height"], p["width"], p["batch"]
    weights = trained_weights(ctx.config["weights"])
    codec = Codec(port_config(ctx.config), weights, device=dev,
                  num_lanes=p["lanes"])
    ctx.note("codec built")
    pool = synthetic_images(p["pool"], H, W, p["pool_seed"], dev).cpu().numpy()
    ctx.note("images made")
    units = [list(range(u * K, (u + 1) * K)) for u in range(p["pool"] // K)]
    order = permutation(len(units), ctx.seed, 0)
    if K == 1:
        def encode(imgs):
            return codec.compress(imgs[0])

        def decode(streams):
            return [codec.decompress(streams)]
    else:
        def encode(imgs):
            return codec.compress_batch(imgs)

        def decode(streams):
            return codec.decompress_batch(streams)

    def call(u: int):
        imgs = [pool[i] for i in units[u]]
        sync(dev)
        t0 = time.perf_counter()
        with trace.span("compress"):
            streams = encode(imgs)
        sync(dev)
        t1 = time.perf_counter()
        with trace.span("decompress"):
            outs = decode(streams)
        sync(dev)
        t2 = time.perf_counter()
        return streams, outs, 1e3 * (t1 - t0), 1e3 * (t2 - t1)

    for u in order[:2]:  # warm-up: every kernel and shape of the window
        call(u)
        ctx.note("warm-up call")
    sampled = set(permutation(len(order), ctx.seed, 1)[:p["sample"]])
    setup_s = ctx.setup_done()
    enc_ms: List[float] = []
    dec_ms: List[float] = []
    outs_all, kept, sizes = [], [], {}
    host0 = host_times()
    t_start = time.perf_counter()
    i = 0
    while time.perf_counter() - t_start < ctx.seconds:
        u = order[i % len(order)]
        streams, outs, e, d = call(u)
        enc_ms.append(e)
        dec_ms.append(d)
        sizes.setdefault(u, container_bytes(streams))
        if u in sampled:
            kept.append((u, streams))
            outs_all.append((u, outs))
        i += 1
    window_s = time.perf_counter() - t_start
    host1 = host_times()
    ctx.note(f"window: {len(enc_ms)} calls, encode median "
             f"{np.median(enc_ms):.3f} ms, decode median "
             f"{np.median(dec_ms):.3f} ms; host CPU "
             f"{host1['process'] - host0['process']:.2f} s, stolen "
             f"{host1['steal'] - host0['steal']:.2f} s, load "
             f"{os.getloadavg()[0]:.2f}")
    # a traced run profiles the next calls of the same traffic
    traces: List[trace.Trace] = []
    traced_units = [order[(i + j) % len(order)]
                    for j in range(p["traced"] if ctx.trace else 0)]
    if traced_units:
        with trace.capture(len(traced_units) * K, traces, dev):
            for u in traced_units:
                streams, outs, _, _ = call(u)
                outs_all.append((u, outs))
    peak = memory_peak(dev)
    del codec
    free_memory()
    if len(sizes) != len(units):
        raise RuntimeError(f"{ctx.seconds} s coded {len(sizes)} of the "
                           f"pool's {len(units)} calls: a longer window "
                           "is needed")

    wrong, failed = 0, 0
    for u, outs in outs_all:
        bad = [checks.wrong_subpixels(o, pool[i])
               for o, i in zip(outs, units[u])]
        wrong += sum(bad)
        failed += sum(1 for b in bad if b)

    # the reference, once the program's state is freed
    rcfg = ref_model.Config(ctx.config["model"])
    model = ref_model.build(rcfg, ref_model.from_flax(weights), dev)
    enc = ref_codec.Encoder(model, p["lanes"], dev)
    refs: Dict[int, Dict] = {}
    for u in sorted({u for u, _ in kept} | set(traced_units)):
        imgs = [pool[i] for i in units[u]]
        refs[u] = enc.encode_batch(imgs) if K > 1 else enc.encode(imgs)
        refs[u]["blob"] = ref_codec.serialize(refs[u]["streams"])
    off = sum(checks.bytes_off(ref_codec.serialize(s), refs[u]["blob"])
              for u, s in kept)
    pixels = H * W
    return Outcome(
        attempted=(len(enc_ms) + len(traced_units)) * K, failed=failed,
        setup_s=setup_s,
        window={"seconds": window_s, "images": len(enc_ms) * K,
                "pixels": len(enc_ms) * K * pixels,
                "encode_ms": enc_ms, "decode_ms": dec_ms,
                "bpsp": float(np.mean([8 * b / (K * pixels * 3)
                                       for b in sizes.values()]))},
        checks=[("wrong_subpixels", wrong, ctx.limit("wrong_subpixels")),
                ("container_bytes_off", off,
                 ctx.limit("container_bytes_off"))],
        memory_peak_bytes=peak, trace=traces[0] if traces else None,
        extra={"config": ctx.config, "height": H, "width": W, "batch": K,
               "lanes": p["lanes"], "image": pool[units[order[0]][0]],
               "work": [kernel_work(refs[u], p["lanes"])
                        for u in traced_units],
               "flops_per_image": work.forward_flops(ctx.config["model"],
                                                     H, W)})


def kernel_work(ref: Dict, lanes: int) -> Dict[str, float]:
    """The least seconds of Kernels 1-3 over one round trip of a call's
    images, from the reference's counts on them: Kernel 1's tables in both
    directions, Kernel 2's decode of each slice, Kernel 3's encode of
    each chain."""
    slices, words = ref["slices"], ref["words"]
    K = words.shape[0]
    k1 = k2 = 0.0
    for s, (rows, P, spec, sch, sat) in enumerate(slices):
        k1 += 2 * work.bound_s(*work.cdf_work(rows, P, spec, sch, sat))
        k2 += work.bound_s(work.rans_decode_bytes(
            rows, P, int(words[:, s].sum()), K * lanes), 0)
    symbols = sum(r for r, _, _, _, _ in slices)
    k3 = work.bound_s(work.rans_encode_bytes(
        symbols, int(words.sum()), K * lanes), 0)
    return {"kernel1": k1, "kernel2": k2, "kernel3": k3}
