"""``codec_seeded_batch``'s closed loop, K same-size images a call
(``compress_batch`` into one batch container, then ``decompress_batch``),
for a clr_joint_mode 1 model: the program and the reference
(``llbench/reference/clrjnt1.py``) code with fixed float32 weights made
from ``weights_seed`` (the same model in every run).  Parameters:
``codec_roundtrip``'s, with ``batch`` K >= 2, and ``weights_seed``.

Checked after the window as ``codec_roundtrip`` checks: each decoded
image of the sampled calls against its input (``wrong_subpixels``) and
each batch container byte for byte against the reference encoder's on
the same K images (``container_bytes_off``).  ``flops_per_image`` is
``clrjnt1.forward_flops``; ``work`` holds each traced call's kernel work
(``codec_roundtrip.kernel_work``), ``work_m10`` the least seconds of its
Kernel 1 launches of ten mixture terms (Y's 2M at M = 5), both
directions.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np

from .. import checks, trace, work
from ..cell import Context, Outcome, free_memory, host_times
from ..data import synthetic_images
from ..reference import codec as ref_codec
from ..reference import clrjnt1 as ref_clrjnt1
from ..reference import model as ref_model
from . import memory_peak, permutation, port_config, sync
from .codec_roundtrip import container_bytes, kernel_work


def run(ctx: Context) -> Outcome:
    from llicti_torch import Codec
    p, dev = ctx.params, ctx.device
    H, W, K = p["height"], p["width"], p["batch"]
    if K < 2:
        raise ValueError("a batch container cell codes K >= 2 images a call")
    rcfg = ref_clrjnt1.Clrjnt1Config(ctx.config["model"])
    weights = ref_clrjnt1.seeded_weights(rcfg, p["weights_seed"])
    codec = Codec(port_config(ctx.config), weights, device=dev,
                  num_lanes=p["lanes"])
    ctx.note("codec built")
    pool = synthetic_images(p["pool"], H, W, p["pool_seed"], dev).cpu().numpy()
    ctx.note("images made")
    units = [list(range(u * K, (u + 1) * K)) for u in range(p["pool"] // K)]
    order = permutation(len(units), ctx.seed, 0)

    def call(u: int):
        imgs = [pool[i] for i in units[u]]
        sync(dev)
        t0 = time.perf_counter()
        with trace.span("compress"):
            streams = codec.compress_batch(imgs)
        sync(dev)
        t1 = time.perf_counter()
        with trace.span("decompress"):
            outs = codec.decompress_batch(streams)
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
    traced = [order[(i + j) % len(order)]
              for j in range(p["traced"] if ctx.trace else 0)]
    if traced:
        with trace.capture(len(traced) * K, traces, dev):
            for u in traced:
                outs_all.append((u, call(u)[1]))
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
    model = ref_clrjnt1.build(rcfg, ref_model.from_flax(weights), dev)
    enc = ref_clrjnt1.Clrjnt1Encoder(model, p["lanes"], dev)
    refs: Dict[int, Dict] = {
        u: enc.encode_batch([pool[i] for i in units[u]])
        for u in sorted({u for u, _ in kept} | set(traced))}
    off = sum(checks.bytes_off(ref_codec.serialize(s),
                               ref_codec.serialize(refs[u]["streams"]))
              for u, s in kept)
    pixels = H * W
    return Outcome(
        attempted=(len(enc_ms) + len(traced)) * K, failed=failed,
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
               "work": [kernel_work(refs[u], p["lanes"]) for u in traced],
               "flops_per_image": ref_clrjnt1.forward_flops(
                   ctx.config["model"], H, W),
               "work_m10": [terms_work(refs[u], 10) for u in traced]})


def terms_work(ref: Dict, terms: int) -> float:
    """The least seconds of Kernel 1's launches of ``terms`` mixture terms
    over one round trip of a call's images (both directions), from the
    reference's counts on them."""
    return sum(2 * work.bound_s(*work.cdf_work(rows, P, spec, sch, sat))
               for rows, P, spec, sch, sat in ref["slices"]
               if spec[0] == terms)
