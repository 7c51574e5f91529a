"""``codec_roundtrip``'s closed loop, one image a call, for a model that has
no trained weights here: the program and the reference code with fixed
float32 weights made from ``weights_seed`` (the same model in every run),
by the reference of the configuration's mode
(``llbench/reference/seq.py``: clr_joint_mode 0 with clrjnt0seqmd).
Parameters: ``codec_roundtrip``'s, with ``batch`` 1, and ``weights_seed``.

Checked after the window as ``codec_roundtrip`` checks: each decoded
image of the sampled calls against its input (``wrong_subpixels``) and
each container byte for byte against the reference encoder's
(``container_bytes_off``).  ``flops_per_image`` is the work the model
needs (``seq.forward_flops``), not the program's three trunk passes a
band.
"""
from __future__ import annotations

import os
import time
from typing import List

import numpy as np

from .. import checks, trace
from ..cell import Context, Outcome, free_memory, host_times
from ..data import synthetic_images
from ..reference import codec as ref_codec
from ..reference import model as ref_model
from ..reference import seq as ref_seq
from . import memory_peak, permutation, port_config, sync
from .codec_roundtrip import container_bytes, kernel_work


def run(ctx: Context) -> Outcome:
    from llicti_torch import Codec
    p, dev = ctx.params, ctx.device
    H, W = p["height"], p["width"]
    if p["batch"] != 1:
        raise ValueError("codec_seeded codes one image a call (batch 1)")
    rcfg = ref_seq.SeqConfig(ctx.config["model"])
    weights = ref_seq.seeded_weights(rcfg, p["weights_seed"])
    codec = Codec(port_config(ctx.config), weights, device=dev,
                  num_lanes=p["lanes"])
    ctx.note("codec built")
    pool = synthetic_images(p["pool"], H, W, p["pool_seed"], dev).cpu().numpy()
    ctx.note("images made")
    order = permutation(p["pool"], ctx.seed, 0)

    def call(u: int):
        sync(dev)
        t0 = time.perf_counter()
        with trace.span("compress"):
            streams = codec.compress(pool[u])
        sync(dev)
        t1 = time.perf_counter()
        with trace.span("decompress"):
            out = codec.decompress(streams)
        sync(dev)
        t2 = time.perf_counter()
        return streams, out, 1e3 * (t1 - t0), 1e3 * (t2 - t1)

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
        streams, out, e, d = call(u)
        enc_ms.append(e)
        dec_ms.append(d)
        sizes.setdefault(u, container_bytes(streams))
        if u in sampled:
            kept.append((u, streams))
            outs_all.append((u, out))
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
        with trace.capture(len(traced), traces, dev):
            for u in traced:
                outs_all.append((u, call(u)[1]))
    peak = memory_peak(dev)
    del codec
    free_memory()
    if len(sizes) != p["pool"]:
        raise RuntimeError(f"{ctx.seconds} s coded {len(sizes)} of the "
                           f"pool's {p['pool']} images: a longer window "
                           "is needed")

    wrong = [checks.wrong_subpixels(out, pool[u]) for u, out in outs_all]

    # the reference, once the program's state is freed
    model = ref_seq.build(rcfg, ref_model.from_flax(weights), dev)
    enc = ref_seq.SeqEncoder(model, p["lanes"], dev)
    refs = {u: enc.encode([pool[u]])
            for u in sorted({u for u, _ in kept} | set(traced))}
    off = sum(checks.bytes_off(ref_codec.serialize(s),
                               ref_codec.serialize(refs[u]["streams"]))
              for u, s in kept)
    pixels = H * W
    return Outcome(
        attempted=len(enc_ms) + len(traced),
        failed=sum(1 for b in wrong if b), setup_s=setup_s,
        window={"seconds": window_s, "images": len(enc_ms),
                "pixels": len(enc_ms) * pixels,
                "encode_ms": enc_ms, "decode_ms": dec_ms,
                "bpsp": float(np.mean([8 * b / (pixels * 3)
                                       for b in sizes.values()]))},
        checks=[("wrong_subpixels", sum(wrong),
                 ctx.limit("wrong_subpixels")),
                ("container_bytes_off", off,
                 ctx.limit("container_bytes_off"))],
        memory_peak_bytes=peak, trace=traces[0] if traces else None,
        extra={"config": ctx.config, "height": H, "width": W, "batch": 1,
               "lanes": p["lanes"], "image": pool[order[0]],
               "work": [kernel_work(refs[u], p["lanes"]) for u in traced],
               "flops_per_image": ref_seq.forward_flops(
                   ctx.config["model"], H, W)})
