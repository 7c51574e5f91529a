"""One image a call split by rows over the cell's cards: a ``ShardedCodec``
of ``shards`` row shards over every rank, one rank a card, in a closed
loop (``compress``, then ``decompress``), each call timed on rank 0's
host clock with its card synchronised on both sides.  Parameters:
``height``, ``width``, ``shards`` (G), ``lanes`` (N, a shard's),
``pool`` distinct images made from ``pool_seed`` (the same set for every
run seed; the seed orders them), ``sample`` pool images whose containers
the reference re-encodes, ``traced`` calls profiled on rank 0 in a traced
run, and the configuration's trained ``weights``.

Rank 0 is the command's own process: it starts the other ranks as
processes of the same command and joins them in one process group over
``localhost``.  Every rank makes the pool, codes its rows of every call
and decodes the whole image; they agree on when the window ends by an
all-reduce of rank 0's stop flag after every call.  Checked after the
window on rank 0, on the calls of the sampled images: each decoded image
against its input (``wrong_subpixels``) and each container byte for byte
against the reference encoder's (``llbench/reference/sharded.py``, its
maps in one block a rank: ``container_bytes_off``).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from .. import checks, ranks, trace
from ..cell import Context, Outcome, free_memory
from ..data import synthetic_images, trained_weights
from ..reference import codec as ref_codec
from ..reference import model as ref_model
from ..reference import sharded as ref_sharded
from . import memory_peak, permutation, port_config, sync
from .codec_roundtrip import container_bytes


def run(ctx: Context) -> Outcome:
    """Rank 0: its own rank, then the others' ends (the command started
    them)."""
    try:
        return _rank(ctx)
    finally:
        ranks.wait(ctx.ranks)


def worker(ctx: Context) -> None:
    _rank(ctx)


def _rank(ctx: Context):
    from llicti_torch.parallel.codec_sp import ShardedCodec, make_sp_mesh
    from llicti_torch.parallel.distributed import initialize
    p, dev = ctx.params, ctx.device
    H, W = p["height"], p["width"]
    weights = trained_weights(ctx.config["weights"])
    pool = synthetic_images(p["pool"], H, W, p["pool_seed"], dev).cpu().numpy()
    ctx.note("images made")
    if not dist.is_initialized():
        initialize(f"localhost:{ctx.port}", ctx.world, ctx.rank,
                   device=dev.type)
        ctx.note(f"rank {ctx.rank} of {ctx.world} joined")
    codec = ShardedCodec(port_config(ctx.config), weights,
                         mesh=make_sp_mesh(p["shards"]), num_lanes=p["lanes"],
                         device=dev)
    ctx.note("codec built")
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
    outs, kept, sizes = [], [], {}
    t_start = time.perf_counter()
    i = 0
    while True:
        u = order[i % len(order)]
        streams, out, e, d = call(u)
        enc_ms.append(e)
        dec_ms.append(d)
        sizes.setdefault(u, container_bytes(streams))
        if u in sampled:
            kept.append((u, streams))
            outs.append((u, out))
        i += 1
        stop = torch.tensor([float(ctx.rank == 0 and time.perf_counter()
                                   - t_start >= ctx.seconds)], device=dev)
        dist.all_reduce(stop, op=dist.ReduceOp.MAX)
        if stop.item() > 0:
            break
    window_s = time.perf_counter() - t_start
    ctx.note(f"window: {len(enc_ms)} calls, encode median "
             f"{np.median(enc_ms):.3f} ms, decode median "
             f"{np.median(dec_ms):.3f} ms")
    # a traced run profiles (on rank 0) the next calls of the same traffic
    traces: List[trace.Trace] = []
    traced = [order[(i + j) % len(order)]
              for j in range(p["traced"] if ctx.trace else 0)]
    if traced and ctx.rank == 0:
        with trace.capture(len(traced), traces, dev):
            for u in traced:
                outs.append((u, call(u)[1]))
    else:
        for u in traced:
            call(u)
    peak = torch.tensor([memory_peak(dev)], dtype=torch.float64,
                        device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    del codec
    free_memory()
    dist.barrier()
    dist.destroy_process_group()
    if ctx.rank:
        return None
    if len(sizes) != len(order):
        raise RuntimeError(f"{ctx.seconds} s coded {len(sizes)} of the "
                           f"pool's {len(order)} images: a longer window "
                           "is needed")

    wrong = [checks.wrong_subpixels(o[0], pool[u]) for u, o in outs]
    # the reference, once the program's state is freed
    model = ref_model.build(ref_model.Config(ctx.config["model"]),
                            ref_model.from_flax(weights), dev)
    refs: Dict[int, bytes] = {
        u: reference_blob(model, pool[u], p, dev, ctx.world)
        for u in sorted({u for u, _ in kept})}
    off = sum(checks.bytes_off(ref_codec.serialize(s), refs[u])
              for u, s in kept)
    return Outcome(
        attempted=len(enc_ms) + len(traced), failed=sum(1 for w in wrong
                                                        if w),
        setup_s=setup_s,
        window={"seconds": window_s, "images": len(enc_ms),
                "pixels": len(enc_ms) * H * W,
                "encode_ms": enc_ms, "decode_ms": dec_ms,
                "bpsp": float(np.mean([8 * b / (H * W * 3)
                                       for b in sizes.values()]))},
        checks=[("wrong_subpixels", sum(wrong),
                 ctx.limit("wrong_subpixels")),
                ("container_bytes_off", off,
                 ctx.limit("container_bytes_off"))],
        memory_peak_bytes=int(peak.item()), devices=ctx.world,
        trace=traces[0] if traces else None,
        extra={"config": ctx.config, "height": H, "width": W, "batch": 1,
               "lanes": p["lanes"], "shards": p["shards"]})


def reference_blob(model, img: np.ndarray, p: Dict, dev, blocks: int
                   ) -> bytes:
    """The reference's serialised container of one image, its maps in
    ``blocks`` row blocks (one a rank)."""
    return ref_codec.serialize(ref_sharded.encode(
        model, img, p["shards"], p["lanes"], dev, blocks)["streams"])
