"""python3 -m llbench.sharded_controls --workload CELL [--control-seeds N ...]

The readings the limits of a ``codec_sharded`` cell are set from, on one
card: a ``ShardedCodec`` of the cell's G shards held by one process
(its maps in one block) codes every image of the pool, each container
against the reference encoder's (``llbench/reference/sharded.py``, one
block) and each decoded image against its input; then, on the image each
control seed samples first, the reference under TF32 in the program's
place (the codec states float32 with TF32 off).  The cell's own runs
compare its ranks' containers with the reference in one block a rank.
One JSON line a reading.  The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import sys
from typing import List

from . import checks, run
from .controls import emit
from .data import synthetic_images, trained_weights
from .reference import codec as ref_codec
from .reference import model as ref_model
from .reference import sharded as ref_sharded
from .traffic import permutation, port_config


def readings(ctx, control_seeds: List[int]) -> None:
    import torch

    from llicti_torch.parallel.codec_sp import ShardedCodec, make_sp_mesh
    p, dev = ctx.params, ctx.device
    weights = trained_weights(ctx.config["weights"])
    pool = synthetic_images(p["pool"], p["height"], p["width"],
                            p["pool_seed"], dev).cpu().numpy()
    firsts = {s: permutation(len(pool), s, 0)[0] for s in control_seeds}
    codec = ShardedCodec(port_config(ctx.config), weights,
                         mesh=make_sp_mesh(p["shards"]), num_lanes=p["lanes"],
                         device=dev)
    got = {}
    for u, img in enumerate(pool):
        streams = codec.compress(img)
        got[u] = (ref_codec.serialize(streams), checks.wrong_subpixels(
            codec.decompress(streams)[0], img))
    del codec
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    model = ref_model.build(ref_model.Config(ctx.config["model"]),
                            ref_model.from_flax(weights), dev)

    def encode(u, tf32=False):
        return ref_codec.serialize(ref_sharded.encode(
            model, pool[u], p["shards"], p["lanes"], dev,
            tf32=tf32)["streams"])

    want = {}
    for u, (blob, wrong) in got.items():
        want[u] = encode(u)
        emit(side="program", unit=u,
             container_bytes_off=checks.bytes_off(blob, want[u]),
             wrong_subpixels=wrong)
    for seed, u in firsts.items():
        emit(side="control_tf32", seed=seed, unit=u,
             container_bytes_off=checks.bytes_off(encode(u, tf32=True),
                                                  want[u]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python3 -m llbench.sharded_controls")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    # the CPU in place of the card, for the benchmark's own tests
    ap.add_argument("--device", choices=("cpu",), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    ctx, _, _ = run.prepare(argparse.Namespace(
        workload=args.workload, seed=0, seconds=0.0, trace=0, rank=0,
        port=0, spawn=False), device=args.device or "cuda")
    readings(ctx, args.control_seeds)


if __name__ == "__main__":
    main(sys.argv[1:])
