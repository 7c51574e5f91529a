"""python3 -m llbench.seq_controls --workload CELL [--control-seeds N ...]

The readings the limits of a ``codec_seeded`` cell (weights made from a
seed, ``llbench/reference/seq.py``) are set from, as ``llbench.controls``
gives them for the other codec cells: the program's container of every
image of the pool against the reference encoder's, and every decoded
image against its input; then the control, the reference encoder under
TF32 in the program's place (the codec states float32 with TF32 off), on
the image each control seed samples first.  One JSON line a reading.
The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import sys
from typing import List

from . import checks, run
from .controls import emit
from .data import synthetic_images
from .reference import codec as ref_codec
from .reference import model as ref_model
from .reference import seq as ref_seq
from .traffic import permutation, port_config


def readings(ctx, control_seeds: List[int]) -> None:
    import torch

    from llicti_torch import Codec
    p, dev = ctx.params, ctx.device
    rcfg = ref_seq.SeqConfig(ctx.config["model"])
    weights = ref_seq.seeded_weights(rcfg, p["weights_seed"])
    pool = synthetic_images(p["pool"], p["height"], p["width"],
                            p["pool_seed"], dev).cpu().numpy()
    codec = Codec(port_config(ctx.config), weights, device=dev,
                  num_lanes=p["lanes"])
    got = []
    for img in pool:
        streams = codec.compress(img)
        got.append((ref_codec.serialize(streams),
                    checks.wrong_subpixels(codec.decompress(streams), img)))
    del codec
    torch.cuda.empty_cache()
    model = ref_seq.build(rcfg, ref_model.from_flax(weights), dev)

    def encode(u, tf32=False):
        enc = ref_seq.SeqEncoder(model, p["lanes"], dev, tf32=tf32)
        return ref_codec.serialize(enc.encode([pool[u]])["streams"])

    want = []
    for u, (blob, wrong) in enumerate(got):
        want.append(encode(u))
        emit(side="program", unit=u,
             container_bytes_off=checks.bytes_off(blob, want[u]),
             wrong_subpixels=wrong)
    for seed in control_seeds:
        u = permutation(len(pool), seed, 1)[0]
        emit(side="control_tf32", seed=seed, unit=u,
             container_bytes_off=checks.bytes_off(encode(u, tf32=True),
                                                  want[u]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python3 -m llbench.seq_controls")
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
