"""python3 -m llbench.clrjnt1_controls --workload CELL [--control-seeds N ...]

The readings the limits of a ``codec_seeded_clrjnt1`` cell (clr_joint_mode
1, weights made from a seed, ``llbench/reference/clrjnt1.py``) are set
from, as ``llbench.gdn_controls`` gives them for the GDN1 cell: the
program's batch container of every batch of the pool against the
reference encoder's, and every decoded image against its input; then, on
the batch each control seed samples first, two encoders in the program's
place: the reference under TF32 (the codec states float32 with TF32
off), and the reference coding Y with M mixture terms in place of 2M
(the fault of a Y mixture cut to the joint colours' size).  One JSON
line a reading.  The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import sys
from typing import List

from . import checks, run
from .controls import emit
from .data import synthetic_images
from .reference import clrjnt1 as ref_clrjnt1
from .reference import codec as ref_codec
from .reference import model as ref_model
from .traffic import permutation, port_config


def readings(ctx, control_seeds: List[int]) -> None:
    import torch

    from llicti_torch import Codec
    p, dev = ctx.params, ctx.device
    K = p["batch"]
    rcfg = ref_clrjnt1.Clrjnt1Config(ctx.config["model"])
    weights = ref_clrjnt1.seeded_weights(rcfg, p["weights_seed"])
    pool = synthetic_images(p["pool"], p["height"], p["width"],
                            p["pool_seed"], dev).cpu().numpy()
    units = [list(pool[u * K:(u + 1) * K]) for u in range(p["pool"] // K)]
    firsts = {s: permutation(len(units), s, 0)[0] for s in control_seeds}
    codec = Codec(port_config(ctx.config), weights, device=dev,
                  num_lanes=p["lanes"])
    got = {}
    for u in range(len(units)):
        streams = codec.compress_batch(units[u])
        wrong = sum(checks.wrong_subpixels(o, im) for o, im in zip(
            codec.decompress_batch(streams), units[u]))
        got[u] = (ref_codec.serialize(streams), wrong)
    del codec
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    model = ref_clrjnt1.build(rcfg, ref_model.from_flax(weights), dev)

    def encode(u, tf32=False, y_only_m=False):
        enc = ref_clrjnt1.Clrjnt1Encoder(model, p["lanes"], dev, tf32=tf32,
                                         y_only_m=y_only_m)
        return ref_codec.serialize(enc.encode_batch(units[u])["streams"])

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
        emit(side="fault_y_m_terms", seed=seed, unit=u,
             container_bytes_off=checks.bytes_off(encode(u, y_only_m=True),
                                                  want[u]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python3 -m llbench.clrjnt1_controls")
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
