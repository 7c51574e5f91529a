"""python3 -m llbench.gdn_controls --workload CELL [--control-seeds N ...]

The readings the limits of a ``codec_seeded_batch`` cell (activfun GDN1,
weights made from a seed, ``llbench/reference/gdn.py``) are set from, as
``llbench.seq_controls`` gives them for the sequential-colour cell: the
program's batch container of every batch of the pool against the
reference encoder's, and every decoded image against its input; then, on
the batch each control seed samples first, two controls in the
program's place: the reference encoder under TF32 (the codec states
float32 with TF32 off), and the program with each GDN1's gamma cut to
its diagonal (the fault of a normalisation that mixes no channels).
One JSON line a reading.  The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np

from . import checks, run
from .controls import emit
from .data import synthetic_images
from .reference import codec as ref_codec
from .reference import gdn as ref_gdn
from .traffic import permutation, port_config


def diagonal_gamma(weights):
    """The weights with every GDN1's stored gamma cut to its diagonal (an
    off-diagonal entry stored 0 stands for gamma 0)."""
    return {k: (np.diag(np.diag(v)).astype(np.float32)
                if k.endswith("/GDN1_0/gamma") else v)
            for k, v in weights.items()}


def readings(ctx, control_seeds: List[int]) -> None:
    import torch

    from llicti_torch import Codec
    p, dev = ctx.params, ctx.device
    K = p["batch"]
    rcfg = ref_gdn.GdnConfig(ctx.config["model"])
    weights = ref_gdn.seeded_weights(rcfg, p["weights_seed"])
    pool = synthetic_images(p["pool"], p["height"], p["width"],
                            p["pool_seed"], dev).cpu().numpy()
    units = [list(pool[u * K:(u + 1) * K]) for u in range(p["pool"] // K)]
    firsts = {s: permutation(len(units), s, 0)[0] for s in control_seeds}

    def program(params, which):
        codec = Codec(port_config(ctx.config), params, device=dev,
                      num_lanes=p["lanes"])
        out = {}
        for u in which:
            streams = codec.compress_batch(units[u])
            wrong = sum(checks.wrong_subpixels(o, im) for o, im in zip(
                codec.decompress_batch(streams), units[u]))
            out[u] = (ref_codec.serialize(streams), wrong)
        del codec
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    got = program(weights, range(len(units)))
    diag = program(diagonal_gamma(weights), sorted(set(firsts.values())))
    model = ref_gdn.build(rcfg, ref_gdn.from_flax(weights), dev)

    def encode(u, tf32=False):
        enc = ref_codec.Encoder(model, p["lanes"], dev, tf32=tf32)
        return ref_codec.serialize(enc.encode_batch(units[u])["streams"])

    want = []
    for u, (blob, wrong) in got.items():
        want.append(encode(u))
        emit(side="program", unit=u,
             container_bytes_off=checks.bytes_off(blob, want[u]),
             wrong_subpixels=wrong)
    for seed, u in firsts.items():
        emit(side="control_tf32", seed=seed, unit=u,
             container_bytes_off=checks.bytes_off(encode(u, tf32=True),
                                                  want[u]))
        emit(side="fault_diagonal_gamma", seed=seed, unit=u,
             container_bytes_off=checks.bytes_off(diag[u][0], want[u]),
             wrong_subpixels=diag[u][1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python3 -m llbench.gdn_controls")
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
