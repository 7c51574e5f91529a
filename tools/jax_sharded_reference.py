#!/usr/bin/env python
"""The JAX package's row-sharded codec figures that ``chip_smoke.py``
phase 13 and the multi-device dry run (``llicti_torch/parallel/
dryrun.py``) hold the port against (their ``JAX_SP`` constants).

Runs ``llicti_tpu.parallel.ShardedCodec`` on the CPU with G fake devices
(``--shards``, default 4 and 1), 128 lanes a shard and the trained
flagship weights of ``bench_ckpt/`` on ``synthetic_image(512, 768,
seed=42)`` and ``synthetic_image(310, 598, seed=7)``, and prints, per (G,
image), the container's ``num_bytes`` and its header bytes as hex, and
whether the 512x768 container decodes losslessly at the first G.  Takes
~2 minutes a G and a few GiB on a CPU.

Usage: python tools/jax_sharded_reference.py [--shards 8 2]
Needs JAX, Flax and orbax (the machine that holds the JAX package).
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

LANES = 128
IMAGES = {"512x768": (512, 768, 42), "310x598": (310, 598, 7)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, nargs="+", default=[4, 1])
    shards = ap.parse_args().shards
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={max(shards)}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from export_torch_params import load_bench_params
    from llicti_tpu.config import ModelConfig
    from llicti_tpu.data.dataset import synthetic_image
    from llicti_tpu.parallel.codec_sp import ShardedCodec, make_sp_mesh

    params, _ = load_bench_params(os.path.join(ROOT, "bench_ckpt"))
    for G in shards:
        codec = ShardedCodec(ModelConfig(), params,
                             mesh=make_sp_mesh(shards=G), num_lanes=LANES)
        for label, (h, w, seed) in IMAGES.items():
            img = synthetic_image(h, w, seed=seed)
            streams = codec.compress_many([img])[0]
            print(f"G={G} {label}: num_bytes "
                  f"{ShardedCodec.num_bytes(streams)}, header "
                  f"{streams[0][0].hex()}, blobs "
                  f"{[len(b) for b in streams[1]]}", flush=True)
            if G == shards[0] and label == "512x768":
                out = codec.decompress(streams)
                print(f"G={G} {label}: lossless "
                      f"{bool(np.array_equal(out[0], img))}", flush=True)


if __name__ == "__main__":
    main()
