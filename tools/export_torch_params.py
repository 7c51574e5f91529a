#!/usr/bin/env python
"""Export the trained flagship weights for the PyTorch port.

Loads ``bench_ckpt/bench.orbax`` through the JAX package's
``CheckpointManager`` and writes its parameters as float32 arrays under
flat '/'-joined Flax names to ``llicti_torch/weights/bench_params.npz``,
which the port (``llicti_torch.weights.load_npz``) reads without JAX or
orbax.

Usage: python tools/export_torch_params.py [--ckpt DIR] [--out FILE]
Needs JAX, Flax and orbax (the machine that holds the JAX package).
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def load_bench_params(ckpt_dir: str):
    """(nested numpy Flax params, checkpoint meta) of the flagship model."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from llicti_tpu.config import ModelConfig
    from llicti_tpu.models.llicti import LLICTIModel
    from llicti_tpu.utils.checkpoint import CheckpointManager

    target = LLICTIModel(cfg=ModelConfig()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    params, meta = CheckpointManager(ckpt_dir).load("bench", target)
    return jax.tree.map(np.asarray, params), meta


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=os.path.join(ROOT, "bench_ckpt"))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "llicti_torch", "weights", "bench_params.npz"))
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from llicti_torch.weights import flat_params

    params, meta = load_bench_params(args.ckpt)
    flat = {k: np.asarray(v, np.float32)
            for k, v in flat_params(params).items()}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez(args.out, **flat)
    n = sum(v.size for v in flat.values())
    print(f"wrote {args.out}: {len(flat)} arrays, {n} parameters, "
          f"checkpoint meta {meta}")


if __name__ == "__main__":
    main()
