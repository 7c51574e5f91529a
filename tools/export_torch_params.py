#!/usr/bin/env python
"""Export JAX checkpoints for the PyTorch port.

Default: load ``bench_ckpt/bench.orbax`` through the JAX package's
``CheckpointManager`` and write its parameters as float32 arrays under
flat '/'-joined Flax names to ``llicti_torch/weights/bench_params.npz``,
which the port (``llicti_torch.weights.load_npz``) reads without JAX or
orbax.

``--train-state DIR``: convert a JAX Trainer's Orbax train state
(``DIR/{--name}.orbax`` + ``.meta.json``: parameters, the Adam moments and
count at ``opt_state.inner_state[1][0]``, the scheduler and loggers) into
a port checkpoint ``--out-dir/{--name}.pt`` + ``.meta.json``, which the
port's ``Trainer`` with ``resume_training`` (and ``checkpoint_file`` =
the name) continues from.  The meta is mapped as the JAX trainer's
``load_checkpoint`` reads it: ``epoch`` / ``iteration`` 0 where absent;
the meta's ``step`` (else the state's) becomes the checkpoint's optimiser
step.  ``--config`` names the model's JSON config (default: the flagship).

Usage: python tools/export_torch_params.py [--ckpt DIR] [--out FILE]
       python tools/export_torch_params.py --train-state train_state \\
           [--name checkpoint] --out-dir DIR [--config J]
Needs JAX, Flax, optax and orbax (the machine that holds the JAX package).
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


def load_train_state(state_dir: str, name: str, config=None):
    """A JAX Trainer's Orbax train state -> (its model config as a dict,
    nested numpy params, Adam mu, nu (nested numpy), Adam count, the
    state's step, meta)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from llicti_tpu.config import ModelConfig, config_from_json
    from llicti_tpu.models.llicti import LLICTIModel
    from llicti_tpu.training.steps import init_state
    from llicti_tpu.utils.checkpoint import CheckpointManager

    cfg = config_from_json(config).model if config else ModelConfig()
    model = LLICTIModel(cfg=cfg)
    # the state's structure, shapes and dtypes, traced without compiling,
    # restored onto the first device
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    target = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=one),
        jax.eval_shape(lambda: init_state(
            model, cfg, jax.random.PRNGKey(0),
            jnp.zeros((1, 64, 64, 3), jnp.float32), 1e-4)[0]))
    state, meta = CheckpointManager(state_dir).load(name, target)
    adam = state.opt_state.inner_state[1][0]
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (dataclasses.asdict(cfg), host(state.params), host(adam.mu),
            host(adam.nu), int(adam.count), int(state.step), meta)


def port_checkpoint(cfg_dict, params, mu, nu, count, step, meta):
    """The port's (state, meta) of a JAX train state, as
    ``llicti_torch.utils.CheckpointManager.save`` takes them."""
    from llicti_torch.config import ModelConfig
    from llicti_torch.training import make_optimizer
    from llicti_torch.weights import adam_state_from_optax, params_from_flax

    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in cfg_dict.items()})
    model = params_from_flax(params, cfg)
    lr = meta.get("scheduler", {}).get("lr", 1e-4)
    opt = make_optimizer(model, lr)
    sd = opt.state_dict()
    sd["state"] = adam_state_from_optax(mu, nu, count, model)
    out_meta = dict(meta, epoch=meta.get("epoch", 0),
                    iteration=meta.get("iteration", 0))
    state = {"model": model.state_dict(), "optimizer": sd,
             "step": int(meta.get("step", step))}
    return state, out_meta


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=os.path.join(ROOT, "bench_ckpt"))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "llicti_torch", "weights", "bench_params.npz"))
    ap.add_argument("--train-state", default=None,
                    help="a JAX Trainer's checkpoint dir to convert")
    ap.add_argument("--name", default="checkpoint")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--config", default=None, help="the model's JSON config")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    if args.train_state:
        if not args.out_dir:
            ap.error("--train-state needs --out-dir")
        from llicti_torch.utils.checkpoint import CheckpointManager

        loaded = load_train_state(args.train_state, args.name, args.config)
        state, meta = port_checkpoint(*loaded)
        CheckpointManager(args.out_dir).save(args.name, state, meta)
        print(f"wrote {os.path.join(args.out_dir, args.name)}.pt: Adam "
              f"count {loaded[4]}, step {state['step']}, meta {meta}")
        return

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
