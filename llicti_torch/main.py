"""Experiment runner: ``python -m llicti_torch.main CONFIG.json [--mode M]
[--device D]``.

The port's counterpart of the root ``main.py``.  Accepts reference-style
JSON configs (``configs/llicti_A.json``) or the nested format, keeps the
agent registry (``LLICTIAgent`` / ``Trainer``) and the reference's
multi-experiment sweep (``multi_agent`` / ``multi_param``, reference
main.py:17-24): each sweep value gets its own ``exp_<v>`` experiment
subdir and a full ``run()`` + ``finalize()``.  Runs on the CUDA card unless
``--device cpu`` is given.  ``--mesh`` joins the process group
(``parallel.initialize``) and trains data parallel over all its ranks:
``torchrun --nproc_per_node=N -m llicti_torch.main CONFIG.json --mesh``
(one process a card; alone, a mesh of one).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List

import torch.distributed as dist

from .config import config_from_dict
from .parallel.distributed import initialize
from .training.trainer import Trainer

# agent registry: reference configs select the agent by class name
# (reference main.py:30 via globals()); LLICTIAgent maps to the Trainer
AGENTS = {"LLICTIAgent": Trainer, "Trainer": Trainer}


def sweep(raw: dict) -> List[dict]:
    """The raw configs of a run: ``raw`` itself, or one per value of its
    ``multi_param`` sweep, each with ``exp_name`` ``<base>/exp_<v>``."""
    if not (raw.get("multi_agent") and raw.get("multi_param")):
        return [raw]
    key = raw["multi_param"]
    vals = raw.get(key, [])
    if not isinstance(vals, list):
        return [raw]
    base = raw.get("multi_exp_name") or raw.get("exp_name", "exp")
    return [dict(raw, **{key: v, "exp_name": os.path.join(base, f"exp_{v}")})
            for v in vals]


def main(argv=None) -> List[Trainer]:
    """Run the config's experiments; -> their agents, after ``finalize``."""
    ap = argparse.ArgumentParser(description="LLICTI on PyTorch + CUDA")
    ap.add_argument("config", help="JSON config path")
    ap.add_argument("--mode", default=None,
                    help="override mode (train/eval_model/...)")
    ap.add_argument("--mesh", action="store_true",
                    help="use all ranks of the process group (torchrun) "
                         "as a data mesh")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # a group joined here is left here; a caller's stays the caller's
    own_group = args.mesh and not dist.is_initialized()
    if args.mesh:
        initialize(device=args.device)
    try:
        return [_run(raw_i, args) for raw_i in sweep(_read(args.config))]
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _run(raw_i: dict, args) -> Trainer:
    """One experiment of the sweep: run, finalize; -> its agent."""
    cfg = config_from_dict(raw_i)
    if args.mode:
        cfg = dataclasses.replace(cfg, mode=args.mode)
    trainer = AGENTS[raw_i.get("agent", "Trainer")](
        cfg, device=args.device, use_mesh=args.mesh)
    trainer.run()
    trainer.finalize()
    return trainer


if __name__ == "__main__":
    main()
