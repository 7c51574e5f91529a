"""Checkpoint/resume with the reference's semantic payload.

The port's counterpart of ``llicti_tpu/utils/checkpoint.py``, with its
names and payload: ``{name}.pt`` holds the model's and the optimiser's
``state_dict`` and the step count (``torch.save``, written to a temporary
file and moved into place with ``os.replace``, so a crash never leaves a
half-written checkpoint), and ``{name}.meta.json`` the host-side training
state (epoch, iteration, best_valid_loss, LR-scheduler and rate-logger
state) as JSON, the payload the reference pickles (agents/base.py:83-100).
``save(..., is_best=True)`` also copies both files to ``model_best``
(reference base.py:98-100).  ``load`` reads with ``weights_only=True``:
tensors and plain containers only, no pickled code.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Tuple

import torch


class CheckpointManager:
    def __init__(self, ckpt_dir: str):
        self.dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.dir, exist_ok=True)

    def _paths(self, name: str) -> Tuple[str, str]:
        return (os.path.join(self.dir, name + ".pt"),
                os.path.join(self.dir, name + ".meta.json"))

    def save(self, name: str, state: dict, meta: dict,
             is_best: bool = False) -> None:
        """``state`` is ``{"model": state_dict, "optimizer": state_dict,
        "step": int}``; ``meta`` is JSON-serialisable."""
        tree_path, meta_path = self._paths(name)
        tmp = tree_path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, tree_path)
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        if is_best:
            best_tree, best_meta = self._paths("model_best")
            shutil.copyfile(tree_path, best_tree)
            shutil.copyfile(meta_path, best_meta)

    def load(self, name: str) -> Tuple[dict, dict]:
        """Restore (state, meta), tensors on the CPU.  Raises
        FileNotFoundError."""
        tree_path, meta_path = self._paths(name)
        if not os.path.exists(tree_path):
            raise FileNotFoundError(tree_path)
        state = torch.load(tree_path, map_location="cpu", weights_only=True)
        meta = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return state, meta

    def exists(self, name: str) -> bool:
        return os.path.exists(self._paths(name)[0])
