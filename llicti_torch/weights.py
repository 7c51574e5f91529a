"""Carry the JAX package's Flax parameters into the port's modules.

Parameters cross over as numpy arrays under flat '/'-joined Flax names,
``models_{m}_{b}/{conv_00_11,...,trunk_0,trunk_2}/Conv_0/{kernel,bias}``
(and ``.../PReLU_0/alpha`` for PReLU), which is also the key layout of the
committed ``weights/bench_params.npz`` (the trained flagship weights,
written by ``tools/export_torch_params.py``).  Conv kernels go from Flax's
HWIO to PyTorch's OIHW.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from llicti_tpu.config import ModelConfig

from .models.llicti import LLICTIModel

BENCH_PARAMS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "weights", "bench_params.npz")


def flat_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested Flax parameter dict -> {'/'-joined name: array}; a leading
    ``params`` collection level is dropped."""
    if not prefix and set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(flat_params(val, name))
        else:
            out[name] = np.asarray(val)
    return out


def _torch_name(flax_name: str) -> str:
    parts = flax_name.split("/")
    head, layer, leaf = parts[0], parts[1], parts[2:]
    _, m, b = head.split("_")
    if layer.startswith("trunk_"):
        layer = f"trunk.{int(layer[len('trunk_'):])}"
    if leaf == ["Conv_0", "kernel"]:
        suffix = "weight"
    elif leaf == ["Conv_0", "bias"]:
        suffix = "bias"
    elif leaf == ["PReLU_0", "alpha"]:
        suffix = "weight"
    else:
        raise KeyError(f"unknown parameter {flax_name!r}")
    return f"models.{int(m)}.{int(b)}.{layer}.{suffix}"


def params_from_flax(params: Mapping, cfg: ModelConfig) -> LLICTIModel:
    """Flax parameters (nested, or flat as from :func:`load_npz`) -> an
    :class:`LLICTIModel` of ``cfg`` (on the CPU, in eval mode) holding
    them.  Raises if a name or shape does not match the model."""
    state = {}
    for name, arr in flat_params(params).items():
        if name.endswith("Conv_0/kernel"):
            arr = np.transpose(arr, (3, 2, 0, 1))
        state[_torch_name(name)] = torch.from_numpy(
            np.array(arr, np.float32, order="C"))
    model = LLICTIModel(cfg)
    model.load_state_dict(state, strict=True)
    return model.eval()


def load_npz(path: str = BENCH_PARAMS) -> Dict[str, np.ndarray]:
    """{flat Flax name: float32 array} from an exported ``.npz``."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
