"""Carry the JAX package's Flax parameters into the port's modules.

Parameters cross over as numpy arrays under flat '/'-joined Flax names,
``models_{m}_{b}/{layer}/{Conv_0/kernel, Conv_0/bias, PReLU_0/alpha,
GDN1_0/beta, GDN1_0/gamma}`` with ``layer`` one of the layer-0 convs
(``conv_00_11``, ...), ``seq_toCo`` / ``seq_toCg`` (clrjnt0seqmd),
``act0`` or ``trunk_{i}``, and ``b`` 0 alone under combine_layers1toL;
a band model's factorized prior is ``models_{m}_{b}/factorized_prior/
{quantiles, H{k}, b{k}, a{k}}`` (a prior alone carries the bare names,
which are its PyTorch names too).  That is also the key layout of the committed ``weights/bench_params.npz``
(the trained flagship weights, written by
``tools/export_torch_params.py``).  Conv kernels go from Flax's HWIO to
PyTorch's OIHW.  :func:`init_params` makes fresh parameters of any
configuration in the same layout, without JAX, and
:func:`adam_state_from_optax` carries optax's Adam moments over, so that
a JAX train state continues in the port.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .config import ModelConfig
from .models.llicti import LLICTIModel
from .ops.gdn import GDN1, gdn_init

BENCH_PARAMS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "weights", "bench_params.npz")

# Flax leaf -> PyTorch parameter of the module that holds it
_LEAVES = {"Conv_0/kernel": "weight", "Conv_0/bias": "bias",
           "PReLU_0/alpha": "weight", "GDN1_0/beta": "beta",
           "GDN1_0/gamma": "gamma"}
_PRIOR_LEAF = re.compile(r"quantiles|[Hba]\d+")


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
    head, layer, leaf = flax_name.split("/", 2)
    _, m, b = head.split("_")
    if layer == "factorized_prior" and _PRIOR_LEAF.fullmatch(leaf):
        return f"models.{int(m)}.{int(b)}.factorized_prior.{leaf}"
    if leaf not in _LEAVES:
        raise KeyError(f"unknown parameter {flax_name!r}")
    if layer.startswith("trunk_"):
        layer = f"trunk.{int(layer[len('trunk_'):])}"
    return f"models.{int(m)}.{int(b)}.{layer}.{_LEAVES[leaf]}"


def _state_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax-named arrays (nested or flat) -> {PyTorch name: float32
    tensor}, conv kernels HWIO -> OIHW."""
    state = {}
    for name, arr in flat_params(tree).items():
        if name.endswith("Conv_0/kernel"):
            arr = np.transpose(arr, (3, 2, 0, 1))
        state[_torch_name(name)] = torch.from_numpy(
            np.array(arr, np.float32, order="C"))
    return state


def params_from_flax(params: Mapping, cfg: ModelConfig) -> LLICTIModel:
    """Flax parameters (nested, or flat as from :func:`load_npz`) -> an
    :class:`LLICTIModel` of ``cfg`` (on the CPU, in eval mode) holding
    them.  Raises if a name or shape does not match the model."""
    model = LLICTIModel(cfg)
    model.load_state_dict(_state_from_flax(params), strict=True)
    return model.eval()


def adam_state_from_optax(mu: Mapping, nu: Mapping, count: int,
                          model: nn.Module) -> Dict[int, dict]:
    """optax's Adam state (first and second moments as Flax-named trees,
    nested or flat, and the update count) -> the ``state`` of a
    ``torch.optim.Adam`` over ``model.parameters()``, keyed by each
    parameter's index in that order::

        sd = optimizer.state_dict()
        sd["state"] = adam_state_from_optax(mu, nu, count, model)
        optimizer.load_state_dict(sd)

    optax's count and PyTorch's step both count the updates taken, so the
    next step's bias corrections agree.  Raises if a name or shape does
    not match the model."""
    moments = [_state_from_flax(mu), _state_from_flax(nu)]
    out = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        pair = [m.pop(name, None) for m in moments]
        if any(t is None or t.shape != p.shape for t in pair):
            raise ValueError(f"no Adam moment of shape {tuple(p.shape)} "
                             f"for {name}")
        out[i] = {"step": torch.tensor(float(count)), "exp_avg": pair[0],
                  "exp_avg_sq": pair[1]}
    if moments[0] or moments[1]:
        raise KeyError(f"moments of no parameter of the model: "
                       f"{sorted(moments[0]) + sorted(moments[1])}")
    return out


def flax_from_state_dict(state: Mapping[str, torch.Tensor],
                         cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """A port model's ``state_dict`` (as a checkpoint holds it) -> its
    parameters as {flat Flax name: float32 array}, conv kernels OIHW ->
    HWIO: the inverse of :func:`params_from_flax`, so that ``Codec`` codes
    with a port checkpoint's weights.  Raises KeyError on a name that is
    no parameter of ``cfg``'s model."""
    names = {_torch_name(k): k for k in init_params(cfg)}
    out = {}
    for tname, t in state.items():
        if tname not in names:
            raise KeyError(f"{tname!r} is no parameter of this model")
        arr = t.detach().cpu().numpy().astype(np.float32)
        if names[tname].endswith("Conv_0/kernel"):
            arr = arr.transpose(2, 3, 1, 0)
        out[names[tname]] = np.ascontiguousarray(arr)
    return out


def init_params(cfg: ModelConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Fresh parameters of ``cfg`` as {flat Flax name: float32 array}, with
    the names, shapes and init distributions of ``LLICTIModel.init`` in the
    JAX package (``interpolator.py:32-43``): conv kernels and biases
    U(+-1/sqrt(fan_in)), PReLU slopes 0.25, GDN1 beta = 1 and gamma =
    0.1 I (stored parametrised).  Drawn from
    ``np.random.default_rng(seed)``; no global RNG is touched."""
    rng = np.random.default_rng(seed)

    def uniform(fan_in, shape):
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    with torch.device("meta"):  # shapes only: no values, no RNG
        model = LLICTIModel(cfg)
    out: Dict[str, np.ndarray] = {}
    for path, mod in model.named_modules():
        parts = path.split(".")  # models.m.b.layer[.i]
        if len(parts) < 4:
            continue
        name = f"models_{parts[1]}_{parts[2]}/" + "_".join(parts[3:])
        if isinstance(mod, nn.Conv2d):
            o, i, kh, kw = mod.weight.shape
            # the JAX seq convs take their bias fan-in from in_features=1
            bias_fan = 1 if parts[3].startswith("seq_to") else i * kh * kw
            out[f"{name}/Conv_0/kernel"] = uniform(i * kh * kw,
                                                   (kh, kw, i, o))
            out[f"{name}/Conv_0/bias"] = uniform(bias_fan, (o,))
        elif isinstance(mod, nn.PReLU):
            out[f"{name}/PReLU_0/alpha"] = np.full(
                mod.weight.shape, 0.25, np.float32)
        elif isinstance(mod, GDN1):
            beta, gamma = gdn_init(mod.beta.shape[0])
            out[f"{name}/GDN1_0/beta"] = beta
            out[f"{name}/GDN1_0/gamma"] = gamma
    return out


def load_npz(path: str = BENCH_PARAMS) -> Dict[str, np.ndarray]:
    """{flat Flax name: float32 array} from an exported ``.npz``."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
