"""The reference of LLICTI's GDN1 interpolator: ``activfun: "GDN1"``
(kamisli-icpl/LLICTI ``graphs/models/LLICTI_nets.py:683-693``, compressai's
``GDN1``) at the joint-colour model's widths, its encoder, its FLOP
count, the work of its GDN1 layers and fixed weights made from a seed.
Plain PyTorch and numpy.

The band net is :class:`model.BandNet` with GDN1 in place of each ReLU:
after layer 0's sum and after each hidden trunk conv, over all Ch = 4 chs
channels,

  y_c = x_c / (beta_c + sum_k gamma_ck |x_k|),
  beta = lowerbound(beta~, sqrt(beta_min + p))^2 - p,
  gamma = lowerbound(gamma~, sqrt(p))^2 - p,

p = 2^-36 and beta_min = 1e-6 (compressai's ``NonNegativeParametrizer``
of beta~ and gamma~, the stored parameters), the sum over k a 1x1 conv of
|x| with gamma as its kernel and beta as its bias.  The encoder is
:class:`codec.Encoder` on a :class:`GdnModel`: single containers and
batch containers, under TF32 off.

Departures from the published description:

* float32 with TF32 off throughout (``codec.float32_math``), the
  precision the codec states; the published model runs under PyTorch's
  default flags.
* y = x / norm, one IEEE division, where compressai's GDN1 multiplies x
  by 1 / norm (two roundings): the program's arithmetic, which the
  containers must match byte for byte.
* The weights are made from a seed (:func:`seeded_weights`), no trained
  GDN1 weights being at hand: the convs as the published init draws them,
  beta and gamma drawn around compressai's init (beta = 1, gamma = 0.1 I)
  so that every entry of gamma is non-zero and the normalisation mixes
  all channels.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .model import BandNet, Config, Model
from .model import from_flax as conv_from_flax
from .model import layer0_specs, widths
from .seq import conv_flops

PEDESTAL = 2.0 ** -36  # compressai's reparam_offset ** 2
BETA_MIN = 1e-6
GAMMA_MIN = 0.0


class GdnConfig(Config):
    """The model keys of an activfun GDN1 configuration; every other knob
    as :class:`Config` takes it (three joint colours, normal mixtures,
    YCoCg-R)."""

    def __init__(self, model: Dict):
        if model["activfun"] != "GDN1":
            raise NotImplementedError("the GDN1 reference runs activfun "
                                      "GDN1")
        # the ReLU Config checks every other knob
        super().__init__(dict(model, activfun="ReLU"))


def nonnegative(param: torch.Tensor, minimum: float) -> torch.Tensor:
    """compressai's ``NonNegativeParametrizer``: the value a stored
    parameter stands for."""
    bound = (minimum + PEDESTAL) ** 0.5
    return torch.clamp_min(param, bound) ** 2 - PEDESTAL


def stored(value: np.ndarray) -> np.ndarray:
    """The stored parameter of a value: sqrt(max(value + p, p)), float32."""
    p = np.float32(PEDESTAL)
    return np.sqrt(np.maximum(value.astype(np.float32) + p, p)).astype(
        np.float32)


class Gdn1(nn.Module):
    """l1 GDN over the channels of an NCHW tensor."""

    def __init__(self, channels: int):
        super().__init__()
        self.beta = nn.Parameter(torch.empty(channels))
        self.gamma = nn.Parameter(torch.empty(channels, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta = nonnegative(self.beta, BETA_MIN)
        gamma = nonnegative(self.gamma, GAMMA_MIN)
        norm = F.conv2d(torch.abs(x), gamma[:, :, None, None], beta)
        return x / norm


class GdnBandNet(BandNet):
    """:class:`BandNet` with GDN1 after layer 0 and after each hidden trunk
    conv."""

    def __init__(self, cfg: Config, scale: int, band: int):
        super().__init__(cfg, scale, band)
        _, Ch, _ = widths(cfg, scale)
        self.act0 = Gdn1(Ch)
        for i in range(1, len(self.trunk), 2):
            self.trunk[i] = Gdn1(Ch)


class GdnModel(Model):
    """``models[m][b]``: model m's interpolator of band b."""

    def __init__(self, cfg: GdnConfig):
        nn.Module.__init__(self)
        self.cfg = cfg
        self.models = nn.ModuleList(
            nn.ModuleList(GdnBandNet(cfg, s, b) for b in range(3))
            for s in cfg.model_scales)


# ---- parameters -------------------------------------------------------------

def _flax_name(torch_name: str) -> str:
    """``models.m.b.<layer>.<leaf>`` -> the program's Flax name."""
    _, m, b, layer, leaf = torch_name.replace("trunk.", "trunk_").split(".")
    if leaf in ("beta", "gamma"):
        return f"models_{m}_{b}/{layer}/GDN1_0/{leaf}"
    return f"models_{m}_{b}/{layer}/Conv_0/" + (
        "kernel" if leaf == "weight" else "bias")


def seeded_weights(cfg: GdnConfig, seed: int) -> Dict[str, np.ndarray]:
    """Fixed float32 weights of the model, {Flax name: array} as the
    program reads them (kernels HWIO; ``…/act0/GDN1_0/{beta,gamma}``,
    ``…/trunk_1/GDN1_0/…``), drawn leaf by leaf in the model's order from
    ``np.random.default_rng(seed)``: every conv kernel and bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the kernel's fan-in; beta = 1 +
    U(0, 0.5) and gamma = 0.1 I + U(0, 0.1 / C) in every entry, stored
    parametrised (:func:`stored`)."""
    with torch.device("meta"):
        model = GdnModel(cfg)
    rng = np.random.default_rng(seed)
    fans: Dict[str, int] = {}
    out = {}
    for name, p in model.named_parameters():
        owner, leaf = name.rsplit(".", 1)
        shape = tuple(p.shape)
        if leaf == "beta":
            arr = stored(1.0 + rng.uniform(0.0, 0.5, shape))
        elif leaf == "gamma":
            C = shape[0]
            arr = stored(0.1 * np.eye(C) + rng.uniform(0.0, 0.1 / C, shape))
        else:
            if leaf == "weight":
                fans[owner] = int(np.prod(shape[1:]))
            bound = fans[owner] ** -0.5
            arr = rng.uniform(-bound, bound, shape).astype(np.float32)
            if leaf == "weight":
                arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        out[_flax_name(name)] = arr
    return out


def from_flax(arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flax-named arrays -> this model's state dict: the convs as
    :func:`model.from_flax` reads them, GDN1's stored beta and gamma as
    they are."""
    convs = {k: v for k, v in arrays.items() if "/GDN1_0/" not in k}
    out = conv_from_flax(convs)
    for name, arr in arrays.items():
        if name in convs:
            continue
        head, layer, _, leaf = name.split("/")
        _, m, b = head.split("_")
        layer = layer.replace("trunk_", "trunk.")
        out[f"models.{int(m)}.{int(b)}.{layer}.{leaf}"] = torch.from_numpy(
            np.array(arr, np.float32, order="C"))
    return out


def build(cfg: GdnConfig, state: Dict[str, torch.Tensor],
          device) -> GdnModel:
    model = GdnModel(cfg)
    model.load_state_dict(state, strict=True)
    return model.to(device)


# ---- the work ---------------------------------------------------------------

def band_nets(keys: dict, H: int, W: int) -> Iterator[Tuple[int, int, int,
                                                             int]]:
    """(owning scale, band, h, w) of each band net a pass over one H x W
    image runs (padded up to the coarsest stride): three a scale, on the
    scale's x00 size."""
    cfg = GdnConfig(keys)
    for s, lev in enumerate(cfg.dwtlevels):
        st = 2 ** (lev + 1)
        for b in range(3):
            yield (cfg.model_scales[cfg.model_index[s]], b, -(-H // st),
                   -(-W // st))


def forward_flops(keys: dict, H: int, W: int) -> int:
    """Float operations of the model's convs over one H x W image: per
    band net layer 0's convs, the grouped 1x1 trunk and each GDN1's dense
    1x1 conv (2 C^2 a pixel); GDN1's elementwise work is
    :func:`gdn_work`'s."""
    cfg = GdnConfig(keys)
    total = 0
    for owner, b, h, w in band_nets(keys, H, W):
        grps, Ch, Co = widths(cfg, owner)
        for _, _, (kh, kw), _ in layer0_specs(cfg.evens[owner],
                                              cfg.odds[owner], b):
            total += conv_flops(h, w, cfg.c, Ch, kh, kw, 1)
        for _ in range(cfg.conv_layers - 2):
            total += conv_flops(h, w, Ch, Ch, 1, 1, grps)
        total += conv_flops(h, w, Ch, Co, 1, 1, grps)
        total += (cfg.conv_layers - 1) * conv_flops(h, w, Ch, Ch, 1, 1, 1)
    return total


def gdn_work(keys: dict, H: int, W: int) -> Tuple[int, int]:
    """(float operations, least bytes) of the GDN1 layers of one pass over
    one H x W image: at each of a band net's conv_layers - 1 GDN1 layers,
    a pixel's 2 C^2 + 3 C operations (the dense 1x1 conv, |x|, the bias
    and the division) and its C channels read once (x) and written once
    (y), float32."""
    cfg = GdnConfig(keys)
    flops = nbytes = 0
    for owner, _, h, w in band_nets(keys, H, W):
        _, C, _ = widths(cfg, owner)
        layers = (cfg.conv_layers - 1) * h * w
        flops += layers * (2 * C * C + 3 * C)
        nbytes += layers * 2 * 4 * C
    return flops, nbytes

