"""The reference model: colour transform, lazy wavelet, the interpolators
and the rate forward (bits of every subpixel under the discrete normal
mixtures).  Plain PyTorch; NHWC tensors outside, NCHW convs inside.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

HALF = 0.5 / 255.0
SCALE_BOUND = 0.11 / 255.0  # a normal mixture's lower bound on its scale
WEIGHT_BOUND = 1e-6
LIKELIHOOD_BOUND = 1e-9
SQRT2_INV = 2 ** -0.5


class Config:
    """The model keys of a benchmark configuration file, with the
    quantities the model derives from them."""

    def __init__(self, model: Dict):
        refused = [k for k, ok in (
            ("clrchs", model["clrchs"] == 3),
            ("clr_joint_mode", model["clr_joint_mode"] == 2),
            ("ycocg", model["ycocg"] is True),
            ("activfun", model["activfun"] == "ReLU"),
            ("distribution", model["distribution"] == "normal"),
            ("lif_prec_bits", model["lif_prec_bits"] == 8),
            ("mwsa_joint", not model["mwsa_joint"]),
            ("clrjnt0seqmd", not model["clrjnt0seqmd"]),
            ("combine_layers1toL", not model["combine_layers1toL"]),
            ("subtract_mean", not model["subtract_mean"])) if not ok]
        if refused:
            raise NotImplementedError(f"the reference does not run "
                                      f"{', '.join(refused)} as given")
        self.chs = tuple(model["chs"])
        self.conv_layers = int(model["conv_layers"])
        self.evens = tuple(model["evens"])
        self.odds = tuple(model["odds"])
        self.dwtlevels = tuple(model["dwtlevels"])
        self.useprevlevNN = tuple(model["useprevlevNN"])
        self.M = int(model["num_mixtures"])
        self.c = 3  # channels of a band unit: Y, Co, Cg
        self.rndfactor = 255.0
        self.mean_y = 127.0 / 255.0

    @property
    def num_scales(self) -> int:
        return len(self.dwtlevels)

    @property
    def model_index(self) -> List[int]:
        """Scale -> interpolator model; a scale whose useprevlevNN is true
        shares the model before it."""
        idx, m = [], 0
        for s in range(self.num_scales):
            if s > 0 and not self.useprevlevNN[s]:
                m += 1
            idx.append(m)
        return idx

    @property
    def model_scales(self) -> List[int]:
        """The wavelet level of the scale that owns each distinct model (it
        sets the model's widths)."""
        owners = []
        for s, m in enumerate(self.model_index):
            if m == len(owners):
                owners.append(self.dwtlevels[s])
        return owners


# ---- ops -------------------------------------------------------------------

class _LowerBound(torch.autograd.Function):
    """max(x, bound); the gradient passes where x >= bound or where it is
    negative (a descent step then lifts x towards the bound): compressai's
    LowerBound, which the published model trains with."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x >= bound)
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (passes,) = ctx.saved_tensors
        return torch.where(passes | (g < 0), g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _LowerBound.apply(x, bound)
    return torch.clamp_min(x, bound)


def ieee_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as one IEEE division (a Python divisor becomes a reciprocal
    multiply on the card)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def rgb_to_ycocg_r(x: torch.Tensor, rnd: float) -> torch.Tensor:
    """Float YCoCg-R lifting of RGB in [0, 1], rounded to 1/rnd steps."""
    R, G, B = x[..., 0], x[..., 1], x[..., 2]
    Co = R - B
    t = B + ieee_div(torch.round(Co * rnd / 2), rnd)
    Cg = G - t
    Y = t + ieee_div(torch.round(Cg * rnd / 2), rnd)
    return torch.stack((Y, Co, Cg), dim=-1)


def rgb_int_to_ycocg_r_int(x: torch.Tensor) -> torch.Tensor:
    """Integer YCoCg-R lifting (floor halves) of uint8 RGB."""
    x = x.to(torch.int32)
    R, G, B = x[..., 0], x[..., 1], x[..., 2]
    Co = R - B
    t = B + torch.div(Co, 2, rounding_mode="floor")
    Cg = G - t
    Y = t + torch.div(Cg, 2, rounding_mode="floor")
    return torch.stack((Y, Co, Cg), dim=-1)


def rgb_int_to_ycocg_r_int_np(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.int32)
    R, G, B = x[..., 0], x[..., 1], x[..., 2]
    Co = R - B
    t = B + Co // 2
    Cg = G - t
    Y = t + Cg // 2
    return np.stack((Y, Co, Cg), axis=-1)


def _pad_edge(x: torch.Tensor, right: int, bottom: int) -> torch.Tensor:
    """Replicate the last column ``right`` times and the last row
    ``bottom`` times of an NHWC tensor."""
    if right == bottom == 0:
        return x
    H, W = x.shape[1], x.shape[2]
    hi = torch.arange(0, H + bottom, device=x.device).clamp_(0, H - 1)
    wi = torch.arange(0, W + right, device=x.device).clamp_(0, W - 1)
    return x[:, hi][:, :, wi]


def lazy_dwt(x: torch.Tensor, levels: Sequence[int], pad: bool = False):
    """[B, H, W, C] -> per level [B, h, w, 4C], the polyphase bands (x00,
    x11, x01, x10) side by side; with ``pad`` the odd sizes' bands are
    replicate-padded to x00's size and the pad flags come back too."""
    y_list, flags = [], []
    for lev in range(0, max(levels) + 1):
        if lev not in levels:
            continue
        st = 2 ** (lev + 1)
        of = st // 2
        x00 = x[:, 0::st, 0::st, :]
        x01 = x[:, 0::st, of::st, :]
        x10 = x[:, of::st, 0::st, :]
        x11 = x[:, of::st, of::st, :]
        if pad:
            padH = x00.shape[1] > x11.shape[1]
            padW = x00.shape[2] > x11.shape[2]
            flags.append((padH, padW))
            x01 = _pad_edge(x01, int(padW), 0)
            x10 = _pad_edge(x10, 0, int(padH))
            x11 = _pad_edge(x11, int(padW), int(padH))
        y_list.append(torch.cat((x00, x11, x01, x10), dim=-1))
    return (y_list, flags) if pad else y_list


def band_coded_shape(h: int, w: int, band: int, padH: bool,
                     padW: bool) -> Tuple[int, int]:
    """The coded size of band 0 (x11), 1 (x01) or 2 (x10) of a scale whose
    x00 is h x w: a padded row or column is not coded."""
    ch = h - 1 if (padH and band in (0, 2)) else h
    cw = w - 1 if (padW and band in (0, 1)) else w
    return ch, cw


# ---- the interpolators -------------------------------------------------------

def layer0_specs(Ev: int, Od: int, band: int):
    """[(conditioning unit, conv name, kernel (kh, kw), replicate pad
    (left, right, top, bottom))] of a band's layer 0: kernels and pads
    that centre each receptive field on the predicted polyphase
    position."""
    e0, e1, o = Ev // 2 - 1, Ev // 2, Od // 2
    return {
        0: [(0, "conv_00_11", (Ev, Ev), (e0, e1, e0, e1))],
        1: [(0, "conv_00_01", (Od, Ev), (e0, e1, o, o)),
            (1, "conv_11_01", (Ev, Od), (o, o, e1, e0))],
        2: [(0, "conv_00_10", (Ev, Od), (o, o, e0, e1)),
            (1, "conv_11_10", (Od, Ev), (e1, e0, o, o)),
            (2, "conv_01_10", (Ev, Ev), (e1, e0, e0, e1))],
    }[band]


def widths(cfg: Config, scale: int) -> Tuple[int, int, int]:
    """(groups of the trunk, hidden channels, parameter channels) of the
    model owned by ``scale``: four groups of chs[scale] channels; per
    pixel sigma, mu and w of M mixtures for each of three colours, and
    the M coefficients a, b, d of the colours' mean updates."""
    grps = 4
    return grps, grps * cfg.chs[scale], 12 * cfg.M


class BandNet(nn.Module):
    """The interpolator of one (scale model, band)."""

    def __init__(self, cfg: Config, scale: int, band: int):
        super().__init__()
        grps, Ch, Co = widths(cfg, scale)
        self.c = cfg.c
        self.specs = layer0_specs(cfg.evens[scale], cfg.odds[scale], band)
        for _, name, kernel, _ in self.specs:
            self.add_module(name, nn.Conv2d(cfg.c, Ch, kernel))
        self.act0 = nn.ReLU()
        trunk: List[nn.Module] = []
        for _ in range(cfg.conv_layers - 2):
            trunk += [nn.Conv2d(Ch, Ch, 1, groups=grps), nn.ReLU()]
        trunk.append(nn.Conv2d(Ch, Co, 1, groups=grps))
        self.trunk = nn.Sequential(*trunk)

    def params(self, y_cond: torch.Tensor) -> torch.Tensor:
        """Conditioning bands [B, h, w, c (band + 1)] -> parameter map
        [B, h, w, Co], contiguous."""
        x = y_cond.permute(0, 3, 1, 2)
        out = None
        for unit, name, _, pad in self.specs:
            xb = x[:, unit * self.c:(unit + 1) * self.c].contiguous()
            o = getattr(self, name)(F.pad(xb, pad, mode="replicate"))
            out = o if out is None else out + o
        h = self.trunk(self.act0(out))
        return h.permute(0, 2, 3, 1).contiguous()


class Model(nn.Module):
    """``models[m][b]``: model m's interpolator of band b."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.models = nn.ModuleList(
            nn.ModuleList(BandNet(cfg, s, b) for b in range(3))
            for s in cfg.model_scales)

    def band(self, scale: int, band: int) -> BandNet:
        return self.models[self.cfg.model_index[scale]][band]

    def transform(self, x: torch.Tensor) -> List[torch.Tensor]:
        """RGB [B, H, W, 3] in [0, 1] -> per scale the float bands of
        YCoCg-R, Y shifted by 127/255."""
        cfg = self.cfg
        x = rgb_to_ycocg_r(x, cfg.rndfactor)
        x = torch.cat((x[..., :1] - cfg.mean_y, x[..., 1:]), dim=-1)
        return lazy_dwt(x, cfg.dwtlevels)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """RGB [B, H, W, 3] in [0, 1] -> per scale the bits of every
        subpixel of bands 1..3, [B, h, w, 9]."""
        c = self.cfg.c
        out = []
        for s, y in enumerate(self.transform(x)):
            out.append(torch.cat([
                self_information(self.band(s, b).params(y[..., :c * (b + 1)]),
                                 y[..., c * (b + 1):c * (b + 2)], self.cfg.M)
                for b in range(3)], dim=-1))
        return out


# ---- the discrete mixture ------------------------------------------------------

def _sum_last(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right."""
    acc = t[..., 0]
    for i in range(1, t.shape[-1]):
        acc = acc + t[..., i]
    return acc


def self_information(params: torch.Tensor, y: torch.Tensor,
                     M: int) -> torch.Tensor:
    """-log2 p of each colour of ``y`` [..., 3] under the parameter map's
    mixtures, [3M sigma | 3M mu | 3M w | M a | M b | M d]: the mass of
    [v - 0.5/255, v + 0.5/255], with mu_Co += a Y and mu_Cg += b Y + d Co
    (the colours' joint model)."""
    mean = params[..., 3 * M:6 * M]
    a = params[..., 9 * M:10 * M]
    b = params[..., 10 * M:11 * M]
    d = params[..., 11 * M:12 * M]
    mean = torch.cat([mean[..., :M], mean[..., M:2 * M] + a * y[..., 0:1],
                      mean[..., 2 * M:] + (b * y[..., 0:1] + d * y[..., 1:2])],
                     -1)
    shape = y.shape + (M,)
    values = torch.abs(y[..., None] - mean.reshape(shape))
    scales = lower_bound(params[..., 0:3 * M].reshape(shape), SCALE_BOUND)
    upper = 0.5 * torch.special.erfc(-SQRT2_INV * ((HALF - values) / scales))
    lower = 0.5 * torch.special.erfc(-SQRT2_INV * ((-HALF - values) / scales))
    w = lower_bound(params[..., 6 * M:9 * M].reshape(shape), WEIGHT_BOUND)
    w = w / _sum_last(w)[..., None]
    p = _sum_last(w * (upper - lower))
    return -torch.log2(lower_bound(p, LIKELIHOOD_BOUND))


def rate(x: torch.Tensor, bits: Sequence[torch.Tensor]) -> torch.Tensor:
    """The training loss: bits over the batch's subpixels, times 3 (bits a
    pixel), summed over scales."""
    total = None
    for si in bits:
        r = (si.sum(dim=(0, 1, 2)) / x.numel() * 3).sum()
        total = r if total is None else total + r
    return total


# ---- parameters --------------------------------------------------------------

def leaves(cfg: Config) -> List[Tuple[str, Tuple[int, ...], int]]:
    """(name, shape, fan-in) of every parameter of the model, in the
    model's order."""
    with torch.device("meta"):
        model = Model(cfg)
    out = []
    for name, p in model.named_parameters():
        fan_in = int(np.prod(p.shape[1:])) if p.dim() > 1 else None
        out.append((name, tuple(p.shape), fan_in))
    # a bias takes its conv's fan-in
    fans = {n.rsplit(".", 1)[0]: f for n, _, f in out if f is not None}
    return [(n, s, f if f is not None else fans[n.rsplit(".", 1)[0]])
            for n, s, f in out]


def from_flax(arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The published model's Flax-named arrays
    (``models_{m}_{b}/{layer}/Conv_0/{kernel,bias}``, kernels HWIO) ->
    this model's state dict (kernels OIHW)."""
    out = {}
    for name, arr in arrays.items():
        head, layer, leaf = name.split("/", 2)
        _, m, b = head.split("_")
        if layer.startswith("trunk_"):
            layer = "trunk." + layer[len("trunk_"):]
        if leaf == "Conv_0/kernel":
            arr, leaf = np.transpose(arr, (3, 2, 0, 1)), "weight"
        elif leaf == "Conv_0/bias":
            leaf = "bias"
        else:
            raise KeyError(f"unknown parameter {name!r}")
        out[f"models.{int(m)}.{int(b)}.{layer}.{leaf}"] = torch.from_numpy(
            np.array(arr, np.float32, order="C"))
    return out


def build(cfg: Config, state: Dict[str, torch.Tensor], device) -> Model:
    model = Model(cfg)
    model.load_state_dict(state, strict=True)
    return model.to(device)
