"""The reference of LLICTI's clr_joint_mode 1 interpolator (kamisli-icpl/
LLICTI ``graphs/models/LLICTI_nets.py:21``: Y coded on its own, Co and Cg
jointly) at the joint-colour model's widths, its encoder up to the batch
container, its FLOP count and fixed weights made from a seed.  Plain
PyTorch and numpy.

A band unit is four channels, a zero channel in front of (Y, Co, Cg), so
layer 0's two groups see (0, Y) and (Co, Cg): each layer-0 conv is
``Conv2d(4, 8 chs, k, groups=2)``, the trunk runs 8 groups of chs
channels (Ch = 8 chs) and the parameter map has 16 M channels:

  [2M unused | Y: 2M sigma | 2M mu | 2M w | Co, Cg: sigma 2M | mu 2M |
   w 2M | a M | M unused],

Y a mixture of 2M terms, Co and Cg of M each, and Cg's mean
mu_Cg += a Co, from the pixel's own Co.

Departures from the published description:

* float32 with TF32 off throughout (``codec.float32_math``), the
  precision the codec states; the published model runs under PyTorch's
  default flags.
* The CDF tables are the reference codec's (``codec.cdf_tables``: the
  Abramowitz-Stegun erf, 2^16 total, one count a symbol at least), which
  the program's containers must match byte for byte; the published codec
  builds its tables with torchac.
* The weights are made from a seed (:func:`seeded_weights`), the
  published init's U(-1/sqrt(fan_in), 1/sqrt(fan_in)) of every conv
  kernel and bias: no trained weights of this mode are at hand, so the
  bit rate is that fixed model's.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .codec import INV255, Encoder, cdf_tables, sampling_points
from .model import (Config, band_coded_shape, layer0_specs, lazy_dwt,
                    rgb_int_to_ycocg_r_int)
from .seq import conv_flops

LAYER0_GROUPS = 2


class Clrjnt1Config(Config):
    """The model keys of a clr_joint_mode 1 configuration; every other knob
    as :class:`Config` takes it (ReLU, normal mixtures, YCoCg-R, three
    colours).  A band unit has four channels."""

    def __init__(self, model: Dict):
        if model["clr_joint_mode"] != 1:
            raise NotImplementedError("the clr_joint_mode 1 reference runs "
                                      "clr_joint_mode 1")
        # the joint-colour Config checks every other knob
        super().__init__(dict(model, clr_joint_mode=2))
        self.c = 4  # a zero channel, Y, Co, Cg


def widths(cfg: Config, scale: int):
    """(trunk groups, hidden channels, parameter channels) of the model
    owned by ``scale``: 8 groups of chs[scale], 16 M parameters."""
    return 8, 8 * cfg.chs[scale], 16 * cfg.M


class Clrjnt1BandNet(nn.Module):
    """The interpolator of one (scale model, band)."""

    def __init__(self, cfg: Config, scale: int, band: int):
        super().__init__()
        grps, Ch, Co = widths(cfg, scale)
        self.c = cfg.c
        self.specs = layer0_specs(cfg.evens[scale], cfg.odds[scale], band)
        for _, name, kernel, _ in self.specs:
            self.add_module(name, nn.Conv2d(cfg.c, Ch, kernel,
                                            groups=LAYER0_GROUPS))
        self.act0 = nn.ReLU()
        trunk: List[nn.Module] = []
        for _ in range(cfg.conv_layers - 2):
            trunk += [nn.Conv2d(Ch, Ch, 1, groups=grps), nn.ReLU()]
        trunk.append(nn.Conv2d(Ch, Co, 1, groups=grps))
        self.trunk = nn.Sequential(*trunk)

    def params(self, y_cond: torch.Tensor) -> torch.Tensor:
        """Conditioning bands [B, h, w, 4 (band + 1)] -> parameter map
        [B, h, w, 16 M], contiguous."""
        x = y_cond.permute(0, 3, 1, 2)
        out = None
        for unit, name, _, pad in self.specs:
            xb = x[:, unit * self.c:(unit + 1) * self.c].contiguous()
            o = getattr(self, name)(F.pad(xb, pad, mode="replicate"))
            out = o if out is None else out + o
        h = self.trunk(self.act0(out))
        return h.permute(0, 2, 3, 1).contiguous()


class Clrjnt1Model(nn.Module):
    """``models[m][b]``: model m's interpolator of band b."""

    def __init__(self, cfg: Clrjnt1Config):
        super().__init__()
        self.cfg = cfg
        self.models = nn.ModuleList(
            nn.ModuleList(Clrjnt1BandNet(cfg, s, b) for b in range(3))
            for s in cfg.model_scales)

    def band(self, scale: int, band: int) -> Clrjnt1BandNet:
        return self.models[self.cfg.model_index[scale]][band]


def colour_spec(c: int, M: int, band: int, clr: int, y_only_m: bool = False):
    """(terms, std0, mean0, w0, ((coef0, y channel), ...), symbol channel)
    of one colour in a band's parameter map: Y with 2M terms from column
    2M; Co and Cg with M from 8M + (clr - 1) M, Cg's mean updated by a Co
    (coefficients from column 14M).  ``y_only_m`` codes Y with its first
    M terms alone: a fault for the comparison's own tests."""
    sym = c * (band + 1) + 1 + clr
    if clr == 0:
        T = M if y_only_m else 2 * M
        return T, 2 * M, 4 * M, 6 * M, (), sym
    i = clr - 1
    upd = ((14 * M, c * (band + 1) + 2),) if clr == 2 else ()
    return M, (8 + i) * M, (10 + i) * M, (12 + i) * M, upd, sym


# ---- parameters -------------------------------------------------------------

def seeded_weights(cfg: Clrjnt1Config, seed: int) -> Dict[str, np.ndarray]:
    """Fixed float32 weights of the model, {Flax name: array} as
    ``model.from_flax`` reads them (kernels HWIO): every kernel and bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the kernel's fan-in (a grouped
    kernel's: its group's inputs), drawn leaf by leaf in the model's
    order from ``np.random.default_rng(seed)``."""
    with torch.device("meta"):
        model = Clrjnt1Model(cfg)
    rng = np.random.default_rng(seed)
    fans: Dict[str, int] = {}
    out = {}
    for name, p in model.named_parameters():
        owner, leaf = name.rsplit(".", 1)
        if leaf == "weight":
            fans[owner] = int(np.prod(p.shape[1:]))
        bound = fans[owner] ** -0.5
        arr = rng.uniform(-bound, bound, tuple(p.shape)).astype(np.float32)
        _, m, b, layer = owner.split(".", 3)
        key = f"models_{m}_{b}/{layer.replace('trunk.', 'trunk_')}/Conv_0/"
        if leaf == "weight":
            out[key + "kernel"] = np.ascontiguousarray(
                arr.transpose(2, 3, 1, 0))
        else:
            out[key + "bias"] = arr
    return out


def build(cfg: Clrjnt1Config, state: Dict[str, torch.Tensor],
          device) -> Clrjnt1Model:
    model = Clrjnt1Model(cfg)
    model.load_state_dict(state, strict=True)
    return model.to(device)


# ---- the work ---------------------------------------------------------------

def forward_flops(keys: dict, H: int, W: int) -> int:
    """Float operations of the model's convs over one H x W image (padded
    up to the coarsest stride): per scale and band, layer 0's convs of two
    groups on the conditioning units, then the 8-group 1x1 trunk."""
    cfg = Clrjnt1Config(keys)
    total = 0
    for s, lev in enumerate(cfg.dwtlevels):
        owner = cfg.model_scales[cfg.model_index[s]]
        st = 2 ** (lev + 1)
        h, w = -(-H // st), -(-W // st)
        grps, Ch, Co = widths(cfg, owner)
        for b in range(3):
            for _, _, (kh, kw), _ in layer0_specs(cfg.evens[owner],
                                                  cfg.odds[owner], b):
                total += conv_flops(h, w, cfg.c, Ch, kh, kw, LAYER0_GROUPS)
            for _ in range(cfg.conv_layers - 2):
                total += conv_flops(h, w, Ch, Ch, 1, 1, grps)
            total += conv_flops(h, w, Ch, Co, 1, 1, grps)
    return total


# ---- the encoder ------------------------------------------------------------

class Clrjnt1Encoder(Encoder):
    """Codes images with a :class:`Clrjnt1Model`: the containers of
    :class:`codec.Encoder`, the bands carrying the zero channel and each
    colour's mixture sliced by :func:`colour_spec`.  ``y_only_m``: the
    fault of :func:`colour_spec`."""

    def __init__(self, model, lanes: int, device, tf32: bool = False,
                 y_only_m: bool = False):
        super().__init__(model, lanes, device, tf32)
        self.y_only_m = y_only_m

    def _slices(self, rgb: np.ndarray, ranges, flags_out: list):
        cfg, c, M = self.cfg, self.cfg.c, self.cfg.M
        K = rgb.shape[0]
        dev = torch.from_numpy(np.ascontiguousarray(rgb)).to(self.device)
        shift = torch.tensor((127, 0, 0), dtype=torch.int32,
                             device=self.device)
        x = (rgb_int_to_ycocg_r_int(dev) - shift).float() * INV255
        x = torch.cat((torch.zeros_like(x[..., :1]), x), dim=-1)
        y_list, flags = lazy_dwt(x, cfg.dwtlevels, pad=True)
        flags_out.extend(flags)
        pts = [sampling_points(*r).to(self.device) for r in ranges]
        sf, work = [], []
        for scl in range(cfg.num_scales - 1, -1, -1):
            y_lev = y_list[scl]
            padH, padW = flags[scl]
            for b in range(3):
                ch, cw = band_coded_shape(y_lev.shape[1], y_lev.shape[2], b,
                                          padH, padW)
                n = ch * cw

                def rows(t):
                    return t[:, :ch, :cw].reshape(K * n, -1).contiguous()

                pm = rows(self.model.band(scl, b).params(
                    y_lev[..., :c * (b + 1)].contiguous()))
                y2 = rows(y_lev)
                for clr in range(3):
                    T, s0, m0, w0, upd, sch = colour_spec(
                        c, M, b, clr, self.y_only_m)
                    _, start, freq, sat = cdf_tables(
                        pts[clr], pm, y2, T, s0, m0, w0, upd, sch,
                        ranges[clr][0])
                    sf.append((start.view(K, n), freq.view(K, n)))
                    work.append((K * n, pts[clr].shape[0],
                                 (T, s0, m0, w0, upd), sch, sat))
        host = [(s.cpu().numpy(), f.cpu().numpy()) for s, f in sf]
        return host, [(r, P, spec, sch, int(sat))
                      for r, P, spec, sch, sat in work]
