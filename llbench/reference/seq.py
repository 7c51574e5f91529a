"""The reference of LLICTI's sequential-colour interpolator: clr_joint_mode
0 with clrjnt0seqmd (kamisli-icpl/LLICTI,
``graphs/models/LLICTI_nets.py:655-682,727-730``), its encoder, its FLOP
count and fixed weights made from a seed.  Plain PyTorch and numpy.

Each colour has its own channel groups: layer 0 convolves each colour of
the conditioning bands with a group of its own (groups 3, Ch = 9 chs),
the trunk runs 9 groups of chs channels, and colour c's mixture (sigma,
mu, w of M terms) is columns 3cM, (3c+1)M, (3c+2)M of the parameter map,
with no mean update.  The current pixel's earlier colours enter the
pre-activation layer-0 map: ``seq_toCo`` (a 1x1 conv of Y) adds to the Co
third, ``seq_toCg`` (of Y and Co) to the Cg third.  So a decoder, which
holds only the colours below c, computes colour c's map from those:
the encoder codes a band colour by colour, the trunk run on the map with
the colours below c added.

Departures from the published description:

* float32 with TF32 off throughout (``codec.float32_math``), the
  precision the codec states; the published model runs under PyTorch's
  default flags.
* A colour's map comes from a trunk pass of its own over all 9 groups,
  as the program computes it (both directions must run identical
  shapes); the published forward runs the trunk once, on the map with
  both colours added.  The trunk's groups never mix, so colour c's
  columns are the same numbers either way.
* The weights are made from a seed (:func:`seeded_weights`), the
  published init's U(-1/sqrt(fan_in), 1/sqrt(fan_in)) of every conv
  kernel and bias: no trained weights of this mode are at hand.
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


class SeqConfig(Config):
    """The model keys of a clr_joint_mode 0 + clrjnt0seqmd configuration;
    every other knob as :class:`Config` takes it (ReLU, normal mixtures,
    YCoCg-R, three colours)."""

    def __init__(self, model: Dict):
        if model["clr_joint_mode"] != 0 or model["clrjnt0seqmd"] is not True:
            raise NotImplementedError("the sequential-colour reference runs "
                                      "clr_joint_mode 0 with clrjnt0seqmd")
        # the joint-colour Config checks every other knob
        super().__init__(dict(model, clr_joint_mode=2, clrjnt0seqmd=False))


def widths(cfg: Config, scale: int):
    """(trunk groups, hidden channels, parameter channels) of the model
    owned by ``scale``: 9 groups of chs[scale], 9 M parameters (sigma,
    mu, w of M terms, a colour)."""
    return 9, 9 * cfg.chs[scale], 9 * cfg.M


class SeqBandNet(nn.Module):
    """The interpolator of one (scale model, band)."""

    def __init__(self, cfg: Config, scale: int, band: int):
        super().__init__()
        grps, Ch, Co = widths(cfg, scale)
        self.c = cfg.c
        self.specs = layer0_specs(cfg.evens[scale], cfg.odds[scale], band)
        for _, name, kernel, _ in self.specs:
            self.add_module(name, nn.Conv2d(cfg.c, Ch, kernel, groups=3))
        self.seq_toCo = nn.Conv2d(1, Ch // 3, 1)
        self.seq_toCg = nn.Conv2d(2, Ch // 3, 1)
        self.act0 = nn.ReLU()
        trunk: List[nn.Module] = []
        for _ in range(cfg.conv_layers - 2):
            trunk += [nn.Conv2d(Ch, Ch, 1, groups=grps), nn.ReLU()]
        trunk.append(nn.Conv2d(Ch, Co, 1, groups=grps))
        self.trunk = nn.Sequential(*trunk)

    def base(self, y_cond: torch.Tensor) -> torch.Tensor:
        """Conditioning bands [B, h, w, c (band + 1)] -> the layer-0 sum
        before the activation, NCHW [B, Ch, h, w]."""
        x = y_cond.permute(0, 3, 1, 2)
        out = None
        for unit, name, _, pad in self.specs:
            xb = x[:, unit * self.c:(unit + 1) * self.c].contiguous()
            o = getattr(self, name)(F.pad(xb, pad, mode="replicate"))
            out = o if out is None else out + o
        return out

    def params(self, base: torch.Tensor, y_seq: torch.Tensor,
               clr: int) -> torch.Tensor:
        """Colour ``clr``'s parameter map [B, h, w, Co], contiguous, from
        the layer-0 sum and the pixel's own Y and Co (``y_seq`` [B, h, w,
        2]): seq_toCo(Y) added to the Co third for clr >= 1,
        seq_toCg(Y, Co) to the Cg third for clr = 2, then the activation
        and the trunk."""
        h = base
        if clr >= 1:
            third = base.shape[1] // 3
            ys = y_seq.permute(0, 3, 1, 2)
            parts = [base[:, :third], base[:, third:2 * third],
                     base[:, 2 * third:]]
            parts[1] = parts[1] + self.seq_toCo(ys[:, 0:1].contiguous())
            if clr >= 2:
                parts[2] = parts[2] + self.seq_toCg(ys[:, 0:2].contiguous())
            h = torch.cat(parts, dim=1)
        h = self.trunk(self.act0(h))
        return h.permute(0, 2, 3, 1).contiguous()


class SeqModel(nn.Module):
    """``models[m][b]``: model m's interpolator of band b."""

    def __init__(self, cfg: SeqConfig):
        super().__init__()
        self.cfg = cfg
        self.models = nn.ModuleList(
            nn.ModuleList(SeqBandNet(cfg, s, b) for b in range(3))
            for s in cfg.model_scales)

    def band(self, scale: int, band: int) -> SeqBandNet:
        return self.models[self.cfg.model_index[scale]][band]


def colour_spec(c: int, M: int, band: int, clr: int):
    """(M, std0, mean0, w0, no updates, symbol channel) of one colour in a
    band's parameter map."""
    return (M, 3 * clr * M, (3 * clr + 1) * M, (3 * clr + 2) * M, (),
            c * (band + 1) + clr)


# ---- parameters -------------------------------------------------------------

def seeded_weights(cfg: SeqConfig, seed: int) -> Dict[str, np.ndarray]:
    """Fixed float32 weights of the model, {Flax name: array} as
    ``model.from_flax`` reads them (kernels HWIO): every kernel and bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the kernel's fan-in, drawn leaf
    by leaf in the model's order from ``np.random.default_rng(seed)``."""
    with torch.device("meta"):
        model = SeqModel(cfg)
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


def build(cfg: SeqConfig, state: Dict[str, torch.Tensor],
          device) -> SeqModel:
    model = SeqModel(cfg)
    model.load_state_dict(state, strict=True)
    return model.to(device)


# ---- the work ---------------------------------------------------------------

def conv_flops(h: int, w: int, cin: int, cout: int, kh: int, kw: int,
               groups: int) -> int:
    """2 x multiply-adds of a stride-1 conv with an h x w output."""
    return 2 * h * w * cout * (cin // groups) * kh * kw


def forward_flops(keys: dict, H: int, W: int) -> int:
    """Float operations the model needs over one H x W image (padded up to
    the coarsest stride): per scale and band, layer 0's grouped convs,
    one pass of the 9-group trunk and the two sequential convs; a
    decoder's colour c needs only its own third of the trunk, so the
    three thirds are one pass."""
    cfg = SeqConfig(keys)
    total = 0
    owner = cfg.dwtlevels[0]
    for s, lev in enumerate(cfg.dwtlevels):
        if s > 0 and not cfg.useprevlevNN[s]:
            owner = lev
        st = 2 ** (lev + 1)
        h, w = -(-H // st), -(-W // st)
        grps, Ch, Co = widths(cfg, owner)
        Ev, Od = cfg.evens[owner], cfg.odds[owner]
        for b in range(3):
            for _, _, (kh, kw), _ in layer0_specs(Ev, Od, b):
                total += conv_flops(h, w, cfg.c, Ch, kh, kw, 3)
            total += (conv_flops(h, w, 1, Ch // 3, 1, 1, 1)
                      + conv_flops(h, w, 2, Ch // 3, 1, 1, 1))
            for _ in range(cfg.conv_layers - 2):
                total += conv_flops(h, w, Ch, Ch, 1, 1, grps)
            total += conv_flops(h, w, Ch, Co, 1, 1, grps)
    return total


# ---- the encoder ------------------------------------------------------------

class SeqEncoder(Encoder):
    """Codes images with a :class:`SeqModel`: the containers of
    :class:`codec.Encoder`, each band's colours coded one after another,
    colour c's map from the pixels' true colours below c."""

    def _slices(self, rgb: np.ndarray, ranges, flags_out: list):
        cfg, c, M = self.cfg, self.cfg.c, self.cfg.M
        K = rgb.shape[0]
        dev = torch.from_numpy(np.ascontiguousarray(rgb)).to(self.device)
        shift = torch.tensor((127, 0, 0), dtype=torch.int32,
                             device=self.device)
        x = (rgb_int_to_ycocg_r_int(dev) - shift).float() * INV255
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

                net = self.model.band(scl, b)
                base = net.base(y_lev[..., :c * (b + 1)].contiguous())
                y2 = rows(y_lev)
                y_seq = y_lev[..., c * (b + 1):c * (b + 1) + 2]
                for clr in range(3):
                    pm = rows(net.params(base, y_seq, clr))
                    Mx, s0, m0, w0, upd, sch = colour_spec(c, M, b, clr)
                    _, start, freq, sat = cdf_tables(
                        pts[clr], pm, y2, Mx, s0, m0, w0, upd, sch,
                        ranges[clr][0])
                    sf.append((start.view(K, n), freq.view(K, n)))
                    work.append((K * n, pts[clr].shape[0],
                                 (Mx, s0, m0, w0, upd), sch, sat))
        host = [(s.cpu().numpy(), f.cpu().numpy()) for s, f in sf]
        return host, [(r, P, spec, sch, int(sat))
                      for r, P, spec, sch, sat in work]
