"""Interpolator network: the conditional-GMM parameter CNN of one
(scale, band).

Port of ``llicti_tpu/models/interpolator.py:92-304`` (codec path).  Layer
0 is band-geometry specific: small Ev/Od kernels with asymmetric
replicate padding that align receptive fields with the polyphase sample
positions; the trunk is grouped 1x1 convs.  ``band=-1``
(combine_layers1toL) holds every band's layer-0 convs and picks them by
the conditioning channel count.  With clrjnt0seqmd, the current pixel's
earlier colours feed the later colours' channel groups through
``seq_toCo`` / ``seq_toCg`` (:meth:`Interpolator.params_from_base`).
Public tensors are NHWC like the JAX package's; inside, the convs run
NCHW.  subtract_mean (a training variant) is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops.gdn import GDN1


def interpolator_dims(cfg: ModelConfig, scale: int):
    """(grps, Ch, Co, c, grp0) of the interpolator owning ``scale``."""
    M = cfg.num_mixtures
    ch = cfg.chs[scale]
    if cfg.clrchs == 3:
        if cfg.clr_joint_mode == 2:
            grps = 1 if cfg.mwsa_joint else 4
            Ch = grps * ch
            Co = 3 * M * 3 + 3 * M  # sigma/mu/w for 3 colours + (a,b,d)*M
        elif cfg.clr_joint_mode == 1:
            grps = 8
            Ch = grps * ch
            Co = M * 16
        elif cfg.clr_joint_mode == 0:
            grps = 3 if cfg.mwsa_joint else 9
            Ch = grps * ch
            Co = M * grps
        else:
            raise ValueError(cfg.clr_joint_mode)
    else:
        chs = [48, 32, 24, 24]
        if cfg.clrchs in (1, 2):
            chs = [int(i * 0.75) for i in chs]
        Ch = 3 * chs[scale]
        grps = 3
        Co = M * 3
    c = cfg.cond_channels
    grp0 = 1 if (cfg.clrchs < 3 or cfg.clr_joint_mode == 2) else (
        3 if cfg.clr_joint_mode == 0 else 2)
    return grps, Ch, Co, c, grp0


def seq_colours(cfg: ModelConfig) -> bool:
    """Whether the config conditions later colours on earlier ones of the
    same pixel (clrjnt0seqmd)."""
    return cfg.clrchs == 3 and cfg.clr_joint_mode == 0 and cfg.clrjnt0seqmd


def _activation(kind: str, channels: int) -> nn.Module:
    if kind == "ReLU":
        return nn.ReLU()
    if kind == "LeakyReLU":
        return nn.LeakyReLU(0.01)
    if kind == "PReLU":
        return nn.PReLU(num_parameters=channels, init=0.25)
    if kind == "GDN1":
        return GDN1(channels)
    return nn.Identity()  # any other name, as the JAX _Activation


def _layer0_specs(Ev: int, Od: int):
    """band -> [(input band unit, conv name, kernel (kh, kw), replicate
    pad (left, right, top, bottom))] of layer 0."""
    e0, e1, o = Ev // 2 - 1, Ev // 2, Od // 2
    return {
        0: [(0, "conv_00_11", (Ev, Ev), (e0, e1, e0, e1))],
        1: [(0, "conv_00_01", (Od, Ev), (e0, e1, o, o)),
            (1, "conv_11_01", (Ev, Od), (o, o, e1, e0))],
        2: [(0, "conv_00_10", (Ev, Od), (o, o, e0, e1)),
            (1, "conv_11_10", (Od, Ev), (e1, e0, o, o)),
            (2, "conv_01_10", (Ev, Ev), (e1, e0, e0, e1))],
    }


class Interpolator(nn.Module):
    """One conditional-GMM parameter network for a (scale, band); band -1
    serves all three bands."""

    def __init__(self, cfg: ModelConfig, scale: int, band: int):
        super().__init__()
        if band not in (0, 1, 2, -1):
            raise ValueError(f"band={band}")
        grps, Ch, Co, c, grp0 = interpolator_dims(cfg, scale)
        self.c = c
        specs = _layer0_specs(cfg.evens[scale], cfg.odds[scale])
        self._specs = {b: s for b, s in specs.items() if band in (b, -1)}
        for spec in self._specs.values():
            for _, name, kernel, _ in spec:
                self.add_module(name, nn.Conv2d(c, Ch, kernel, groups=grp0))
        if seq_colours(cfg):
            self.seq_toCo = nn.Conv2d(1, Ch // 3, 1)
            self.seq_toCg = nn.Conv2d(2, Ch // 3, 1)
        self.act0 = _activation(cfg.activfun, Ch)
        trunk = []
        for _ in range(cfg.conv_layers - 2):
            trunk.append(nn.Conv2d(Ch, Ch, 1, groups=grps))
            trunk.append(_activation(cfg.activfun, Ch))
        trunk.append(nn.Conv2d(Ch, Co, 1, groups=grps))
        self.trunk = nn.Sequential(*trunk)

    def _base(self, y_cond: torch.Tensor) -> torch.Tensor:
        """Pre-activation layer-0 sum, NCHW."""
        x = y_cond.permute(0, 3, 1, 2)
        c = self.c
        band = y_cond.shape[-1] // c - 1
        if band not in self._specs:
            raise ValueError(f"{y_cond.shape[-1]} conditioning channels fit "
                             f"no band of this interpolator")
        out = None
        for unit, name, _, pad in self._specs[band]:
            xb = x[:, unit * c:(unit + 1) * c].contiguous()
            o = getattr(self, name)(F.pad(xb, pad, mode="replicate"))
            out = o if out is None else out + o
        return out

    def _head(self, base: torch.Tensor) -> torch.Tensor:
        """Activation + trunk of an NCHW base -> NHWC contiguous pmap."""
        h = self.trunk(self.act0(base))
        return h.permute(0, 2, 3, 1).contiguous()

    def forward(self, y_cond: torch.Tensor) -> torch.Tensor:
        """Conditioning bands ``[B, H, W, c*(band+1)]`` -> GMM parameter map
        ``[B, H, W, Co]`` (contiguous)."""
        return self._head(self._base(y_cond))

    def band_base(self, y_cond: torch.Tensor) -> torch.Tensor:
        """clrjnt0seqmd codec path: the pre-activation layer-0 map
        ``[B, H, W, Ch]`` (an NHWC view of an NCHW tensor)."""
        return self._base(y_cond).permute(0, 2, 3, 1)

    def params_from_base(self, base: torch.Tensor, y_seq: torch.Tensor,
                         clr: int) -> torch.Tensor:
        """clrjnt0seqmd codec path: add the current pixel's colours below
        ``clr`` (``y_seq`` ``[B, H, W, 2]``, Y and Co) to the later colours'
        channel groups of ``base``, then activation + trunk.  The groups of
        colour ``clr`` depend on colours < ``clr`` only, so a decoder that
        holds just those computes the same map."""
        b = base.permute(0, 3, 1, 2)
        ys = y_seq.permute(0, 3, 1, 2)
        K = b.shape[1] // 9
        parts = [b[:, :3 * K], b[:, 3 * K:6 * K], b[:, 6 * K:]]
        if clr >= 1:
            parts[1] = parts[1] + self.seq_toCo(ys[:, 0:1].contiguous())
        if clr >= 2:
            parts[2] = parts[2] + self.seq_toCg(ys[:, 0:2].contiguous())
        return self._head(torch.cat(parts, dim=1) if clr >= 1 else b)
