"""Interpolator network: the conditional-GMM parameter CNN of one
(scale, band).

Port of ``llicti_tpu/models/interpolator.py:109-292`` (codec path).  Layer
0 is band-geometry specific: small Ev/Od kernels with asymmetric
replicate padding that align receptive fields with the polyphase sample
positions; the trunk is grouped 1x1 convs.  Public tensors are NHWC like
the JAX package's; inside, the convs run NCHW.  GDN1, the clrjnt0seqmd
sequential colours and subtract_mean are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from llicti_tpu.config import ModelConfig


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


def _activation(kind: str, channels: int) -> nn.Module:
    if kind == "ReLU":
        return nn.ReLU()
    if kind == "LeakyReLU":
        return nn.LeakyReLU(0.01)
    if kind == "PReLU":
        return nn.PReLU(num_parameters=channels, init=0.25)
    raise NotImplementedError(f"activfun={kind!r} is not ported yet")


class Interpolator(nn.Module):
    """One conditional-GMM parameter network for a (scale, band)."""

    def __init__(self, cfg: ModelConfig, scale: int, band: int):
        super().__init__()
        if cfg.clrchs == 3 and cfg.clr_joint_mode == 0 and cfg.clrjnt0seqmd:
            raise NotImplementedError("clrjnt0seqmd is not ported yet")
        grps, Ch, Co, c, grp0 = interpolator_dims(cfg, scale)
        self.c = c
        Ev, Od = cfg.evens[scale], cfg.odds[scale]

        def conv(kh, kw):
            return nn.Conv2d(c, Ch, (kh, kw), groups=grp0)

        # (input channel unit, conv name, pad as (left, right, top, bottom))
        if band == 0:
            self.conv_00_11 = conv(Ev, Ev)
            specs = [(0, "conv_00_11", (Ev // 2 - 1, Ev // 2,
                                        Ev // 2 - 1, Ev // 2))]
        elif band == 1:
            self.conv_00_01 = conv(Od, Ev)
            self.conv_11_01 = conv(Ev, Od)
            specs = [(0, "conv_00_01", (Ev // 2 - 1, Ev // 2,
                                        Od // 2, Od // 2)),
                     (1, "conv_11_01", (Od // 2, Od // 2,
                                        Ev // 2, Ev // 2 - 1))]
        elif band == 2:
            self.conv_00_10 = conv(Ev, Od)
            self.conv_11_10 = conv(Od, Ev)
            self.conv_01_10 = conv(Ev, Ev)
            specs = [(0, "conv_00_10", (Od // 2, Od // 2,
                                        Ev // 2 - 1, Ev // 2)),
                     (1, "conv_11_10", (Ev // 2, Ev // 2 - 1,
                                        Od // 2, Od // 2)),
                     (2, "conv_01_10", (Ev // 2, Ev // 2 - 1,
                                        Ev // 2 - 1, Ev // 2))]
        else:
            raise NotImplementedError(f"band={band} (combine_layers1toL) "
                                      "is not ported yet")
        self._specs: Tuple = tuple(specs)
        self.act0 = _activation(cfg.activfun, Ch)
        trunk = []
        for _ in range(cfg.conv_layers - 2):
            trunk.append(nn.Conv2d(Ch, Ch, 1, groups=grps))
            trunk.append(_activation(cfg.activfun, Ch))
        trunk.append(nn.Conv2d(Ch, Co, 1, groups=grps))
        self.trunk = nn.Sequential(*trunk)

    def forward(self, y_cond: torch.Tensor) -> torch.Tensor:
        """Conditioning bands ``[B, H, W, c*(band+1)]`` -> GMM parameter map
        ``[B, H, W, Co]`` (contiguous)."""
        x = y_cond.permute(0, 3, 1, 2)
        c = self.c
        out = None
        for unit, name, pad in self._specs:
            xb = x[:, unit * c:(unit + 1) * c].contiguous()
            o = getattr(self, name)(F.pad(xb, pad, mode="replicate"))
            out = o if out is None else out + o
        h = self.trunk(self.act0(out))
        return h.permute(0, 2, 3, 1).contiguous()
