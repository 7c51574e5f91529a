"""Top-level model for the codec path: the interpolators of every scale.

Port of ``llicti_tpu/models/llicti.py:27-33,51-66,110-126``.  Scales share
interpolators through ``useprevlevNN`` (``cfg.model_index``); each shared
model holds one network per band, or with ``combine_layers1toL`` one
network (band -1) for all three bands.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..config import ModelConfig
from .interpolator import Interpolator


def model_scales(cfg: ModelConfig) -> List[int]:
    """The scale (dwt level) owning each distinct interpolator model."""
    owners = []
    for s in range(cfg.num_scales):
        if cfg.model_index[s] == len(owners):
            owners.append(cfg.dwtlevels[s])
    return owners


class LLICTIModel(nn.Module):
    """``models[m][b]`` is the band-``b`` interpolator of model ``m``
    (``models[m][0]`` serves every band under combine_layers1toL)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        bands = (-1,) if cfg.combine_layers1toL else (0, 1, 2)
        self.models = nn.ModuleList(
            nn.ModuleList(Interpolator(cfg, scl, b) for b in bands)
            for scl in model_scales(cfg))

    def _band_model(self, scale: int, band: int) -> Interpolator:
        bands = self.models[self.cfg.model_index[scale]]
        return bands[0] if self.cfg.combine_layers1toL else bands[band]

    def band_params(self, y_cond: torch.Tensor, scale: int,
                    band: int) -> torch.Tensor:
        """GMM parameter map ``[B, H, W, Co]`` of one (scale, band) from its
        conditioning bands ``[B, H, W, c*(band+1)]``."""
        return self._band_model(scale, band)(y_cond)

    def band_base(self, y_cond: torch.Tensor, scale: int,
                  band: int) -> torch.Tensor:
        """Pre-activation layer-0 map (clrjnt0seqmd codec path)."""
        return self._band_model(scale, band).band_base(y_cond)

    def band_params_seq(self, base: torch.Tensor, y_seq: torch.Tensor,
                        scale: int, band: int, clr: int) -> torch.Tensor:
        """Per-colour GMM parameter map from a layer-0 base
        (clrjnt0seqmd)."""
        return self._band_model(scale, band).params_from_base(base, y_seq,
                                                              clr)
