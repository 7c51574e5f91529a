"""Top-level model for the codec path: the interpolators of every scale.

Port of ``llicti_tpu/models/llicti.py:27-33,51-66,110-117``.  Scales share
interpolators through ``useprevlevNN`` (``cfg.model_index``); each shared
model holds one network per band.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from llicti_tpu.config import ModelConfig

from .interpolator import Interpolator


def model_scales(cfg: ModelConfig) -> List[int]:
    """The scale (dwt level) owning each distinct interpolator model."""
    owners = []
    for s in range(cfg.num_scales):
        if cfg.model_index[s] == len(owners):
            owners.append(cfg.dwtlevels[s])
    return owners


class LLICTIModel(nn.Module):
    """``models[m][b]`` is the band-``b`` interpolator of model ``m``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.combine_layers1toL:
            raise NotImplementedError(
                "combine_layers1toL is not ported yet")
        self.cfg = cfg
        self.models = nn.ModuleList(
            nn.ModuleList(Interpolator(cfg, scl, b) for b in range(3))
            for scl in model_scales(cfg))

    def band_params(self, y_cond: torch.Tensor, scale: int,
                    band: int) -> torch.Tensor:
        """GMM parameter map ``[B, H, W, Co]`` of one (scale, band) from its
        conditioning bands ``[B, H, W, c*(band+1)]``."""
        return self.models[self.cfg.model_index[scale]][band](y_cond)
