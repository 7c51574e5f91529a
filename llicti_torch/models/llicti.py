"""Top-level model: the interpolators of every scale, their codec entry
points and the rate forward.

Port of ``llicti_tpu/models/llicti.py``.  Scales share interpolators
through ``useprevlevNN`` (``cfg.model_index``); each shared model holds
one network per band, or with ``combine_layers1toL`` one network (band
-1) for all three bands.  :meth:`LLICTIModel.forward` is the training and
validation forward (colour transform, mean shift, float lazy wavelet,
per-scale self-information); it sets no cuDNN / TF32 flag itself: the
training step runs it with cuDNN's TF32 off
(``training.steps.fp32_convs``), and a codec-equal forward on the card
runs under :func:`llicti_torch.codec.exact_math`.
:meth:`LLICTIModel.aux_loss` sums the quantile loss of any factorized
prior a band model holds (none in the live model, as in the JAX
package).
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.color import rgb_to_ycocg_r
from ..ops.wavelet import lazy_dwt
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

    def band_params(self, y_cond: torch.Tensor, scale: int, band: int,
                    halo=None) -> torch.Tensor:
        """GMM parameter map ``[B, H, W, Co]`` of one (scale, band) from its
        conditioning bands ``[B, H, W, c*(band+1)]``; ``halo`` as in
        :meth:`forward`."""
        return self._band_model(scale, band).get_params(y_cond, halo)

    def band_params_batched(self, y_cond: torch.Tensor, scale: int,
                            band: int) -> torch.Tensor:
        """:meth:`band_params` of K whole images, the trunk at batch 1
        (:meth:`Interpolator.get_params_batched`)."""
        return self._band_model(scale, band).get_params_batched(y_cond)

    def band_base(self, y_cond: torch.Tensor, scale: int, band: int,
                  halo=None) -> torch.Tensor:
        """Pre-activation layer-0 map (clrjnt0seqmd codec path)."""
        return self._band_model(scale, band).band_base(y_cond, halo)

    def band_params_seq(self, base: torch.Tensor, y_seq: torch.Tensor,
                        scale: int, band: int, clr: int) -> torch.Tensor:
        """Per-colour GMM parameter map from a layer-0 base
        (clrjnt0seqmd)."""
        return self._band_model(scale, band).params_from_base(base, y_seq,
                                                              clr)

    def transform(self, x: torch.Tensor) -> List[torch.Tensor]:
        """RGB ``[B, H, W, 3]`` in [0, 1] (H, W multiples of the coarsest
        stride) -> the per-scale bands ``[B, h, w, 4c]``: float YCoCg-R
        (or RGB) shifted by 127/255, clrjnt 1's zero channel in front, or
        the one channel ``clrchs`` of the single-channel variants."""
        cfg = self.cfg
        if cfg.ycocg:
            x = rgb_to_ycocg_r(x, cfg.rndfactor)
            x = torch.cat((x[..., :1] - cfg.mean_y_ycocg, x[..., 1:]), dim=-1)
        else:
            x = x - cfg.mean_y_ycocg
        if cfg.clrchs == 3:
            if cfg.clr_joint_mode == 1:
                x = torch.cat((torch.zeros_like(x[..., :1]), x), dim=-1)
            return lazy_dwt(x, cfg.dwtlevels)
        return lazy_dwt(x[..., cfg.clrchs:cfg.clrchs + 1],
                        tuple(range(cfg.num_scales)))

    def entropy_forward(self, y_list: List[torch.Tensor], halo=None
                        ) -> List[torch.Tensor]:
        """Per scale, the self-information of bands 1..3 given the bands
        before them: ``[B, h, w, 9]`` (``[B, h, w, 3]`` for one colour),
        band-major."""
        c = self.cfg.cond_channels
        return [torch.cat([
            self._band_model(s, b)(y_lev[..., :c * (b + 1)],
                                   y_lev[..., c * (b + 1):c * (b + 2)],
                                   halo)
            for b in range(3)], dim=-1) for s, y_lev in enumerate(y_list)]

    def forward(self, x: torch.Tensor, halo=None) -> List[torch.Tensor]:
        """RGB ``[B, H, W, 3]`` in [0, 1] -> the self-information maps of
        every scale, finest first (bits; their sum is the rate
        estimate).  ``halo``: when ``x`` is a rank's block of the images'
        rows, the exchange of its layer-0 convs' boundary rows with the
        neighbouring ranks (``parallel.halo.halo_rows``); the block's
        height must then be a multiple of the coarsest stride, so that
        the wavelet stays local (ValueError)."""
        if halo is not None:
            stride = 2 ** (max(self.cfg.dwtlevels) + 1)
            if x.shape[1] % stride:
                raise ValueError(
                    f"a rank's block of {x.shape[1]} rows: spatial sharding "
                    f"needs a multiple of {stride} rows a rank")
        return self.entropy_forward(self.transform(x), halo)

    def aux_loss(self) -> torch.Tensor:
        """Aggregated quantile aux loss over factorized-prior bottleneck
        submodules (reference LLICTIBaseNet.aux_loss, LLICTI_nets.py:31-38).

        Vestigial like the reference's: the live interpolator stack holds
        no factorized prior, so the sum is empty (0 on the model's
        device); a band model that holds an
        :class:`llicti_torch.ops.factorized.FactorizedPrior` as
        ``factorized_prior`` contributes its :meth:`loss`."""
        total = torch.zeros((), device=next(self.parameters()).device)
        for bands in self.models:
            for mdl in bands:
                prior = getattr(mdl, "factorized_prior", None)
                if prior is not None:
                    total = total + prior.loss()
        return total
