"""The interpolator's batch-1 path for a batch of K > 1 images
(``Interpolator.get_params_batched``: layer 0's sum written channel-major,
the trunk run on the K images stacked along the height) against
``get_params`` at batch K, in float64 on the CPU; and that the codec's
band loop takes it only for K > 1 on the card, with no halo and no
sequential-colour model."""
import torch_helpers  # noqa: F401  (first: caps torch's threads)

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from llicti_torch import Codec, ModelConfig
from llicti_torch.codec import band_coded_shape, pad_flags_for_shape
from llicti_torch.data.dataset import synthetic_image
from llicti_torch.weights import init_params, params_from_flax

# coded rows and columns of 26x38 images: odd at scale 0 (13x19)
H, W = 26, 38


def small_cfg(**kw):
    return ModelConfig(chs=(8, 8), evens=(4, 4), odds=(3, 3),
                       dwtlevels=(0, 1), useprevlevNN=(False, True), **kw)


def bands(codec, K):
    """The codec's padded wavelet bands of K distinct images, per scale."""
    rgb = np.stack([synthetic_image(H, W, seed=11 + k) for k in range(K)])
    with torch.inference_mode():
        return codec._front(torch.from_numpy(rgb))


@pytest.mark.parametrize("act", ["ReLU", "PReLU"])
@pytest.mark.parametrize("band", [0, 1, 2])
@pytest.mark.parametrize("K", [2, 3])
def test_batched_params_equal_get_params(K, band, act):
    cfg = small_cfg(activfun=act)
    codec = Codec(cfg, init_params(cfg, 5), num_lanes=8, device="cpu")
    model = params_from_flax(init_params(cfg, 5), cfg).double()
    flags, _ = pad_flags_for_shape(H, W, cfg.dwtlevels)
    c = cfg.cond_channels
    for scl, y_lev in enumerate(bands(codec, K)):
        if scl == 0:
            ch, cw = band_coded_shape(y_lev.shape[1], y_lev.shape[2], band,
                                      *flags[0])
            assert ch % 2 and cw % 2  # a padded shape
        y = y_lev[..., :c * (band + 1)].double().contiguous()
        with torch.inference_mode():
            want = model.band_params(y, scl, band)
            got = model.band_params_batched(y, scl, band)
        assert got.shape == want.shape and got.is_contiguous()
        assert float((got - want).abs().max()) <= 1e-12


def replicate_halo(t, top, bottom):
    """One rank's halo of a whole image: its own edge rows repeated."""
    return F.pad(t.permute(0, 3, 1, 2), (0, 0, top, bottom),
                 mode="replicate").permute(0, 2, 3, 1)


@pytest.mark.parametrize("K, device, halo, seq, takes", [
    (2, "cuda", False, False, True),
    (1, "cuda", False, False, False),
    (2, "cuda", True, False, False),
    (2, "cpu", False, False, False),
    (2, "cuda", False, True, False),
])
def test_band_takes_batch1_path_only_for_a_card_batch(
        monkeypatch, K, device, halo, seq, takes):
    cfg = (small_cfg(clr_joint_mode=0, clrjnt0seqmd=True) if seq
           else small_cfg())
    codec = Codec(cfg, init_params(cfg, 5), num_lanes=8, device="cpu")
    y_list = bands(codec, K)
    calls = {"batched": 0, "batch K": 0}
    model = codec.model

    def counted(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(model, "band_params_batched",
                        counted("batched", model.band_params_batched))
    monkeypatch.setattr(model, "band_params",
                        counted("batch K", model.band_params))
    # the branch reads only the device's type; every tensor stays here
    codec.device = torch.device(device)
    codec._halo = replicate_halo if halo else None
    with torch.inference_mode():
        for b in range(3):
            codec._band(y_list[0].clone(), 0, b, False, False,
                        lambda b, clr, pm, y2: None)
    assert calls["batched"] == (3 if takes else 0)
    assert calls["batch K"] == (0 if takes or seq else 3)
