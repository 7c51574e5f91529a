"""The port's GDN1 interpolator (activfun GDN1 at the joint-colour model's
widths) against the benchmark's plain reference
(``llbench/reference/gdn.py``) on the CPU, at seeded weights: each band
net's map, the batch-1 trunk of a batch against the batch-K map, the
codec's held beta and gamma against the per-call form (and a training
forward that still differentiates through them), the containers byte for
byte with lossless decodes, the FLOP and work counts the benchmark
divides by, and the ``llicti.gdn`` span, two a band net in each
direction and none under ReLU."""
import torch_helpers  # noqa: F401  (first: caps torch's threads)

import json
import os

import numpy as np
import pytest
import torch

from llbench.data import synthetic_images
from llbench.reference import codec as ref_codec
from llbench.reference import gdn
from llbench.traffic import port_config
from llicti_torch import Codec
from llicti_torch.ops.gdn import GDN1
from llicti_torch.weights import init_params, params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "llbench", "configs", "llicti_A_gdn.json")) as f:
    GDN_A = json.load(f)["model"]
# llicti_A_gdn's keys at chs 8 and two scales: Ch = 32
KEYS = dict(GDN_A, chs=[8, 1], dwtlevels=[0, 1], evens=[4, 4], odds=[3, 3],
            useprevlevNN=[False, True])
H, W = 64, 96


@pytest.fixture(scope="module")
def models():
    """(Flax-named seeded weights, the port's model, the reference's)."""
    cfg = gdn.GdnConfig(KEYS)
    weights = gdn.seeded_weights(cfg, 3)
    port = params_from_flax(weights, port_config({"model": KEYS}))
    return weights, port, gdn.build(cfg, gdn.from_flax(weights), "cpu")


def bands(b, h, w, K=1, seed=0):
    """Conditioning bands [K, h, w, 3 (b + 1)], values on the codec's
    1/255 grid."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randint(-127, 129, (K, h, w, 3 * (b + 1)), generator=g)
    return y.float() / 255.0


def images(K, seed=2 ** 31 + 3):
    return list(synthetic_images(K, H, W, seed, "cpu").numpy())


@pytest.mark.parametrize("scale", [0, 1])
@pytest.mark.parametrize("b", [0, 1, 2])
def test_band_net_matches_the_reference(models, scale, b):
    """A (scale, band)'s map of a 64 x 96 image (bands of 32 x 48 at scale
    0, 16 x 24 at scale 1): the port's ``band_params`` against the
    reference's ``params``, within 1e-5."""
    _, port, ref = models
    h, w = 32 >> scale, 48 >> scale
    y = bands(b, h, w, seed=10 * scale + b)
    with torch.no_grad():
        got = port.band_params(y, scale, b)
        want = ref.band(scale, b).params(y)
    assert got.shape == want.shape == (1, h, w, 12 * KEYS["num_mixtures"])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("K", [2, 3])
def test_batched_map_equals_get_params_in_float64(models, K):
    """``get_params_batched`` (the activation and the trunk on the K images
    stacked along the height, GDN1 mixing the channels of each pixel
    alone) against ``get_params`` at batch K, every (scale, band), in
    float64."""
    weights, _, _ = models
    port = params_from_flax(weights, port_config({"model": KEYS})).double()
    for scale in (0, 1):
        for b in range(3):
            y = bands(b, 32 >> scale, 48 >> scale, K, seed=K + b).double()
            with torch.inference_mode():
                want = port.band_params(y, scale, b)
                got = port.band_params_batched(y, scale, b)
            assert got.shape == want.shape and got.is_contiguous()
            assert float((got - want).abs().max()) <= 1e-12


def test_held_constants_equal_the_per_call_form(models):
    """The codec holds each GDN1's effective beta and gamma, bit-equal to
    the per-call reparametrisation, and its band maps equal a model that
    computes them in every call; a forward that records a gradient still
    differentiates through ``lower_bound`` into the stored parameters."""
    weights, _, _ = models
    codec = Codec(port_config({"model": KEYS}), weights, device="cpu",
                  num_lanes=16)
    fresh = params_from_flax(weights, port_config({"model": KEYS}))
    held = [m for m in codec.model.modules() if isinstance(m, GDN1)]
    assert len(held) == 2 * 3  # act0 and trunk_1 of each band net
    for m in held:
        with torch.no_grad():
            beta, gamma = m.effective()
        assert torch.equal(m.held[0], beta) and torch.equal(m.held[1], gamma)
        assert gamma.shape == (32, 32, 1, 1)
    assert not any(m.held for m in fresh.modules() if isinstance(m, GDN1))
    y = bands(2, 32, 48, K=2, seed=4)
    with torch.inference_mode():
        assert torch.equal(codec.model.band_params(y, 0, 2),
                           fresh.band_params(y, 0, 2))
    # training: the held constants are not used, the gradient flows
    net = codec.model.models[0][2]
    net.zero_grad()
    net.get_params(y).square().sum().backward()
    for m in (net.act0, net.trunk[1]):
        assert m.beta.grad is not None and m.gamma.grad is not None
        assert float(m.gamma.grad.abs().sum()) > 0
        _, gamma = m.effective()
        names, stack = set(), [gamma.grad_fn]
        while stack:
            fn = stack.pop()
            if fn is not None:
                names.add(type(fn).__name__)
                stack += [g for g, _ in fn.next_functions]
        assert "_LowerBoundBackward" in names


@pytest.mark.parametrize("K", [1, 2])
def test_reference_container_equals_the_codecs(models, K):
    """The reference encoder's container (single for K = 1, batch for K =
    2) equals ``Codec.compress`` / ``compress_batch``'s byte for byte on
    the CPU, and the decode gives the images back."""
    weights, _, ref = models
    codec = Codec(port_config({"model": KEYS}), weights, device="cpu",
                  num_lanes=16)
    imgs = images(K)
    enc = ref_codec.Encoder(ref, 16, "cpu")
    if K == 1:
        got = codec.compress(imgs[0])
        want = enc.encode(imgs)
        outs = [codec.decompress(got)[0]]
    else:
        got = codec.compress_batch(imgs)
        want = enc.encode_batch(imgs)
        outs = codec.decompress_batch(got)
    assert ref_codec.serialize(got) == ref_codec.serialize(want["streams"])
    assert all(np.array_equal(o, im) for o, im in zip(outs, imgs))
    assert want["words"].shape == (K, 18)


def test_flop_and_work_counts_against_a_hand_sum():
    """At 64 x 96 with KEYS (two scales, one shared model, chs 8: Ch 32,
    Co 60): per band layer 0's convs, the 4-group trunk conv and the
    last conv, and two dense 32 -> 32 GDN1 convs; GDN1's work 2 C^2 + 3 C
    operations and 8 C bytes a pixel a layer; and at llicti_A_gdn's
    widths 245.30 GFLOP a pass at 512 x 768, 194.69 of them GDN1's."""
    def conv(hw, cout, cin, k):
        return 2 * hw * cout * cin * k
    total, pixels = 0, 0
    for hw in (32 * 48, 16 * 24):  # dwt levels 0 and 1
        for k in (16, 12 + 12, 12 + 12 + 16):  # Ev x Ev, Od x Ev, ...
            total += (conv(hw, 32, 3, k) + conv(hw, 32, 8, 1)
                      + conv(hw, 60, 8, 1) + 2 * conv(hw, 32, 32, 1))
            pixels += hw
    assert gdn.forward_flops(KEYS, H, W) == total == 61_562_880
    assert gdn.gdn_work(KEYS, H, W) == (2 * pixels * (2 * 32 ** 2 + 3 * 32),
                                        2 * pixels * 8 * 32)
    assert gdn.forward_flops(GDN_A, 512, 768) == 245_303_156_736
    flops, nbytes = gdn.gdn_work(GDN_A, 512, 768)
    assert 2 * 392_832 * 2 * 352 ** 2 == 194_693_824_512
    assert (flops, nbytes) == (2 * 392_832 * (2 * 352 ** 2 + 3 * 352),
                               2 * 392_832 * 8 * 352)


def test_flop_count_equals_the_counted_convs(models):
    """The count equals FlopCounterMode's count of the reference's convs
    over one pass of every band net."""
    from torch.utils.flop_counter import FlopCounterMode
    _, _, ref = models
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        for scale in (0, 1):
            for b in range(3):
                ref.band(scale, b).params(bands(b, 32 >> scale, 48 >> scale))
    assert counter.get_total_flops() == gdn.forward_flops(KEYS, H, W)


@pytest.mark.parametrize("K", [1, 2])
def test_gdn_span_opens_twice_a_band_net_and_never_under_relu(
        models, monkeypatch, K):
    """Under a CPU profiler each band net opens two llicti.gdn (act0 and
    the trunk's) in each direction of a GDN1 round trip, for one image
    and for a batch alike, and a ReLU one opens none (the spans' names
    counted as they open)."""
    weights, _, _ = models
    relu = dict(KEYS, activfun="ReLU")
    opened = []
    record = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or record(name))
    imgs = images(K, seed=5)
    for keys, params, per_pass in (
            (KEYS, weights, 2 * 3 * 2),  # GDN1s x bands x scales
            (relu, init_params(port_config({"model": relu})), 0)):
        codec = Codec(port_config({"model": keys}), params, device="cpu",
                      num_lanes=16)
        counts = []
        for direction in ("compress", "decompress"):
            opened.clear()
            with torch.profiler.profile():
                if direction == "compress":
                    streams = (codec.compress(imgs[0]) if K == 1
                               else codec.compress_batch(imgs))
                else:
                    outs = (codec.decompress(streams) if K == 1
                            else codec.decompress_batch(streams))
            assert "llicti.band" in opened
            counts.append(opened.count("llicti.gdn"))
        assert counts == [per_pass, per_pass]
        assert all(np.array_equal(o, im) for o, im in zip(outs, imgs))
