"""The port's sequential-colour interpolator (clr_joint_mode 0 with
clrjnt0seqmd) against the benchmark's plain reference
(``llbench/reference/seq.py``) on the CPU, at seeded weights: each
colour's parameter map and its causality, the codec's container byte for
byte and a lossless decode, the FLOP count the benchmark divides by, and
the ``llicti.seq`` span, three a band in each direction and none in a
joint-colour pass."""
import torch_helpers  # noqa: F401  (first: caps torch's threads)

import json
import os

import numpy as np
import pytest
import torch

from llbench.data import synthetic_images
from llbench.reference import codec as ref_codec
from llbench.reference import model as ref_model
from llbench.reference import seq
from llbench.traffic import port_config
from llicti_torch import Codec, ModelConfig
from llicti_torch.weights import init_params, params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "llbench", "configs", "llicti_A_seq.json")) as f:
    SEQ_A = json.load(f)["model"]
# llicti_A_seq's keys at chs 8 and two scales
KEYS = dict(SEQ_A, chs=[8, 1], dwtlevels=[0, 1], evens=[4, 4], odds=[3, 3],
            useprevlevNN=[False, True])
M = KEYS["num_mixtures"]


@pytest.fixture(scope="module")
def models():
    """(Flax-named seeded weights, the port's model, the reference's)."""
    cfg = seq.SeqConfig(KEYS)
    weights = seq.seeded_weights(cfg, 3)
    port = params_from_flax(weights, port_config({"model": KEYS}))
    return weights, port, seq.build(cfg, ref_model.from_flax(weights), "cpu")


def bands(b, h=16, w=24, seed=0):
    """Conditioning bands [1, h, w, 3 (b + 1)] and the pixels' Y and Co
    [1, h, w, 2], values on the codec's 1/255 grid."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randint(-127, 129, (1, h, w, 3 * (b + 2)), generator=g)
    y = y.float() / 255.0
    return y[..., :3 * (b + 1)].contiguous(), y[..., 3 * (b + 1):][..., :2]


def colour(pm, clr):
    """Colour ``clr``'s sigma, mu and w columns of a parameter map."""
    return pm[..., 3 * clr * M:3 * (clr + 1) * M]


@pytest.mark.parametrize("scale", [0, 1])
@pytest.mark.parametrize("b", [0, 1, 2])
def test_band_net_matches_the_reference(models, scale, b):
    """Each colour's map of a (scale, band) of a 32 x 48 image (bands of
    16 x 24 at scale 0, 8 x 12 at scale 1): the port's ``band_base`` /
    ``params_from_base`` against the reference's ``base`` / ``params``,
    within 1e-5."""
    _, port, ref = models
    h, w = 16 >> scale, 24 >> scale
    y_cond, y_seq = bands(b, h, w, seed=10 * scale + b)
    net = ref.band(scale, b)
    with torch.no_grad():
        base_p = port.band_base(y_cond, scale, b)
        base_r = net.base(y_cond)
        for clr in range(3):
            got = port.band_params_seq(base_p, y_seq, scale, b, clr)
            want = net.params(base_r, y_seq, clr)
            assert got.shape == want.shape == (1, h, w, 9 * M)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("clr", [0, 1])
def test_a_colours_map_ignores_its_own_and_later_colours(models, clr):
    """Colour ``clr``'s columns of the map with every colour added do not
    change when the pixel's colours from ``clr`` on change, and equal the
    columns of the map a decoder computes from the colours below ``clr``
    alone; the later colours' columns do change.  In the port and the
    reference alike."""
    _, port, ref = models
    y_cond, y_seq = bands(2, seed=7)
    moved = y_seq.clone()
    moved[..., clr:] = torch.flip(moved[..., clr:], dims=(1,)) + 0.1
    net = ref.band(0, 2)

    def port_params(base, ys, c):
        return port.band_params_seq(base, ys, 0, 2, c)

    with torch.no_grad():
        for params, base in ((port_params, port.band_base(y_cond, 0, 2)),
                             (net.params, net.base(y_cond))):
            full = params(base, y_seq, 2)
            other = params(base, moved, 2)
            assert torch.equal(colour(full, clr), colour(other, clr))
            assert torch.equal(colour(full, clr),
                               colour(params(base, moved, clr), clr))
            later = slice(3 * (clr + 1) * M, None)
            assert not torch.equal(full[..., later], other[..., later])


def test_reference_container_equals_the_codecs(models):
    """The reference encoder's container equals ``Codec.compress``'s byte
    for byte on the CPU, and ``decompress`` gives the image back."""
    weights, _, ref = models
    codec = Codec(port_config({"model": KEYS}), weights, device="cpu",
                  num_lanes=16)
    img = synthetic_images(1, 40, 64, 2 ** 31 + 3, "cpu").numpy()[0]
    got = codec.compress(img)
    want = seq.SeqEncoder(ref, 16, "cpu").encode([img])
    assert ref_codec.serialize(got) == ref_codec.serialize(want["streams"])
    assert np.array_equal(codec.decompress(got)[0], img)
    assert want["words"].shape == (1, 18)


def test_flop_count_against_a_hand_sum():
    """At 16 x 24 with KEYS (two scales, one shared model, chs 8: Ch 72,
    Co 45): per band the layer-0 convs (groups 3: one input channel a
    group), the two sequential convs and one 9-group trunk pass; and
    75.08 GFLOP at llicti_A_seq's widths at 512 x 768."""
    def conv(hw, cout, cin, k):
        return 2 * hw * cout * cin * k
    total = 0
    for hw in (8 * 12, 4 * 6):  # dwt levels 0 and 1
        layer0 = [16, 12 + 12, 12 + 12 + 16]  # Ev x Ev, Od x Ev, ...
        for k in layer0:
            total += (conv(hw, 72, 1, k) + conv(hw, 24, 1, 1)
                      + conv(hw, 24, 2, 1) + conv(hw, 72, 8, 1)
                      + conv(hw, 45, 8, 1))
    assert seq.forward_flops(KEYS, 16, 24) == total == 2_108_160
    assert seq.forward_flops(SEQ_A, 512, 768) == 75_084_337_152


def test_flop_count_equals_the_counted_convs(models):
    """The count equals FlopCounterMode's count of the reference's convs
    when each band runs its layer 0 once and the trunk once, on the map
    with both colours added."""
    from torch.utils.flop_counter import FlopCounterMode
    _, _, ref = models
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        for scale, (h, w) in enumerate(((8, 12), (4, 6))):
            for b in range(3):
                y_cond, y_seq = bands(b, h, w)
                net = ref.band(scale, b)
                net.params(net.base(y_cond), y_seq, 2)
    assert counter.get_total_flops() == seq.forward_flops(KEYS, 16, 24)


def test_seq_span_opens_three_times_a_band_and_never_in_clrjnt2(
        models, monkeypatch):
    """Under a CPU profiler each colour of each band opens one llicti.seq
    in each direction of a sequential-colour round trip, and a
    joint-colour one opens none (the spans' names counted as they open:
    reading back the profiler's events would take seconds a pass)."""
    weights, _, _ = models
    img = synthetic_images(1, 24, 32, 5, "cpu").numpy()[0]
    joint_cfg = ModelConfig(chs=(4, 4), evens=(4, 4), odds=(3, 3),
                            dwtlevels=(0, 1), useprevlevNN=(False, True))
    opened = []
    record = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or record(name))
    for codec, per_pass in (
            (Codec(port_config({"model": KEYS}), weights, device="cpu",
                   num_lanes=16), 3 * 3 * 2),  # colours x bands x scales
            (Codec(joint_cfg, init_params(joint_cfg), device="cpu",
                   num_lanes=16), 0)):
        counts = []
        for direction in ("compress", "decompress"):
            opened.clear()
            with torch.profiler.profile():
                if direction == "compress":
                    streams = codec.compress(img)
                else:
                    out = codec.decompress(streams)
            assert "llicti.band" in opened
            counts.append(opened.count("llicti.seq"))
        assert counts == [per_pass, per_pass]
        assert np.array_equal(out[0], img)
