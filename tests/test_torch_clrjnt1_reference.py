"""The port's clr_joint_mode 1 interpolator (Y alone with a 2M-term
mixture, Co and Cg joint, layer 0 at groups 2 over a zero channel and
(Y, Co, Cg)) against the benchmark's plain reference
(``llbench/reference/clrjnt1.py``) on the CPU, at seeded weights: each
band net's map, the int32 tables of every colour, the K = 2 batch
container byte for byte with a lossless decode, a faulty reference (Y
coded with M terms) that the container tells apart, the FLOP count, and
the codec's layer-0 kernel held ungrouped (block-diagonal), which gives
the grouped conv's map and is held for clr_joint_mode 1 alone."""
import torch_helpers  # noqa: F401  (first: caps torch's threads)

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from llbench.data import synthetic_images
from llbench.reference import clrjnt1
from llbench.reference import codec as ref_codec
from llbench.reference import model as ref_model
from llbench.traffic import port_config
from llicti_torch import Codec
from llicti_torch.codec import pmap_cdf_spec, sym_channel
from llicti_torch.models.interpolator import Interpolator, block_diagonal
from llicti_torch.ops.cdf import gmm_cdf_from_pmap
from llicti_torch.ops.gmm import cdf_sampling_points
from llicti_torch.weights import init_params, params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "llbench", "configs",
                       "llicti_A_clrjnt1.json")) as f:
    J1_A = json.load(f)["model"]
# llicti_A_clrjnt1's keys at chs 8 and two scales: Ch = 64, Co = 80
KEYS = dict(J1_A, chs=[8, 1], dwtlevels=[0, 1], evens=[4, 4], odds=[3, 3],
            useprevlevNN=[False, True])
H, W = 64, 96
M = KEYS["num_mixtures"]


@pytest.fixture(scope="module")
def models():
    """(Flax-named seeded weights, the port's model, the reference's)."""
    cfg = clrjnt1.Clrjnt1Config(KEYS)
    weights = clrjnt1.seeded_weights(cfg, 3)
    port = params_from_flax(weights, port_config({"model": KEYS}))
    return weights, port, clrjnt1.build(cfg, ref_model.from_flax(weights),
                                        "cpu")


def bands(b, h, w, K=1, seed=0):
    """Conditioning bands [K, h, w, 4 (b + 1)]: each unit's zero channel,
    then Y, Co, Cg on the codec's 1/255 grid."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randint(-127, 129, (K, h, w, 4 * (b + 1)), generator=g)
    y[..., 0::4] = 0
    return y.float() / 255.0


def images(K, seed=2 ** 31 + 3):
    return list(synthetic_images(K, H, W, seed, "cpu").numpy())


@pytest.mark.parametrize("scale", [0, 1])
@pytest.mark.parametrize("b", [0, 1, 2])
def test_band_net_matches_the_reference(models, scale, b):
    """A (scale, band)'s map of a 64 x 96 image: the port's
    ``band_params`` against the reference's ``params``, within 1e-5 (the
    float32 sums of two implementations of the same convs; on the card
    the codec's maps are bit-equal, ``chip_smoke.py``)."""
    _, port, ref = models
    h, w = 32 >> scale, 48 >> scale
    y = bands(b, h, w, seed=10 * scale + b)
    with torch.no_grad():
        got = port.band_params(y, scale, b)
        want = ref.band(scale, b).params(y)
    assert got.shape == want.shape == (1, h, w, 16 * M)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_int32_tables_equal_the_references(models):
    """Every colour of band 2 at scale 0 (Y at 2M terms, Co, Cg with its
    a Co update): the codec's int32 table and (start, freq) against the
    reference's ``cdf_tables`` on the same parameter rows, equal."""
    _, port, _ = models
    y = bands(3, 32, 48, seed=7)  # the conditioning units and band 2's
    with torch.no_grad():
        pm = port.band_params(y[..., :12], 0, 2).reshape(32 * 48, -1)
    y2 = y.reshape(32 * 48, -1)
    cfg = port_config({"model": KEYS})
    for clr, (lo, hi) in enumerate(((-127, 128), (-96, 95), (-64, 63))):
        pts = cdf_sampling_points(lo, hi)
        T, s0, m0, w0, upd, sch = clrjnt1.colour_spec(4, M, 2, clr)
        assert (T, s0, m0, w0, upd) == pmap_cdf_spec(cfg, 2, clr)
        assert sch == sym_channel(cfg, 2, clr)
        got = gmm_cdf_from_pmap(pts, pm, y2, T, s0, m0, w0, upd, False, sch,
                                lo)
        want = ref_codec.cdf_tables(pts, pm, y2, T, s0, m0, w0, upd, sch,
                                    lo)[:3]
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_batch_container_equals_the_references(models):
    """The reference encoder's K = 2 batch container equals
    ``compress_batch``'s byte for byte, the decode gives the images back,
    and a reference that codes Y with M terms (a fault) gives another."""
    weights, _, ref = models
    codec = Codec(port_config({"model": KEYS}), weights, device="cpu",
                  num_lanes=16)
    imgs = images(2)
    got = codec.compress_batch(imgs)
    want = clrjnt1.Clrjnt1Encoder(ref, 16, "cpu").encode_batch(imgs)
    assert ref_codec.serialize(got) == ref_codec.serialize(want["streams"])
    outs = codec.decompress_batch(got)
    assert all(np.array_equal(o, im) for o, im in zip(outs, imgs))
    assert want["words"].shape == (2, 18)
    assert [s[2][0] for s in want["slices"][:3]] == [2 * M, M, M]
    fault = clrjnt1.Clrjnt1Encoder(ref, 16, "cpu",
                                   y_only_m=True).encode_batch(imgs)
    assert ref_codec.serialize(got) != ref_codec.serialize(fault["streams"])


def test_flop_count_equals_the_counted_convs(models):
    """The count equals FlopCounterMode's count of the reference's convs
    over one pass of every band net: layer 0 at groups 2 (4 inputs, two
    a group), the trunk at 8 groups."""
    from torch.utils.flop_counter import FlopCounterMode
    _, _, ref = models
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        for scale in (0, 1):
            for b in range(3):
                ref.band(scale, b).params(bands(b, 32 >> scale, 48 >> scale))
    assert counter.get_total_flops() == clrjnt1.forward_flops(KEYS, H, W)
    assert clrjnt1.forward_flops(J1_A, 512, 768) == 83_703_595_008


def test_block_diagonal_kernel_gives_the_grouped_map():
    """A layer-0 conv of groups 2 over 4 channels and its block-diagonal
    ungrouped kernel give the same map: exactly in float64, where each
    sum only gains exact zero products."""
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(4, 16, (3, 4), groups=2).double()
    x = torch.randn(2, 4, 9, 11, dtype=torch.float64)
    x[:, 0] = 0
    dense = block_diagonal(conv)
    assert dense.shape == (16, 4, 3, 4)
    assert torch.equal(dense[:8, 2:], torch.zeros(8, 2, 3, 4,
                                                  dtype=torch.float64))
    assert torch.equal(dense[8:, :2], torch.zeros(8, 2, 3, 4,
                                                  dtype=torch.float64))
    with torch.no_grad():
        assert torch.equal(F.conv2d(x, dense, conv.bias), conv(x))


@pytest.mark.parametrize("mode,held", [(1, 6), (2, 0), (0, 0)])
def test_codec_holds_an_ungrouped_kernel_for_clrjnt1_alone(mode, held):
    """The codec holds one ungrouped kernel a layer-0 conv of
    clr_joint_mode 1 (1 + 2 + 3 convs over the three band nets), none of
    the joint model's (ungrouped) or clr_joint_mode 0's (depthwise)."""
    keys = dict(KEYS, clr_joint_mode=mode)
    cfg = port_config({"model": keys})
    codec = Codec(cfg, init_params(cfg, 0), device="cpu", num_lanes=16)
    convs = [getattr(m, name) for m in codec.model.modules()
             if isinstance(m, Interpolator)
             for spec in m._specs.values() for _, name, _, _ in spec]
    dense = [c for c in convs if hasattr(c, "held_dense")]
    assert len(convs) == 6 and len(dense) == held
    for c in dense:
        assert c.groups == 2 and torch.equal(c.held_dense, block_diagonal(c))
