"""The port's codec round trip for every configuration it codes, and its
container against the JAX package's ``Codec(use_pallas_cdf=True)`` on the
same image and weights.

Header bytes must be equal.  The rANS streams differ only where a CDF
entry rounds the other way (exp differs by an ulp between the two
frameworks), so the total size must agree within max(0.1 %, 16 bytes).
"""
import torch_helpers  # first: caps torch's threads
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llicti_tpu.codec import Codec as JaxCodec
from llicti_tpu.config import ModelConfig
from llicti_tpu.data.dataset import synthetic_image
from llicti_tpu.models.llicti import LLICTIModel as JaxModel
from llicti_torch import Codec, load_npz
from llicti_torch.weights import init_params

SIZES = [(32, 32), (33, 37), (30, 31)]

# the configurations chip_smoke.py round-trips at full width
CHIP_VARIANTS = (
    [{"clr_joint_mode": m, "distribution": d}
     for m in (2, 1, 0) for d in ("normal", "logistic")]
    + [{"clr_joint_mode": 0, "clrjnt0seqmd": True, "distribution": d}
       for d in ("normal", "logistic")]
    + [{"activfun": "GDN1"}, {"mwsa_joint": True},
       {"combine_layers1toL": True}])


def small_cfg(**kw):
    return ModelConfig(chs=(8, 8), evens=(4, 4), odds=(3, 3),
                       dwtlevels=(0, 1), useprevlevNN=(False, True), **kw)


def assert_lossless(codec, img):
    streams = codec.compress(img)
    out = codec.decompress(Codec.deserialize(Codec.serialize(streams)),
                           xorg=img)
    assert out.shape == (1,) + img.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out[0], img)
    assert codec.last_ycocg_err == 0
    return streams


@pytest.fixture(scope="module")
def codecs():
    """The port's codec and JAX's of the tiny weights, from torch_helpers."""
    return (Codec(small_cfg(), torch_helpers.tiny_jax_params()[1],
                  num_lanes=32, device="cpu"),
            torch_helpers.tiny_jax_codec())


@pytest.mark.parametrize("h,w", SIZES)
def test_roundtrip_and_container_match_jax(codecs, h, w):
    port, ref = codecs
    img = synthetic_image(h, w, seed=h + w)
    streams = assert_lossless(port, img)
    assert len(port.last_slice_bits) == 2
    assert all(len(row) == 9 for row in port.last_slice_bits)
    assert np.array(port.last_ideal_bits).shape == (2, 9)
    # head_words (byte 13): stream words of every scale but the finest
    head = int(np.frombuffer(streams[0][0][13:17], np.uint32)[0])
    assert head * 16 == sum(sum(r) for r in port.last_slice_bits[:-1])
    assert Codec.num_bytes(streams) == 4 * 32 + 2 * (
        sum(sum(r) for r in port.last_slice_bits) // 16) + sum(
            len(s) for s in streams[0])

    jstreams = ref.compress(img)
    assert streams[0][0][:13] == jstreams[0][0][:13]
    assert streams[0][1:4] == jstreams[0][1:4]
    assert len(streams) == len(jstreams) == 2
    nb, jnb = Codec.num_bytes(streams), JaxCodec.num_bytes(jstreams)
    print(f"{h}x{w}: port {nb} bytes, JAX {jnb} bytes")
    assert abs(nb - jnb) <= max(0.001 * jnb, 16)


def test_flagship_crop_roundtrip():
    """Trained flagship weights from the committed .npz on a 64x96 crop."""
    codec = Codec(ModelConfig(), load_npz(), num_lanes=128, device="cpu")
    img = np.ascontiguousarray(synthetic_image(512, 768, seed=42)[:64, :96])
    streams = codec.compress(img)
    out = codec.decompress(streams, xorg=img)
    np.testing.assert_array_equal(out[0], img)
    assert codec.last_ycocg_err == 0
    assert len(codec.last_slice_bits) == 5
    act = sum(sum(r) for r in codec.last_slice_bits)
    ideal = sum(sum(r) for r in codec.last_ideal_bits)
    # rANS closure: stream words vs the ideal code length of its tables
    assert abs(act - ideal) <= 0.01 * ideal + 16 * 128


def test_codec_rejects_bad_input(codecs):
    port, _ = codecs
    img = synthetic_image(16, 16, seed=0)
    with pytest.raises(ValueError):
        port.compress(img.astype(np.int16))
    with pytest.raises(ValueError):
        port.compress(img[..., :2])
    with pytest.raises(ValueError):
        port.compress(img[:2])
    streams = port.compress(img)
    hdr, minmax = streams[0][0], streams[0][1]
    wide = np.frombuffer(minmax, np.int16).copy()
    wide[4] = 300  # a Co maximum no YCoCg-R image has
    taller = np.array([40], np.uint32).tobytes()
    for bad in ([bytes([7]) + hdr[1:]] + streams[0][1:],
                [hdr, wide.tobytes()] + streams[0][2:],
                [hdr[:5] + taller + hdr[9:]] + streams[0][1:],
                streams[0][:3] + [streams[0][3][:-3]] + streams[0][4:]):
        with pytest.raises(ValueError):
            port.decompress([bad, streams[1]])
    with pytest.raises(ValueError):
        port.decompress(streams[:1])
    with pytest.raises(ValueError):
        Codec.deserialize(Codec.serialize(streams)[:-3])


@pytest.mark.parametrize("kw", [
    {"subtract_mean": True}, {"ycocg": False}, {"clrchs": 1},
    {"num_mixtures": 1},
    {"clr_joint_mode": 0, "clrjnt0seqmd": True, "activfun": "GDN1"}])
def test_codec_refuses_what_jax_refuses(kw):
    cfg = ModelConfig(**kw)
    with pytest.raises(AssertionError):
        JaxCodec(cfg, {}, num_lanes=32)
    with pytest.raises(NotImplementedError):
        Codec(cfg, {}, num_lanes=32, device="cpu")


@pytest.mark.parametrize("kw", CHIP_VARIANTS)
def test_variant_roundtrip(kw):
    cfg = small_cfg(**kw)
    codec = Codec(cfg, init_params(cfg, seed=0), num_lanes=32, device="cpu")
    assert_lossless(codec, synthetic_image(33, 37, seed=3))
    act = sum(sum(r) for r in codec.last_slice_bits)
    ideal = sum(sum(r) for r in codec.last_ideal_bits)
    assert abs(act - ideal) <= 0.01 * ideal + 16 * 32


@pytest.mark.parametrize("kw", [
    {"clr_joint_mode": 1, "distribution": "logistic"},
    {"clr_joint_mode": 0, "clrjnt0seqmd": True},
    # conv_layers 2: the JAX Codec's dense_group_params raises KeyError on
    # a trunk activation with parameters (trunk_1/GDN1_0, codec.py:183);
    # act0 still runs GDN1
    {"combine_layers1toL": True, "activfun": "GDN1", "conv_layers": 2}])
def test_variant_container_matches_jax(kw):
    cfg = small_cfg(**kw)
    params = JaxModel(cfg=cfg).init(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 16, 16, 3)))
    port = Codec(cfg, jax.tree.map(np.asarray, params), num_lanes=32,
                 device="cpu")
    ref = JaxCodec(cfg, params, num_lanes=32, use_pallas_cdf=True)
    img = synthetic_image(33, 37, seed=11)
    streams = assert_lossless(port, img)
    jstreams = ref.compress(img)
    assert streams[0][0][:13] == jstreams[0][0][:13]
    assert streams[0][1:4] == jstreams[0][1:4]
    nb, jnb = Codec.num_bytes(streams), JaxCodec.num_bytes(jstreams)
    print(f"{kw}: port {nb} bytes, JAX {jnb} bytes")
    assert abs(nb - jnb) <= max(0.001 * jnb, 16)
