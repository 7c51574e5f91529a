"""The port's codec round trip, and its container against the JAX
package's ``Codec(use_pallas_cdf=True)`` on the same image and weights.

Header bytes must be equal.  The rANS streams differ only where a CDF
entry rounds the other way (exp differs by an ulp between the two
frameworks), so the total size must agree within max(0.1 %, 16 bytes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llicti_tpu.codec import Codec as JaxCodec
from llicti_tpu.config import ModelConfig
from llicti_tpu.data.dataset import synthetic_image
from llicti_tpu.models.llicti import LLICTIModel as JaxModel
from llicti_torch import Codec, load_npz

SIZES = [(32, 32), (33, 37), (30, 31)]


def small_cfg():
    return ModelConfig(chs=(8, 8), evens=(4, 4), odds=(3, 3),
                       dwtlevels=(0, 1), useprevlevNN=(False, True))


@pytest.fixture(scope="module")
def codecs():
    cfg = small_cfg()
    params = JaxModel(cfg=cfg).init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 16, 16, 3)))
    np_params = jax.tree.map(np.asarray, params)
    return (Codec(cfg, np_params, num_lanes=32),
            JaxCodec(cfg, params, num_lanes=32, use_pallas_cdf=True))


@pytest.mark.parametrize("h,w", SIZES)
def test_roundtrip_and_container_match_jax(codecs, h, w):
    port, ref = codecs
    img = synthetic_image(h, w, seed=h + w)
    streams = port.compress(img)
    out = port.decompress(Codec.deserialize(Codec.serialize(streams)),
                          xorg=img)
    assert out.shape == (1, h, w, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out[0], img)
    assert port.last_ycocg_err == 0
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
    codec = Codec(ModelConfig(), load_npz(), num_lanes=128)
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
    with pytest.raises(NotImplementedError):
        Codec(ModelConfig(clr_joint_mode=0), {}, num_lanes=32)
