"""The port's serving path against the JAX package's: the K-image batch
container, pipelined many-image calls, the resident closures,
``size_bucket`` and ``two_stage``, on the CPU (plain kernel versions).

Headers must be equal byte for byte; a blob's size within max(0.1 %, 16
bytes) of JAX's (the CDF entries may round the other way, as in
``test_torch_codec.py``); every round trip lossless.
"""
import torch_helpers  # first: caps torch's threads
import numpy as np
import pytest

from llicti_tpu.config import ModelConfig
from llicti_tpu.data.dataset import synthetic_image
from llicti_torch import Codec
from llicti_torch.coder.rans import pack_stream_packed, unpack_stream
from llicti_torch.weights import init_params


def small_cfg(**kw):
    return ModelConfig(chs=(8, 8), evens=(4, 4), odds=(3, 3),
                       dwtlevels=(0, 1), useprevlevNN=(False, True), **kw)


def three_scale_cfg():
    return ModelConfig(chs=(8, 8, 8), evens=(4, 4, 4), odds=(3, 3, 3),
                       dwtlevels=(0, 1, 2), useprevlevNN=(False, True, True))


@pytest.fixture(scope="module")
def jax_params():
    """JAX's tiny weights, and the same as numpy arrays, from torch_helpers."""
    return torch_helpers.tiny_jax_params()


@pytest.fixture(scope="module")
def codecs(jax_params):
    return (Codec(small_cfg(), jax_params[1], num_lanes=32, device="cpu"),
            torch_helpers.tiny_jax_codec())


@pytest.fixture(scope="module")
def split(jax_params):
    """A two-stage port codec of the same weights."""
    return Codec(small_cfg(), jax_params[1], num_lanes=32, device="cpu",
                 two_stage=True)


def words_of(blob, N=32):
    return unpack_stream(blob, N)[1].size


def test_batch_container_matches_jax(codecs):
    port, ref = codecs
    imgs = [synthetic_image(32, 40, seed=s) for s in (3, 5)]
    streams = port.compress_batch(imgs)
    jstreams = ref.compress_batch(imgs)
    assert len(streams) == len(jstreams) == 3
    assert streams[0] == jstreams[0]  # header, union minmax, pad, raw
    for k in range(2):
        nb, jnb = len(streams[1 + k][0]), len(jstreams[1 + k][0])
        print(f"batch image {k}: port {nb} bytes, JAX {jnb} bytes")
        assert abs(nb - jnb) <= max(0.001 * jnb, 16)
    # the per-image slice-bits tables count each blob's words
    assert len(port.last_slice_bits_batch) == 2
    for k, table in enumerate(port.last_slice_bits_batch):
        assert sum(sum(r) for r in table) == 16 * words_of(streams[1 + k][0])
        assert np.array(port.last_ideal_bits_batch[k]).shape == (2, 9)
    for s in range(2):
        for i in range(9):
            assert port.last_slice_bits[s][i] == sum(
                t[s][i] for t in port.last_slice_bits_batch)
    outs = port.decompress_batch(Codec.deserialize(Codec.serialize(streams)))
    assert len(outs) == 2
    for img, out in zip(imgs, outs):
        assert out.shape == img.shape and out.dtype == np.uint8
        np.testing.assert_array_equal(out, img)


def test_batch_container_above_1024_lanes(jax_params):
    """K = 2 at N = 2048 lanes (on the card the wide Kernels 2 and 3):
    lossless, and each image's slice-bits table counts its blob's words."""
    N = 2048
    codec = Codec(small_cfg(), jax_params[1], num_lanes=N, device="cpu")
    imgs = [synthetic_image(32, 40, seed=s) for s in (3, 5)]
    streams = codec.compress_batch(imgs)
    assert len(streams) == 3 and len(codec.last_slice_bits_batch) == 2
    for k, table in enumerate(codec.last_slice_bits_batch):
        blob = streams[1 + k][0]
        assert len(blob) > 4 * N  # N lane states lead the blob
        assert sum(sum(r) for r in table) == 16 * words_of(blob, N)
    outs = codec.decompress_batch(Codec.deserialize(Codec.serialize(streams)))
    for img, out in zip(imgs, outs):
        assert out.shape == img.shape and out.dtype == np.uint8
        np.testing.assert_array_equal(out, img)


def test_batch_container_identical_and_ragged(codecs):
    port, _ = codecs
    img = synthetic_image(48, 32, seed=9)
    streams = port.compress_batch([img, img, img])
    assert streams[1][0] == streams[2][0] == streams[3][0]
    # odd sizes: pad flags inside the batch, each image cropped back
    imgs = [synthetic_image(33, 37, seed=s) for s in range(2)]
    for img, out in zip(imgs, port.decompress_batch(
            port.compress_batch(imgs))):
        np.testing.assert_array_equal(out, img)


def test_batch_container_is_refused_elsewhere(codecs):
    """A batch container decodes only through the batch path, a single
    one only through the single path; malformed batch headers raise."""
    port, _ = codecs
    img = synthetic_image(32, 40, seed=1)
    batch1 = port.compress_batch([img])
    single = port.compress(img)
    with pytest.raises(ValueError):
        port.decompress(batch1)
    with pytest.raises(ValueError):
        port.decompress_batch(single)
    with pytest.raises(ValueError):
        port.compress_batch([img, synthetic_image(32, 36, seed=2)])
    with pytest.raises(ValueError):
        port.compress_batch([])
    streams = port.compress_batch([img, img])
    hdr = streams[0][0]
    origs = np.frombuffer(hdr[7:], np.uint32).copy()
    origs[2] = 41  # taller than the coded 32 rows
    for bad in ([[hdr[:1] + bytes([3]) + hdr[2:]] + streams[0][1:]]
                + streams[1:],                      # K = 3, two blobs
                [[hdr[:7] + origs.tobytes()] + streams[0][1:]] + streams[1:],
                [streams[0][:3] + [streams[0][3][:-6]] + streams[0][4:]]
                + streams[1:],
                streams[:2]):
        with pytest.raises(ValueError):
            port.decompress_batch(bad)


def test_pipelined_many_matches_single_calls(codecs):
    port, _ = codecs
    imgs = [synthetic_image(32, 32, seed=s) for s in (1, 2)] + [
        synthetic_image(33, 37, seed=3)]
    singles = [port.compress(im) for im in imgs]
    manys = port.compress_many(imgs)
    assert manys == singles
    for im, out in zip(imgs, port.decompress_many(manys)):
        np.testing.assert_array_equal(out[0], im)
    # decompress_dispatch: the padded device image and the crop
    rgb, oh, ow = port.decompress_dispatch(manys[2])
    assert (oh, ow) == (33, 37)
    np.testing.assert_array_equal(rgb.numpy()[0, :33, :37], imgs[2])


def test_pipelined_many_per_image_accounting(codecs):
    """One table per image (two different images) equal to each image's
    compress tables; last_slice_bits / last_ideal_bits their sums."""
    port, _ = codecs
    imgs = [synthetic_image(32, 32, seed=101),
            synthetic_image(32, 32, seed=202)]
    ref_act, ref_ideal = [], []
    for im in imgs:
        port.compress(im)
        ref_act.append(port.last_slice_bits)
        ref_ideal.append(port.last_ideal_bits)
    assert ref_act[0] != ref_act[1]
    port.compress_many(imgs)
    assert port.last_slice_bits_batch == ref_act
    for got, ref in zip(port.last_ideal_bits_batch, ref_ideal):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-6)
    for s in range(2):
        for i in range(9):
            assert port.last_slice_bits[s][i] == (
                ref_act[0][s][i] + ref_act[1][s][i])
            np.testing.assert_allclose(
                port.last_ideal_bits[s][i],
                ref_ideal[0][s][i] + ref_ideal[1][s][i], rtol=1e-6)


def test_resident_closures_match_wire_paths(codecs):
    port, _ = codecs
    img = synthetic_image(33, 37, seed=8)  # odd size: pad/crop path too
    streams = port.compress(img)
    dec = port.prepare_decode(streams)
    for _ in range(2):  # each call starts from the staged states
        rgb = dec().numpy()
        np.testing.assert_array_equal(rgb[:, :33, :37],
                                      port.decompress(streams))
    cursors, states, buf, ideal = port.prepare_encode(img)()
    assert cursors.shape == (1, 18) and ideal.shape == (1, 18)
    blob = pack_stream_packed(buf[0, :int(cursors[0, -1])].numpy(),
                              states[0].numpy())
    assert blob == streams[1][0]
    imgs = [synthetic_image(32, 40, seed=s) for s in (1, 2)]
    bstreams = port.compress_batch(imgs)
    brgb = port.prepare_decode_batch(bstreams)().numpy()
    for k, (im, ref) in enumerate(zip(imgs, port.decompress_batch(
            bstreams))):
        np.testing.assert_array_equal(brgb[k], ref)
        np.testing.assert_array_equal(brgb[k], im)


def test_size_bucket_header_matches_jax(codecs, jax_params):
    port, ref = codecs
    bucketed = Codec(small_cfg(), jax_params[1], num_lanes=32, device="cpu",
                     size_bucket=16)
    img = synthetic_image(37, 45, seed=39)  # pads to 48x48
    streams = bucketed.compress(img)
    ref.size_bucket = 16
    try:
        jstreams = ref.compress(img)
    finally:
        ref.size_bucket = 0
    assert streams[0][0][:13] == jstreams[0][0][:13]
    assert streams[0][1:4] == jstreams[0][1:4]
    assert np.frombuffer(streams[0][0][5:13], np.uint32).tolist() == [37, 45]
    out = bucketed.decompress(streams, xorg=img)
    assert out.shape == (1, 37, 45, 3)
    np.testing.assert_array_equal(out[0], img)
    assert bucketed.last_ycocg_err == 0
    # the malformed headers of test_torch_codec are still refused
    hdr = streams[0][0]
    wide = np.frombuffer(streams[0][1], np.int16).copy()
    wide[4] = 300
    for bad in ([bytes([7]) + hdr[1:]] + streams[0][1:],
                [hdr, wide.tobytes()] + streams[0][2:],
                [hdr[:5] + np.array([49], np.uint32).tobytes() + hdr[9:]]
                + streams[0][1:],
                streams[0][:3] + [streams[0][3][:-3]] + streams[0][4:]):
        with pytest.raises(ValueError):
            bucketed.decompress([bad, streams[1]])
    with pytest.raises(ValueError):
        Codec(small_cfg(), {}, num_lanes=32, device="cpu", size_bucket=6)


def test_size_bucket_bounds_padded_shapes(jax_params):
    codec = Codec(small_cfg(), jax_params[1], num_lanes=32, device="cpu",
                  size_bucket=16)
    shapes = [(17, 23), (19, 21), (23, 17), (30, 26),
              (33, 39), (37, 47), (41, 33), (47, 44)]
    imgs = [synthetic_image(h, w, seed=100 + i)
            for i, (h, w) in enumerate(shapes)]
    outs = codec.decompress_many(codec.compress_many(imgs))
    for img, out in zip(imgs, outs):
        assert out.shape == (1,) + img.shape
        np.testing.assert_array_equal(out[0], img)
    assert codec.compiled_shapes == {(32, 32), (48, 48)}
    # a bucketed batch: ragged originals of one padded shape
    batch = imgs[:4]
    for img, out in zip(batch, codec.decompress_batch(
            codec.compress_batch(batch))):
        np.testing.assert_array_equal(out, img)


def test_two_stage_split_point_and_round_trip(codecs, split):
    fused, _ = codecs
    img = synthetic_image(48, 56, seed=33)
    streams = split.compress(img)
    head = int(np.frombuffer(streams[0][0][13:17], np.uint32)[0])
    assert 0 < head < words_of(streams[1][0])
    assert head * 16 == sum(sum(r) for r in split.last_slice_bits[:-1])
    out = split.decompress(streams, xorg=img)
    np.testing.assert_array_equal(out[0], img)
    assert split.last_ycocg_err == 0
    # pipelined, resident and batch paths of the two-stage codec
    for out in split.decompress_many([streams, streams]):
        np.testing.assert_array_equal(out[0], img)
    np.testing.assert_array_equal(split.prepare_decode(streams)().numpy()[0],
                                  img)
    for out in split.decompress_batch(split.compress_batch([img, img])):
        np.testing.assert_array_equal(out, img)


def test_two_stage_cross_family_decode(codecs, split):
    """The encoder's bytes do not depend on two_stage, and each codec
    decodes the other's streams."""
    fused, _ = codecs
    img = synthetic_image(32, 48, seed=37)
    s_fused, s_split = fused.compress(img), split.compress(img)
    assert s_fused == s_split
    np.testing.assert_array_equal(split.decompress(s_fused)[0], img)
    np.testing.assert_array_equal(fused.decompress(s_split)[0], img)
    b_fused = fused.compress_batch([img, img])
    np.testing.assert_array_equal(split.decompress_batch(b_fused)[1], img)


def test_two_stage_three_scales():
    cfg = three_scale_cfg()
    codec = Codec(cfg, init_params(cfg, seed=1), num_lanes=32, device="cpu",
                  two_stage=True)
    img = synthetic_image(40, 56, seed=35)
    streams = codec.compress(img)
    head = int(np.frombuffer(streams[0][0][13:17], np.uint32)[0])
    assert head * 16 == sum(sum(r) for r in codec.last_slice_bits[:-1])
    np.testing.assert_array_equal(codec.decompress(streams)[0], img)


@pytest.mark.parametrize("kw", [{"two_stage": True}, {"size_bucket": 16}])
def test_serving_codecs_default_to_the_card(kw):
    """Without ``device``, a Codec runs on CUDA; with no card it raises."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default codec would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        Codec(small_cfg(), {}, num_lanes=32, **kw)
