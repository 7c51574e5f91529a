"""The encoder's colour ranges, reduced on the codec's device from the
uploaded batch (``Codec._stage``), against the host twin ``host_header``:
the same 6 integers over the same padded pixels, and so the same header
bytes, for one image and for several, at YCoCg-R's extremes and under
``size_bucket`` padding.  A CPU codec runs the device path in torch."""
import torch_helpers  # noqa: F401  (first: caps torch's threads)

import numpy as np
import pytest

from llicti_torch import Codec, ModelConfig
from llicti_torch.codec import (batch_header_group, header_group,
                                host_header, pad_flags_for_shape)
from llicti_torch.weights import init_params

CFG = ModelConfig(chs=(4, 4), evens=(4, 4), odds=(3, 3), dwtlevels=(0, 1),
                  useprevlevNN=(False, True))
LEVELS = CFG.dwtlevels
STRIDE = 2 ** (max(LEVELS) + 1)
BUCKET = 8

# RGB colours at which Y, Co or Cg take their least or greatest value
EXTREMES = {"red": (255, 0, 0), "blue": (0, 0, 255), "green": (0, 255, 0),
            "magenta": (255, 0, 255), "black": (0, 0, 0),
            "white": (255, 255, 255)}


@pytest.fixture(scope="module")
def codec():
    return Codec(CFG, init_params(CFG), num_lanes=16, device="cpu")


@pytest.fixture(scope="module")
def bucketed():
    return Codec(CFG, init_params(CFG), num_lanes=16, device="cpu",
                 size_bucket=BUCKET)


def random_image(seed, h=21, w=18):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def solid(rgb, h=13, w=10):
    return np.broadcast_to(np.array(rgb, np.uint8), (h, w, 3)).copy()


def padded(img, bucket=0):
    """``img`` [H, W, 3] edge-padded to ``bucket`` multiples, [1, H', W',
    3], as the header describes it."""
    h, w = img.shape[:2]
    if bucket:
        img = np.pad(img, ((0, -(-h // bucket) * bucket - h),
                           (0, -(-w // bucket) * bucket - w), (0, 0)),
                     mode="edge")
    return img[None]


def staged_minmax(codec, imgs):
    """The 6 integers the codec's staging reduces on its device."""
    (st,), _ = codec._stage([imgs])
    return st.minmax


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_image_ranges_are_host_headers(codec, seed):
    img = random_image(seed, 17 + seed, 22 - seed)
    assert staged_minmax(codec, [img]) == host_header(padded(img),
                                                      LEVELS)[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_three_image_ranges_are_host_headers_union(codec, seed):
    imgs = [random_image(10 * seed + k) for k in range(3)]
    want = host_header(np.concatenate([padded(i) for i in imgs]), LEVELS)[0]
    assert staged_minmax(codec, imgs) == want
    # the union, not the first image's
    assert want != host_header(padded(imgs[0]), LEVELS)[0]


@pytest.mark.parametrize("name", sorted(EXTREMES))
def test_ranges_at_an_extreme(codec, name):
    """A solid image of a colour at one of YCoCg-R's extremes, and a
    random image with one pixel of it."""
    img = solid(EXTREMES[name])
    assert staged_minmax(codec, [img]) == host_header(padded(img),
                                                      LEVELS)[0]
    mixed = random_image(7)
    mixed[3, 5] = EXTREMES[name]
    assert staged_minmax(codec, [mixed]) == host_header(padded(mixed),
                                                        LEVELS)[0]


def test_three_solid_images_span_every_extreme(codec):
    """Y, Co and Cg each reach both ends of their ranges only across the
    three images: [0, -255, -255, 255, 255, 255]."""
    imgs = [solid(EXTREMES[n]) for n in ("red", "blue", "black")]
    imgs[0][0, 0] = EXTREMES["green"]
    imgs[1][0, 0] = EXTREMES["magenta"]
    imgs[2][0, 0] = EXTREMES["white"]
    want = host_header(np.concatenate([padded(i) for i in imgs]), LEVELS)[0]
    assert want == [0, -255, -255, 255, 255, 255]
    assert staged_minmax(codec, imgs) == want


@pytest.mark.parametrize("shape", [(21, 18), (9, 30)])
def test_ranges_cover_the_bucket_padding(bucketed, shape):
    """A size off the bucket: the ranges are those of the edge-padded
    block, and the staged batch is that block."""
    img = random_image(5, *shape)
    img[-1, -1] = EXTREMES["white"]  # replicated along the padded edges
    (st,), (dev,) = bucketed._stage([[img]])
    want = padded(img, BUCKET)
    assert st.rgb.shape != img[None].shape
    assert np.array_equal(dev.numpy(), want)
    assert st.minmax == host_header(want, LEVELS)[0]


def host_group(imgs, bucket, head_words=None):
    """streams[0] built from ``host_header`` on the host: a single
    container's (``head_words`` given) or a batch container's."""
    block = np.concatenate([padded(i, bucket) for i in imgs])
    H, W = block.shape[1:3]
    minmax, raw = host_header(block, LEVELS)
    _, pad_int = pad_flags_for_shape(H, W, LEVELS)
    last = (-(-H // STRIDE), -(-W // STRIDE))
    origs = [i.shape[:2] for i in imgs]
    if head_words is None:
        return batch_header_group(CFG.num_scales, *last, origs, minmax,
                                  pad_int, raw.tobytes())
    return header_group(CFG.num_scales, *last, *origs[0], minmax, pad_int,
                        raw.tobytes(), head_words)


def head_words(table):
    """Stream words of scales S-1..1, from an image's bits table."""
    return sum(sum(row) for row in table[:-1]) // 16


@pytest.mark.parametrize("bucket", [0, BUCKET])
def test_compress_header_is_host_headers(codec, bucketed, bucket):
    c = bucketed if bucket else codec
    img = random_image(3, 19, 26)
    streams = c.compress(img)
    assert streams[0] == host_group(
        [img], bucket, head_words(c.last_slice_bits_batch[0]))


def test_compress_many_headers_are_host_headers(codec):
    """Two images of different shapes: one fetch of both groups' ranges,
    each image's own header."""
    imgs = [random_image(4, 21, 18), random_image(5, 14, 27)]
    imgs[1][2, 2] = EXTREMES["blue"]
    out = codec.compress_many(imgs)
    for img, streams, table in zip(imgs, out, codec.last_slice_bits_batch):
        assert streams[0] == host_group([img], 0, head_words(table))
        assert streams == codec.compress(img)


@pytest.mark.parametrize("bucket", [0, BUCKET])
def test_compress_batch_header_is_host_headers(codec, bucketed, bucket):
    c = bucketed if bucket else codec
    imgs = [random_image(6 + k, 21, 18) for k in range(3)]
    imgs[2][0, 0] = EXTREMES["magenta"]
    streams = c.compress_batch(imgs)
    assert streams[0] == host_group(imgs, bucket)
    outs = c.decompress_batch(streams)
    assert all(np.array_equal(o, i) for o, i in zip(outs, imgs))
