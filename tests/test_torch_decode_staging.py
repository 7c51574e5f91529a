"""The decoder's staging of rANS words (``Codec._decode_stage`` and
``_decode_upload``) on the CPU: each stream's 16-bit words written once
into the codec's reused staging block and widened to the int32 rows
Kernel 2 reads (``coder/rans.py`` ``widen_words``, whose plain version
runs here), equal to the zero-padded rows and int64 states that
``unpack_stream`` gives; malformed blobs refused before anything is
written; every decoder lossless through the block, with its
``staging_counts``.  The kernel against its plain version runs on a card
only."""
import torch_helpers  # noqa: F401  (first: caps torch's threads)

import numpy as np
import pytest
import torch

from llicti_torch import Codec, ModelConfig
from llicti_torch.codec import Header
from llicti_torch.coder.rans import (unpack_stream, widen_words,
                                     widen_words_plain)
from llicti_torch.data.dataset import synthetic_image
from llicti_torch.weights import init_params

N = 32
CFG = ModelConfig(chs=(8, 8), evens=(4, 4), odds=(3, 3), dwtlevels=(0, 1),
                  useprevlevNN=(False, True))


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, 0)


@pytest.fixture(scope="module")
def codec(params):
    return Codec(CFG, params, num_lanes=N, device="cpu")


def blob(rng, n: int, word=None) -> bytes:
    """A rANS blob of N random lane states and ``n`` words (random over
    all 16 bits, or all ``word``)."""
    states = rng.integers(1 << 16, 1 << 32, N, dtype=np.uint64)
    words = (rng.integers(0, 1 << 16, n) if word is None
             else np.full(n, word))
    return (states.astype(np.uint32).tobytes()
            + words.astype(np.uint16).tobytes())


def unpacked_rows(blobs):
    """What the decoder staged before the block: each stream unpacked
    (``unpack_stream``), its words in a zero-padded int32 row, its states
    int64."""
    unpacked = [unpack_stream(b, N) for b in blobs]
    words = np.zeros((len(blobs), max(w.size for _, w in unpacked)),
                     np.int32)
    for k, (_, w) in enumerate(unpacked):
        words[k, :w.size] = w
    return words, np.stack([s for s, _ in unpacked]).astype(np.int64)


def header(K: int) -> Header:
    return Header([0] * 6, [(False, False)] * CFG.num_scales,
                  np.zeros((K, 1, 1, 3), np.uint8), [(1, 1)] * K, None)


@pytest.mark.parametrize("lengths", [[37], [64, 0, 17, 64, 3, 50, 1, 33]],
                         ids=["K1", "K8_ragged"])
def test_staged_rows_widen_to_the_unpacked_rows(codec, lengths):
    rng = np.random.default_rng(len(lengths))
    # a longer decode first leaves all-ones words in the reused block
    codec._decode_stage([[blob(rng, 100, 0xFFFF) for _ in range(8)]])
    grown = codec.staging_counts["grown"]
    blobs = [blob(rng, n) for n in lengths]
    staged, = codec._decode_stage([blobs])
    assert codec.staging_counts["grown"] == grown
    d = codec._decode_upload(header(len(blobs)), staged, split=False)
    words, states = unpacked_rows(blobs)
    assert d.words.dtype == torch.int32 and d.states.dtype == torch.int64
    np.testing.assert_array_equal(d.words.numpy(), words)
    np.testing.assert_array_equal(d.states.numpy(), states)
    assert d.head is None and d.tail_ready is None


@pytest.mark.parametrize("cols", [(0, 24), (0, 9), (9, 24), (5, 5)])
def test_widen_plain_zeroes_past_each_length(cols):
    gen = torch.Generator().manual_seed(cols[0] * 100 + cols[1])
    src = torch.randint(-32768, 32768, (5, 24), dtype=torch.int16,
                        generator=gen)
    lengths = torch.tensor([24, 0, 9, 13, 1])
    out = torch.full((5, 30), -7, dtype=torch.int32)
    assert widen_words(src, lengths, out, *cols) is out
    want = np.full((5, 30), -7)
    u16 = src.numpy().view(np.uint16)
    for k, n in enumerate(lengths.tolist()):
        for c in range(*cols):
            want[k, c] = u16[k, c] if c < n else 0
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("bad", [7, 4 * N - 2, 4 * N + 3],
                         ids=["short", "no_states", "odd"])
def test_malformed_blob_raises_before_anything_is_written(codec, bad):
    rng = np.random.default_rng(bad)
    good = blob(rng, 40)
    codec._decode_stage([[good, good]])
    blocks = [b.clone() for b in codec._blocks]
    counts = codec.staging_counts.copy()
    with pytest.raises(ValueError, match="does not fit"):
        codec._decode_stage([[blob(rng, 10)], [good, good[:bad]]])
    assert all(torch.equal(a, b) for a, b in zip(blocks, codec._blocks))
    assert codec.staging_counts == counts


def test_truncated_blob_in_a_batch_container_raises(codec):
    streams = codec.compress_batch([synthetic_image(24, 32, seed=s)
                                    for s in (1, 2)])
    streams[2] = [streams[2][0][:-1]]
    with pytest.raises(ValueError, match="does not fit"):
        codec.decompress_batch(streams)


def test_decompress_many_equals_decompress_one_by_one(codec):
    imgs = [synthetic_image(h, w, seed=s)
            for s, (h, w) in enumerate(((24, 32), (40, 56), (32, 40)))]
    containers = [codec.compress(im) for im in imgs]
    assert len({len(c[1][0]) for c in containers}) == 3
    stages = sum(codec.staging_counts.values())
    many = codec.decompress_many(containers)
    # the three containers staged in one call, each in its own region
    assert sum(codec.staging_counts.values()) == stages + 1
    for got, c, im in zip(many, containers, imgs):
        np.testing.assert_array_equal(got, codec.decompress(c))
        np.testing.assert_array_equal(got[0], im)


def test_a_larger_decode_grows_the_block_then_reuses_it(params):
    codec = Codec(CFG, params, num_lanes=N, device="cpu")
    small = codec.compress(synthetic_image(24, 32, seed=4))
    large = codec.compress(synthetic_image(48, 64, seed=4))
    assert len(large[1][0]) > 2 * len(small[1][0])
    codec.decompress(small)
    assert codec.staging_counts == {"grown": 1}
    codec.decompress(large)
    assert codec.staging_counts == {"grown": 2}
    for streams in (large, small):
        codec.decompress(streams)
    assert codec.staging_counts == {"grown": 2, "reused": 2}


def test_resident_closure_keeps_its_words_when_the_block_is_rewritten(
        codec):
    imgs = [synthetic_image(24, 32, seed=s) for s in (5, 6)]
    decode = codec.prepare_decode_batch(codec.compress_batch(imgs))
    codec.decompress(codec.compress(synthetic_image(40, 56, seed=9)))
    out = decode().numpy()
    for k, im in enumerate(imgs):
        np.testing.assert_array_equal(out[k], im)


def test_two_stage_decodes_to_the_same_image(codec, params):
    split = Codec(CFG, params, num_lanes=N, device="cpu", two_stage=True)
    img = synthetic_image(40, 56, seed=11)
    streams = split.compress(img)
    assert streams == codec.compress(img)
    np.testing.assert_array_equal(split.decompress(streams)[0], img)
    np.testing.assert_array_equal(split.decompress_many([streams])[0][0],
                                  img)


def test_widen_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the widen kernel has no CPU mode")
    gen = torch.Generator().manual_seed(27)
    K, W = 9, 70001
    src = torch.randint(-32768, 32768, (K, W), dtype=torch.int16,
                        generator=gen)
    lengths = torch.tensor([W, 0, 1, 5, W - 1, 4096, 65537, 3, 70000])
    for cols in ((0, W), (0, 12345), (12345, W), (7, 7)):
        want = widen_words_plain(src, lengths,
                                 torch.full((K, W), -7, dtype=torch.int32),
                                 *cols)
        got = widen_words(src.cuda(), lengths.cuda(),
                          torch.full((K, W), -7, dtype=torch.int32,
                                     device="cuda"), *cols)
        assert torch.equal(got.cpu(), want), cols
