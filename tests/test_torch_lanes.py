"""More than 1024 rANS lanes, and the float-CDF device path, against the
JAX package.

Lanes: the plain versions of Kernels 2 and 3 at N = 2048 and 1500 give
the bytes, symbols, states and offsets of JAX's lane scans, and at N =
20000 and 70000 JAX's encode bytes; containers at N = 2048 and 20000 have
JAX's ``Codec(use_pallas_cdf=True)`` header and their sizes within
max(0.1 %, 16 B).  Float CDF
(``Codec(use_kernel_cdf=False)``, JAX's ``use_pallas_cdf=False``): the
int32 tables equal JAX's ``cdf_float_to_cum_int32(gmm_cdf_table(...))``
or differ by one step in a counted few entries, the encoder's (start,
freq) equal JAX's lookup, and a container is within max(0.1 %, 16 B) of
JAX's, lossless through every entry point.
"""
import torch_helpers  # first: caps torch's threads
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llicti_tpu.codec import Codec as JaxCodec
from llicti_tpu.coder import rans_device as jr
from llicti_tpu.config import ModelConfig as JaxConfig
from llicti_tpu.data.dataset import synthetic_image
from llicti_tpu.ops import gmm as jgmm
from llicti_torch import Codec
from llicti_torch.coder import rans as tr
from llicti_torch.config import ModelConfig
from llicti_torch.ops.gmm import (cdf_float_to_cum_int32, cdf_sampling_points,
                                  cum_start_freq, gmm_cdf_table)
from test_torch_rans import (_jax_chain, make_cum, port_decode, port_encode,
                             sample_syms, start_freq)

TINY = torch_helpers.TINY


def size_close(nb, jnb):
    return abs(nb - jnb) <= max(0.001 * jnb, 16)


@pytest.mark.parametrize("N", [2048, 1500])
def test_plain_coder_above_1024_lanes_matches_jax(N):
    """A chain of slices (sizes not multiples of N, one below N) encoded
    by the port and by JAX's rans_encode_body_batch: the same blob; each
    decodes it to the same symbols, states and word offset."""
    rng = np.random.default_rng(N)
    slices = []
    for n, Lp in [(5000, 257), (N - 7, 513), (64, 33), (2 * N + 100, 129)]:
        cum = make_cum(rng, n, Lp, floor0=n == 64)
        slices.append((cum, sample_syms(rng, cum)))
    blob, cursors = port_encode(slices, N)
    st_fr = tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in
                  (start_freq(c, s) for c, s in reversed(slices)))
    cap = sum(len(s) for _, s in slices) + N
    buf, cursor, states = _jax_chain(
        st_fr, jnp.full((1, N), jr.RANS_L, jnp.uint32),
        jnp.zeros((1, cap), jnp.int32))
    total = int(cursor[0])
    assert total == cursors[-1]
    assert blob == jr.pack_stream_packed(np.asarray(buf)[0][:total],
                                         np.asarray(states)[0])

    out, st, off, W = port_decode(blob, slices, N)
    jst, jwords = jr.unpack_stream(blob, N)
    jst = jnp.asarray(jst, jnp.uint32)[None]
    joff = jnp.zeros((1,), jnp.int32)
    for (cum, syms), got in zip(slices, out):
        jsyms, jst, joff = jr.rans_decode_body_batch(
            jnp.asarray(cum)[None], jnp.asarray(jwords)[None], jst, joff, N,
            len(syms))
        np.testing.assert_array_equal(got, syms)
        np.testing.assert_array_equal(np.asarray(jsyms)[0], syms)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst)[0])
    assert off == int(joff[0]) == W


@pytest.mark.parametrize("N", [20000, 70000])
def test_plain_coder_above_16384_lanes_matches_jax(N):
    """Any N, as in the JAX package: a chain of slices shorter than N,
    longer than N and empty (P = 33 ... 65) encoded by the port's plain
    chain and by JAX's rans_encode_body_batch chain gives the same blob,
    and the port's plain decode returns the symbols, the encoder's first
    states and the word offset.  JAX's own decode is not run at these N:
    its refill builds a [K, N, N] one-hot (rans_device.py:280-283), 1.6 GB
    at N = 20000."""
    rng = np.random.default_rng(N)
    slices = []
    for n, Lp in [(N // 3, 33), (0, 40), (N + 4321, 65)]:
        if n:
            cum = make_cum(rng, n, Lp, floor0=Lp == 65)
            slices.append((cum, sample_syms(rng, cum)))
        else:
            slices.append((np.zeros((0, Lp), np.int32),
                           np.zeros((0,), np.int32)))
    blob, cursors = port_encode(slices, N)
    st_fr = tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in
                  (start_freq(c, s) for c, s in reversed(slices)))
    cap = sum(len(s) for _, s in slices) + N
    buf, cursor, states = _jax_chain(
        st_fr, jnp.full((1, N), jr.RANS_L, jnp.uint32),
        jnp.zeros((1, cap), jnp.int32))
    total = int(cursor[0])
    assert total == cursors[-1]
    assert blob == jr.pack_stream_packed(np.asarray(buf)[0][:total],
                                         np.asarray(states)[0])

    out, st, off, W = port_decode(blob, slices, N)
    for (_, syms), got in zip(slices, out):
        np.testing.assert_array_equal(got, syms)
    assert (st.numpy() == jr.RANS_L).all()
    assert off == W == total


@pytest.fixture(scope="module")
def tiny():
    """(port config, JAX params, the same as numpy arrays, a 32x40 image);
    the weights from torch_helpers."""
    params, np_params = torch_helpers.tiny_jax_params()
    return (ModelConfig(**TINY), params, np_params,
            synthetic_image(32, 40, seed=5))


def assert_lossless(codec, img):
    streams = codec.compress(img)
    out = codec.decompress(Codec.deserialize(Codec.serialize(streams)),
                           xorg=img)
    np.testing.assert_array_equal(out[0], img)
    assert codec.last_ycocg_err == 0
    return streams


@pytest.mark.parametrize("N", [2048, 20000])
def test_container_at_2048_lanes_matches_jax(tiny, N):
    """A container at N lanes (also above the 16384 the port once
    refused): lossless, JAX's header, its size within max(0.1 %, 16 B)."""
    cfg, params, np_params, img = tiny
    streams = assert_lossless(
        Codec(cfg, np_params, num_lanes=N, device="cpu"), img)
    jstreams = JaxCodec(JaxConfig(**TINY), params, num_lanes=N,
                        use_pallas_cdf=True).compress(img)
    assert streams[0] == jstreams[0]
    # N lane states of 4 bytes lead the blob
    assert len(streams[1][0]) > 4 * N
    assert size_close(Codec.num_bytes(streams), JaxCodec.num_bytes(jstreams))


@pytest.mark.parametrize("logistic", [False, True])
def test_float_cdf_tables_match_jax(logistic):
    """cdf_float_to_cum_int32(gmm_cdf_table(...)) of both packages on the
    same mixtures: entries equal or one step apart (exp and erfc differ by
    ulps between the frameworks), the mismatches counted; the encoder's
    (start, freq) as JAX's one-hot lookup gives them from one table."""
    rng = np.random.default_rng(7 + logistic)
    n, M = 2000, 5
    stdevs = rng.uniform(-0.01, 0.08, (n, M)).astype(np.float32)
    means = rng.uniform(-0.6, 0.6, (n, M)).astype(np.float32)
    weights = rng.uniform(-0.1, 1.0, (n, M)).astype(np.float32)
    worst, mism, size = 0, 0, 0
    for minv, maxv in [(-127, 128), (-64, 63), (-256, 255)]:
        pts = cdf_sampling_points(minv, maxv)
        got = cdf_float_to_cum_int32(gmm_cdf_table(
            pts, torch.from_numpy(stdevs), torch.from_numpy(means),
            torch.from_numpy(weights), logistic=logistic)).numpy()
        ref = np.array(jr.cdf_float_to_cum_int32(jgmm.gmm_cdf_table(
            jnp.asarray(pts.numpy()), jnp.asarray(stdevs), jnp.asarray(means),
            jnp.asarray(weights), logistic=logistic)))
        d = np.abs(got.astype(np.int64) - ref)
        worst, mism, size = max(worst, int(d.max())), mism + int(
            (d > 0).sum()), size + d.size
        assert (got[:, -1] == 1 << 16).all() and (np.diff(got) > 0).all()
        # start / freq at symbols, some outside [0, P - 2] (clipped)
        y = rng.uniform(minv - 3, maxv + 3, n).round().astype(np.float32)
        start, freq = cum_start_freq(torch.from_numpy(ref),
                                     torch.from_numpy(y / 255.0), minv)
        sym = np.clip(y.astype(np.int64) - minv, 0, ref.shape[1] - 2)
        i = np.arange(n)
        np.testing.assert_array_equal(start.numpy(), ref[i, sym])
        np.testing.assert_array_equal(freq.numpy(),
                                      ref[i, sym + 1] - ref[i, sym])
    print(f"float tables: {mism} of {size} entries one step apart")
    assert worst <= 1
    assert mism <= 5e-4 * size


def test_float_cdf_container_matches_jax(tiny):
    """Codec(use_kernel_cdf=False) against JAX's default codec: the same
    header, the size within max(0.1 %, 16 B); lossless, also through the
    batch container, two_stage and the resident closures."""
    cfg, params, np_params, img = tiny
    codec = Codec(cfg, np_params, num_lanes=64, device="cpu",
                  use_kernel_cdf=False)
    streams = assert_lossless(codec, img)
    jstreams = JaxCodec(JaxConfig(**TINY), params, num_lanes=64).compress(img)
    assert streams[0] == jstreams[0]
    assert size_close(Codec.num_bytes(streams), JaxCodec.num_bytes(jstreams))
    kernel = Codec(cfg, np_params, num_lanes=64, device="cpu").compress(img)
    assert Codec.serialize(kernel) != Codec.serialize(streams)

    imgs = [img, synthetic_image(32, 40, seed=6)]
    batch = codec.compress_batch(imgs)
    for a, b in zip(codec.decompress_batch(batch), imgs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(codec.prepare_decode(streams)()[0].numpy(),
                                  img)
    cursors, states, buf, _ = codec.prepare_encode(img)()
    total = int(cursors[0, -1])
    assert tr.pack_stream_packed(buf[0, :total].numpy(),
                                 states[0].numpy()) == streams[1][0]
    split = Codec(cfg, np_params, num_lanes=64, device="cpu",
                  use_kernel_cdf=False, two_stage=True)
    assert split.compress(img) == streams
    np.testing.assert_array_equal(split.decompress(streams)[0], img)
