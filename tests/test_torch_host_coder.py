"""The host backend of the port against the JAX package's: the range
coder byte for byte on the same uint16 inputs (mirroring
``tests/test_coder.py``), and host containers on tiny configurations.

A host container's streams[0] must equal JAX's byte for byte; its range
streams differ only where a float CDF entry rounds the other way, so the
total size must agree within max(0.1 %, 16 bytes).
"""
import torch_helpers  # noqa: F401  (first: caps torch's threads)
import numpy as np
import pytest

from llicti_tpu import coder as jcoder
from llicti_tpu.codec import Codec as JaxCodec
from llicti_tpu.config import ModelConfig
from llicti_tpu.data.dataset import synthetic_image
from llicti_torch import Codec
from llicti_torch.coder import range_coder as rc
from llicti_torch.codec import parse_container
from llicti_torch.weights import init_params
from test_torch_model import nested


def random_cdfs(rng, n, Lp, concentrated=False):
    """Random uint16 CDF rows of the coder's contract (test_coder.py)."""
    alphas = np.full(Lp - 1, 0.05 if concentrated else 1.0)
    if concentrated:
        alphas[rng.integers(0, Lp - 1, size=3)] = 10.0
    p = rng.dirichlet(alphas, size=n)
    cdf_f = np.concatenate([np.zeros((n, 1)), np.cumsum(p, axis=-1)], -1)
    cdf_f = np.clip(cdf_f, 0.0, 1.0)
    cdf_f[:, -1] = 1.0
    q = np.round(cdf_f * (2 ** 16 - (Lp - 1))).astype(np.int64)
    return ((q + np.arange(Lp)) % 2 ** 16).astype(np.uint16)


def likely_symbols(rng, cdf):
    """Symbols drawn from each row's own distribution."""
    c = cdf.astype(np.int64)
    c[:, -1] = 2 ** 16
    u = rng.integers(0, 2 ** 16, size=cdf.shape[0])
    return (np.sum(c[:, :-1] <= u[:, None], axis=-1) - 1).astype(np.int16)


def coder_case(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "empty":
        return random_cdfs(rng, 0, 257), np.zeros(0, np.int16)
    if kind == "single":
        return random_cdfs(rng, 1, 257), np.array([100], np.int16)
    if kind == "concentrated":
        cdf = random_cdfs(rng, 20000, 257, concentrated=True)
        return cdf, likely_symbols(rng, cdf)
    if kind == "extreme":  # first and last symbols of peaky rows
        cdf = random_cdfs(rng, 512, 512, concentrated=True)
        syms = np.zeros(512, np.int16)
        syms[::2] = 510
        return cdf, syms
    Lp, n = {"random-257": (257, 1000), "random-17": (17, 4096),
             "random-2": (2, 100)}[kind]
    cdf = random_cdfs(rng, n, Lp)
    return cdf, rng.integers(0, Lp - 1, size=n).astype(np.int16)


@pytest.mark.parametrize("kind", ["random-257", "random-17", "random-2",
                                  "concentrated", "extreme", "empty",
                                  "single"])
def test_range_coder_bytes_equal_jax(kind):
    cdf, syms = coder_case(kind)
    n = syms.size
    data = rc.encode_cdf(cdf, syms)
    assert data == jcoder.encode_cdf(cdf, syms)
    lo = cdf[np.arange(n), syms]
    hi = cdf[np.arange(n), syms + 1]
    assert rc.encode_lohi(lo, hi) == data == jcoder.encode_lohi(lo, hi)
    np.testing.assert_array_equal(rc.decode_cdf(cdf, data), syms)
    if n:
        row = cdf[0]
        shared = rc.encode_cdf(np.broadcast_to(row, cdf.shape).copy(), syms)
        np.testing.assert_array_equal(rc.decode_shared_cdf(row, n, shared),
                                      syms)


def test_range_coder_rejects_bad_input():
    cdf = random_cdfs(np.random.default_rng(0), 4, 9)
    with pytest.raises(ValueError):
        rc.encode_cdf(cdf, np.array([0, 8, 1, 2], np.int16))  # 8 > Lp - 2
    with pytest.raises(ValueError):
        rc.encode_cdf(cdf, np.zeros(3, np.int16))
    with pytest.raises(ValueError):
        rc.encode_lohi(np.zeros(3, np.uint16), np.ones(2, np.uint16))
    with pytest.raises(ValueError):
        rc.decode_cdf(cdf, b"\0" * 8, n=5)


def small_cfg(**kw):
    return ModelConfig(chs=(8, 8), evens=(4, 4), odds=(3, 3),
                       dwtlevels=(0, 1), useprevlevNN=(False, True), **kw)


@pytest.fixture(scope="module")
def codecs():
    cfg = small_cfg()
    flat = init_params(cfg, 0)
    return (Codec(cfg, flat, device="cpu", num_lanes=32, backend="host",
                  num_threads=3),
            JaxCodec(cfg, nested(flat), backend="host", num_lanes=32),
            Codec(cfg, flat, device="cpu", num_lanes=32))


@pytest.mark.parametrize("h,w", [(32, 32), (17, 19), (30, 31)])
def test_host_container_roundtrip_and_matches_jax(codecs, h, w):
    port, ref, _ = codecs
    img = synthetic_image(h, w, seed=h * w)
    streams = port.compress(img)
    assert len(streams) == 3 and [len(g) for g in streams[1:]] == [9, 9]
    assert port.last_slice_bits == [[8 * len(s) for s in g]
                                    for g in streams[1:]]
    out = port.decompress(Codec.deserialize(Codec.serialize(streams)),
                          xorg=img)
    np.testing.assert_array_equal(out[0], img)
    assert port.last_ycocg_err == 0
    jstreams = ref.compress(img)
    assert streams[0] == jstreams[0]  # 13-byte header, minmax, pad, raw
    nb, jnb = Codec.num_bytes(streams), JaxCodec.num_bytes(jstreams)
    print(f"{h}x{w} host container: port {nb} bytes, JAX {jnb} bytes")
    assert abs(nb - jnb) <= max(0.001 * jnb, 16)


def test_serving_calls_take_host_containers(codecs):
    """decompress_many (mixed with a device container) and
    decompress_dispatch decode host containers; compress_many and
    prepare_encode code with the device coder, as in the JAX package."""
    port, _, device = codecs
    imgs = [synthetic_image(17, 19, seed=1), synthetic_image(30, 31, seed=2)]
    host = port.compress(imgs[0])
    many = port.compress_many(imgs)
    assert many == device.compress_many(imgs)
    assert len(many[0]) == 2 and len(many[0][1]) == 1
    outs = port.decompress_many([host, many[1]])
    for img, out in zip(imgs, outs):
        np.testing.assert_array_equal(out[0], img)
    rgb, oh, ow = device.decompress_dispatch(host)
    assert (oh, ow) == (17, 19)
    np.testing.assert_array_equal(rgb.numpy()[0, :oh, :ow], imgs[0])
    cursors, states, buf, _ = port.prepare_encode(imgs[1])()
    assert int(cursors[0, -1]) * 16 == sum(
        sum(r) for r in device.last_slice_bits_batch[1])


def test_host_backend_refusals(codecs):
    port, _, _ = codecs
    img = synthetic_image(17, 19, seed=4)
    streams = port.compress(img)
    with pytest.raises(ValueError):
        port.prepare_decode(streams)
    with pytest.raises(ValueError):
        port.compress_batch([img])
    with pytest.raises(ValueError):  # a stream missing from a group
        parse_container([streams[0], streams[1][:8], streams[2]], (0, 1))
    flat = {}
    for bad in [dict(cfg=small_cfg(clr_joint_mode=0, clrjnt0seqmd=True)),
                dict(cfg=small_cfg(), two_stage=True),
                dict(cfg=small_cfg(), backend="torchac"),
                dict(cfg=small_cfg(), num_threads=0)]:
        kw = {"device": "cpu", "backend": "host", **bad}
        with pytest.raises(ValueError):
            Codec(params=flat, **kw)
