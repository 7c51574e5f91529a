"""The port's rate estimation against the JAX package's: the mixture
functions, the host backend's uint16 CDF tables, the model's
self-information forward on every trained configuration, an est/act check
of the port alone, and the scoped exact-math flags.

Tolerances: the mixture functions rtol 1e-5 / atol 1e-6 (erfc and sigmoid
differ by ulps between the frameworks); the self-information maps rtol
1e-4 / atol 1e-3 bits, since a pmap difference of 1e-7 (the two
frameworks sum the conv products in other orders) moves a sharp
mixture's bits further than the pmap, and the per-slice sums within 1e-5
relative.  The JAX reference is ``model.apply`` run eagerly, as
``tests/test_rate_crosscheck.py`` runs it: the program ``jax.jit`` makes
of it moves single pixels of random-weight maps by bits, away from the
eager, the port's and a float64 value alike.
"""
import torch_helpers  # noqa: F401  (first: caps torch's threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llicti_tpu import codec as jcodec
from llicti_tpu.config import ModelConfig
from llicti_tpu.data.dataset import synthetic_image, synthetic_natural_image
from llicti_tpu.models.llicti import LLICTIModel as JaxModel
from llicti_tpu.ops import gmm as jgmm
from llicti_torch import Codec, load_npz
from llicti_torch import codec as tcodec
from llicti_torch.codec import exact_math
from llicti_torch.ops import gmm as tgmm
from llicti_torch.weights import init_params, params_from_flax
from test_torch_model import nested

# every configuration the JAX package trains, at tiny widths
FORWARD_CONFIGS = [
    {}, {"distribution": "logistic"}, {"clr_joint_mode": 1},
    {"clr_joint_mode": 0}, {"clr_joint_mode": 0, "clrjnt0seqmd": True},
    {"subtract_mean": True}, {"clrchs": 0}, {"clrchs": 2}, {"ycocg": False},
    {"activfun": "GDN1"}, {"combine_layers1toL": True}]


def small_cfg(**kw):
    base = dict(chs=(8, 8), evens=(4, 4), odds=(3, 3), dwtlevels=(0, 1),
                useprevlevNN=(False, True))
    base.update(kw)
    return ModelConfig(**base)


def mixture_inputs(seed, shape, X):
    """y, scales (a share below both bounds), means, weights (some
    negative) of a mixture of X per value."""
    rng = np.random.default_rng(seed)
    y = (rng.integers(-60, 61, shape) / 255).astype(np.float32)
    scales = rng.uniform(-0.01, 0.1, shape[:-1] + (shape[-1] * X,))
    means = rng.uniform(-0.25, 0.25, scales.shape)
    weights = rng.uniform(-0.2, 1.0, scales.shape)
    return [a.astype(np.float32) for a in (y, scales, means, weights)]


@pytest.mark.parametrize("logistic", [False, True])
def test_self_information_matches_jax(logistic):
    y, s, m, w = mixture_inputs(1, (4, 64, 3), 5)
    ref = np.asarray(jgmm.gmm_self_information(
        *map(jnp.asarray, (y, s, m, w)), 5, logistic=logistic))
    got = tgmm.gmm_self_information(*map(torch.from_numpy, (y, s, m, w)), 5,
                                    logistic=logistic).numpy()
    assert got.shape == ref.shape == (4, 64, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("logistic", [False, True])
def test_cdf_table_matches_jax(logistic):
    _, s, m, w = mixture_inputs(2, (3, 50, 1), 5)
    pts = tgmm.cdf_sampling_points(-63, 64)
    ref = np.asarray(jgmm.gmm_cdf_table(jnp.asarray(pts.numpy()),
                                        *map(jnp.asarray, (s, m, w)),
                                        logistic=logistic))
    got = tgmm.gmm_cdf_table(pts, *map(torch.from_numpy, (s, m, w)),
                             logistic=logistic).numpy()
    assert got.shape == ref.shape == (3, 50, 129)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_cdf_float_to_uint16_exact():
    """Equal to JAX's on one float input: rounding ties, values outside
    [0, 1], one-ulp dips (the running max) and the mod-2^16 wrap."""
    rng = np.random.default_rng(3)
    P = 97
    cdf = np.sort(rng.uniform(-0.01, 1.01, (200, P)), axis=-1)
    new_max = 2 ** 16 - (P - 1)
    cdf[:20] = (rng.integers(0, new_max, (20, P)) + 0.5) / new_max  # ties
    cdf[20:40, 1::2] = np.nextafter(cdf[20:40, 0::2][:, :48], -1)  # dips
    cdf = cdf.astype(np.float32)
    ref = np.asarray(jgmm.cdf_float_to_uint16(jnp.asarray(cdf)))
    got = tgmm.cdf_float_to_uint16(torch.from_numpy(cdf))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("trained", [True, False],
                         ids=["flagship-trained", "logistic-random"])
def test_host_tables_match_jax(trained):
    """The [1, h, w, P] uint16 tables of the finest scale's nine slices,
    from the same pmaps and sampling grids through each package's
    _cdf_u16: at most one step apart, in at most 0.1 % of the entries
    (each framework's erfc / exp differ by ulps).  The trained flagship
    on a 32x48 crop, and random weights of the logistic mixture."""
    if trained:
        cfg, flat = ModelConfig(), load_npz()
        img = synthetic_image(512, 768, seed=42)[:32, :48]
    else:
        cfg = small_cfg(distribution="logistic")
        flat, img = init_params(cfg, 0), synthetic_image(32, 48, seed=5)
    jax_codec = jcodec.Codec(cfg, nested(flat), backend="host", num_lanes=32)
    port = Codec(cfg, flat, device="cpu", backend="host")
    minmax, _ = tcodec.host_header(img[None], cfg.dwtlevels)
    y_lev = port._front(torch.from_numpy(np.ascontiguousarray(img[None])))[0]
    h, w = y_lev.shape[1:3]
    mism = total = 0
    for b in range(3):
        with torch.inference_mode():
            pm = port.model.band_params(
                y_lev[..., :3 * (b + 1)].contiguous(), 0, b)
        for clr in range(3):
            pts = tgmm.cdf_sampling_points(*tcodec.clr_range(clr, minmax))
            ref = np.asarray(jax_codec._cdf_u16(
                jnp.asarray(pm.numpy()), jnp.asarray(y_lev.numpy()),
                jnp.asarray(pts.numpy()), b, clr))
            got = port._cdf_u16(pm.reshape(h * w, -1),
                                y_lev.reshape(h * w, -1), pts, b, clr)
            got = got.numpy().reshape(ref.shape)
            diff = np.abs(got.astype(np.int64) - ref.astype(np.int64))
            diff = np.minimum(diff, 65536 - diff)  # the last entry wraps
            assert diff.max() <= 1
            print(f"b={b} clr={clr} P={ref.shape[-1]}: "
                  f"{int((diff > 0).sum())} of {diff.size} entries differ")
            mism += int((diff > 0).sum())
            total += diff.size
    print(f"all nine tables: {mism} of {total} entries differ")
    assert mism <= 0.001 * total


def forward_maps(cfg, params, img_f32):
    """(JAX's eager self-information maps, the port's), finest first."""
    ref = [np.asarray(s) for s in JaxModel(cfg=cfg).apply(
        params, jnp.asarray(img_f32))]
    with torch.inference_mode():
        got = [s.numpy() for s in params_from_flax(params, cfg)(
            torch.from_numpy(img_f32))]
    return ref, got


def assert_maps_match(ref, got, label):
    assert [g.shape for g in got] == [r.shape for r in ref]
    dev = max(float(np.abs(g - r).max()) for g, r in zip(got, ref))
    rel = max(float(np.abs(g.sum((0, 1, 2)) - r.sum((0, 1, 2))).max()
                    / np.abs(r.sum((0, 1, 2))).max())
              for g, r in zip(got, ref))
    print(f"{label}: largest map deviation {dev:.3g} bits, per-slice sums "
          f"{rel:.3g} relative")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(g.sum((0, 1, 2)), r.sum((0, 1, 2)),
                                   rtol=1e-5)


@pytest.mark.parametrize("kw", FORWARD_CONFIGS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "flagship-family")
def test_forward_matches_jax(kw):
    cfg = small_cfg(**kw)
    img = synthetic_natural_image(32, 32, seed=3)[None].astype(
        np.float32) / 255.0
    ref, got = forward_maps(cfg, nested(init_params(cfg, 1)), img)
    channels = 9 if cfg.clrchs == 3 else 3
    assert got[0].shape == (1, 16, 16, channels)
    assert all(np.isfinite(g).all() and (g > -1e-4).all() for g in got)
    assert_maps_match(ref, got, str(kw))


def test_flagship_crop_forward_matches_jax():
    """The trained flagship weights on a 64x64 crop (5 scales)."""
    img = np.ascontiguousarray(synthetic_image(512, 768, seed=42)[:64, :64])
    ref, got = forward_maps(ModelConfig(), nested(load_npz()),
                            img[None].astype(np.float32) / 255.0)
    assert [g.shape[1] for g in got] == [32, 16, 8, 4, 2]
    assert_maps_match(ref, got, "flagship 64x64")


@pytest.mark.parametrize("backend", ["device", "host"])
def test_estimate_bounds_port_codec(backend):
    """The port's estimate against the port codec's bits per (scale, band,
    colour), with JAX's efficiency bound
    (``tests/test_rate_crosscheck.py:71``): the coder may beat the
    estimate, never spend more than 2 % + 1536 bits above it."""
    cfg = small_cfg(chs=(8, 1))
    flat = init_params(cfg, 3)
    img = synthetic_natural_image(96, 64, seed=7)
    model = params_from_flax(nested(flat), cfg)
    with torch.inference_mode():
        si = model(torch.from_numpy(img[None].astype(np.float32) / 255.0))
    est = np.stack([s.sum(dim=(0, 1, 2)).numpy() for s in si])
    codec = Codec(cfg, flat, device="cpu", num_lanes=64, backend=backend)
    codec.compress(img)
    act = np.asarray(codec.last_slice_bits, dtype=np.float64)[::-1]
    assert est.shape == act.shape == (2, 9)
    print(f"{backend}: estimate {est.sum():.0f} bits, coded {act.sum():.0f}")
    assert (act <= 1.02 * est + 1536).all()
    assert act.sum() < est.sum()  # random weights: out-of-range mass


FLAGS = ("cudnn.enabled", "cudnn.allow_tf32", "cuda.matmul.allow_tf32",
         "cudnn.benchmark", "cudnn.deterministic")


def read_flags():
    b = torch.backends
    return (b.cudnn.enabled, b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
            b.cudnn.benchmark, b.cudnn.deterministic)


def set_flags(values):
    b = torch.backends
    (b.cudnn.enabled, b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
     b.cudnn.benchmark, b.cudnn.deterministic) = values


@pytest.mark.parametrize("values", [(True, True, True, True, False),
                                    (False, False, False, False, True),
                                    (True, True, False, True, True)])
def test_exact_math_restores_caller_flags(values):
    saved = read_flags()
    try:
        set_flags(values)
        with exact_math():
            assert read_flags() == (True, False, False, False, True)
        assert read_flags() == values
        with pytest.raises(KeyError):
            with exact_math():
                raise KeyError("inside the pass")
        assert read_flags() == values
        # a codec pass, and a closure call, leave them as they were
        cfg = small_cfg()
        codec = Codec(cfg, init_params(cfg, 0), device="cpu", num_lanes=16)
        img = synthetic_image(17, 19, seed=5)
        streams = codec.compress(img)
        assert read_flags() == values
        codec.prepare_decode(streams)()
        assert read_flags() == values
        assert np.array_equal(codec.decompress(streams)[0], img)
        assert read_flags() == values
    finally:
        set_flags(saved)
