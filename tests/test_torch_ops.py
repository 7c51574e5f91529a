"""PyTorch port vs JAX package: integer colour transform, lazy wavelet,
pad flags and the CDF sampling grid.  Every integer stage and every copy
must be exact."""
import torch_helpers  # noqa: F401  (first: caps torch's threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llicti_tpu import codec as jcodec
from llicti_tpu.ops import color as jcolor
from llicti_tpu.ops import gmm as jgmm
from llicti_tpu.ops import wavelet as jwav
from llicti_torch import codec as tcodec
from llicti_torch.ops import color as tcolor
from llicti_torch.ops import gmm as tgmm
from llicti_torch.ops import wavelet as twav

SIZES = [(17, 19), (18, 24), (33, 32), (30, 31), (64, 96), (310, 598)]
LEVELS = (0, 1, 2, 3, 4)


def rand_img(h, w, seed=0):
    return np.random.default_rng(seed + 7 * h + w).integers(
        0, 256, (1, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("h,w", SIZES)
def test_color_exact(h, w):
    img = rand_img(h, w)
    j = np.asarray(jcolor.rgb_int_to_ycocg_r_int(jnp.asarray(img)))
    t = tcolor.rgb_int_to_ycocg_r_int(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tcolor.rgb_int_to_ycocg_r_int_np(img), j)
    back_j = np.asarray(jcolor.ycocg_r_int_to_rgb_int(jnp.asarray(j)))
    back_t = tcolor.ycocg_r_int_to_rgb_int(torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(back_t, back_j)
    np.testing.assert_array_equal(back_t, img.astype(np.int32))


@pytest.mark.parametrize("h,w", SIZES)
def test_lazy_dwt_and_interleave_exact(h, w):
    img = rand_img(h, w, seed=1)
    ycocg = jcolor.rgb_int_to_ycocg_r_int_np(img)
    x = ((ycocg - np.array([127, 0, 0], np.int32)).astype(np.float32)
         * np.float32(1 / 255))
    jy, jflags, jint = jwav.lazy_dwt(jnp.asarray(x), LEVELS, pad=True)
    ty, tflags, tint = twav.lazy_dwt(torch.from_numpy(x), LEVELS, pad=True)
    assert tflags == [(bool(a), bool(b)) for a, b in jflags]
    assert tint == jint
    assert tcodec.pad_flags_for_shape(h, w, LEVELS) == \
        jcodec.pad_flags_for_shape(h, w, LEVELS)
    assert twav.unpack_pad_flags(tint, len(LEVELS)) == \
        jwav.unpack_pad_flags(jint, len(LEVELS))
    for a, b in zip(jy, ty):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for lev, (ya, yb) in enumerate(zip(jy, ty)):
        ch, cw = (int(v) for v in jflags[lev])
        np.testing.assert_array_equal(
            twav.interleave_scale(yb, 3, ch, cw).numpy(),
            np.asarray(jwav.interleave_scale(ya, 3, ch, cw)))
    # the finest scale interleaves back to the image
    ch, cw = (int(v) for v in jflags[0])
    np.testing.assert_array_equal(
        twav.interleave_scale(ty[0], 3, ch, cw).numpy(), x)


@pytest.mark.parametrize("padH", [False, True])
@pytest.mark.parametrize("padW", [False, True])
def test_pad_decoded_band_and_coded_shape_exact(padH, padW):
    band_in = np.random.default_rng(3).uniform(
        -1, 1, (1, 5, 7, 1)).astype(np.float32)
    for band in range(3):
        ch, cw = twav.band_coded_shape(6, 8, band, padH, padW)
        assert (ch, cw) == jwav.band_coded_shape(6, 8, band, padH, padW)
        x = band_in[:, :ch, :cw]
        np.testing.assert_array_equal(
            twav.pad_decoded_band(torch.from_numpy(x), band, padH,
                                  padW).numpy(),
            np.asarray(jwav.pad_decoded_band(jnp.asarray(x), band, padH,
                                             padW)))


def test_bucket_and_colour_range():
    for lo, hi in [(-5, 10), (0, 0), (-255, 255), (-32, 31), (-97, 3)]:
        assert tcodec.bucket_range(lo, hi) == jcodec.bucket_range(lo, hi)
    for minmax in ([3, -200, -17, 250, 31, 96], [0, -255, -255, 255, 255,
                                                 255], [100, 0, 0, 140, 3, 5]):
        for clr in range(3):
            assert tcodec.clr_range(clr, minmax) == \
                jcodec.Codec._clr_range(None, clr, minmax)


@pytest.mark.parametrize("lo,hi", [(-63, 64), (-127, 128), (-256, 255),
                                   (-127, 31), (-32, 95), (0, 63)])
def test_cdf_sampling_points(lo, hi):
    """Endpoints exact; interior points within two ulps of the grid's
    largest magnitude (XLA reassociates and contracts jnp.linspace)."""
    j = np.asarray(jgmm.cdf_sampling_points(lo, hi))
    t = tgmm.cdf_sampling_points(lo, hi).numpy()
    assert t.dtype == np.float32 and t.shape == j.shape == (hi - lo + 2,)
    assert t[0] == j[0] and t[-1] == j[-1]
    ulp = np.spacing(np.float32(max(abs(lo - 0.5), abs(hi + 0.5)))) / 255
    ulp *= 2
    np.testing.assert_allclose(t, j, rtol=0, atol=ulp)
    assert (np.diff(t) > 0).all()
