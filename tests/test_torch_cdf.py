"""Kernels 1 and 4's plain PyTorch versions against the JAX package's
Pallas CDF kernels (run in interpret mode on the CPU, as its own tests run
them): Kernel 1 for clr_joint_mode 0, 1 and 2 at every (band, colour),
normal and logistic; Kernel 4 on pre-sliced parameters.

Tolerance: one quantisation step per table entry, at most 0.2 % of the
entries.  The two evaluate the same float32 formulas (the A&S erf
polynomial; the sigmoid as 1 / (1 + exp(-z))) with different exp
implementations, so an entry that lands within an ulp of a rounding tie
can round the other way; such entries are counted and must stay rare.
"""
import torch_helpers  # noqa: F401  (first: caps torch's threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llicti_tpu import codec as jcodec
from llicti_tpu.config import ModelConfig
from llicti_tpu.models.interpolator import interpolator_dims
from llicti_tpu.ops.cdf_pallas import (gmm_cdf_from_pmap_pallas,
                                       gmm_cdf_table_int32_pallas)
from llicti_tpu.ops.gmm import cdf_sampling_points
from llicti_torch import codec as tcodec
from llicti_torch.ops.cdf import gmm_cdf_from_pmap, gmm_cdf_table_int32

N_PIX = 256


def make_inputs(cfg, seed, minv, maxv):
    """A [n, Co] pmap of ``cfg``'s layout with GMM-like columns (some
    scales below the bound) and a [n, 4c] y on the symbol grid of the
    range."""
    logistic = cfg.distribution == "logistic"
    Co = interpolator_dims(cfg, 0)[2]
    rng = np.random.default_rng(seed)
    pm = rng.uniform(-1.0, 1.0, (N_PIX, Co)).astype(np.float32)  # coefs
    for b in range(3):
        for clr in range(3):
            M, s0, m0, w0, _ = jcodec.pmap_cdf_spec(cfg, b, clr)
            pm[:, s0:s0 + M] = rng.uniform(
                -0.01, 0.15 if logistic else 0.08, (N_PIX, M))
            pm[:, m0:m0 + M] = rng.uniform(minv, maxv, (N_PIX, M)) / 255
            pm[:, w0:w0 + M] = rng.uniform(-0.2, 1.0, (N_PIX, M))
    y = (rng.integers(minv, maxv + 1, (N_PIX, 4 * cfg.cond_channels))
         / 255).astype(np.float32)
    return pm, y


def assert_tables_close(cum, jcum, label):
    assert cum.shape == jcum.shape
    diff = np.abs(cum.astype(np.int64) - jcum)
    mism = int((diff > 0).sum())
    print(f"{label}: {mism} of {diff.size} entries differ by one step")
    assert diff.max() <= 1
    assert mism <= 0.002 * diff.size
    assert (cum[..., -1] == 1 << 16).all()
    assert (np.diff(cum, axis=-1) > 0).all()


def _case(mode, logistic, minv, maxv):
    kind = f"clrjnt{mode}-logistic-" if logistic else (
        "" if mode == 2 else f"clrjnt{mode}-")
    return pytest.param(mode, logistic, minv, maxv,
                        id=f"{kind}{minv}-{maxv}")


@pytest.mark.parametrize("mode,logistic,minv,maxv", [
    _case(2, False, -63, 64), _case(2, False, -127, 128),
    _case(2, True, -63, 64), _case(1, False, -127, 128),
    _case(1, True, -63, 64), _case(0, True, -127, 128)])
@pytest.mark.parametrize("b", [0, 1, 2])
def test_plain_cdf_matches_pallas(b, mode, logistic, minv, maxv):
    cfg = ModelConfig(clr_joint_mode=mode,
                      distribution="logistic" if logistic else "normal")
    pts = cdf_sampling_points(minv, maxv)
    P = pts.shape[0]
    pm, y = make_inputs(cfg, 100 * b + maxv + 7 * mode, minv, maxv)
    for clr in range(3):
        spec = jcodec.pmap_cdf_spec(cfg, b, clr)
        assert tcodec.pmap_cdf_spec(cfg, b, clr) == spec
        sch = jcodec.sym_channel(cfg, b, clr)
        assert tcodec.sym_channel(cfg, b, clr) == sch
        M, s0, m0, w0, upd = spec
        jcum, _, _ = gmm_cdf_from_pmap_pallas(
            pts, jnp.asarray(pm), jnp.asarray(y), M, s0, m0, w0, upd,
            logistic, sch, minv)
        cum, start, freq = gmm_cdf_from_pmap(
            torch.from_numpy(np.array(pts)), torch.from_numpy(pm),
            torch.from_numpy(y), M, s0, m0, w0, upd, logistic, sch, minv)
        cum = cum.numpy()
        assert cum.shape == (N_PIX, P)
        assert_tables_close(cum, np.asarray(jcum),
                            f"mode={mode} logistic={logistic} b={b} "
                            f"clr={clr} M={M} P={P}")
        # (start, freq) are lookups into the port's own table
        sym = np.clip(np.round(y[:, sch] * np.float32(255)).astype(np.int64)
                      - minv, 0, P - 2)
        lo = np.take_along_axis(cum, sym[:, None], 1)[:, 0]
        hi = np.take_along_axis(cum, sym[:, None] + 1, 1)[:, 0]
        np.testing.assert_array_equal(start.numpy(), lo)
        np.testing.assert_array_equal(freq.numpy(), hi - lo)


@pytest.mark.parametrize("X,minv,maxv", [(5, -127, 128), (10, -256, 255)])
def test_plain_table_matches_pallas(X, minv, maxv):
    """Kernel 4 (gmm_cdf_table_int32) on pre-sliced [..., X] parameters."""
    rng = np.random.default_rng(X)
    shape = (1, 6, 11, X)  # 66 pixels: the Pallas grid pads the last block
    std = rng.uniform(-0.01, 0.08, shape).astype(np.float32)
    mean = (rng.uniform(minv, maxv, shape) / 255).astype(np.float32)
    w = rng.uniform(-0.2, 1.0, shape).astype(np.float32)
    pts = cdf_sampling_points(minv, maxv)
    jcum = np.asarray(gmm_cdf_table_int32_pallas(
        pts, jnp.asarray(std), jnp.asarray(mean), jnp.asarray(w), 64))
    cum = gmm_cdf_table_int32(torch.from_numpy(np.array(pts)),
                              torch.from_numpy(std), torch.from_numpy(mean),
                              torch.from_numpy(w)).numpy()
    assert cum.shape == shape[:-1] + (pts.shape[0],) and cum.dtype == np.int32
    assert_tables_close(cum, jcum, f"table X={X} P={pts.shape[0]}")


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_gmm_slice_params_equal_jax(mode):
    cfg = ModelConfig(clr_joint_mode=mode)
    pm, y = make_inputs(cfg, mode, -127, 128)
    pm, y = pm.reshape(1, 16, 16, -1), y.reshape(1, 16, 16, -1)
    for b in range(3):
        for clr in range(3):
            ref = jcodec.gmm_slice_params(cfg, jnp.asarray(pm),
                                          jnp.asarray(y), b, clr)
            got = tcodec.gmm_slice_params(cfg, torch.from_numpy(pm),
                                          torch.from_numpy(y), b, clr)
            for r, g in zip(ref, got):
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_column_spec_matches_jax_all_modes():
    for mode in (0, 1, 2):
        cfg = ModelConfig(clr_joint_mode=mode)
        for b in range(3):
            for clr in range(3):
                assert tcodec.pmap_cdf_spec(cfg, b, clr) == \
                    jcodec.pmap_cdf_spec(cfg, b, clr)
                assert tcodec.sym_channel(cfg, b, clr) == \
                    jcodec.sym_channel(cfg, b, clr)


def test_cdf_wrapper_rejects_bad_input():
    pts = torch.linspace(-0.5, 0.5, 9)
    pm = torch.zeros((4, 60))
    y = torch.zeros((4, 12))
    sd = torch.ones((4, 5))
    with pytest.raises(ValueError):
        gmm_cdf_table_int32(pts, sd, sd, sd[:3])
    with pytest.raises(ValueError):
        gmm_cdf_table_int32(pts, sd.double(), sd, sd)
    with pytest.raises(ValueError):
        gmm_cdf_table_int32(pts[:1], sd, sd, sd)
    with pytest.raises(ValueError):
        gmm_cdf_from_pmap(pts, pm.double(), y, 5, 0, 15, 30)
    with pytest.raises(ValueError):
        gmm_cdf_from_pmap(pts, pm[:, :20], y, 5, 0, 15, 30)
    with pytest.raises(ValueError):
        gmm_cdf_from_pmap(pts, pm, y[:3], 5, 0, 15, 30)
    with pytest.raises(ValueError):
        gmm_cdf_from_pmap(pts, pm, y, 5, 0, 15, 30, sym_ch=12)
    with pytest.raises(ValueError):
        gmm_cdf_from_pmap(pts, pm.t().contiguous().t(), y, 5, 0, 15, 30)
