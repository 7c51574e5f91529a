"""Kernel 1's plain PyTorch version against the JAX package's Pallas
from-pmap CDF kernel (run in interpret mode on the CPU, as its own tests
run it), for clr_joint_mode 2 at every (band, colour).

Tolerance: one quantisation step per table entry.  The two evaluate the
same A&S erf polynomial in float32 with different exp implementations, so
an entry that lands within an ulp of a rounding tie can round the other
way; such entries are counted and must stay rare.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llicti_tpu import codec as jcodec
from llicti_tpu.config import ModelConfig
from llicti_tpu.ops.cdf_pallas import gmm_cdf_from_pmap_pallas
from llicti_tpu.ops.gmm import cdf_sampling_points
from llicti_torch import codec as tcodec
from llicti_torch.ops.cdf import gmm_cdf_from_pmap

CFG = ModelConfig()
N_PIX = 256


def make_inputs(seed, minv, maxv):
    """A [n, 60] pmap with GMM-like columns and a [n, 12] y on the
    symbol grid of the range."""
    rng = np.random.default_rng(seed)
    pm = np.empty((N_PIX, 60), np.float32)
    pm[:, 0:15] = rng.uniform(-0.01, 0.08, (N_PIX, 15))    # std (some < bound)
    pm[:, 15:30] = rng.uniform(minv, maxv, (N_PIX, 15)) / 255
    pm[:, 30:45] = rng.uniform(-0.2, 1.0, (N_PIX, 15))     # weights
    pm[:, 45:60] = rng.uniform(-1.0, 1.0, (N_PIX, 15))     # a, b, d coefs
    y = (rng.integers(minv, maxv + 1, (N_PIX, 12)) / 255).astype(np.float32)
    return pm, y


@pytest.mark.parametrize("minv,maxv", [(-63, 64), (-127, 128)])
@pytest.mark.parametrize("b", [0, 1, 2])
def test_plain_cdf_matches_pallas(b, minv, maxv):
    pts = cdf_sampling_points(minv, maxv)
    P = pts.shape[0]
    pm, y = make_inputs(100 * b + maxv, minv, maxv)
    for clr in range(3):
        spec = jcodec.pmap_cdf_spec(CFG, b, clr)
        assert tcodec.pmap_cdf_spec(CFG, b, clr) == spec
        sch = jcodec.sym_channel(CFG, b, clr)
        assert tcodec.sym_channel(CFG, b, clr) == sch
        M, s0, m0, w0, upd = spec
        jcum, _, _ = gmm_cdf_from_pmap_pallas(
            pts, jnp.asarray(pm), jnp.asarray(y), M, s0, m0, w0, upd, False,
            sch, minv)
        cum, start, freq = gmm_cdf_from_pmap(
            torch.from_numpy(np.array(pts)), torch.from_numpy(pm),
            torch.from_numpy(y), M, s0, m0, w0, upd, sch, minv)
        cum = cum.numpy()
        jcum = np.asarray(jcum)
        assert cum.shape == jcum.shape == (N_PIX, P)
        diff = np.abs(cum.astype(np.int64) - jcum)
        mism = int((diff > 0).sum())
        print(f"b={b} clr={clr} P={P}: {mism} of {diff.size} entries "
              f"differ by one step")
        assert diff.max() <= 1
        assert mism <= 0.002 * diff.size
        assert (cum[:, -1] == 1 << 16).all()
        assert (np.diff(cum, axis=1) > 0).all()
        # (start, freq) are lookups into the port's own table
        sym = np.clip(np.round(y[:, sch] * np.float32(255)).astype(np.int64)
                      - minv, 0, P - 2)
        lo = np.take_along_axis(cum, sym[:, None], 1)[:, 0]
        hi = np.take_along_axis(cum, sym[:, None] + 1, 1)[:, 0]
        np.testing.assert_array_equal(start.numpy(), lo)
        np.testing.assert_array_equal(freq.numpy(), hi - lo)


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
