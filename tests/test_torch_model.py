"""The port's interpolator model against the JAX package's, with the same
weights carried over by ``params_from_flax``.

Tolerance for the float32 parameter maps: rtol = atol = 1e-5, since the
two frameworks sum the conv products in different orders.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llicti_tpu.config import ModelConfig
from llicti_tpu.models.llicti import LLICTIModel as JaxModel
from llicti_torch.models.llicti import LLICTIModel
from llicti_torch.weights import (BENCH_PARAMS, flat_params, load_npz,
                                  params_from_flax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_cfg(**kw):
    base = dict(chs=(8, 8), evens=(4, 4), odds=(3, 3), dwtlevels=(0, 1),
                useprevlevNN=(False, True))
    base.update(kw)
    return ModelConfig(**base)


def jax_params(cfg, seed=0):
    model = JaxModel(cfg=cfg)
    return jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3))))


def assert_pmaps_match(cfg, params, shape=(1, 8, 12)):
    jm = JaxModel(cfg=cfg)
    tm = params_from_flax(params, cfg)
    c = cfg.cond_channels
    y = np.random.default_rng(1).uniform(
        -0.4, 0.4, shape + (4 * c,)).astype(np.float32)
    for scl in range(cfg.num_scales):
        for b in range(3):
            yc = y[..., :c * (b + 1)]
            ref = np.asarray(jm.apply(params, jnp.asarray(yc), scl, b,
                                      method=JaxModel.band_params))
            with torch.inference_mode():
                got = tm.band_params(torch.from_numpy(yc), scl, b).numpy()
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_flagship_param_count():
    n = sum(p.numel() for p in LLICTIModel(ModelConfig()).parameters())
    assert n == 196596


@pytest.mark.parametrize("activ,shared,extra", [
    ("ReLU", True, {}), ("LeakyReLU", False, {}),
    ("PReLU", False, {"conv_layers": 4}),
    ("ReLU", True, {"clr_joint_mode": 0}),
    ("ReLU", False, {"clr_joint_mode": 1}),
    ("ReLU", True, {"clrchs": 1, "chs": (8, 8)})])
def test_pmap_matches_jax_random_weights(activ, shared, extra):
    cfg = small_cfg(activfun=activ, useprevlevNN=(False, shared), **extra)
    assert_pmaps_match(cfg, jax_params(cfg, seed=3))


def test_bench_weights_npz_equals_orbax_and_pmap_matches():
    from llicti_tpu.utils.checkpoint import CheckpointManager

    cfg = ModelConfig()
    target = JaxModel(cfg=cfg).init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 64, 3), jnp.float32))
    params, meta = CheckpointManager(os.path.join(ROOT, "bench_ckpt")).load(
        "bench", target)
    assert meta["steps"] == 137500
    params = jax.tree.map(np.asarray, params)
    ref = flat_params(params)
    npz = load_npz(BENCH_PARAMS)
    assert sorted(npz) == sorted(ref)
    for k in ref:
        assert npz[k].dtype == np.float32
        np.testing.assert_array_equal(npz[k], ref[k])
    assert sum(v.size for v in npz.values()) == 196596
    assert_pmaps_match(cfg, params)
    # the flat .npz form loads into the same model
    m_npz = params_from_flax(npz, cfg)
    m_tree = params_from_flax(params, cfg)
    for (ka, a), (kb, b) in zip(m_npz.state_dict().items(),
                                m_tree.state_dict().items()):
        assert ka == kb and torch.equal(a, b)


def test_params_from_flax_rejects_mismatch():
    cfg = small_cfg()
    params = flat_params(jax_params(cfg))
    with pytest.raises(RuntimeError):
        params_from_flax(params, small_cfg(chs=(16, 16)))
    bad = dict(params)
    bad["models_0_0/conv_00_11/Conv_0/scale"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        params_from_flax(bad, cfg)
