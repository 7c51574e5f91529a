"""The port's interpolator model against the JAX package's, with the same
weights carried over by ``params_from_flax``.

Tolerance for the float32 parameter maps: rtol = atol = 1e-5, since the
two frameworks sum the conv products in different orders.
"""
import torch_helpers  # noqa: F401  (first: caps torch's threads)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llicti_tpu.config import ModelConfig
from llicti_tpu.models.llicti import LLICTIModel as JaxModel
from llicti_torch.models.llicti import LLICTIModel
from llicti_torch.weights import (BENCH_PARAMS, flat_params, init_params,
                                  load_npz, params_from_flax)

# the configurations the port's codec codes beyond the flagship family
VARIANTS = [{"clr_joint_mode": 1}, {"clr_joint_mode": 0},
            {"clr_joint_mode": 0, "clrjnt0seqmd": True},
            {"activfun": "GDN1"}, {"mwsa_joint": True},
            {"combine_layers1toL": True},
            {"combine_layers1toL": True, "activfun": "GDN1"},
            {"clr_joint_mode": 1, "activfun": "PReLU", "mwsa_joint": True}]

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


def nested(flat):
    """{flat Flax name: array} -> the {'params': ...} tree Flax applies."""
    tree = {}
    for name, arr in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return {"params": tree}


def assert_pmaps_match(cfg, params, shape=(1, 8, 12)):
    if "params" not in params:
        params = nested(params)
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
    ("ReLU", True, {"clrchs": 1, "chs": (8, 8)}),
    ("GDN1", False, {}), ("GDN1", True, {"clr_joint_mode": 1}),
    ("ReLU", False, {"mwsa_joint": True}),
    ("PReLU", False, {"combine_layers1toL": True}),
    ("GDN1", True, {"combine_layers1toL": True, "clr_joint_mode": 0}),
    ("none", True, {})])
def test_pmap_matches_jax_random_weights(activ, shared, extra):
    cfg = small_cfg(activfun=activ, useprevlevNN=(False, shared), **extra)
    assert_pmaps_match(cfg, jax_params(cfg, seed=3))


@pytest.mark.parametrize("activ", ["ReLU", "PReLU"])
def test_seqmd_base_and_per_colour_params_match_jax(activ):
    """clrjnt0seqmd: band_base once per band, then band_params_seq per
    colour; colour clr's columns must not depend on colours >= clr."""
    cfg = small_cfg(clr_joint_mode=0, clrjnt0seqmd=True, activfun=activ)
    params = jax_params(cfg, seed=5)
    jm = JaxModel(cfg=cfg)
    tm = params_from_flax(params, cfg)
    M = cfg.num_mixtures
    y = np.random.default_rng(2).uniform(
        -0.4, 0.4, (1, 8, 12, 12)).astype(np.float32)
    for scl in range(cfg.num_scales):
        for b in range(3):
            yc = y[..., :3 * (b + 1)]
            y_seq = y[..., 3 * (b + 1):3 * (b + 1) + 2]
            jbase = jm.apply(params, jnp.asarray(yc), scl, b,
                             method=JaxModel.band_base)
            with torch.inference_mode():
                base = tm.band_base(torch.from_numpy(yc), scl, b)
            np.testing.assert_allclose(base.numpy(), np.asarray(jbase),
                                       rtol=1e-5, atol=1e-5)
            for clr in range(3):
                ref = np.asarray(jm.apply(
                    params, jbase, jnp.asarray(y_seq), scl, b, clr,
                    method=JaxModel.band_params_seq))
                # what a decoder holds: colours >= clr not decoded yet
                held = y_seq.copy()
                held[..., clr:] = 0.0
                with torch.inference_mode():
                    got = tm.band_params_seq(base, torch.from_numpy(y_seq),
                                             scl, b, clr).numpy()
                    dec = tm.band_params_seq(base, torch.from_numpy(held),
                                             scl, b, clr).numpy()
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
                cols = slice(3 * clr * M, 3 * (clr + 1) * M)
                np.testing.assert_array_equal(dec[..., cols], got[..., cols])


@pytest.mark.parametrize("extra", VARIANTS + [{}, {"activfun": "PReLU"}])
def test_init_params_names_and_shapes_match_jax(extra):
    cfg = small_cfg(useprevlevNN=(False, False), **extra)
    ref = flat_params(jax_params(cfg))
    got = init_params(cfg, seed=0)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].shape == v.shape and got[k].dtype == np.float32, k
        if "/GDN1_0/" in k or "/PReLU_0/" in k:  # deterministic inits
            np.testing.assert_array_equal(got[k], v)
            continue
        # U(+-1/sqrt(fan_in)); the JAX seq convs' biases take fan_in 1
        kernel = ref[k.replace("/bias", "/kernel")]
        fan = 1 if "/seq_to" in k and k.endswith("bias") else \
            np.prod(kernel.shape[:-1])
        bound = np.float32(1 / np.sqrt(fan))
        assert np.abs(got[k]).max() <= bound, k
        assert np.abs(v).max() <= bound, k
    again = init_params(cfg, seed=0)
    assert all(np.array_equal(again[k], got[k]) for k in got)
    assert not np.array_equal(init_params(cfg, seed=1)[k], got[k])
    assert_pmaps_match(cfg, got)


def test_gdn1_matches_jax():
    from llicti_tpu.ops.gdn import GDN1 as JaxGDN1
    from llicti_torch.ops.gdn import GDN1

    rng = np.random.default_rng(4)
    x = rng.uniform(-2, 2, (2, 5, 7, 6)).astype(np.float32)
    params = {"params": {
        "beta": rng.uniform(0.5, 1.5, 6).astype(np.float32),
        "gamma": rng.uniform(-0.3, 0.3, (6, 6)).astype(np.float32)}}
    ref = np.asarray(JaxGDN1(channels=6).apply(params, jnp.asarray(x)))
    g = GDN1(6)
    g.load_state_dict({k: torch.from_numpy(v)
                       for k, v in params["params"].items()})
    with torch.inference_mode():
        got = g(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


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
