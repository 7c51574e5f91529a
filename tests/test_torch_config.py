"""The port's own copies of the JAX package's configuration and synthetic
images: the same fields, defaults, derived properties and refusals, and
the same image bytes for the same seed."""
import torch_helpers  # noqa: F401  (first: caps torch's threads)
import dataclasses

import numpy as np
import pytest

from llicti_tpu.config import ModelConfig as JaxConfig
from llicti_tpu.data.dataset import synthetic_image as jax_synthetic_image
from llicti_torch import ModelConfig, synthetic_image

PROPERTIES = ("num_scales", "rndfactor", "mean_y_ycocg", "cond_channels",
              "model_index", "num_models")


def test_fields_and_defaults_equal_jax():
    ours = [(f.name, f.type, f.default) for f in dataclasses.fields(ModelConfig)]
    ref = [(f.name, f.type, f.default) for f in dataclasses.fields(JaxConfig)]
    assert ours == ref
    assert ModelConfig.__dataclass_params__.frozen


@pytest.mark.parametrize("kw", [
    {}, {"clr_joint_mode": 1}, {"clr_joint_mode": 0, "clrchs": 1},
    {"lif_prec_bits": 10}, {"dwtlevels": (0, 1), "chs": (8, 8),
                            "useprevlevNN": (False, False)},
    {"dwtlevels": (0, 1, 2), "useprevlevNN": (False, True, False)},
    {"dwtlevels": ()}])
def test_properties_equal_jax(kw):
    ours, ref = ModelConfig(**kw), JaxConfig(**kw)
    for name in PROPERTIES:
        assert getattr(ours, name) == getattr(ref, name), name
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("kw", [
    {"wtr_type": "x"}, {"net_type": "other"}, {"distribution": "laplace"},
    {"ent_mdl_num": 3}])
def test_refuses_what_jax_refuses(kw):
    with pytest.raises(NotImplementedError):
        JaxConfig(**kw)
    with pytest.raises(NotImplementedError):
        ModelConfig(**kw)


@pytest.mark.parametrize("h,w,seed", [(32, 32, 0), (33, 37, 3),
                                      (64, 96, 42), (31, 17, 7)])
def test_synthetic_image_bytes_equal_jax(h, w, seed):
    ours = synthetic_image(h, w, seed=seed)
    ref = jax_synthetic_image(h, w, seed=seed)
    assert ours.dtype == ref.dtype == np.uint8
    assert ours.shape == ref.shape == (h, w, 3)
    assert ours.tobytes() == ref.tobytes()
