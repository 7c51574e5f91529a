"""The benchmark's reference of the row-sharded container
(``llbench/reference/sharded.py``) against the port's one-process
``ShardedCodec`` on the CPU: G = 4 row shards of a 64 x 96 image, the
maps in one block, byte for byte with a lossless decode; a reference of
another lane count tells its container apart; and the ``llicti.halo``
span opens once a call of ``halo_rows``."""
import torch_helpers  # noqa: F401  (first: caps torch's threads)

import json
import os

import numpy as np
import pytest
import torch

from llbench.data import synthetic_images
from llbench.reference import codec as ref_codec
from llbench.reference import model as ref_model
from llbench.reference import sharded
from llbench.traffic import port_config
from llicti_torch.parallel import ShardedCodec, make_sp_mesh
from llicti_torch.parallel.halo import halo_rows
from llicti_torch.weights import init_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "llbench", "configs", "llicti_A.json")) as f:
    A = json.load(f)["model"]
# llicti_A's keys at chs 8 and two scales (stride 4: G = 4 shards take
# a height of a multiple of 16)
KEYS = dict(A, chs=[8, 1], dwtlevels=[0, 1], evens=[4, 4], odds=[3, 3],
            useprevlevNN=[False, True])


@pytest.fixture(scope="module")
def setup():
    cfg = port_config({"model": KEYS})
    weights = init_params(cfg, 5)
    codec = ShardedCodec(cfg, weights, mesh=make_sp_mesh(4), num_lanes=8,
                         device="cpu")
    ref = ref_model.build(ref_model.Config(KEYS),
                          ref_model.from_flax(weights), "cpu")
    img = synthetic_images(1, 64, 96, 2 ** 31 + 9, "cpu").numpy()[0]
    return codec, ref, img


def test_sharded_container_equals_the_references(setup):
    """Four shards of 16 rows (8 lanes each): the reference's container
    equals ``compress``'s byte for byte, ``decompress`` gives the image
    back; a reference at 16 lanes gives another container."""
    codec, ref, img = setup
    got = codec.compress(img)
    want = sharded.encode(ref, img, 4, 8, "cpu")
    assert len(got[1]) == 4 and want["words"].shape == (4, 18)
    assert ref_codec.serialize(got) == ref_codec.serialize(want["streams"])
    assert np.array_equal(codec.decompress(got)[0], img)
    other = sharded.encode(ref, img, 4, 16, "cpu")
    assert ref_codec.serialize(got) != ref_codec.serialize(other["streams"])


def test_reference_refuses_a_padded_image(setup):
    _, ref, img = setup
    with pytest.raises(ValueError):
        sharded.encode(ref, img[:40], 4, 8, "cpu")


def test_halo_span_opens_once_a_call(monkeypatch):
    """``halo_rows`` under a CPU profiler opens ``llicti.halo`` once a
    call (here in a group of one, where it pads with replicate rows)."""
    opened = []
    record = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or record(name))
    x = torch.arange(24.0).reshape(1, 4, 3, 2)
    with torch.profiler.profile():
        out = halo_rows(x, 2, 1)
        halo_rows(x, 1, 1)
    assert opened.count("llicti.halo") == 2
    assert torch.equal(out[:, :2], x[:, :1].expand(1, 2, 3, 2))
    assert torch.equal(out[:, -1], x[:, -1])
