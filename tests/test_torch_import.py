"""The port runs without JAX and without the JAX package: a subprocess
that refuses every import of jax, flax, optax, orbax and llicti_tpu
imports llicti_torch, runs a CPU round trip, a training step and a
row-sharded round trip (two shards in one process), and no
module of the port (nor chip_smoke.py) imports any of them."""
import torch_helpers  # first: caps torch's threads
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax")
# modules of the JAX package the port may use: none, not even JAX-free ones
ALLOWED_TPU = ()

_CHILD = r"""
import sys

BLOCKED = %r


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


for mod in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[mod]
sys.meta_path.insert(0, Blocker())

import numpy as np
import torch
from llicti_torch import Codec, ModelConfig
from llicti_torch.models.llicti import LLICTIModel
from llicti_torch.weights import flat_params

cfg = ModelConfig(chs=(4, 4), evens=(4, 4), odds=(3, 3), dwtlevels=(0, 1),
                  useprevlevNN=(False, True))
torch.manual_seed(0)
params = {}
for m, bands in enumerate(LLICTIModel(cfg).models):
    for b, net in enumerate(bands):
        for name, mod in net.named_modules():
            if isinstance(mod, torch.nn.Conv2d):
                key = f"models_{m}_{b}/" + name.replace("trunk.", "trunk_")
                params[key + "/Conv_0/kernel"] = (
                    mod.weight.detach().numpy().transpose(2, 3, 1, 0))
                params[key + "/Conv_0/bias"] = mod.bias.detach().numpy()
codec = Codec(cfg, params, num_lanes=16, device="cpu")
img = np.random.default_rng(0).integers(0, 256, (21, 18, 3), dtype=np.uint8)
out = codec.decompress(codec.compress(img))
assert np.array_equal(out[0], img)

from llicti_torch import cli, eval_protocol, main
from llicti_torch.config import config_from_json
from llicti_torch.data import TrainLoader, ImageDataset
from llicti_torch.ops.factorized import FactorizedPrior
from llicti_torch.training import make_optimizer, make_train_step
from llicti_torch.training.trainer import Trainer
from llicti_torch.utils import CheckpointManager, Notifier, RateLogger
from llicti_torch.weights import params_from_flax
assert config_from_json("configs/small_b.json").train.batch_size == 64
model = params_from_flax(params, cfg)
batch = next(iter(TrainLoader(ImageDataset(synthetic_len=4,
                                           synthetic_size=32), 2, 32)))
m = make_train_step(model, make_optimizer(model, 1e-3))(
    torch.from_numpy(batch))
assert np.isfinite(float(m["loss"]))
assert float(FactorizedPrior(2).loss()) > 0

from llicti_torch.parallel import ShardedCodec, make_sp_mesh
sharded = ShardedCodec(cfg, params, mesh=make_sp_mesh(2), num_lanes=16,
                       device="cpu")
streams = sharded.compress(img)
assert len(streams[1]) == 2
assert np.array_equal(sharded.decompress(streams)[0], img)
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("OK")
"""


def test_port_runs_with_jax_blocked():
    res = subprocess.run([sys.executable, "-c",
                          _CHILD % (BLOCKED + ("llicti_tpu",),)],
                         cwd=ROOT, env=torch_helpers.env(PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            if node.module == "llicti_tpu":
                yield from (f"llicti_tpu.{a.name}" for a in node.names)


def test_static_scan_finds_no_jax_import():
    files = sorted((ROOT / "llicti_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"llicti_torch/cli.py", "llicti_torch/main.py",
            "llicti_torch/eval_protocol.py",
            "llicti_torch/parallel/codec_sp.py",
            "llicti_torch/parallel/halo.py"} <= names
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in BLOCKED, f"{path}: imports {mod}"
            if top == "llicti_tpu":
                assert mod in ALLOWED_TPU, f"{path}: imports {mod}"


def test_codec_defaults_to_the_card():
    """Without ``device``, Codec runs on CUDA; with no card it raises."""
    import torch

    from llicti_torch import Codec, ModelConfig
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default codec would run")
    cfg = ModelConfig(chs=(4, 4), evens=(4, 4), odds=(3, 3),
                      dwtlevels=(0, 1), useprevlevNN=(False, True))
    with pytest.raises(RuntimeError, match="CUDA"):
        Codec(cfg, {}, num_lanes=16)
