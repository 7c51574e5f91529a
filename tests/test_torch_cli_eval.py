"""The port's CLI, runner, eval_model, flops estimate, eval protocol and
resume from a JAX train state, on the CPU, against the JAX package.

CLI: a 48x64 PNG and a uint8 ``.npy`` round-trip byte-exactly, the blob
is the port codec's ``serialize(compress(img))``, and its size is within
max(0.1 %, 16 B) of the JAX CLI's (``--ckpt bench_ckpt``, same lanes).
eval_model: JAX's ``results.json`` keys, lossless, ``rate`` from the
bytes, ``est_rate`` within 1e-5 of JAX's eager forward on the same padded
images and weights.  flops: the convs' count exactly, and within 5 % of
XLA's cost analysis at flagship width.  The runner's sweep, the eval
protocol's summary keys (those of JAX's ``flush``) and its ONLY / SKIP /
APPEND dedup, and the Orbax train state resumed in the port's Trainer.
"""
import torch_helpers  # noqa: F401  (first: caps torch's threads)
import ast
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from llicti_torch import Codec, cli, eval_protocol
from llicti_torch import main as runner
from llicti_torch.config import (DataConfig, LLICTIConfig, ModelConfig,
                                 TrainConfig)
from llicti_torch.data.dataset import synthetic_image
from llicti_torch.training.trainer import Trainer, pad_to_multiple
from llicti_torch.weights import BENCH_PARAMS, flax_from_state_dict, load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(chs=(8, 1), evens=(4, 4), odds=(3, 3), dwtlevels=(0, 1),
            useprevlevNN=(False, True))


def size_close(nb, jnb):
    return abs(nb - jnb) <= max(0.001 * jnb, 16)


def nested(flat):
    """Flat '/'-joined Flax names -> JAX's nested ``{"params": ...}``."""
    tree = {}
    for name, arr in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(arr)
    return {"params": tree}


def jax_cli_blob(img_path, out_path, lanes):
    """The JAX package's CLI encode (bench_ckpt, the CPU); its compile cache
    stays where tests/conftest.py put it."""
    from llicti_tpu import cli as jcli
    update = jax.config.update

    def keep_cache(key, value):
        if key != "jax_compilation_cache_dir" and \
                not key.startswith("jax_persistent_cache"):
            update(key, value)

    jax.config.update = keep_cache
    try:
        assert jcli.main(["encode", img_path, out_path, "--ckpt",
                          os.path.join(ROOT, "bench_ckpt"), "--platform",
                          "cpu", "--lanes", str(lanes)]) == 0
    finally:
        jax.config.update = update
    with open(out_path, "rb") as f:
        return f.read()


def test_cli_png_round_trip_matches_jax(tmp_path):
    img = synthetic_image(48, 64, seed=3)
    png, blob_path, dec = (str(tmp_path / n) for n in
                           ("in.png", "in.llic", "out.png"))
    Image.fromarray(img).save(png)
    args = ["--ckpt", BENCH_PARAMS, "--device", "cpu", "--lanes", "64"]
    assert cli.main(["encode", png, blob_path] + args) == 0
    assert cli.main(["decode", blob_path, dec] + args) == 0
    np.testing.assert_array_equal(np.asarray(Image.open(dec)), img)
    with open(blob_path, "rb") as f:
        blob = f.read()
    codec = Codec(ModelConfig(), load_npz(), device="cpu", num_lanes=64)
    assert blob == Codec.serialize(codec.compress(img))
    jblob = jax_cli_blob(png, str(tmp_path / "jax.llic"), 64)
    print(f"48x64 PNG at 64 lanes: port {len(blob)} bytes, JAX CLI "
          f"{len(jblob)} bytes")
    assert size_close(len(blob), len(jblob))


def test_cli_npy_input_and_output_without_pil(tmp_path, monkeypatch):
    """A uint8 .npy encodes (the port's one addition to the JAX CLI's
    inputs); without PIL the decoder writes OUT.npy, as JAX's does."""
    img = synthetic_image(40, 36, seed=4)
    src, blob_path = str(tmp_path / "in.npy"), str(tmp_path / "in.llic")
    np.save(src, img)
    args = ["--device", "cpu", "--lanes", "32", "--config",
            os.path.join(ROOT, "configs", "paper_a.json")]
    assert cli.main(["encode", src, blob_path] + args) == 0
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert cli.main(["decode", blob_path, str(tmp_path / "out.png")]
                    + args) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "out.png.npy"), img)
    np.save(tmp_path / "bad.npy", img.astype(np.int16))
    with pytest.raises(ValueError, match="uint8"):
        cli.main(["encode", str(tmp_path / "bad.npy"), blob_path] + args)


def test_cli_reads_a_port_checkpoint_and_needs_the_card(tmp_path):
    """--ckpt DIR takes a Trainer's {name}.pt; without --device cpu and
    without a card the CLI raises instead of running on the CPU."""
    cfg = LLICTIConfig(exp_name="c", mode="train", model=ModelConfig(**TINY),
                       train=TrainConfig(), data=DataConfig(synthetic=True),
                       experiments_root=str(tmp_path))
    tr = Trainer(cfg, device="cpu")
    tr.save_checkpoint("model_best")
    img = synthetic_image(24, 40, seed=2)
    np.save(tmp_path / "in.npy", img)
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps({"model": {k: list(v) for k, v in
                                              TINY.items()}}))
    args = [str(tmp_path / "in.npy"), str(tmp_path / "x.llic"), "--ckpt",
            cfg.checkpoint_dir, "--ckpt-name", "model_best", "--config",
            str(cfg_path), "--lanes", "16"]
    assert cli.main(["encode"] + args + ["--device", "cpu"]) == 0
    codec = Codec(cfg.model, cli.load_params(cfg.checkpoint_dir, "model_best",
                                             cfg.model), device="cpu",
                  num_lanes=16)
    with open(tmp_path / "x.llic", "rb") as f:
        assert f.read() == Codec.serialize(codec.compress(img))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["encode"] + args)


def eval_config(tmp_path, images, **kw):
    data = tmp_path / "set"
    data.mkdir()
    for k, img in enumerate(images):
        Image.fromarray(img).save(data / f"im{k}.png")
    return LLICTIConfig(
        exp_name="e", mode="eval_model", model=ModelConfig(**TINY),
        train=TrainConfig(seed=3, **kw),
        data=DataConfig(train_dirs=(str(data),), valid_dir=str(data),
                        test_dir=str(data)),
        experiments_root=str(tmp_path))


def test_eval_model_matches_jax(tmp_path):
    """Two images, one not a multiple of the stride (4): JAX's results.json
    keys, lossless, rate from the bytes, est_rate as JAX's eager forward of
    the same weights on the same replicate-padded images."""
    from llicti_tpu.config import ModelConfig as JaxConfig
    from llicti_tpu.models.llicti import LLICTIModel as JaxModel

    images = [synthetic_image(32, 40, seed=1), synthetic_image(30, 37, seed=2)]
    cfg = eval_config(tmp_path, images)
    tr = Trainer(cfg, device="cpu")
    tr.run()
    with open(os.path.join(cfg.out_dir, "results.json")) as f:
        res = json.load(f)
    assert set(res) == {"rate", "est_rate", "dist", "lossless", "per_image"}
    assert res["lossless"] and all(r["ok"] for r in res["per_image"])
    assert set(res["per_image"][0]) == {"bpsp", "est_bpsp", "est_gap_pct",
                                        "coder_gap_pct", "enc_t", "dec_t",
                                        "ok"}
    flat = flax_from_state_dict(tr.model.state_dict(), cfg.model)
    codec = Codec(cfg.model, flat, device="cpu", num_lanes=64)
    rates = [Codec.num_bytes(codec.compress(img)) * 8 / img.size
             for img in images]
    assert res["rate"] == pytest.approx(float(np.mean(rates)), rel=1e-12)
    # the coder gap of an image this small is mostly the bits its lane
    # states hold at the end (the stream bits leave them out)
    assert all(-3.0 <= r["coder_gap_pct"] <= 0.5 for r in res["per_image"])

    jmodel = JaxModel(cfg=JaxConfig(**dataclasses.asdict(cfg.model)))
    jparams = nested(flat)
    est = []
    for img in images:
        x = pad_to_multiple(img[None].astype(np.float32) / 255.0, 4)
        bits = sum(float(jnp.sum(si)) for si in
                   jmodel.apply(jparams, jnp.asarray(x)))
        est.append(bits / img.size)
    assert res["est_rate"] == pytest.approx(float(np.mean(est)), rel=1e-5)


def conv_flops(model, x):
    """2 x MACs of every conv of one forward, from the convs' shapes."""
    total = []

    def hook(mod, inp, out):
        k = mod.in_channels // mod.groups * mod.kernel_size[0] \
            * mod.kernel_size[1]
        total.append(2 * out.numel() * k)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return sum(total)


@pytest.mark.parametrize("model_kw", [TINY, {}], ids=["tiny", "flagship"])
def test_flops_estimation(tmp_path, model_kw):
    """The count is the convs' (FlopCounterMode counts no elementwise op).
    At flagship width it is within 5 % of XLA's cost analysis, which also
    counts the mixture's elementwise operations; those do not shrink with
    the width, so at the tiny width XLA's count is 39 % higher."""
    from llicti_tpu.config import ModelConfig as JaxConfig
    from llicti_tpu.models.llicti import LLICTIModel as JaxModel

    cfg = LLICTIConfig(exp_name="f", mode="flops_est",
                       model=ModelConfig(**model_kw), train=TrainConfig(),
                       data=DataConfig(synthetic=True, synthetic_len=4),
                       experiments_root=str(tmp_path))
    tr = Trainer(cfg, device="cpu")
    flops = tr.flops_estimation(64, 64)
    assert flops == conv_flops(tr.model, torch.zeros((1, 64, 64, 3)))
    if model_kw:
        tr.run()  # mode flops_est: at 512 x 512
        return
    jm = JaxModel(cfg=JaxConfig(**dataclasses.asdict(cfg.model)))
    x = jnp.zeros((1, 64, 64, 3))
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    cost = jax.jit(jm.apply).lower(params, x).compile().cost_analysis()
    jflops = (cost[0] if isinstance(cost, list) else cost)["flops"]
    print(f"flagship 64x64: port {flops} flops, XLA {jflops:.0f}")
    assert abs(flops - jflops) <= 0.05 * jflops


def test_runner_sweep_makes_one_experiment_per_value(tmp_path):
    raw = {"exp_name": "sweep", "multi_exp_name": "sweep",
           "multi_agent": True, "multi_param": "learning_rate",
           "mode": "train", "agent": "LLICTIAgent",
           "model": {k: list(v) for k, v in TINY.items()},
           "data": {"synthetic": True, "synthetic_len": 4},
           "experiments_root": str(tmp_path),
           "learning_rate": [0.001, 0.0005]}
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps(raw))
    runner.main([str(path), "--mode", "model_size", "--device", "cpu"])
    for v in ("exp_0.001", "exp_0.0005"):
        d = tmp_path / "sweep" / v
        assert (d / "checkpoints").is_dir()
        assert (d / "logs" / "exp_debug.log").exists()
    assert sorted(os.listdir(tmp_path / "sweep")) == ["exp_0.0005",
                                                      "exp_0.001"]
    # --mesh without torchrun: a data mesh of one process
    runner.main([str(path), "--mode", "model_size", "--mesh", "--device",
                 "cpu"])
    assert sorted(os.listdir(tmp_path / "sweep")) == ["exp_0.0005",
                                                      "exp_0.001"]


def jax_dict_keys(path, func, target):
    """Keys of the dict that ``func`` in the JAX tool builds for ``target``
    (a ``summary = {...}`` literal, or a ``results.append(dict(...))``)."""
    tree = ast.parse(open(path).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if target == "summary" and isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", "") == "summary":
            return {k.value for k in node.value.keys}
        if target == "append" and isinstance(node, ast.Call) and \
                getattr(node.func, "attr", "") == "append":
            return {k.arg for k in node.args[0].keywords if k.arg}
    raise AssertionError(f"no {target} in {func}")


def test_eval_protocol_keys_and_dedup(tmp_path, monkeypatch):
    corpus = tmp_path / "corpus"
    for split, sizes in (("valid", [(24, 40), (32, 32)]),
                         ("test", [(40, 33)])):
        (corpus / split).mkdir(parents=True)
        for k, (h, w) in enumerate(sizes):
            Image.fromarray(synthetic_image(h, w, seed=k + len(split))).save(
                corpus / split / f"{split}{k}.png")
    out = str(tmp_path / "out")
    monkeypatch.setenv("LLICTI_EVAL_PLATFORM", "cpu")
    summary = eval_protocol.main(out, root=str(corpus))
    tool = os.path.join(ROOT, "tools", "eval_protocol.py")
    assert set(summary) == jax_dict_keys(tool, "flush", "summary")
    per = summary["per_image"]
    assert [(r["split"], r["file"]) for r in per] == [
        ("valid", "valid0.png"), ("valid", "valid1.png"),
        ("test", "test0.png"), ("test_crop512", "test0.png")]
    assert set(per[0]) == jax_dict_keys(tool, "run_image", "append")
    assert summary["all_lossless"] and summary["n_exact_mult"] == 1
    assert summary["max_abs_coder_gap_pct"] == max(
        abs(r["coder_gap_pct"]) for r in per)
    assert all(r["ycocg_err"] == 0 and r["device"] == "cpu" for r in per)
    with open(os.path.join(out, "results.json")) as f:
        assert json.load(f) == json.loads(json.dumps(summary))

    # APPEND + ONLY redoes one file, in place of its earlier entries
    monkeypatch.setenv("LLICTI_EVAL_APPEND", "1")
    monkeypatch.setenv("LLICTI_EVAL_ONLY", "test0.png")
    again = eval_protocol.main(out, root=str(corpus))["per_image"]
    assert sorted((r["split"], r["file"]) for r in again) == sorted(
        (r["split"], r["file"]) for r in per)
    # APPEND + SKIP: a skipped file replaces its entry, nothing duplicates
    monkeypatch.delenv("LLICTI_EVAL_ONLY")
    monkeypatch.setenv("LLICTI_EVAL_SKIP", "valid1.png")
    last = eval_protocol.main(out, root=str(corpus))
    assert len(last["per_image"]) == 4 and last["n_images"] == 3
    assert [r for r in last["per_image"] if r.get("skipped")] == [
        {"split": "valid", "file": "valid1.png", "skipped": True}]


def test_resume_from_jax_train_state(tmp_path):
    """train_state/checkpoint.orbax (step 140,172) exported to a .pt and
    resumed by the port's Trainer: parameters bit-equal to the Orbax ones,
    Adam moments and count equal to optax's, the scheduler and iteration
    those of the meta; one more step is finite."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import export_torch_params as export

    from llicti_torch.weights import _state_from_flax

    loaded = export.load_train_state(os.path.join(ROOT, "train_state"),
                                     "checkpoint")
    cfg_dict, params, mu, nu, count, _, meta = loaded
    cfg = LLICTIConfig(
        exp_name="r", mode="train", model=ModelConfig(),
        train=TrainConfig(batch_size=1, patch_size=32, max_epoch=1,
                          resume_training=True, checkpoint_file="checkpoint"),
        data=DataConfig(synthetic=True, synthetic_len=2),
        experiments_root=str(tmp_path))
    state, out_meta = export.port_checkpoint(*loaded)
    from llicti_torch.utils.checkpoint import CheckpointManager
    CheckpointManager(cfg.checkpoint_dir).save("checkpoint", state, out_meta)

    tr = Trainer(cfg, device="cpu")
    want = _state_from_flax(params)
    got = tr.model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    moments = [_state_from_flax(mu), _state_from_flax(nu)]
    opt = tr.optimizer.state_dict()["state"]
    for i, (name, _) in enumerate(tr.model.named_parameters()):
        assert torch.equal(opt[i]["exp_avg"], moments[0][name])
        assert torch.equal(opt[i]["exp_avg_sq"], moments[1][name])
        assert float(opt[i]["step"]) == count
    assert tr.scheduler.state_dict() == meta["scheduler"]
    assert tr.current_iteration == meta.get("iteration", 0) == 0
    assert tr.best_valid_loss == meta["best_valid_loss"]
    assert tr.optimizer.param_groups[0]["lr"] == meta["scheduler"]["lr"]
    batch = next(iter(tr.train_loader))
    m = tr.train_step(tr.upload(batch))
    assert np.isfinite(float(m["loss"]))
    assert all(float(s["step"]) == count + 1
               for s in tr.optimizer.state_dict()["state"].values())
