"""The port's Trainer lifecycle on the CPU (train -> validate ->
checkpoint -> resume, test mode, crash handling), mirroring
``tests/test_trainer.py``, plus checkpoints restored bit for bit, the
model size against the JAX package's and the eval_model / flops_est modes."""
import torch_helpers  # noqa: F401  (first: caps torch's threads)
import dataclasses
import json
import logging
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from llicti_torch.config import (DataConfig, LLICTIConfig, ModelConfig,
                                 TrainConfig)
from llicti_torch.training.trainer import Trainer, pad_to_multiple
from llicti_torch.utils.checkpoint import CheckpointManager


def tiny_config(tmp_path, **train_kw):
    model = ModelConfig(chs=(8, 1), evens=(4, 4), odds=(3, 3),
                        dwtlevels=(0, 1), useprevlevNN=(False, True))
    tkw = dict(batch_size=2, patch_size=32, grad_acc_iters=1,
               loss_prnt_iters=100, learning_rate=1e-3, max_epoch=1,
               seed=3, val_patch_size=32)
    tkw.update(train_kw)
    return LLICTIConfig(
        exp_name="t", mode="train",
        model=model, train=TrainConfig(**tkw),
        data=DataConfig(synthetic=True, synthetic_len=8),
        experiments_root=str(tmp_path),
    )


def with_train(cfg, **kw):
    return dataclasses.replace(cfg,
                               train=dataclasses.replace(cfg.train, **kw))


def last_event(cfg):
    log = os.path.join(cfg.log_dir, "events.jsonl")
    assert os.path.exists(log)
    with open(log) as f:
        return json.loads(f.read().splitlines()[-1])


def test_pad_to_multiple_equals_jax():
    from llicti_tpu.training.trainer import pad_to_multiple as jax_pad
    x = np.random.default_rng(0).uniform(size=(2, 30, 33, 3)).astype(
        np.float32)
    y = pad_to_multiple(x, 8)
    assert y.shape == (2, 32, 40, 3)
    np.testing.assert_array_equal(y, jax_pad(x, 8))
    assert pad_to_multiple(y, 8) is y


def test_train_validate_checkpoint_resume(tmp_path):
    cfg = tiny_config(tmp_path)
    tr = Trainer(cfg, device="cpu")
    losses = []
    step = tr.train_step
    tr.train_step = lambda b: losses.append(step(b)) or losses[-1]
    tr.run()
    tr.finalize()  # the CLI flow: run + finalize (writes epoch-complete meta)
    assert tr.current_iteration == 4  # 8 imgs / batch 2
    assert all(np.isfinite(float(m["loss"])) for m in losses)
    assert tr.ckpt.exists("checkpoint")
    assert tr.ckpt.exists("model_best")
    assert np.isfinite(tr.best_valid_loss)

    tr2 = Trainer(with_train(cfg, resume_training=True, max_epoch=2),
                  device="cpu")
    assert tr2.current_iteration == 4
    for a, b in zip(tr.model.parameters(), tr2.model.parameters()):
        assert torch.equal(a, b)
    tr2.run()
    assert tr2.current_iteration == 8
    assert tr2.current_epoch == 2


def test_checkpoint_roundtrip_bit_exact(tmp_path):
    """Parameters and Adam state come back bit for bit; is_best copies
    both files; a missing checkpoint raises FileNotFoundError."""
    cfg = tiny_config(tmp_path)
    tr = Trainer(cfg, device="cpu")
    tr.train(max_steps=2)
    tr.save_checkpoint("named", is_best=True)
    mgr = CheckpointManager(cfg.checkpoint_dir)
    state, meta = mgr.load("model_best")
    assert state["step"] == meta["iteration"] == 2
    assert os.path.exists(os.path.join(cfg.checkpoint_dir,
                                       "model_best.meta.json"))
    fresh = Trainer(cfg, device="cpu")
    fresh.load_checkpoint("named")
    for (n, a), b in zip(tr.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    saved, loaded = (t.optimizer.state_dict() for t in (tr, fresh))
    assert saved["param_groups"] == loaded["param_groups"]
    assert saved["state"].keys() == loaded["state"].keys()
    for k, s in saved["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s[key], loaded["state"][k][key]), (k, key)
    assert fresh.current_iteration == 2
    with pytest.raises(FileNotFoundError):
        mgr.load("absent")
    with pytest.raises(FileNotFoundError):
        fresh.load_checkpoint("absent")


def test_test_mode_estimate_only(tmp_path):
    """'test' mode runs an estimate-only eval over the test set (the
    reference's test() is an empty stub; ours reports the mean rate)."""
    cfg = tiny_config(tmp_path)
    Trainer(cfg, device="cpu").run()
    trt = Trainer(dataclasses.replace(cfg, mode="test"), device="cpu")
    loss = trt.test()
    assert np.isfinite(loss) and 0 < loss < 48


def test_crash_notification_written(tmp_path):
    """An unexpected exception writes a failure event and re-raises; with
    no progress made, nothing is saved."""
    cfg = dataclasses.replace(tiny_config(tmp_path), mode="bogus_mode")
    tr = Trainer(cfg, device="cpu")
    with pytest.raises(NameError):
        tr.run()
    ev = last_event(cfg)
    assert "crashed" in ev["subject"] and "bogus_mode" in ev["subject"]
    assert not tr.ckpt.exists("checkpoint")


def test_crash_after_progress_saves_then_notifies(tmp_path):
    cfg = tiny_config(tmp_path)
    tr = Trainer(cfg, device="cpu")
    step = tr.train_step

    def failing(batch):
        if tr.current_iteration == 2:
            raise FloatingPointError("loss went NaN")
        return step(batch)

    tr.train_step = failing
    with pytest.raises(FloatingPointError):
        tr.run()
    assert tr.ckpt.load("checkpoint")[1]["iteration"] == 2
    ev = last_event(cfg)
    assert "FloatingPointError" in ev["body"] and "iter 2" in ev["body"]


@pytest.mark.parametrize("mode,where", [("eval_model", "A5"),
                                        ("flops_est", "A5")])
def test_modes_not_ported_raise(tmp_path, mode, where):
    """The two modes that raised until ROADMAP ``where`` was ported now run
    (the test keeps its name): eval_model round-trips the test set
    losslessly into results.json, flops_est counts a positive number of
    flops; neither saves a checkpoint."""
    cfg = dataclasses.replace(tiny_config(tmp_path), mode=mode)
    tr = Trainer(cfg, device="cpu")
    if mode == "flops_est":
        assert tr.flops_estimation(32, 32) > 0
    tr.run()
    tr.finalize()
    if mode == "eval_model":
        with open(os.path.join(cfg.out_dir, "results.json")) as f:
            res = json.load(f)
        assert res["lossless"] and len(res["per_image"]) == 4, where
    assert not tr.ckpt.exists("checkpoint")


def test_data_shards_not_ported_raise(tmp_path):
    """num_data_shards > 1 needs a process group of that many ranks (the
    two-process run is tests/test_torch_parallel_2proc.py); alone, the
    Trainer raises naming torchrun."""
    with pytest.raises(RuntimeError, match="torchrun"):
        Trainer(with_train(tiny_config(tmp_path), num_data_shards=2),
                device="cpu")


def test_debug_mode_trains_under_anomaly_detection(tmp_path):
    cfg = dataclasses.replace(tiny_config(tmp_path), mode="debug")
    tr = Trainer(cfg, device="cpu")
    seen = []
    step = tr.train_step
    tr.train_step = lambda b: seen.append(
        torch.is_anomaly_enabled()) or step(b)
    tr.run()
    assert seen == [True] * 4 and not torch.is_anomaly_enabled()


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_model_size_equals_jax(tmp_path):
    """The MB figure of the parameters equals the JAX trainer's for the
    same configuration (``init_params`` has JAX's names and shapes)."""
    import jax
    import jax.numpy as jnp

    from llicti_tpu.config import ModelConfig as JaxConfig
    from llicti_tpu.models.llicti import LLICTIModel as JaxModel
    from llicti_tpu.training.trainer import Trainer as JaxTrainer

    cfg = dataclasses.replace(tiny_config(tmp_path), mode="model_size")
    tr = Trainer(cfg, device="cpu")
    records = _Records()
    logging.getLogger("Agent").addHandler(records)
    try:
        tr.run()
    finally:
        logging.getLogger("Agent").removeHandler(records)
    assert sum("models.0.0.conv_00_11.weight" in m
               for m in records.messages) == 1
    jcfg = JaxConfig(**dataclasses.asdict(cfg.model))
    # the JAX parameters' shapes and dtypes, traced without compiling
    params = jax.eval_shape(JaxModel(cfg=jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)))
    ref = JaxTrainer.model_size_estimation(SimpleNamespace(
        state=SimpleNamespace(params=params),
        logger=logging.getLogger("Agent")))
    assert tr.model_size_estimation() == ref


def test_trainer_defaults_to_the_card(tmp_path):
    """Without ``device``, the Trainer runs on CUDA; with no card it
    raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default trainer would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(tiny_config(tmp_path))
