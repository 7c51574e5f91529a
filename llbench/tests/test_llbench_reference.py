"""The reference against the program at small sizes, and its controls:
computed in the precision below the configuration's, the reference put
in the program's place fails the comparison."""
from __future__ import annotations


import pytest
import torch

from conftest import TINY_CONFIGS, load
from llbench import checks, work
from llbench.data import (random_weights, synthetic_images,
                          training_batches, trained_weights)
from llbench.reference import codec as ref_codec
from llbench.reference import model as ref_model
from llbench.reference import train as ref_train
from llbench.traffic import port_config

A = load("llbench", "configs", "llicti_A.json")


def tiny_config(name):
    src, model, train = TINY_CONFIGS[name]
    cfg = load("llbench", "configs", src + ".json")
    cfg["model"].update(model)
    cfg["train"].update(train)
    return cfg


@pytest.fixture(scope="module")
def flagship():
    weights = trained_weights(A["weights"])
    model = ref_model.build(ref_model.Config(A["model"]),
                            ref_model.from_flax(weights), "cpu")
    return weights, model


@pytest.mark.parametrize("batch", [1, 2])
def test_reference_containers_equal_the_programs(flagship, batch):
    from llicti_torch import Codec
    weights, model = flagship
    codec = Codec(port_config(A), weights, device="cpu", num_lanes=32)
    enc = ref_codec.Encoder(model, 32, "cpu")
    imgs = list(synthetic_images(batch, 42, 70, 2 ** 31 + 7, "cpu").numpy())
    if batch == 1:
        got, want = codec.compress(imgs[0]), enc.encode(imgs)
    else:
        got, want = codec.compress_batch(imgs), enc.encode_batch(imgs)
    assert checks.bytes_off(ref_codec.serialize(got),
                            ref_codec.serialize(want["streams"])) == 0
    # the words each slice holds: what Kernel 2's and 3's counts read
    assert want["words"].shape == (batch, 45)
    assert want["words"].sum() * 2 == sum(
        len(g[0]) for g in (got[1:] if batch > 1 else [got[1]])) \
        - batch * 4 * 32


def test_bytes_off_counts_a_flipped_byte_and_a_length():
    assert checks.bytes_off(b"abcd", b"abcd") == 0
    assert checks.bytes_off(b"abcd", b"abXd") == 1
    assert checks.bytes_off(b"abcd", b"abcdef") == 2


def test_forward_flops_match_the_counted_convs(flagship):
    """The work count's FLOPs equal FlopCounterMode's count of the
    reference model's convs (50.61 GFLOP at 512 x 768)."""
    from torch.utils.flop_counter import FlopCounterMode
    _, model = flagship
    x = torch.zeros((1, 64, 96, 3))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x)
    assert counter.get_total_flops() == work.forward_flops(A["model"], 64, 96)
    assert work.forward_flops(A["model"], 512, 768) == 50_609_332_224


def tiny_step_numbers(precision="float32", half=False, seed=3):
    """The tiny training config: the program's checked steps against the
    reference's, or (``precision``, ``half``) the reference in the
    program's place."""
    from llicti_torch.models.llicti import LLICTIModel
    from llicti_torch.training import make_optimizer, make_train_step
    from llbench.traffic.train_step import program_readings
    cfg = tiny_config("tiny_B")
    t = cfg["train"]
    rcfg = ref_model.Config(cfg["model"])
    state = random_weights(ref_model.leaves(rcfg), seed, "cpu")
    batches = training_batches(3, t["grad_acc_iters"], 4, t["patch_size"],
                               seed + 1, "cpu")

    def reference(b, p="float32"):
        r = ref_train.run_steps(rcfg, state, b, t["learning_rate"],
                                t["grad_clip_value"], "cpu", p)
        return {"losses": r["losses"], "grads": checks.norms(r["grads"]),
                "delta": checks.norms(r["delta"])}

    ref = reference(batches)
    if precision == "float32" and not half:
        model = LLICTIModel(port_config(cfg))
        model.load_state_dict(state)
        opt = make_optimizer(model, t["learning_rate"])
        step = make_train_step(model, opt, t["grad_clip_value"])
        prog = program_readings(model, opt, lambda i: step(batches[i]), 3)
    else:
        prog = reference([b[:, :b.shape[1] // 2] for b in batches]
                         if half else batches, precision)
    return {k: v[0] for k, v in checks.step_numbers(prog, ref).items()}


LIMITS = load("llbench", "workloads", "llicti_B.train_step.json")["limits"]


def test_reference_step_agrees_with_the_programs():
    nums = tiny_step_numbers()
    assert all(nums[k] <= v for k, v in LIMITS.items()), nums


@pytest.mark.parametrize("fault", ["bf16", "half_batch"])
def test_control_and_half_batch_fail(fault):
    nums = tiny_step_numbers("bf16" if fault == "bf16" else "float32",
                             half=fault == "half_batch")
    assert any(nums[k] > v for k, v in LIMITS.items()), nums


@pytest.mark.card
def test_tf32_control_fails_the_container_comparison(card):
    """On the card the codec's control, the reference encoder under TF32,
    codes other bytes than under float32 (with TF32 off)."""
    weights = trained_weights(A["weights"])
    model = ref_model.build(ref_model.Config(A["model"]),
                            ref_model.from_flax(weights), card)
    img = list(synthetic_images(1, 128, 192, 5, card).cpu().numpy())
    exact = ref_codec.Encoder(model, 128, card).encode(img)
    tf32 = ref_codec.Encoder(model, 128, card, tf32=True).encode(img)
    assert checks.bytes_off(ref_codec.serialize(tf32["streams"]),
                            ref_codec.serialize(exact["streams"])) > \
        load("llbench", "workloads",
             "llicti_A.codec_single.json")["limits"]["container_bytes_off"]
