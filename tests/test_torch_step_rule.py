"""The step rule that holds one optimiser step to another
(``llicti_torch.parallel.dryrun.step_rule``; chip_smoke.py's phases 11 (a)
and 13 (c) and the dry run's parts (c) and (d) use it), on the CPU: sound
pairs of steps pass it with 3x margin on each bound, and each fault fails
the check meant for it.  Each pair is one clip + Adam step from one
state (Adam's first step, or a second after a sound one) on a
[2, 2, 32, 32, 3] batch of synthetic crops, at lr 1e-4: the tiny
configuration from random weights and the flagship from its trained
weights (near a minimum, where many gradients are float noise).  A wrong
halo exchange fails part (d)'s rule in tests/test_torch_parallel_2proc.py.
"""
import torch_helpers  # first: caps torch's threads

import copy

import numpy as np
import pytest
import torch

from llicti_torch import ModelConfig, load_npz, synthetic_image
from llicti_torch.models.llicti import LLICTIModel
from llicti_torch.parallel import dryrun
from llicti_torch.training import (apply_gradients, make_optimizer,
                                   make_train_step)
from llicti_torch.training.steps import accumulate
from llicti_torch.weights import init_params, params_from_flax

LR = 1e-4
CLIP = 5.0  # apply_gradients' default, as make_train_step clips
TINY = ModelConfig(**torch_helpers.TINY)
MODELS = {"tiny": (TINY, lambda: init_params(TINY, 0)),
          "flagship_trained": (ModelConfig(), load_npz)}


def batches(seed: int = 0):
    """Two [2, 2, 32, 32, 3] batches of crops of synthetic images."""
    rng = np.random.default_rng(seed)
    crops = []
    for k in range(8):
        img = synthetic_image(96, 96, seed=seed + k)
        r, c = rng.integers(0, 64, 2)
        crops.append(img[r:r + 32, c:c + 32])
    x = np.stack(crops).reshape(2, 2, 2, 32, 32, 3).astype(np.float32)
    return [torch.from_numpy(b / np.float32(255)) for b in x]


def start(cfg, params, x=None):
    """The state both steps of a pair start from: the model and a fresh
    Adam (the first step), or both after one sound step on ``x`` (Adam's
    moments set)."""
    model = params_from_flax(params, cfg).train()
    opt = make_optimizer(model, LR)
    if x is not None:
        make_train_step(model, opt)(x)
    return model, opt


def step(state, x, flip=False, channels_last=False, float64=False):
    """One step on ``x`` from a copy of ``state``: (the parameters after
    it, the gradients it took).  ``flip``: each microbatch's images in
    reverse order; ``channels_last``: the step ``make_train_step``
    builds, which puts the model in ``torch.channels_last``, else its
    arithmetic on the model in NCHW; ``float64``: Adam on the gradients of
    ``dryrun.float64_step``, in float64."""
    model = copy.deepcopy(state[0]).to(memory_format=torch.contiguous_format)
    x = x.flip(1) if flip else x
    if float64:
        _, grads = dryrun.float64_step(model, x, CLIP)
        model = model.double()
    opt = make_optimizer(model, LR)
    opt.load_state_dict(copy.deepcopy(state[1].state_dict()))
    if channels_last:
        make_train_step(model, opt)(x)
        return dryrun.model_step(model)
    opt.zero_grad(set_to_none=True)
    if float64:
        for n, p in model.named_parameters():
            p.grad = grads[n]
    else:
        accumulate(model, x, x[0].numel())
        for p in model.parameters():
            p.grad.div_(x.shape[0])
    apply_gradients(opt)
    return dryrun.model_step(model)


@pytest.fixture(scope="module")
def reference():
    """Per model and start: (the state, the batch, the float32 step from
    it, the float64 step)."""
    out = {}
    for name, (cfg, make) in MODELS.items():
        params = make()
        x1, x2 = batches()
        for label, state, x in (("first_step", start(cfg, params), x1),
                                ("second_step", start(cfg, params, x1), x2)):
            out[name, label] = (state, x, step(state, x),
                                step(state, x, float64=True))
    return out


def margins(r: dict) -> str:
    return (f"{dryrun.rule_line(r)}; margins: gradients "
            f"{r['grad_bound'] / max(r['grad_rel_l2'], 1e-300):.3g}x, noise "
            f"{1 / max(r['beyond_signal_ratio'], 1e-300):.3g}x")


@pytest.mark.parametrize("pair", ["reversed_batch", "float32_vs_float64",
                                  "channels_last_vs_nchw"])
@pytest.mark.parametrize("begin", ["first_step", "second_step"])
@pytest.mark.parametrize("model", list(MODELS))
def test_sound_pairs_pass_with_margin(reference, model, begin, pair):
    """A step against itself with each microbatch's images reversed
    (bound GRAD_REL_L2, the parallel comparison's), a float32 step
    against the float64 one and a channels-last step against NCHW (bound
    CARD_CPU_GRAD_REL_L2, the other-arithmetic comparison's; both with
    the float64 gradients as the signs' reference) pass the rule, 3x
    inside the gradient bound and the noise band: Adam's first step
    (where a gradient at float noise moves its parameter by ~lr either
    way) and a second.  The old rule (99.9 % within 1e-3 lr) also passes
    these CPU pairs: the card's larger rounding differences are what it
    could not take (PERF.md §6)."""
    state, x, f32, (p64, g64) = reference[model, begin]
    if pair == "reversed_batch":
        r = dryrun.step_rule(*step(state, x, flip=True), *f32, LR,
                             dryrun.GRAD_REL_L2, exact=g64)
    elif pair == "float32_vs_float64":
        r = dryrun.step_rule(*f32, p64, g64, LR,
                             dryrun.CARD_CPU_GRAD_REL_L2)
    else:
        r = dryrun.step_rule(*step(state, x, channels_last=True), *f32, LR,
                             dryrun.CARD_CPU_GRAD_REL_L2, exact=g64)
    print(f"{model} {begin} {pair}: {margins(r)}")
    assert r["ok"], margins(r)
    assert r["grad_rel_l2"] <= r["grad_bound"] / 3, margins(r)
    assert r["beyond_signal_ratio"] <= 1 / 3, margins(r)


_ADAM_STEP = torch.optim.Adam.step
_FORWARD = LLICTIModel.forward


def _no_update(self, closure=None):
    return None


def _mis_scaled(self, closure=None):  # the step at 1.01 x its lr
    for group in self.param_groups:
        group["lr"] *= 1.01
    try:
        return _ADAM_STEP(self)
    finally:
        for group in self.param_groups:
            group["lr"] /= 1.01


def _moments_lost(self, closure=None):  # each step starts Adam afresh
    self.state.clear()
    return _ADAM_STEP(self)


def _zeroed_band(self, x, halo=None):  # band 1 passes back no gradient
    out = []
    for si in _FORWARD(self, x, halo):
        w = si.shape[-1] // 3
        out.append(torch.cat((si[..., :w], si[..., w:2 * w].detach(),
                              si[..., 2 * w:]), dim=-1))
    return out


def _sign_flipped(self, closure=None):
    """The largest tensor's largest gradient, far above float noise,
    with its sign flipped."""
    p = max((p for g in self.param_groups for p in g["params"]),
            key=torch.numel)
    g = p.grad.view(-1)
    g[g.abs().argmax()] *= -1
    return _ADAM_STEP(self)


_ADAM, _MODEL = (torch.optim.Adam, "step"), (LLICTIModel, "forward")


@pytest.mark.parametrize("where,fault", [
    (_ADAM, _no_update), (_ADAM, _mis_scaled), (_ADAM, _moments_lost),
    (_MODEL, _zeroed_band), (_ADAM, _sign_flipped),
], ids=["no_update", "mis_scaled", "moments_lost", "zeroed_band",
        "sign_flipped"])
def test_faults_fail_the_rule(reference, where, fault, monkeypatch):
    """Each fault in the tiny model's second step, held to the sound
    float32 step (bound GRAD_REL_L2): no update, the update at 1.01 x lr and
    Adam's moments lost each move parameters beyond 1e-3 lr where the
    gradient is far above noise; a zeroed band's gradients leave the
    gradient bound; one flipped gradient sign above noise is the one
    entry beyond 1e-3 lr with signal, which the old share (99.9 % within
    1e-3 lr) lets through."""
    state, x, f32, (_, g64) = reference["tiny", "second_step"]
    monkeypatch.setattr(*where, fault)
    r = dryrun.step_rule(*step(state, x), *f32, LR, dryrun.GRAD_REL_L2,
                         exact=g64)
    print(f"{fault.__name__}: {dryrun.rule_line(r)}")
    assert not r["ok"]
    if fault is _zeroed_band:
        assert r["grad_rel_l2"] > 100 * dryrun.GRAD_REL_L2
    elif fault is _sign_flipped:
        assert r["beyond_with_signal"] == 1
        assert r["beyond_signal_ratio"] > 100
        assert r["param_within"] >= 0.999
    else:
        assert r["beyond_with_signal"] > 0 and r["beyond_signal_ratio"] > 100
