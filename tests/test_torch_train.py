"""The port's training pieces against the JAX package's: lower_bound's
gradient, the rate-loss gradients, clip + Adam, grad accumulation, one
train step against JAX's jitted step, the plateau schedule, the
configuration files, the loaders, the rate table's text and the
factorized prior; and the channels-last step ``make_train_step`` builds
against the same step on the model in NCHW (``dryrun.step_rule`` at
``GRAD_REL_L2``, float32 rounding in another order), and a codec of its
trained weights against the same weights held NCHW (byte-equal).

Tolerances: the rate-loss gradients in float64 on both sides, rtol 1e-7
and atol 1e-9 * max|g| per tensor (the same arithmetic; why not float32
is in that test);
grad accumulation rtol 2e-4 / atol 2e-6, the bound of JAX's own
``test_grad_acc_equivalent_to_big_batch`` (``tests/test_train.py:60``);
clip + Adam rtol 1e-6 / atol 1e-4 * lr (optax's float32 bias
corrections).  JAX's jitted float32 forward moves single random-weight
pixels by up to 7.57 bits away from its eager one (ROADMAP C6), so the
one test of JAX's jitted float32 ``make_train_step`` has the looser bound
that test states.
"""
import torch_helpers  # noqa: F401  (first: caps torch's threads)
import dataclasses
import logging
from datetime import datetime

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llicti_tpu import config as jconfig
from llicti_tpu.data import dataset as jdata
from llicti_tpu.models.llicti import LLICTIModel as JaxModel
from llicti_tpu.ops.bounds import lower_bound as jax_lower_bound
from llicti_tpu.ops.factorized import FactorizedPrior as JaxPrior
from llicti_tpu.training import loss as jloss
from llicti_tpu.training import steps as jsteps
from llicti_tpu.training.schedule import ReduceLROnPlateau as JaxPlateau
from llicti_tpu.utils import logging_utils as jlog
from llicti_torch import config as tconfig
from llicti_torch.data import dataset as tdata
from llicti_torch.ops.bounds import lower_bound
from llicti_torch.ops.factorized import FactorizedPrior
from llicti_torch.parallel import dryrun
from llicti_torch.training import loss as tloss
from llicti_torch.training import steps as tsteps
from llicti_torch.training.schedule import ReduceLROnPlateau
from llicti_torch.utils import logging_utils as tlog
from llicti_torch.weights import (_torch_name, adam_state_from_optax,
                                  flat_params, init_params, params_from_flax)
from test_torch_model import nested

# the configurations whose gradients are held against JAX's
GRAD_CONFIGS = [
    {}, {"clr_joint_mode": 1},
    {"clr_joint_mode": 0, "clrjnt0seqmd": True, "distribution": "logistic"},
    {"activfun": "GDN1"}, {"mwsa_joint": True}, {"combine_layers1toL": True}]


def tiny_cfg(**kw):
    base = dict(chs=(8, 1), evens=(4, 4), odds=(3, 3), dwtlevels=(0, 1),
                useprevlevNN=(False, True))
    base.update(kw)
    return tconfig.ModelConfig(**base)


def jax_cfg(cfg):
    return jconfig.ModelConfig(**dataclasses.asdict(cfg))


def patches(n, seed, P=32):
    """``n`` float32 [P, P, 3] patches of synthetic natural images."""
    imgs = [jdata.synthetic_natural_image(P, P, seed + i) for i in range(n)]
    return np.stack(imgs).astype(np.float32) / 255.0


def torch_view(flax_name, arr):
    """A Flax-named array as the port holds it (conv kernels OIHW)."""
    arr = np.asarray(arr)
    return arr.transpose(3, 2, 0, 1) if flax_name.endswith(
        "Conv_0/kernel") else arr


def assert_grads_close(ref, got, label, rtol, atol_rel):
    """``ref``: {flax name: JAX gradient}; ``got``: {torch name: the
    port's}.  Each tensor within rtol and atol = atol_rel * max|ref|."""
    assert sorted(_torch_name(n) for n in ref) == sorted(got)
    worst = 0.0
    for name, g in ref.items():
        g = torch_view(name, g)
        t = got[_torch_name(name)]
        scale = float(np.abs(g).max())
        if scale > 0:
            worst = max(worst, float(np.abs(t - g).max()) / scale)
        np.testing.assert_allclose(t, g, rtol=rtol, atol=atol_rel * scale,
                                   err_msg=f"{label}: {name}")
    print(f"{label}: largest gradient deviation {worst:.3g} of the "
          "tensor's max|g|")


def test_lower_bound_gradient_matches_custom_vjp():
    """x below, at and above the bound, g of both signs and 0."""
    bound = 0.25
    x = np.array([-1.0, 0.1, bound, bound, 0.5, 2.0, -3.0, bound, 0.2, 1.0],
                 np.float32)
    g = np.array([1.0, -2.0, 0.5, -0.5, 3.0, -1.0, 0.0, 0.0, -0.1, 0.0],
                 np.float32)
    y_ref, vjp = jax.vjp(lambda v: jax_lower_bound(v, bound), jnp.asarray(x))
    (g_ref,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    y = lower_bound(xt, bound)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(g_ref))
    # without a recorded gradient it is clamp_min, as the codec calls it
    with torch.inference_mode():
        np.testing.assert_array_equal(
            lower_bound(torch.from_numpy(x), bound).numpy(), np.asarray(y_ref))


def jax_rate_grads(cfg, flat, x):
    """JAX's float64 total rate, breakdown and gradients of ``x``."""
    jm = JaxModel(cfg=jax_cfg(cfg))

    def loss_fn(params, xb):
        return jloss.rate_loss_list(xb.size, jm.apply(params, xb))

    with jax.enable_x64(True):
        (total, bd), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(
            nested({n: a.astype(np.float64) for n, a in flat.items()}),
            jnp.asarray(x.astype(np.float64)))
        return (float(total), np.asarray(bd),
                {n: np.asarray(g) for n, g in flat_params(grads).items()})


def port_rate_grads(cfg, flat, x, dtype):
    model = params_from_flax(flat, cfg).to(dtype)
    total, bd = tloss.rate_loss_list(x.size, model(torch.from_numpy(x).to(
        dtype)))
    total.backward()
    return (total.item(), bd.detach().double().numpy(),
            {n: p.grad.double().numpy() for n, p in model.named_parameters()})


@pytest.mark.parametrize("kw", GRAD_CONFIGS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "clrjnt2-normal")
def test_rate_loss_gradients_match_jax(kw):
    """The port's total rate, breakdown and gradients against JAX's, both
    in float64 (``jax.enable_x64``), where JAX's jitted program equals its
    eager one (4.2e-16 relative on clrjnt 2): rtol 1e-7 and atol 1e-9 *
    max|g| per tensor, the same arithmetic rounded in other orders.

    Why not float32: the two frameworks' float32 gradients cannot be held
    elementwise to rtol 2e-4 / atol 1e-5 * max|g|.  A pixel whose mixture
    weight or likelihood sits within an ulp of its lower_bound has its
    gradient passed in one framework and cut in the other (the bound's
    gradient is discontinuous there): against eager float32 JAX, 3 of
    1,536 entries of a clrjnt 1 kernel missed that bound, and other seeds
    of the seqmd logistic configuration moved single entries by 7e-4 of
    the tensor's max|g|.  Float32 and float64 runs are not comparable
    either: YCoCg-R's rounding ties fall differently.  The float32 step
    is held against JAX's in ``test_train_step_matches_jitted_jax_step``,
    and on the card against the CPU by ``chip_smoke.py``."""
    cfg = tiny_cfg(**kw)
    flat = init_params(cfg, 2)
    x = patches(2, 10)
    j_total, j_bd, j_g = jax_rate_grads(cfg, flat, x)
    total, bd, g = port_rate_grads(cfg, flat, x, torch.float64)
    assert bd.shape == (2, 9)
    np.testing.assert_allclose(total, j_total, rtol=1e-12)
    np.testing.assert_allclose(bd, j_bd, rtol=1e-10, atol=1e-12)
    assert_grads_close(j_g, g, f"{kw} float64", rtol=1e-7, atol_rel=1e-9)


def random_grads(flat, rng, scale):
    """Gradient trees in Flax names, some entries beyond the clip."""
    return {n: (rng.standard_normal(a.shape) * scale).astype(np.float32)
            for n, a in flat.items()}


def torch_opt_step(model, opt, grads):
    for n, p in model.named_parameters():
        p.grad = None
    names = {_torch_name(n): n for n in grads}
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(np.ascontiguousarray(
            torch_view(names[n], grads[names[n]])))
    tsteps.apply_gradients(opt, 5.0)


def assert_params_close(model, flat, label, lr):
    """Within rtol 1e-6 and atol 1e-4 * lr: optax computes Adam's bias
    corrections 1 - beta^t in float32 (relative error up to 6e-5 at t = 1
    for beta2 = 0.999, 3e-5 in the update), PyTorch in float64."""
    ref = {_torch_name(n): torch_view(n, a) for n, a in flat.items()}
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], rtol=1e-6,
                                   atol=1e-4 * lr, err_msg=f"{label}: {n}")


def test_clip_and_adam_match_optax():
    """Three steps of clip(5) + Adam(1e-3) on identical gradient trees,
    then a fresh port optimiser continuing from optax's moments carried
    over by adam_state_from_optax."""
    cfg = tiny_cfg()
    flat = init_params(cfg, 4)
    rng = np.random.default_rng(5)
    grads = [random_grads(flat, rng, s) for s in (3.0, 0.1, 10.0, 1.0)]
    tx = jsteps.make_optimizer(1e-3, 5.0)
    jparams = nested(flat)
    jstate = tx.init(jparams)
    model = params_from_flax(flat, cfg)
    opt = tsteps.make_optimizer(model, 1e-3)
    for k, g in enumerate(grads[:3]):
        upd, jstate = tx.update(nested(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        torch_opt_step(model, opt, g)
        assert_params_close(model, flat_params(jparams), f"step {k}", 1e-3)
    # continue from JAX's state in a new port model and optimiser
    adam = jstate.inner_state[1][0]
    model2 = params_from_flax(flat_params(jparams), cfg)
    opt2 = tsteps.make_optimizer(model2, 1e-3)
    sd = opt2.state_dict()
    sd["state"] = adam_state_from_optax(adam.mu, adam.nu, int(adam.count),
                                        model2)
    opt2.load_state_dict(sd)
    upd, jstate = tx.update(nested(grads[3]), jstate, jparams)
    jparams = optax.apply_updates(jparams, upd)
    torch_opt_step(model2, opt2, grads[3])
    assert_params_close(model2, flat_params(jparams), "carried-over step",
                        1e-3)
    assert float(opt2.state_dict()["state"][0]["step"]) == 4
    with pytest.raises(ValueError):
        adam_state_from_optax({}, {}, 1, model2)


def test_learning_rate_set_and_get():
    model = params_from_flax(init_params(tiny_cfg(), 0), tiny_cfg())
    opt = tsteps.make_optimizer(model, 1e-4)
    assert tsteps.get_learning_rate(opt) == 1e-4
    tsteps.set_learning_rate(opt, 5e-5)
    assert tsteps.get_learning_rate(opt) == 5e-5


def test_grad_acc_equivalent_to_big_batch():
    """acc=2 with B=2 must match acc=1 with B=4 (same samples): the
    gradients, the step and the metrics."""
    cfg = tiny_cfg()
    flat = init_params(cfg, 1)
    x = patches(4, 20)
    out = []
    for acc in (1, 2):
        model = params_from_flax(flat, cfg)
        opt = tsteps.make_optimizer(model, 1e-3)
        step = tsteps.make_train_step(model, opt)
        m = step(torch.from_numpy(x.reshape(acc, 4 // acc, 32, 32, 3)))
        out.append((m, {n: (p.grad.clone(), p.detach().clone())
                        for n, p in model.named_parameters()}))
    (m1, s1), (m2, s2) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m1["breakdown"].numpy(),
                               m2["breakdown"].numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(m1["breakdown"].sum()),
                               float(m1["loss"]), rtol=1e-5)
    for n in s1:
        np.testing.assert_allclose(s1[n][0].numpy(), s2[n][0].numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=n)


def nchw_step(model, opt, batch):
    """``make_train_step``'s arithmetic on a model left in NCHW -> the
    mean loss."""
    opt.zero_grad(set_to_none=True)
    loss, _ = tsteps.accumulate(model, batch, batch[0].numel())
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(batch.shape[0])
    tsteps.apply_gradients(opt, 5.0)
    return loss / batch.shape[0]


# llicti_B's widths (2 scales, chs 60, clrjnt 2) on 32x32 patches
B_SHAPED = dict(chs=(60, 1))


@pytest.mark.parametrize("case", ["llicti_B", "tiny_acc2_clrjnt0",
                                  "llicti_B_resumed"])
def test_channels_last_step_matches_nchw(case):
    """``make_train_step`` puts the model in channels-last and gives, from
    the same weights and batch, the loss and parameters of the same step
    on the model in NCHW, within float32 rounding; with Adam's state
    already held ("resumed": one NCHW step first), the state goes
    channels-last too and the next step still agrees."""
    cfg = tiny_cfg(**({"clr_joint_mode": 0, "clrjnt0seqmd": True}
                      if case == "tiny_acc2_clrjnt0" else B_SHAPED))
    flat = init_params(cfg, 4)
    acc = 2 if case == "tiny_acc2_clrjnt0" else 1
    batches = [torch.from_numpy(patches(4, 40 + 4 * i).reshape(
        acc, 4 // acc, 32, 32, 3)) for i in range(2)]
    lr = 1e-3
    ref = params_from_flax(flat, cfg).train()
    ref_opt = tsteps.make_optimizer(ref, lr)
    model = params_from_flax(flat, cfg).train()
    opt = tsteps.make_optimizer(model, lr)
    if case == "llicti_B_resumed":
        for m, o in ((ref, ref_opt), (model, opt)):
            nchw_step(m, o, batches[0])
        assert all(s["exp_avg"].is_contiguous() for s in opt.state.values())
    params = list(model.parameters())
    step = tsteps.make_train_step(model, opt)
    assert [id(p) for p in model.parameters()] == [id(p) for p in params]
    w = model.models[0][0].conv_00_11.weight
    assert w.stride(1) == 1 and w.is_contiguous(
        memory_format=torch.channels_last)
    for s in opt.state.values():  # the resumed case's moments
        assert all(s[k].stride() == p.stride() for k in ("exp_avg",
                   "exp_avg_sq") for p in [w] if s[k].shape == w.shape)
    x = batches[1]
    got = float(step(x)["loss"])
    want = float(nchw_step(ref, ref_opt, x))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # float32 rounding: the gradients within the parallel comparison's
    # relative L2, every parameter within Adam's rule (a gradient at
    # rounding noise moves its parameter by up to lr either way)
    r = dryrun.step_rule(*dryrun.model_step(model),
                         *dryrun.model_step(ref), lr, dryrun.GRAD_REL_L2)
    assert r["ok"], dryrun.rule_line(r)
    for n, p in model.named_parameters():
        if p.dim() == 4:
            assert p.grad.stride() == p.stride(), n
    assert w.stride(1) == 1  # the step left the layout as it found it


def test_codec_of_channels_last_trained_params_is_byte_equal():
    """A ``Codec`` built from a channels-last trained model's parameters
    codes an image to the container that the same weights held NCHW
    give."""
    from llicti_torch.codec import Codec
    from llicti_torch.weights import flax_from_state_dict
    cfg = tiny_cfg(**B_SHAPED)
    model = params_from_flax(init_params(cfg, 5), cfg).train()
    tsteps.make_train_step(model, tsteps.make_optimizer(model, 1e-3))(
        torch.from_numpy(patches(2, 50).reshape(1, 2, 32, 32, 3)))
    state = model.state_dict()
    assert state["models.0.0.conv_00_11.weight"].stride(1) == 1
    nchw = {k: v.contiguous() for k, v in state.items()}
    img = (patches(1, 60, P=64)[0, :, :48] * 255).round().astype(np.uint8)
    got, want = (Codec(cfg, flax_from_state_dict(s, cfg), device="cpu",
                       num_lanes=64).compress(img) for s in (state, nchw))
    assert got == want


def test_train_step_matches_jitted_jax_step():
    """One acc=2 step of the port against JAX's jitted make_train_step
    from the same parameters.  The looser bound of the jitted program
    (ROADMAP C6: it moves single pixels by up to 7.57 bits): the loss and
    the breakdown within 1e-3 relative (a 7.57-bit pixel moves this
    batch's mean rate by ~1e-4 of it); after Adam's first step, whose size
    is lr * g / (|g| + eps), every parameter within 2 * lr of JAX's (a
    gradient near 0 may take either sign) and 99 % of them within
    1e-3 * lr."""
    cfg = tiny_cfg()
    flat = init_params(cfg, 6)
    batch = patches(4, 30).reshape(2, 2, 32, 32, 3)
    lr = 1e-3
    jm = JaxModel(cfg=jax_cfg(cfg))
    tx = jsteps.make_optimizer(lr, 5.0)
    jparams = nested(flat)
    jstate = jsteps.TrainState(jparams, tx.init(jparams),
                               jnp.zeros((), jnp.int32))
    jstate, jm_out = jax.jit(jsteps.make_train_step(jm, tx))(
        jstate, jnp.asarray(batch))
    model = params_from_flax(flat, cfg)
    opt = tsteps.make_optimizer(model, lr)
    m = tsteps.make_train_step(model, opt)(torch.from_numpy(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm_out["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(m["breakdown"].numpy(),
                               np.asarray(jm_out["breakdown"]), rtol=1e-3,
                               atol=1e-4)
    ref = {_torch_name(n): torch_view(n, a)
           for n, a in flat_params(jstate.params).items()}
    dev = np.concatenate([np.abs(p.detach().numpy() - ref[n]).ravel()
                          for n, p in model.named_parameters()])
    close = float(np.mean(dev <= 1e-3 * lr))
    print(f"after one step: largest parameter deviation {dev.max():.3g} "
          f"(lr {lr}), {100 * close:.2f} % within 1e-3 * lr")
    assert dev.max() <= 2 * lr
    assert close >= 0.99


def test_plateau_scheduler_matches_jax():
    rng = np.random.default_rng(7)
    metric = 10 - np.cumsum(rng.uniform(-0.3, 0.5, 200)) * 0.01
    metric[60:120] = metric[60]  # a long stall: reductions and cooldowns
    kw = dict(lr=1e-3, patience=4, cooldown=3, min_lr=1e-5)
    ref, got = JaxPlateau(**kw), ReduceLROnPlateau(**kw)
    lrs = []
    for v in metric:
        lrs.append(got.step(float(v)))
        assert lrs[-1] == ref.step(float(v))
    assert min(lrs) < kw["lr"]  # the sequence reduced the lr
    assert got.state_dict() == ref.state_dict()
    again = ReduceLROnPlateau(lr=1.0)
    again.load_state_dict(got.state_dict())
    assert again.state_dict() == got.state_dict()


@pytest.mark.parametrize("name", ["paper_a", "small_b"])
def test_config_files_parse_equal(name):
    path = f"configs/{name}.json"
    got, ref = tconfig.config_from_json(path), jconfig.config_from_json(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.checkpoint_dir == ref.checkpoint_dir
    assert tconfig.replace(got, mode="test").mode == "test"


def dataset_pair(**kw):
    return tdata.ImageDataset(**kw), jdata.ImageDataset(**kw)


@pytest.mark.parametrize("ppi", [1, 2])
def test_train_loader_batches_byte_equal(ppi):
    tds, jds = dataset_pair(synthetic_len=6, synthetic_size=48, seed=11)
    kw = dict(batch_size=2, patch_size=32, grad_acc=2, patches_per_img=ppi,
              seed=5, num_threads=2)
    tl, jl = tdata.TrainLoader(tds, **kw), jdata.TrainLoader(jds, **kw)
    assert tl.steps_per_epoch() == jl.steps_per_epoch()
    for epoch in range(2):
        got, ref = list(tl), list(jl)
        assert len(got) == len(ref) == 6 * ppi // 4
        for a, b in zip(got, ref):
            assert a.dtype == np.float32 and a.shape == (2, 2, 32, 32, 3)
            assert a.tobytes() == b.tobytes(), f"epoch {epoch}"
    assert tl.epoch == 2


def test_eval_loader_batches_byte_equal():
    tds, jds = dataset_pair(synthetic_len=5, synthetic_size=40, seed=3)
    for size, bs in ((0, 1), (32, 2), (64, 3)):
        got = list(tdata.EvalLoader(tds, size, batch_size=bs))
        ref = list(jdata.EvalLoader(jds, size, batch_size=bs))
        assert [a.tobytes() for a in got] == [b.tobytes() for b in ref]
        assert [a.tobytes() for a in tdata.EvalLoader(tds, size).iter_uint8()
                ] == [b.tobytes() for b in
                      jdata.EvalLoader(jds, size).iter_uint8()]
    img = jdata.synthetic_image(20, 30, 1)
    rng_t, rng_j = np.random.default_rng(2), np.random.default_rng(2)
    assert np.array_equal(tdata.random_patch(img, 24, rng_t),
                          jdata.random_patch(img, 24, rng_j))
    assert np.array_equal(tdata._resize_to_fit(img, 41, 17),
                          jdata._resize_to_fit(img, 41, 17))


class _FixedClock(datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime(2026, 1, 2, 3, 4, 5)


@pytest.mark.parametrize("typ", ["tr", "te", "va", "it"])
def test_rate_table_text_equal(typ, caplog, monkeypatch):
    monkeypatch.setattr(jlog, "datetime", _FixedClock)
    monkeypatch.setattr(tlog, "datetime", _FixedClock)
    rng = np.random.default_rng(8)
    rates = [rng.uniform(0, 3, (3, 9)) for _ in range(4)]
    texts, outs = [], []
    for mod in (tlog, jlog):
        lg = mod.RateLogger()
        for r in rates:
            lg(r)
        with caplog.at_level(logging.INFO, logger="Rate Loss"):
            caplog.clear()
            outs.append(lg.display(lr=1.5e-4, typ=typ,
                                   epoch=None if typ == "va" else 7))
            texts.append(caplog.records[-1].getMessage())
        assert lg.state_dict()["it"] == 4
    assert texts[0] == texts[1]
    assert outs[0] == outs[1]
    assert "(lr: 0.000150)" in texts[0] or typ in ("te", "va")


def prior_pair(channels, **kw):
    """A JAX FactorizedPrior's parameters, and the port's prior holding
    them (the Flax names are the PyTorch names)."""
    jp = JaxPrior(channels=channels, **kw)
    params = jp.init(jax.random.PRNGKey(channels), jnp.zeros((4, channels)))
    tp = FactorizedPrior(channels, **kw)
    tp.load_state_dict({n: torch.from_numpy(np.array(a)) for n, a in
                        flat_params(params).items()}, strict=True)
    return jp, params, tp


def test_factorized_prior_matches_jax():
    jp, params, tp = prior_pair(2, init_scale=4.0, tail_mass=0.05)
    rng = np.random.default_rng(9)
    x = (rng.integers(-60, 61, (50, 2)) / 255).astype(np.float32)
    pts = np.linspace(-0.3, 0.3, 41, dtype=np.float32)
    for method, arg, targ in ((JaxPrior.likelihood, x, x),
                              (JaxPrior.__call__, x, x),
                              (JaxPrior.cdf_table, pts, pts)):
        ref = np.asarray(jp.apply(params, jnp.asarray(arg), method=method))
        fn = {"likelihood": tp.likelihood, "__call__": tp,
              "cdf_table": tp.cdf_table}[method.__name__]
        got = fn(torch.from_numpy(targ)).detach().numpy()
        assert got.shape == ref.shape
        # masses to 1e-7 (a difference of two sigmoids, each within an
        # ulp); bits to 1e-3, that error relative to masses of ~1e-4
        np.testing.assert_allclose(
            got, ref, rtol=1e-5,
            atol=1e-3 if method is JaxPrior.__call__ else 1e-7,
            err_msg=method.__name__)
    ref_loss, ref_grad = jax.value_and_grad(
        lambda p: jp.apply(p, method=JaxPrior.loss))(params)
    loss = tp.loss()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for name, g in flat_params(ref_grad).items():
        p = dict(tp.named_parameters())[name]
        if name == "quantiles":
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(g),
                                       rtol=1e-5, atol=1e-6)
        else:  # density parameters are stopped: no gradient reaches them
            assert p.grad is None and not np.asarray(g).any(), name
    np.testing.assert_array_equal(
        tp.medians().detach().numpy(),
        np.asarray(jp.apply(params, method=JaxPrior.medians)))


def test_factorized_prior_init_and_aux_loss():
    """The port's own init: the JAX shapes, biases from the seed (the
    global RNG untouched), and aux_loss 0 for the live model."""
    _, params, _ = prior_pair(3)
    shapes = {n: a.shape for n, a in flat_params(params).items()}
    torch.manual_seed(0)
    before = torch.rand(1)
    torch.manual_seed(0)
    a, b = FactorizedPrior(3, seed=1), FactorizedPrior(3, seed=1)
    assert torch.rand(1) == before
    assert {n: tuple(p.shape) for n, p in a.named_parameters()} == shapes
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert not torch.equal(a.b0, FactorizedPrior(3, seed=2).b0)
    model = params_from_flax(init_params(tiny_cfg(), 0), tiny_cfg())
    aux = model.aux_loss()
    assert float(aux) == 0.0 and aux.device == torch.device("cpu")
    model.models[0][1].factorized_prior = a  # a band model holding a prior
    np.testing.assert_allclose(model.aux_loss().item(), a.loss().item())


def test_params_from_flax_names_a_band_prior():
    assert (_torch_name("models_0_2/factorized_prior/quantiles")
            == "models.0.2.factorized_prior.quantiles")
    assert (_torch_name("models_1_0/factorized_prior/H3")
            == "models.1.0.factorized_prior.H3")
    with pytest.raises(KeyError):
        _torch_name("models_0_0/factorized_prior/Z0")
