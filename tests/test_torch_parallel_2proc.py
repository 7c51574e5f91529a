"""The port's multi-device path across two processes on the CPU (gloo).

One spawn of two ranks (this file run as a script: the worker, which
imports no JAX) drives every case and writes what it saw to an .npz a
rank; the tests read them:
  * a data-parallel step (data = 2) against the port's single-process
    step on the same global batch (loss rtol 1e-5, parameters rtol 1e-4 /
    atol 1e-6, as tests/test_sharding.py);
  * data = 1 x spatial = 2: the sharded rate and a step against one
    process, and the halo exchange's gradient (also across two ranks'
    blocks) against autograd through replicate padding;
  * the row-sharded codec at G = 4 over 2 ranks: the same container on
    both ranks, lossless, its coder closure, and the parent holds it
    against JAX's ShardedCodec on 4 fake devices (streams[0] byte-equal,
    num_bytes within max(0.1 %, 16 B)), with the weights the parent made;
  * the Trainer with num_data_shards=2: two data-parallel steps (equal
    parameters on both ranks) and eval_model through the sharded codec;
  * the multi-device dry run (``parallel/dryrun.py``) at tiny widths:
    part (a), JAX's ``dryrun_multichip``, its loss and its five-scale
    container held against JAX's by the parent; parts (b)-(e), which
    check themselves in both ranks; and part (d)'s step with a wrong
    halo exchange, which must fail its gradient rule.
A second spawn runs the runner under torchrun with --mesh.
"""
import torch_helpers  # first: caps torch's threads
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 240  # seconds of a spawn; one takes ~20 s on an idle CPU


def natural_image(h, w, seed=0):
    """tests/test_codec_roundtrip.py's image (that module imports JAX)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (127 + 80 * np.sin(yy / 17.0) * np.cos(xx / 23.0)
            + 40 * np.sin((xx + yy) / 41.0))
    img = np.stack([base, base * 0.8 + 20, base * 0.6 + 50], axis=-1)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


CODEC_IMG = (64, 48, 41)  # h, w, seed
CODEC_G, CODEC_N = 4, 16


# ---- the worker (two processes, no JAX) -----------------------------------

def _tiny():
    from llicti_torch.config import ModelConfig
    return ModelConfig(chs=(8, 1), evens=(4, 4), odds=(3, 3),
                       dwtlevels=(0, 1), useprevlevNN=(False, True))


def _flat(model):
    return np.concatenate([p.detach().reshape(-1).numpy()
                           for p in model.parameters()])


def _step_pair(cfg, batch, mesh, seed):
    """(metrics, parameters) of one parallel step on this rank's part and,
    on rank 0, of the single-process step on the whole batch."""
    import torch
    from llicti_torch.parallel import (batch_sharding,
                                       make_parallel_train_step, shard_state)
    from llicti_torch.training import make_optimizer, make_train_step
    from llicti_torch.weights import init_params, params_from_flax

    out = {}
    model = params_from_flax(init_params(cfg, seed), cfg)
    opt = make_optimizer(model, 1e-4)
    shard_state(model, opt, mesh)
    local = batch_sharding(mesh, has_acc_axis=True)(batch)
    m = make_parallel_train_step(model, opt, mesh)(
        torch.from_numpy(np.ascontiguousarray(local)))
    out["loss"], out["params"] = float(m["loss"]), _flat(model)
    out["breakdown"] = m["breakdown"].numpy()
    if mesh.rank == 0:
        ref = params_from_flax(init_params(cfg, seed), cfg)
        m = make_train_step(ref, make_optimizer(ref, 1e-4))(
            torch.from_numpy(batch))
        out["ref_loss"], out["ref_params"] = float(m["loss"]), _flat(ref)
    return out


def _halo_grads(group, rank, top, bottom, h):
    """(this rank's gradient through halo_rows, the whole image's through
    replicate padding) of sum(w * haloed block) summed over the ranks."""
    import torch
    from llicti_torch.parallel.halo import halo_rows
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((2, 2 * h, 5, 3), generator=gen, dtype=torch.float64)
    w = torch.randn((2, 2, top + h + bottom, 5, 3), generator=gen,
                    dtype=torch.float64)
    mine = x[:, rank * h:(rank + 1) * h].clone().requires_grad_(True)
    (w[rank] * halo_rows(mine, top, bottom, group)).sum().backward()
    full = x.clone().requires_grad_(True)
    rows = torch.arange(-top, 2 * h + bottom).clamp(0, 2 * h - 1)
    padded = full[:, rows]
    sum((w[r] * padded[:, r * h:r * h + top + h + bottom]).sum()
        for r in range(2)).backward()
    return mine.grad.numpy(), full.grad[:, rank * h:(rank + 1) * h].numpy()


def _own_rows_halo(x, top, bottom, group=None):
    """A wrong halo exchange: this rank's block padded with its own edge
    rows (as one device pads the image's edges), not its neighbours'."""
    import torch
    h = x.shape[1]
    return x[:, torch.arange(-top, h + bottom).clamp(0, h - 1)]


def worker(rank, port, out_dir):
    import torch

    from llicti_torch.parallel import mesh as mesh_module

    from llicti_torch.config import (DataConfig, LLICTIConfig, ModelConfig,
                                     TrainConfig)
    from llicti_torch.parallel import (ShardedCodec, dryrun, initialize,
                                       make_mesh, make_sharded_rate_fn,
                                       make_sp_mesh)
    from llicti_torch.training.loss import rate_loss_list
    from llicti_torch.training.trainer import Trainer
    from llicti_torch.weights import init_params, params_from_flax

    torch.set_num_threads(1)
    assert initialize(f"localhost:{port}", 2, rank, device="cpu")
    assert torch.distributed.get_backend() == "gloo"
    res = {}
    cfg = _tiny()

    # data = 2: one step of an [1, 8, 32, 32, 3] batch
    data = make_mesh(data=2)
    batch = np.random.default_rng(0).uniform(
        0.2, 0.8, (1, 8, 32, 32, 3)).astype(np.float32)
    for k, v in _step_pair(cfg, batch, data, 0).items():
        res["dp_" + k] = v

    # data = 1 x spatial = 2: the rate, a step, halo gradients
    sp = make_mesh(data=1, spatial=2)
    x = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    model = params_from_flax(init_params(cfg, 0), cfg)
    total, bd = make_sharded_rate_fn(model, sp)(x)
    res["rate"], res["rate_bd"] = float(total), bd.numpy()
    with torch.no_grad():
        ref, ref_bd = rate_loss_list(x.size, model(torch.from_numpy(x)))
    res["rate_ref"], res["rate_bd_ref"] = float(ref), ref_bd.numpy()
    batch = np.random.default_rng(1).uniform(
        0.2, 0.8, (2, 4, 32, 32, 3)).astype(np.float32)
    for k, v in _step_pair(cfg, batch, sp, 1).items():
        res["sp_" + k] = v
    for name, (top, bottom, h) in {"halo": (2, 1, 3),
                                   "halo_far": (2, 2, 1)}.items():
        res[name], res[name + "_ref"] = _halo_grads(sp.spatial_group, rank,
                                                    top, bottom, h)
    try:
        make_sp_mesh(3)
        res["uneven_refused"] = False
    except ValueError:
        res["uneven_refused"] = True

    # the row-sharded codec, G = 4 over 2 ranks
    params = dict(np.load(os.path.join(out_dir, "codec_params.npz")))
    small = ModelConfig(chs=(8, 8), evens=(4, 4), odds=(3, 3),
                        dwtlevels=(0, 1), useprevlevNN=(False, True))
    codec = ShardedCodec(small, params, mesh=make_sp_mesh(CODEC_G),
                         num_lanes=CODEC_N, device="cpu")
    h, w, seed = CODEC_IMG
    img = natural_image(h, w, seed)
    streams = codec.compress(img)
    res["container"] = np.frombuffer(ShardedCodec.serialize(streams),
                                     np.uint8)
    res["num_bytes"] = ShardedCodec.num_bytes(streams)
    res["act"] = np.sum(codec.last_slice_bits)
    res["ideal"] = np.sum(codec.last_ideal_bits)
    res["scale_bits"] = np.sum(codec.last_slice_bits, axis=1)
    res["payload_bits"] = sum((len(b) - 4 * CODEC_N) * 8 for b in streams[1])
    out = codec.decompress(streams, xorg=img)
    res["counts"] = [codec.dispatch_counts["decode"],
                     codec.dispatch_counts["encode"]]
    res["lossless"] = bool(np.array_equal(out[0], img))
    res["ycocg_err"] = codec.last_ycocg_err
    res["resident_equal"] = bool(np.array_equal(
        codec.prepare_decode(streams)()[:, :h, :w].numpy(), out))
    res["many_equal"] = bool(np.array_equal(
        codec.decompress_many([streams])[0], out))

    # the multi-device dry run at tiny widths, parts (a)-(e): each part
    # raises DryrunError in both ranks on a failed check
    cpu = torch.device("cpu")
    prof = dryrun.tiny_profile()
    dry = dryrun.run("abcde", prof, cpu)
    a = dry["a"]
    for k in ("loss", "params_sha256", "lossless", "codec_sha256",
              "num_bytes", "header", "lanes", "act_bits", "ideal_bits"):
        res["dry_" + k] = a[k]
    res["dry_dispatches"] = [a["dispatches"]["decode"],
                             a["dispatches"]["encode"]]
    res["dry_b"] = json.dumps(dry["b"])
    for part, r in (("c", dry["c"]), ("d", dry["d"]["step"])):
        res[f"dry_{part}"] = [r["loss_rel"], r["grad_rel_l2"],
                              r["param_within"], r["beyond_with_signal"]]
    res["dry_rate_rel"] = dry["d"]["rate"]["rel"]
    res["dry_e"] = [dry["e"][k]["iteration"] for k in ("train", "resume")]
    res["dry_e_writes"] = [dry["e"][k]["checkpoint_writes"]
                           for k in ("train", "resume")]
    # a wrong halo: part (d)'s step must raise in both ranks
    real = mesh_module.halo_rows
    mesh_module.halo_rows = _own_rows_halo
    try:
        dryrun.steps(cpu, prof, 2)
        res["mutant_error"] = ""
    except dryrun.DryrunError as e:
        res["mutant_error"] = str(e)
    finally:
        mesh_module.halo_rows = real

    # the Trainer with num_data_shards=2: two steps, then eval_model
    tcfg = LLICTIConfig(
        exp_name="dp", mode="train", model=cfg,
        train=TrainConfig(batch_size=2, patch_size=32, loss_prnt_iters=100,
                          learning_rate=1e-3, max_epoch=1, seed=3,
                          num_data_shards=2, val_patch_size=32),
        data=DataConfig(synthetic=True, synthetic_len=8),
        experiments_root=os.path.join(out_dir, "exp"))
    tr = Trainer(tcfg, device="cpu")
    res["trainer_world"] = tr.mesh.size
    tr.train_one_epoch(max_steps=2)
    res["trainer_params"] = _flat(tr.model)
    calls = []
    compress = ShardedCodec.compress
    ShardedCodec.compress = lambda self, im: calls.append(1) or compress(
        self, im)
    results = tr.eval_model()
    res["eval_sharded_calls"] = len(calls)
    res["eval_ok"] = [r["ok"] for r in results]
    res["eval_coder_gap"] = [r["coder_gap_pct"] for r in results]
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


# ---- the parent ------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def codec_params():
    """(JAX config, JAX params) of the tiny weights, from torch_helpers."""
    from llicti_tpu.config import ModelConfig
    return (ModelConfig(**torch_helpers.TINY),
            torch_helpers.tiny_jax_params()[0])


@pytest.fixture(scope="module")
def ranks(codec_params, tmp_path_factory):
    from llicti_torch.weights import flat_params
    out = tmp_path_factory.mktemp("two_ranks")
    import jax
    np.savez(out / "codec_params.npz", **flat_params(
        jax.tree.map(np.asarray, codec_params[1])))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(port), str(out)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.timeout(TIMEOUT + 60)
def test_dp_step_matches_single_process(ranks):
    r0, r1 = ranks
    assert float(r0["dp_loss"]) == float(r1["dp_loss"])
    np.testing.assert_array_equal(r0["dp_params"], r1["dp_params"])
    np.testing.assert_allclose(float(r0["dp_loss"]), float(r0["dp_ref_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(r0["dp_params"], r0["dp_ref_params"],
                               rtol=1e-4, atol=1e-6)


@pytest.mark.timeout(TIMEOUT + 60)
def test_spatial_rate_step_and_halo_gradients(ranks):
    r0, r1 = ranks
    for r in ranks:
        np.testing.assert_allclose(float(r["rate"]), float(r0["rate_ref"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(r["rate_bd"], r0["rate_bd_ref"],
                                   rtol=1e-4, atol=1e-6)
        for name in ("halo", "halo_far"):
            np.testing.assert_allclose(r[name], r[name + "_ref"],
                                       rtol=1e-12, atol=1e-12)
        assert bool(r["uneven_refused"])
    np.testing.assert_array_equal(r0["sp_params"], r1["sp_params"])
    np.testing.assert_allclose(float(r0["sp_loss"]), float(r0["sp_ref_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(r0["sp_params"], r0["sp_ref_params"],
                               rtol=1e-4, atol=1e-6)


@pytest.mark.timeout(TIMEOUT + 60)
def test_sharded_codec_over_two_ranks(ranks, codec_params):
    from llicti_torch.codec import deserialize
    from llicti_tpu.parallel.codec_sp import ShardedCodec as JaxSharded
    from llicti_tpu.parallel.codec_sp import make_sp_mesh
    r0, r1 = ranks
    np.testing.assert_array_equal(r0["container"], r1["container"])
    streams = deserialize(r0["container"].tobytes())
    assert len(streams[1]) == CODEC_G
    for r in ranks:
        assert bool(r["lossless"]) and int(r["ycocg_err"]) == 0
        assert bool(r["resident_equal"]) and bool(r["many_equal"])
        assert int(r["act"]) == int(r["payload_bits"])
        slack = 32.0 * CODEC_N * CODEC_G
        assert abs(float(r["act"]) - float(r["ideal"])) <= (
            0.01 * float(r["ideal"]) + slack)
        assert r["counts"].tolist() == [2, 3]  # S scale passes; S + 1
    cfg, params = codec_params
    ref = JaxSharded(cfg, params, mesh=make_sp_mesh(shards=CODEC_G),
                     num_lanes=CODEC_N)
    h, w, seed = CODEC_IMG
    jstreams = ref.compress(natural_image(h, w, seed))
    assert streams[0] == jstreams[0]
    nb, jnb = int(r0["num_bytes"]), JaxSharded.num_bytes(jstreams)
    print(f"G={CODEC_G} over 2 ranks: port {nb} bytes, JAX {jnb}")
    assert abs(nb - jnb) <= max(0.001 * jnb, 16)
    np.testing.assert_allclose(r0["scale_bits"],
                               np.sum(ref.last_slice_bits, axis=1),
                               rtol=0.01)


@pytest.mark.timeout(TIMEOUT + 60)
def test_trainer_with_two_data_shards(ranks):
    r0, r1 = ranks
    assert int(r0["trainer_world"]) == 2
    np.testing.assert_array_equal(r0["trainer_params"], r1["trainer_params"])
    for r in ranks:
        assert int(r["eval_sharded_calls"]) == len(r["eval_ok"]) > 0
        assert all(r["eval_ok"])
        assert all(abs(g) < 10.0 for g in r["eval_coder_gap"])


@pytest.mark.timeout(TIMEOUT + 60)
def test_dryrun_part_a_on_two_ranks(ranks):
    """JAX's dryrun_multichip(2), ported, at the dry run's tiny widths: one
    data = 2 step of the global ``ones * 0.5`` batch, its loss within 1e-5
    of JAX's jitted make_train_step's (3e-7 apart here), and the
    five-scale codec at 2 shards and
    8 lanes against JAX's ShardedCodec on 2 fake devices with the same
    weights (streams[0] byte-equal, num_bytes within max(0.1 %, 16 B))."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from llicti_torch.parallel import dryrun
    from llicti_torch.weights import init_params
    from llicti_tpu.config import ModelConfig as JaxConfig
    from llicti_tpu.models.llicti import LLICTIModel as JaxModel
    from llicti_tpu.parallel.codec_sp import ShardedCodec as JaxSharded
    from llicti_tpu.parallel.codec_sp import make_sp_mesh
    from llicti_tpu.training import steps as jsteps
    from test_torch_model import nested

    r0, r1 = ranks
    for r in ranks:
        assert np.isfinite(float(r["dry_loss"]))
        assert bool(r["dry_lossless"])
        act, ideal = float(r["dry_act_bits"]), float(r["dry_ideal_bits"])
        assert abs(act - ideal) <= 0.01 * ideal + 32.0 * int(
            r["dry_lanes"]) * 2
        assert r["dry_dispatches"].tolist() == [5, 6]  # S; S + 1
    assert float(r0["dry_loss"]) == float(r1["dry_loss"])
    assert str(r0["dry_params_sha256"]) == str(r1["dry_params_sha256"])
    assert str(r0["dry_codec_sha256"]) == str(r1["dry_codec_sha256"])

    cfg = dryrun.tiny_profile().train_cfg
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    tx = jsteps.make_optimizer(1e-4)
    params = nested(init_params(cfg, 0))
    state = jsteps.TrainState(params, tx.init(params),
                              jnp.zeros((), jnp.int32))
    _, m = jax.jit(jsteps.make_train_step(JaxModel(cfg=jcfg), tx))(
        state, jnp.full((2, 4, 64, 64, 3), 0.5, jnp.float32))
    print(f"part (a) loss: port {float(r0['dry_loss'])}, JAX "
          f"{float(m['loss'])}")
    np.testing.assert_allclose(float(r0["dry_loss"]), float(m["loss"]),
                               rtol=1e-5)

    five = dryrun.FIVE_SCALES
    ref = JaxSharded(JaxConfig(**dataclasses.asdict(five)),
                     nested(init_params(five, 1)),
                     mesh=make_sp_mesh(shards=2), num_lanes=8)
    jstreams = ref.compress(dryrun.jax_image(2))
    nb, jnb = int(r0["dry_num_bytes"]), JaxSharded.num_bytes(jstreams)
    print(f"five-scale codec at 2 shards: port {nb} bytes, JAX {jnb}")
    assert str(r0["dry_header"]) == jstreams[0][0].hex()
    assert abs(nb - jnb) <= max(0.001 * jnb, 16)


@pytest.mark.timeout(TIMEOUT + 60)
def test_dryrun_parts_b_to_e_on_two_ranks(ranks):
    """The dry run's parts (b)-(e) under gloo at tiny widths passed their
    own checks in both ranks (they raise otherwise); what they saw: the
    sharded containers at G = 2 and 4 lossless and equal to the
    one-process container of their G, the parallel steps as close to one
    process's as float rounding, the spatial rate equal to one
    process's, the runner at iterations 2 and 3 with rank 0 alone
    writing checkpoints."""
    from llicti_torch.parallel import dryrun
    r0, r1 = ranks
    b0, b1 = (json.loads(str(r["dry_b"])) for r in ranks)
    assert b0 == b1
    assert sorted(b0) == ["G2 64x48", "G4 64x48"]
    for row in b0.values():
        assert row["equal_to_one_process"]
        assert row["sha256"] == row["one_process_sha256"]
    for r in ranks:
        for part in ("dry_c", "dry_d"):
            loss_rel, grad_rel_l2, within, beyond = r[part].tolist()
            assert loss_rel <= 1e-4 and grad_rel_l2 <= dryrun.GRAD_REL_L2
            assert within == 1.0 and beyond == 0
        assert float(r["dry_rate_rel"]) <= 1e-5
        assert r["dry_e"].tolist() == [2, 3]
    for writes in r0["dry_e_writes"].tolist():
        assert writes[0] > 0 and not any(writes[1:])


@pytest.mark.timeout(TIMEOUT + 60)
def test_dryrun_step_rule_fails_a_wrong_halo(ranks):
    """A wrong halo exchange (each rank pads its block with its own rows)
    moves the tiny step's loss by less than 1e-4, so it is the gradient
    rule that holds a parallel step to one process's that fails part
    (d)'s step, in both ranks and well past its bound."""
    import re

    from llicti_torch.parallel import dryrun
    for r in ranks:
        err = str(r["mutant_error"])
        assert err.startswith("(1x2) gradients or parameters"), err
        rel = float(re.search(r"'grad_rel_l2': ([^,]+),", err).group(1))
        print(f"wrong halo: gradients {rel:.3g} relative L2 from one "
              "process's")
        assert rel > 100 * dryrun.GRAD_REL_L2


@pytest.mark.timeout(TIMEOUT + 60)
def test_runner_mesh_under_torchrun(tmp_path):
    """``torchrun --nproc_per_node=2 -m llicti_torch.main CONFIG --mesh``:
    one epoch of data-parallel training; rank 0 alone writes the logs and
    checkpoints."""
    raw = {"exp_name": "mesh", "mode": "train",
           "model": {"chs": [8, 1], "evens": [4, 4], "odds": [3, 3],
                     "dwtlevels": [0, 1], "useprevlevNN": [False, True]},
           "train": {"batch_size": 4, "patch_size": 32,
                     "loss_prnt_iters": 100, "learning_rate": 1e-3,
                     "max_epoch": 1, "seed": 7},
           "data": {"synthetic": True, "synthetic_len": 8},
           "experiments_root": str(tmp_path)}
    path = tmp_path / "mesh.json"
    path.write_text(json.dumps(raw))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
         f"--master_port={_free_port()}", "-m", "llicti_torch.main",
         str(path), "--mesh", "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    ckpt = tmp_path / "mesh" / "checkpoints"
    assert (ckpt / "checkpoint.pt").exists()
    log = (tmp_path / "mesh" / "logs" / "exp_debug.log").read_text()
    assert log.count("Train Epoch:") == 1  # one rank logged


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
