"""The port's row-sharded codec and halo exchange in one process (G
shards on one device) against the JAX package's ``ShardedCodec`` on fake
CPU devices (tests/conftest.py's 8), with tests/test_codec_sp.py's
configurations, images and lanes, so that JAX's compile cache serves them.

Held: streams[0] (header, minmax, raw band) byte-equal, one blob a shard,
num_bytes within max(0.1 %, 16 B) of JAX's (a CDF entry may round the
other way, as in test_torch_codec.py), each scale's stream bits within
1 %, lossless.  The two-process path is tests/test_torch_parallel_2proc.py.
"""
import torch_helpers  # first: caps torch's threads
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from llicti_torch.config import ModelConfig
from llicti_torch.models.llicti import LLICTIModel as TorchModel
from llicti_torch.parallel import ShardedCodec, make_sp_mesh
from llicti_torch.parallel.halo import halo_rows
from llicti_torch.weights import init_params, params_from_flax
from llicti_tpu.config import ModelConfig as JaxConfig
from llicti_tpu.models.llicti import LLICTIModel
from llicti_tpu.parallel.codec_sp import ShardedCodec as JaxSharded
from llicti_tpu.parallel.codec_sp import make_sp_mesh as jax_mesh

from test_codec_roundtrip import natural_image, small_cfg


@functools.lru_cache(maxsize=None)
def jax_params(cfg, seed=0):
    lev = max(cfg.dwtlevels) + 1
    return LLICTIModel(cfg=cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 2 ** lev * 4, 2 ** lev * 4, 3)))


def pair(cfg, shards, num_lanes=16, seed=0):
    """(port codec, JAX codec) of the same random weights (JAX's init, as
    test_codec_sp.py's make_sharded)."""
    params = jax_params(cfg, seed)
    port = ShardedCodec(ModelConfig(**dataclasses.asdict(cfg)),
                        jax.tree.map(np.asarray, params),
                        mesh=make_sp_mesh(shards), num_lanes=num_lanes,
                        device="cpu")
    return port, JaxSharded(cfg, params, mesh=jax_mesh(shards=shards),
                            num_lanes=num_lanes)


def held_against_jax(port, ref, img):
    streams = port.compress(img)
    jstreams = ref.compress(img)
    assert streams[0] == jstreams[0]
    assert len(streams[1]) == len(jstreams[1]) == port.G
    nb, jnb = ShardedCodec.num_bytes(streams), JaxSharded.num_bytes(jstreams)
    print(f"G={port.G} {img.shape}: port {nb} bytes, JAX {jnb}")
    assert abs(nb - jnb) <= max(0.001 * jnb, 16)
    np.testing.assert_allclose(np.sum(port.last_slice_bits, axis=1),
                               np.sum(ref.last_slice_bits, axis=1),
                               rtol=0.01)
    out = port.decompress(ShardedCodec.deserialize(
        ShardedCodec.serialize(streams)), xorg=img)
    assert out.shape == (1,) + img.shape
    assert np.array_equal(out[0], img)
    assert port.last_ycocg_err == 0
    return streams


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_matches_jax(shards):
    port, ref = pair(small_cfg(), shards)
    held_against_jax(port, ref, natural_image(64, 32, seed=3))


@pytest.mark.parametrize("name, kw, shards, size, seed", [
    ("clrjnt0", dict(clr_joint_mode=0), 4, (36, 44), 0),
    ("clrjnt1", dict(clr_joint_mode=1), 4, (36, 44), 1),
    ("logistic", dict(distribution="logistic"), 2, (32, 32), 9),
    ("clrjnt0seqmd", dict(clr_joint_mode=0, clrjnt0seqmd=True), 4,
     (32, 36), 13),
    ("odd size", {}, 4, (50, 37), 5),
])
def test_variants_match_jax(name, kw, shards, size, seed):
    port, ref = pair(small_cfg(**kw), shards)
    held_against_jax(port, ref, natural_image(*size, seed=seed))


def test_five_scales_match_jax_and_count_passes():
    """The flagship's 5-scale schedule (tiny channels): decode runs S
    scale passes, encode S passes and one chain call."""
    cfg = JaxConfig(chs=(8, 1, 1, 1, 1))
    port, ref = pair(cfg, 4, num_lanes=8)
    img = natural_image(160, 64, seed=19)
    streams = port.compress(img)
    assert port.dispatch_counts == {"decode": 0, "encode": 6}
    assert streams[0] == ref.compress(img)[0]
    assert np.array_equal(port.decompress(streams, xorg=img)[0], img)
    assert port.dispatch_counts["decode"] == 5
    assert port.last_ycocg_err == 0


def test_supports_equals_jax():
    cfgs = [small_cfg(), small_cfg(clr_joint_mode=0),
            small_cfg(clr_joint_mode=1), small_cfg(distribution="logistic"),
            small_cfg(clr_joint_mode=0, clrjnt0seqmd=True),
            small_cfg(subtract_mean=True), small_cfg(ycocg=False),
            small_cfg(num_mixtures=1), small_cfg(clrchs=0),
            small_cfg(clr_joint_mode=0, clrjnt0seqmd=True,
                      activfun="GDN1"), small_cfg(activfun="GDN1")]
    for cfg in cfgs:
        got = ShardedCodec.supports(ModelConfig(**dataclasses.asdict(cfg)))
        assert got == JaxSharded.supports(cfg), cfg


def test_many_and_resident_calls_equal_single_calls():
    """compress_many / decompress_many / prepare_* give what single calls
    give; the coder closes within 1 % of the ideal bits (plus the
    lane-flush slack of tests/test_codec_sp.py)."""
    port, _ = pair(small_cfg(), 4)
    imgs = [natural_image(64, 48, seed=s) for s in (23, 29)]
    singles = []
    for im in imgs:
        singles.append(port.compress(im))
        table = port.last_slice_bits
        fn = port.prepare_encode(im)
        cursors, states, buf, ideal = fn()
        total = cursors[:, -1]
        assert int(total.sum()) * 16 == sum(map(sum, table))
        words = [w[:int(t)].numpy() for w, t in zip(buf, total)]
        from llicti_torch.coder.rans import pack_stream_packed
        assert [pack_stream_packed(w, s.numpy())
                for w, s in zip(words, states)] == singles[-1][1]
    manys = port.compress_many(imgs)
    assert manys == singles
    slack = 32.0 * port.N * port.G
    for act, ideal in zip(port.last_slice_bits_batch,
                          port.last_ideal_bits_batch):
        assert abs(np.sum(act) - np.sum(ideal)) <= (0.01 * np.sum(ideal)
                                                    + slack)
    assert np.sum(port.last_slice_bits) == sum(
        np.sum(t) for t in port.last_slice_bits_batch)
    outs = port.decompress_many(singles)
    for out, im, s in zip(outs, imgs, singles):
        assert np.array_equal(out[0], im)
        res = port.prepare_decode(s)
        for _ in range(2):
            assert np.array_equal(res()[:, :im.shape[0], :im.shape[1]]
                                  .numpy(), out)


def test_halo_rows_alone_is_replicate_padding():
    x = torch.randn((2, 5, 4, 3))
    for top, bottom in ((0, 0), (1, 2), (2, 1), (7, 6)):
        want = F.pad(x.permute(0, 3, 1, 2), (0, 0, top, bottom),
                     mode="replicate").permute(0, 2, 3, 1)
        assert torch.equal(halo_rows(x, top, bottom), want)
    # the model with the one-rank exchange equals the model without
    cfg = ModelConfig(chs=(8, 1), evens=(4, 4), odds=(3, 3),
                      dwtlevels=(0, 1), useprevlevNN=(False, True),
                      subtract_mean=True)
    model = params_from_flax(init_params(cfg, 0), cfg)
    x = torch.rand((1, 16, 24, 3))
    with torch.no_grad():
        for a, b in zip(model(x), model(x, halo_rows)):
            assert torch.equal(a, b)


def test_refusals():
    cfg = ModelConfig(chs=(8, 1), evens=(4, 4), odds=(3, 3),
                      dwtlevels=(0, 1), useprevlevNN=(False, True))
    for shards in (0, 256):
        with pytest.raises(ValueError, match="1..255"):
            make_sp_mesh(shards)
    # a rank's rows must be a multiple of the coarsest stride (4 here)
    model = TorchModel(cfg)
    with pytest.raises(ValueError, match="multiple of 4"):
        model(torch.rand((1, 6, 8, 3)), halo_rows)
    with pytest.raises(ValueError, match="subtract_mean"):
        ShardedCodec(dataclasses.replace(cfg, subtract_mean=True),
                     {}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedCodec(cfg, init_params(cfg, 0))
    port = ShardedCodec(cfg, init_params(cfg, 0), mesh=make_sp_mesh(2),
                        num_lanes=16, device="cpu")
    other = ShardedCodec(cfg, init_params(cfg, 0), mesh=make_sp_mesh(4),
                         num_lanes=16, device="cpu")
    with pytest.raises(ValueError, match="4 shards"):
        port.decompress(other.compress(natural_image(32, 32, seed=1)))


def test_no_silent_cpu_fallback(monkeypatch):
    """Without a card, initialize() and default_device() raise unless the
    caller asks for the CPU; initialize raises before any group is made.
    With device="cpu" a group of one joins under gloo."""
    import socket

    import torch.distributed as dist
    from llicti_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    made = []
    real_init = dist.init_process_group
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: made.append(k) or real_init(*a, **k))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.initialize(f"localhost:{port}", 1, 0)
    assert made == [] and not dist.is_initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.default_device()
    assert distributed.default_device("cpu") == torch.device("cpu")
    assert distributed.initialize(device="cpu") is False  # nothing to join
    try:
        assert distributed.initialize(f"localhost:{port}", 1, 0,
                                      device="cpu") is False
        assert [k["backend"] for k in made] == ["gloo"]
        assert distributed.comm_device() == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_dryrun_part_past_its_limit_exits_naming_rank_and_part():
    """A dry-run part that outlives its limit (a collective some ranks
    never reach) ends the process with 124, naming the rank and part; a
    failed check names them too."""
    import subprocess
    import sys
    from pathlib import Path

    from llicti_torch.parallel.dryrun import DryrunError, check, deadline
    with pytest.raises(DryrunError, match="^rank 0 part q: lossy$"):
        with deadline("q", 60):
            check(False, "lossy")
    root = Path(__file__).resolve().parent.parent
    code = ("import time\n"
            "from llicti_torch.parallel.dryrun import deadline\n"
            "with deadline('z', 1):\n"
            "    time.sleep(60)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60,
                         env=torch_helpers.env(PYTHONPATH=str(root)))
    assert res.returncode == 124, res.stderr[-2000:]
    assert "rank 0 part z: no end after 1 s" in res.stderr


def test_runner_leaves_only_the_group_it_joined(tmp_path, monkeypatch):
    """``main --mesh`` leaves the process group it joined (NCCL warns at
    exit about one left behind) and keeps a group its caller joined; it
    returns its agents."""
    import json
    import socket

    import torch.distributed as dist
    from llicti_torch.main import main

    raw = {"exp_name": "solo", "mode": "train",
           "model": {"chs": [8, 1], "evens": [4, 4], "odds": [3, 3],
                     "dwtlevels": [0, 1], "useprevlevNN": [False, True]},
           "train": {"batch_size": 2, "patch_size": 32, "grad_acc_iters": 1,
                     "loss_prnt_iters": 100, "max_epoch": 1, "seed": 7},
           "data": {"synthetic": True, "synthetic_len": 2},
           "experiments_root": str(tmp_path)}
    path = tmp_path / "solo.json"
    path.write_text(json.dumps(raw))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    argv = [str(path), "--mesh", "--device", "cpu"]
    agents = main(argv)
    assert [a.current_iteration for a in agents] == [1]
    assert agents[0].mesh.size == 1 and not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        main(argv)
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
