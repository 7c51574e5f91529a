"""The multi-device dry run: the port's counterpart of the JAX package's
``dryrun_multichip(n)``, then the multi-device path at flagship width.

One process a card under NCCL::

    torchrun --nproc_per_node=4 -m llicti_torch.parallel.dryrun [--time]

or, to rehearse, on the CPU under gloo at tiny widths (random weights, no
JAX constants)::

    torchrun --nproc_per_node=2 -m llicti_torch.parallel.dryrun --device cpu

``chip_smoke.py`` runs parts (b)-(d) as two gloo ranks on one card (its
phase 13 (c)) and one NCCL rank a card (phase 13 (d)).

Parts, in order (n ranks); each fails naming its rank and part:

a. JAX's dry run step for step: a data x spatial mesh (spatial 2 when n
   is even and >= 4), one parallel train step of the flagship
   ``ModelConfig()`` from ``init_params(cfg, 0)`` on ``ones * 0.5`` of
   [2, 2 * data, 64, 64, 3], then the tiny five-scale sharded codec
   (``chs=(8, 1, 1, 1, 1)``, n shards, 8 lanes) on JAX's 8n x 40 image:
   lossless, the same container on every rank, its coder closure within
   0.01 * ideal + 32 * N * n bits.  Prints JAX's two ``ok`` lines.
b. The row-sharded codec at G = n and 2n shards (N = 128, the trained
   weights) on 512x768 and 310x598: lossless, ``last_ycocg_err == 0``,
   the header and ``num_bytes`` of JAX's (:data:`JAX_SP`, within
   max(0.1 %, 16 B)), the same sha256 on every rank, 9S Kernel 2
   launches a decode, 2 of Kernel 3 an encode and none of Kernel 1 a
   rank; the container within 16 B of the one-process container of the
   same G (equal or not, printed).
c. A data-parallel step of ``configs/paper_a.json`` at its full batch
   against one card's step on the same global batch: no hand-kernel
   launch, loss within 1e-4 (relative), loss and parameters equal on
   every rank, and :func:`step_rule` with gradients within 1e-5
   (relative L2) of one card's; its readings are recorded beside one
   card's own against its step on the images in reverse order.
d. The same on a data n/2 x spatial 2 mesh (the halo crosses cards; the
   patch cut to 128, a multiple of 2 x 32 rows), then the spatial = n
   rate of 512x768: equal on every rank and within 1e-5 (relative) of
   one card's.
e. The runner, ``llicti_torch.main CONFIG --mesh``, in every rank:
   paper_a with ``num_data_shards = n`` for two steps (rank 0 alone
   writes checkpoints), then a resume of its checkpoint for one more
   step, with equal parameters on every rank.

``--time`` adds the multi-card figures: ms a rank of the sharded encode
and decode and of the one-process codec, ms a step beside one card's,
the flat gradient all-reduce and one halo all-gather (CUDA events), the
spatial rate, peak MiB a rank, and the machine (NCCL version, peer
access, each card's name and power limit).

A part that runs past its limit prints its rank and name and ends the
process with code 124; torchrun then stops the other ranks.  At the end
rank 0 prints every rank's results, a JSON line a rank.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import faulthandler
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import _kernels
from ..codec import exact_math
from ..coder import rans
from ..config import LLICTIConfig, ModelConfig, config_from_dict
from ..data import ImageDataset, TrainLoader, synthetic_image
from ..main import main as runner_main
from ..ops import cdf
from ..training.loss import rate_loss_list
from ..training.steps import make_optimizer, make_train_step
from ..utils import CheckpointManager
from ..weights import init_params, load_npz, params_from_flax
from .codec_sp import ShardedCodec, make_sp_mesh
from .distributed import (all_gather_bytes, all_gather_rows, all_reduce_sum,
                          comm_device, initialize, rank, world_size)
from .eval import make_sharded_rate_fn
from .mesh import batch_sharding, make_mesh
from .train import make_parallel_train_step, shard_state

ROOT = Path(__file__).resolve().parents[2]
PAPER_A = ROOT / "configs" / "paper_a.json"

# the JAX package's ShardedCodec on the CPU (G fake devices, N = 128, the
# trained weights; tools/jax_sharded_reference.py --shards G):
# (G, image) -> (num_bytes, header hex)
JAX_SP = {(4, "512x768"): (860_216, "0504100018000002000000030000"),
          (4, "310x598"): (496_692, "05040c0013003601000056020000"),
          (1, "512x768"): (859_058, "0501100018000002000000030000"),
          (1, "310x598"): (421_572, "05010a0013003601000056020000"),
          (8, "512x768"): (861_756, "0508100018000002000000030000"),
          (8, "310x598"): (646_240, "0508100013003601000056020000"),
          (2, "512x768"): (859_448, "0502100018000002000000030000"),
          (2, "310x598"): (421_964, "05020a0013003601000056020000")}

# seconds each part may take before the rank gives up
LIMITS = {"build": 300, "a": 300, "b": 600, "c": 300, "d": 300, "e": 600}
RUNS = 5  # timed runs of a codec call (median), after one warm-up
STEP_RUNS = 3  # timed train steps (median), after the compared one
EVENT_ITERS = 20  # collectives a CUDA-event timing averages
# The rule that holds one optimiser step to another from the same state
# (step_rule), and each comparison's gradient bound, relative L2: a
# parallel step against one card's (float rounding gives ~1e-7; a wrong
# halo or reduction O(1)), and a card step under exact_math() against the
# CPU's (chip_smoke.py's phase 11 (a) on an NVIDIA H100, 700 W: 7.4e-5,
# the model in channels-last 4.47e-5).  A gradient is float noise where
# its |value| is at most NOISE_SIGMAS times the two float32 gradients' RMS
# distance over the tensor's other entries, and at least wherever it is
# below NOISE_GRAD (under it Adam's eps of 1e-8 moves lr * g / (|g| +
# 1e-8) by more than 1 % of lr).  On that card the largest |g| / band of
# an entry beyond 1e-3 lr read 0.18 (a spatial = 2 step against one
# card's; phase 11 (a) 0.027, channels-last 0.045).
GRAD_REL_L2 = 1e-5
CARD_CPU_GRAD_REL_L2 = 3e-4
# A float32 step's gradients under exact_math() against float64_step's
# from the same state and batch, relative L2, each tensor.  At least 3x
# the worst of 64 first steps of configs/paper_a.json from random weights
# on an NVIDIA H100, 700 W (4 seeds x 8 loader batches, the model in NCHW
# and in channels-last): 1.34e-4.  chip_smoke.py's phase 11 (a) holds the
# trained flagship to it (near a minimum, where a gradient is a small sum
# of large cancelling terms): 7.98e-4 on the card, 5.33e-4 in
# channels-last.
FLOAT64_GRAD_REL_L2 = 3e-3
NOISE_GRAD = 1e-6
NOISE_SIGMAS = 50.0

TINY = ModelConfig(chs=(8, 1), evens=(4, 4), odds=(3, 3), dwtlevels=(0, 1),
                   useprevlevNN=(False, True))
FIVE_SCALES = ModelConfig(chs=(8, 1, 1, 1, 1))


class DryrunError(AssertionError):
    """A check of the dry run failed; the message names rank and part."""


@dataclasses.dataclass(frozen=True)
class Profile:
    """The widths a dry run takes: the card's (flagship, trained weights,
    JAX's constants) or the CPU's rehearsal (tiny, random weights)."""
    train_cfg: ModelConfig          # (a)'s train step
    codec_cfg: ModelConfig          # (b)'s codec and (d)'s rate
    codec_params: Callable[[], dict]
    lanes: int
    images: Dict[str, Tuple[int, int, int]]  # label -> (h, w, seed)
    reference: Dict[Tuple[int, str], Tuple[int, str]]
    step_raw: dict                  # (c), (d) and (e)'s config, nested
    rate_image: str                 # (d)'s image label


def full_profile() -> Profile:
    with open(PAPER_A) as f:
        raw = json.load(f)
    return Profile(ModelConfig(), ModelConfig(), load_npz, 128,
                   {"512x768": (512, 768, 42), "310x598": (310, 598, 7)},
                   JAX_SP, raw, "512x768")


def tiny_profile() -> Profile:
    small = dataclasses.replace(TINY, chs=(8, 8))
    model = {k: list(v) if isinstance(v, tuple) else v
             for k, v in dataclasses.asdict(TINY).items()}
    raw = {"exp_name": "tiny", "mode": "train", "model": model,
           "train": {"batch_size": 4, "patch_size": 32, "grad_acc_iters": 2,
                     "loss_prnt_iters": 2000, "learning_rate": 1e-4,
                     "max_epoch": 1, "seed": 3},
           "data": {"synthetic": True, "synthetic_len": 16}}
    return Profile(TINY, small, lambda: init_params(small, 0), 16,
                   {"64x48": (64, 48, 41)}, {}, raw, "64x48")


# ---- checks and clocks -----------------------------------------------------

def check(cond: bool, msg: str) -> None:
    if not cond:
        raise DryrunError(msg)


def say(msg: str) -> None:
    """Print on rank 0."""
    if rank() == 0:
        print(msg, flush=True)


@contextlib.contextmanager
def deadline(part: str, seconds: float):
    """Run a part under a wall-clock limit: past it, print the rank and
    the part and end the process with 124 (faulthandler, which needs no
    interpreter lock, ends it 30 s later if the first cannot run).  A
    failed check names the rank and the part."""

    def expire():
        print(f"dryrun: rank {rank()} part {part}: no end after {seconds} "
              "s; exiting", file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr)
        os._exit(124)

    timer = threading.Timer(seconds, expire)
    timer.daemon = True
    timer.start()
    faulthandler.dump_traceback_later(seconds + 30, exit=True)
    t0 = time.perf_counter()
    try:
        yield
    except DryrunError as e:
        raise DryrunError(f"rank {rank()} part {part}: {e}") from None
    finally:
        timer.cancel()
        faulthandler.cancel_dump_traceback_later()
    say(f"dryrun part {part}: {time.perf_counter() - t0:.2f} s")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def barrier() -> None:
    """Every rank here before any goes on (a one-element all-reduce read
    back, on the collectives' own device)."""
    float(all_reduce_sum(torch.zeros(1, device=comm_device()))[0])


def same_on_every_rank(value: str, what: str) -> None:
    got = [b.decode() for b in all_gather_bytes([value.encode()])]
    check(len(set(got)) == 1, f"{what} differs across ranks: {got}")


def host_ms(fn, device: torch.device, runs: int = RUNS) -> float:
    """Median host ms of ``fn`` over ``runs`` after a warm-up, every rank
    starting together, synchronised on both sides."""
    fn()
    times = []
    for _ in range(runs):
        barrier()
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[runs // 2]


def event_ms(fn, iters: int = EVENT_ITERS) -> float:
    """CUDA-event ms a call of ``fn`` over ``iters`` back-to-back calls,
    after a warm-up and a barrier."""
    fn()
    barrier()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, device: torch.device) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall ms (host clock,
    synchronised), device-busy ms (the union of the kernels' intervals),
    the idle share, and the ms and count of NCCL's kernels (their time
    includes waiting for the peers) and of cuDNN's layout transposes."""
    from torch.profiler import ProfilerActivity, profile
    spans, nccl, transpose = [], [0.0, 0], 0.0
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall = 1e3 * (time.perf_counter() - t0)
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        ms = (ev.time_range.end - ev.time_range.start) / 1e3
        if "nccl" in ev.name:
            nccl[0] += ms
            nccl[1] += 1
        elif "Transpose" in ev.name:
            transpose += ms
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e3
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "kernels": len(spans), "nccl_ms": nccl[0],
            "nccl_kernels": nccl[1], "transpose_ms": transpose}


def digest(model) -> str:
    return hashlib.sha256(b"".join(
        p.detach().cpu().numpy().tobytes() for p in model.parameters())
    ).hexdigest()


# the launch counters of Kernels 1-3 (each wrapper's, where it launches)
COUNTERS = {"gmm_cdf_from_pmap": cdf.gmm_cdf_from_pmap,
            "rans_decode": rans.rans_decode,
            "rans_encode": rans.rans_encode_chain}


def read_counts() -> Dict[str, int]:
    """Each kernel's launches since the last read; the counts go to 0."""
    out = {name: fn.launches for name, fn in COUNTERS.items()}
    for fn in COUNTERS.values():
        fn.launches = 0
    return out


# ---- (a) JAX's dry run ------------------------------------------------------

def jax_image(n: int) -> np.ndarray:
    """The 8n x 40 image of JAX's ``dryrun_multichip`` (numpy seed 0)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:8 * n, 0:40].astype(np.float32)
    base = 127 + 80 * np.sin(yy / 7.0) * np.cos(xx / 11.0)
    return np.clip(np.stack([base, base * 0.8 + 20, base * 0.6 + 50],
                            axis=-1) + rng.normal(0, 6, base.shape + (3,)),
                   0, 255).astype(np.uint8)


def jax_dryrun(device: torch.device, train_cfg: ModelConfig = ModelConfig(),
               codec_cfg: ModelConfig = FIVE_SCALES) -> dict:
    """Part (a): JAX's ``dryrun_multichip(n)`` on this process group."""
    n = world_size()
    spatial = 2 if n % 2 == 0 and n >= 4 else 1
    data = n // spatial
    mesh = make_mesh(data=data, spatial=spatial)
    model = params_from_flax(init_params(train_cfg, 0), train_cfg).to(device)
    opt = make_optimizer(model, 1e-4)
    shard_state(model, opt, mesh)
    step = make_parallel_train_step(model, opt, mesh)
    acc, B, P = 2, 2 * data, 64
    batch = np.full((acc, B, P, P, 3), 0.5, np.float32)
    local = batch_sharding(mesh, has_acc_axis=True)(batch)
    loss = float(step(torch.from_numpy(np.ascontiguousarray(local))
                      .to(device))["loss"])
    check(math.isfinite(loss), f"train loss {loss}")
    params_sha = digest(model)
    same_on_every_rank(params_sha, "the parameters after the step")
    say(f"dryrun_multichip ok: train ok mesh=({data}x{spatial}) "
        f"loss={loss:.3f}")

    codec = ShardedCodec(codec_cfg, init_params(codec_cfg, 1),
                         mesh=make_sp_mesh(), num_lanes=8, device=device)
    img = jax_image(n)
    streams = codec.compress(img)
    enc_d = dict(codec.dispatch_counts)
    codec.dispatch_counts = {"decode": 0, "encode": 0}
    out = codec.decompress(streams)
    dec_d = dict(codec.dispatch_counts)
    lossless = bool(np.array_equal(out[0], img))
    check(lossless, "the tiny codec's round trip is lossy")
    sha = hashlib.sha256(ShardedCodec.serialize(streams)).hexdigest()
    same_on_every_rank(sha, "the tiny codec's container")
    S = codec_cfg.num_scales
    check(enc_d == {"decode": 0, "encode": S + 1}
          and dec_d == {"decode": S, "encode": 0},
          f"dispatches encode {enc_d}, decode {dec_d}")
    act = float(np.sum(codec.last_slice_bits))
    ideal = float(np.sum(codec.last_ideal_bits))
    closure = (act - ideal) / max(ideal, 1.0) * 100.0
    check(abs(act - ideal) <= 0.01 * ideal + 32.0 * codec.N * n,
          f"coder closure too wide: act {act} vs ideal {ideal}")
    say(f"dryrun_multichip ok: codec ok shards={n} "
        f"img={img.shape[0]}x{img.shape[1]} lossless=True "
        f"dispatches/img: decode={dec_d['decode']} "
        f"encode={enc_d['encode']} (scales={S}; S scale passes a decode, "
        f"S + 1 an encode) coder_closure={closure:+.3f}% "
        f"(act {act:.0f} vs ideal {ideal:.1f} bits)")
    return {"mesh": [data, spatial], "loss": loss,
            "params_sha256": params_sha, "lossless": lossless,
            "codec_sha256": sha, "num_bytes": ShardedCodec.num_bytes(streams),
            "header": streams[0][0].hex(), "lanes": codec.N, "act_bits": act,
            "ideal_bits": ideal, "coder_closure_pct": closure,
            "dispatches": {"encode": enc_d["encode"],
                           "decode": dec_d["decode"]}}


# ---- (b) the sharded codec at flagship width --------------------------------

def sharded_codec(device: torch.device, prof: Profile,
                  timing: bool = False) -> dict:
    """Part (b): G = n and 2n shards over the ranks, each image's
    container held against JAX's and the one-process container of the
    same G (every rank makes that one on its own device, in a group of
    itself)."""
    n = world_size()
    cfg, S = prof.codec_cfg, prof.codec_cfg.num_scales
    params = prof.codec_params()
    solo_group, _ = dist.new_subgroups(group_size=1)
    cuda = device.type == "cuda"
    out = {}
    for G in (n, 2 * n):
        codec = ShardedCodec(cfg, params, mesh=make_sp_mesh(G),
                             num_lanes=prof.lanes, device=device)
        solo = ShardedCodec(cfg, params, device=device, num_lanes=prof.lanes,
                            mesh=make_sp_mesh(G, solo_group))
        for label, (h, w, seed) in prof.images.items():
            img = synthetic_image(h, w, seed=seed)
            read_counts()
            streams = codec.compress(img)
            sync(device)
            enc = read_counts()
            dec_img = codec.decompress(streams, xorg=img)
            dec = read_counts()
            where = f"G={G} {label}"
            check(np.array_equal(dec_img[0], img), f"{where}: lossy")
            check(codec.last_ycocg_err == 0, f"{where}: YCoCg error "
                  f"{codec.last_ycocg_err}")
            check(len(streams[1]) == G, f"{where}: {len(streams[1])} blobs")
            want = ({"rans_encode": 2, "rans_decode": 0,
                     "gmm_cdf_from_pmap": 0},
                    {"rans_encode": 0, "rans_decode": 9 * S,
                     "gmm_cdf_from_pmap": 0}) if cuda else (
                {k: 0 for k in COUNTERS}, {k: 0 for k in COUNTERS})
            check((enc, dec) == want, f"{where}: launches encode {enc}, "
                  f"decode {dec}, expected {want}")
            nb = ShardedCodec.num_bytes(streams)
            sha = hashlib.sha256(ShardedCodec.serialize(streams)).hexdigest()
            same_on_every_rank(sha, f"{where}: the container")
            row = {"num_bytes": nb, "sha256": sha, "encode_launches": enc,
                   "decode_launches": dec}
            if (G, label) in prof.reference:
                jnb, jhdr = prof.reference[(G, label)]
                check(streams[0][0].hex() == jhdr, f"{where}: header "
                      f"{streams[0][0].hex()} is not JAX's {jhdr}")
                check(abs(nb - jnb) <= max(0.001 * jnb, 16), f"{where}: "
                      f"num_bytes {nb} not within max(0.1 %, 16 B) of "
                      f"JAX's {jnb}")
                row["jax_num_bytes"] = jnb
            solo_streams = solo.compress(img)
            solo_sha = hashlib.sha256(
                ShardedCodec.serialize(solo_streams)).hexdigest()
            row["one_process_sha256"] = solo_sha
            row["one_process_num_bytes"] = ShardedCodec.num_bytes(
                solo_streams)
            row["equal_to_one_process"] = solo_sha == sha
            check(abs(nb - row["one_process_num_bytes"]) <= 16, f"{where}: "
                  f"num_bytes {nb} not within 16 B of the one-process "
                  f"container's {row['one_process_num_bytes']}")
            if timing and label == prof.rate_image:
                row["encode_ms"] = host_ms(lambda: codec.compress(img),
                                           device)
                row["decode_ms"] = host_ms(lambda: codec.decompress(streams),
                                           device)
                row["one_process_encode_ms"] = host_ms(
                    lambda: solo.compress(img), device)
                row["one_process_decode_ms"] = host_ms(
                    lambda: solo.decompress(solo_streams), device)
                if cuda:
                    barrier()
                    row["decode_profile"] = device_profile(
                        lambda: codec.decompress(streams), device)
                    row["encode_profile"] = device_profile(
                        lambda: codec.compress(img), device)
            out[f"G{G} {label}"] = row
            say(f"sharded codec {where} N={prof.lanes} over {n} ranks: {nb} "
                f"bytes" + (f" (JAX {row['jax_num_bytes']}, "
                            f"{nb - row['jax_num_bytes']:+d})"
                            if "jax_num_bytes" in row else "")
                + f", lossless, sha256 {sha[:12]}… on every rank; one "
                f"process: {row['one_process_num_bytes']} bytes, "
                + ("the same container" if row["equal_to_one_process"]
                   else f"another container "
                   f"({nb - row['one_process_num_bytes']:+d} B)")
                + f"; launches encode {enc} decode {dec}"
                + (f"; encode / decode {row['encode_ms']:.2f} / "
                   f"{row['decode_ms']:.2f} ms a rank, one process "
                   f"{row['one_process_encode_ms']:.2f} / "
                   f"{row['one_process_decode_ms']:.2f} ms"
                   if "encode_ms" in row else ""))
        del codec, solo
    return out


# ---- (c), (d) parallel steps against one card's -----------------------------

def global_batch(cfg: LLICTIConfig) -> np.ndarray:
    """The first [acc, B, P, P, 3] batch of the config's synthetic loader
    (the same on every rank)."""
    tc = cfg.train
    ds = ImageDataset(synthetic_len=4 * tc.batch_size,
                      synthetic_size=max(tc.patch_size, 64), seed=tc.seed)
    return next(iter(TrainLoader(ds, tc.batch_size, tc.patch_size,
                                 grad_acc=tc.grad_acc_iters, seed=tc.seed)))


def fresh_model(cfg: LLICTIConfig, device: torch.device):
    return params_from_flax(init_params(cfg.model, cfg.train.seed),
                            cfg.model).to(device)


def one_card_step(cfg: LLICTIConfig, batch: np.ndarray,
                  device: torch.device, timing: bool) -> dict:
    """This card alone takes the step on the whole batch (every rank does,
    each on its own card): its loss and parameters, and ms a step."""
    tc = cfg.train
    model = fresh_model(cfg, device)
    step = make_train_step(model, make_optimizer(model, tc.learning_rate),
                           tc.grad_clip_value)
    x = torch.from_numpy(batch).to(device)
    with exact_math():
        loss = float(step(x)["loss"])
    ref = {"loss": loss, "params": [p.detach().clone()
                                    for p in model.parameters()],
           "grads": [p.grad.clone() for p in model.parameters()]}
    # the same step with each microbatch's images in reverse order: the
    # same sums in another order, the noise floor of the comparison
    twin = fresh_model(cfg, device)
    with exact_math():
        make_train_step(twin, make_optimizer(twin, tc.learning_rate),
                        tc.grad_clip_value)(x.flip(1))
    ref["self"] = step_rule(*model_step(twin), ref["params"], ref["grads"],
                            tc.learning_rate, GRAD_REL_L2)
    del twin
    if timing:
        with exact_math():
            ref["step_ms"] = host_ms(lambda: step(x)["loss"], device,
                                     STEP_RUNS)
            if device.type == "cuda":
                ref["profile"] = device_profile(lambda: step(x)["loss"],
                                                device)
    return ref


def parallel_step(cfg: LLICTIConfig, batch: np.ndarray, data: int,
                  spatial: int, device: torch.device, ref: dict,
                  timing: bool) -> dict:
    """One step on a data x spatial mesh, held against ``ref`` (one
    card's step): the loss, the parameters across ranks and against
    one card's.  With ``timing``: ms a step, and the flat gradient
    all-reduce and the largest halo all-gather of the forward timed
    alone."""
    tc = cfg.train
    lr = tc.learning_rate
    mesh = make_mesh(data=data, spatial=spatial)
    model = fresh_model(cfg, device)
    opt = make_optimizer(model, lr)
    shard_state(model, opt, mesh)
    step = make_parallel_train_step(model, opt, mesh, tc.grad_clip_value)
    local = torch.from_numpy(np.ascontiguousarray(
        batch_sharding(mesh, has_acc_axis=True)(batch))).to(device)
    read_counts()
    with exact_math():
        loss = float(step(local)["loss"])
    launches = read_counts()
    check(not any(launches.values()), f"({data}x{spatial}) the step "
          f"launched {launches}")
    loss_rel = abs(loss - ref["loss"]) / abs(ref["loss"])
    check(loss_rel <= 1e-4, f"({data}x{spatial}) loss {loss} vs one card's "
          f"{ref['loss']} ({loss_rel:.3g} relative)")
    same_on_every_rank(repr(loss), f"({data}x{spatial}) the loss")
    same_on_every_rank(digest(model), f"({data}x{spatial}) the parameters")
    cmp = step_rule(*model_step(model), ref["params"], ref["grads"], lr,
                    GRAD_REL_L2)
    res = {"mesh": [data, spatial], "local_batch": list(local.shape),
           "loss": loss, "one_card_loss": ref["loss"], "loss_rel": loss_rel,
           **cmp, "one_card_self": ref["self"]}
    check(cmp["ok"], f"({data}x{spatial}) gradients or parameters: {cmp} "
          f"(one card against itself, images reversed: {ref['self']})")
    if timing:
        with exact_math():
            res["step_ms"] = host_ms(lambda: step(local)["loss"], device,
                                     STEP_RUNS)
    if timing and device.type == "cuda":  # CUDA events time collectives
        with exact_math():
            barrier()
            res["profile"] = device_profile(lambda: step(local)["loss"],
                                            device)
        flat = torch.zeros(sum(p.numel() for p in model.parameters()),
                           device=device)
        res["allreduce_floats"] = flat.numel()
        res["allreduce_ms"] = event_ms(lambda: all_reduce_sum(flat))
        if mesh.halo is not None:
            res.update(halo_gather(model, local[0], mesh))
    say(f"({data}x{spatial}) step of {cfg.exp_name}, {list(local.shape)} a "
        f"rank: loss {loss:.6f} on every rank, one card's "
        f"{ref['loss']:.6f} ({loss_rel:.3g} relative); parameters equal "
        f"across ranks; against one card's: {rule_line(cmp)}; one card "
        f"against itself with the images reversed: {rule_line(ref['self'])}"
        + (f"; {res['step_ms']:.2f} ms a step (one card's "
           f"{ref['step_ms']:.2f})" if timing else "")
        + (f", gradient all-reduce of {res['allreduce_floats']} floats "
           f"{res['allreduce_ms']:.4f} ms" if "allreduce_ms" in res else "")
        + (f"; profiled: {res['profile']['wall_ms']:.2f} ms wall, "
           f"{res['profile']['busy_ms']:.2f} busy, NCCL "
           f"{res['profile']['nccl_ms']:.2f} ms in "
           f"{res['profile']['nccl_kernels']} kernels, transposes "
           f"{res['profile']['transpose_ms']:.2f}; one card "
           f"{ref['profile']['wall_ms']:.2f} wall, "
           f"{ref['profile']['busy_ms']:.2f} busy, transposes "
           f"{ref['profile']['transpose_ms']:.2f}"
           if "profile" in res else "")
        + (f", halo all-gather {res['halo_shape']} "
           f"{res['halo_gather_ms']:.4f} ms ({res['halo_calls']} a forward)"
           if "halo_shape" in res else ""))
    return res


def step_rule(params, grads, ref_params, ref_grads, lr: float,
              grad_bound: float, exact=None) -> dict:
    """One optimiser step held to a reference step from the same state:
    ``params`` / ``grads`` after the step and the gradients it took, beside
    ``ref_params`` / ``ref_grads`` (sequences of tensors in one order, on
    any devices).  ``exact``: the step's float64 gradients where they
    exist, whose signs decide what is noise (else ``ref_grads``).

    Adam moves a parameter by ~lr * m / sqrt(v): by ~lr whatever |g|
    above float noise, so where the gradient *is* float noise (the same
    sums in another order: a sharded batch or block, another cuDNN
    algorithm, the CPU) two sound steps may differ by up to 2 lr, however
    right the gradients.  The rule: the gradients' relative L2 distance
    within ``grad_bound``; every parameter within 2 lr of the
    reference's; and beyond 1e-3 lr only where the exact gradient is
    noise, |g| <= max(NOISE_GRAD, NOISE_SIGMAS x the RMS of ``grads -
    ref_grads`` over the tensor's other entries; one wrong entry does not
    widen its own band).  Both distances allow 2 ulps of the parameter:
    two float32 steps may round p - update to neighbouring floats.

    -> the readings: ``ok``; ``grad_rel_l2``; ``param_all_within``,
    ``param_max_dev_lr``; ``param_within`` (the share within 1e-3 lr, the
    old 99.9 % rule's reading), ``noise_share``, ``beyond_with_signal``
    (entries beyond 1e-3 lr whose gradient is not noise),
    ``beyond_signal_ratio`` (the largest |g| / band over the entries
    beyond 1e-3 lr: above 1 fails) and ``beyond_max_abs_grad``."""
    exact = ref_grads if exact is None else exact
    n = within = noise_n = beyond = 0
    max_dev = ratio = max_g = 0.0
    all_within = True
    diff2 = ref2 = 0.0
    for p, g, rp, rg, e in zip(params, grads, ref_params, ref_grads, exact):
        dev = rp.device
        rp = rp.detach().to(dev, torch.float64).flatten()
        d = (p.detach().to(dev, torch.float64).flatten() - rp).abs()
        rg = rg.detach().to(dev, torch.float64).flatten()
        sq = (g.detach().to(dev, torch.float64).flatten() - rg).square()
        e = e.detach().to(dev, torch.float64).flatten().abs()
        others = (sq.sum() - sq).clamp_min(0) / max(sq.numel() - 1, 1)
        band = (NOISE_SIGMAS * others.sqrt()).clamp_min(NOISE_GRAD)
        ulps = rp.abs() * 2 * torch.finfo(torch.float32).eps
        out = d > 1e-3 * lr + ulps
        n += d.numel()
        within += int((~out).sum())
        noise_n += int((e <= band).sum())
        beyond += int((out & (e > band)).sum())
        all_within &= bool((d <= 2 * lr + ulps).all())
        max_dev = max(max_dev, float(d.max()))
        if out.any():
            ratio = max(ratio, float((e[out] / band[out]).max()))
            max_g = max(max_g, float(e[out].max()))
        diff2 += float(sq.sum())
        ref2 += float(rg.square().sum())
    grad_rel_l2 = math.sqrt(diff2 / ref2)
    return {"ok": grad_rel_l2 <= grad_bound and all_within and beyond == 0,
            "grad_rel_l2": grad_rel_l2, "grad_bound": grad_bound,
            "param_all_within": all_within, "param_max_dev_lr": max_dev / lr,
            "param_within": within / n, "noise_share": noise_n / n,
            "beyond_with_signal": beyond, "beyond_signal_ratio": ratio,
            "beyond_max_abs_grad": max_g}


def rule_line(r: dict) -> str:
    """:func:`step_rule`'s readings on one line, the old share beside."""
    dev = r["param_max_dev_lr"]
    return (f"gradients {r['grad_rel_l2']:.3g} relative L2 apart (bound "
            f"{r['grad_bound']:g}); parameters within {dev:.3g} lr (bound "
            f"2); {r['beyond_with_signal']} beyond 1e-3 lr "
            f"with a gradient above its noise band, the largest |g| / band "
            f"there {r['beyond_signal_ratio']:.3g} (bound 1), "
            f"{100 * r['noise_share']:.4f} % of gradients noise; old rule: "
            f"{100 * r['param_within']:.4f} % within 1e-3 lr")


def model_step(model) -> Tuple[list, list]:
    """A model's parameters and gradients after a step, for
    :func:`step_rule`."""
    params = list(model.parameters())
    return params, [p.grad for p in params]


def float64_step(model: torch.nn.Module, batch: torch.Tensor,
                 clip_value: float) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The reference of one train step: the loss and the clipped
    gradients that ``make_train_step`` takes on ``batch`` [acc, B, H, W,
    3] (the microbatches' gradients summed, divided by acc, clipped at
    +-``clip_value``; the loss their mean), computed in float64 on the
    model's device from a copy of ``model``.  The bands come from the
    float32 ``model``, so that the function is the float32 step's
    (YCoCg-R's rounding ties fall differently in float64)."""
    m64 = copy.deepcopy(model).double()
    m64.zero_grad(set_to_none=True)
    total = 0.0
    for xb in batch:
        with torch.no_grad():
            bands = [y.double() for y in model.transform(xb)]
        loss, _ = rate_loss_list(xb.numel(), m64.entropy_forward(bands))
        loss.backward()
        total += float(loss.detach())
    acc = batch.shape[0]
    grads = {n: (p.grad / acc).clamp(-clip_value, clip_value)
             for n, p in m64.named_parameters()}
    return total / acc, grads


def halo_gather(model, x: torch.Tensor, mesh) -> dict:
    """The halo exchanges of one forward of ``x`` (recorded), and the
    largest one's all-gather timed alone in the spatial subgroup."""
    calls = []

    def record(t, top, bottom):
        calls.append((tuple(t.shape), top, bottom))
        return mesh.halo(t, top, bottom)

    with torch.no_grad(), exact_math():
        model(x, record)
    shapes = [(B, 2 * min(h, max(top, bottom)), W, C)
              for (B, h, W, C), top, bottom in calls]
    edges = torch.zeros(max(shapes, key=math.prod), device=x.device)
    return {"halo_calls": len(calls), "halo_shape": list(edges.shape),
            "halo_gather_ms": event_ms(lambda: all_gather_rows(
                edges, 1, mesh.spatial_group))}


def steps(device: torch.device, prof: Profile, spatial: int,
          timing: bool = False) -> dict:
    """Part (c) (``spatial`` 1) or the step of part (d) (2).  Over spatial
    ranks a rank's rows must be a multiple of the coarsest stride, so
    the patch is cut to a multiple of spatial x stride (paper_a's 160 to
    128)."""
    cfg = config_from_dict(prof.step_raw)
    mult = spatial * 2 ** (max(cfg.model.dwtlevels) + 1)
    if cfg.train.patch_size % mult:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, patch_size=cfg.train.patch_size // mult * mult))
    batch = global_batch(cfg)
    ref = one_card_step(cfg, batch, device, timing)
    res = parallel_step(cfg, batch, world_size() // spatial, spatial,
                        device, ref, timing)
    if timing:
        res["one_card_step_ms"] = ref["step_ms"]
        res["one_card_profile"] = ref.get("profile")
    return res


def spatial_rate(device: torch.device, prof: Profile,
                 timing: bool = False) -> dict:
    """Part (d)'s rate: the image over spatial = n ranks against this
    card's rate of the whole image."""
    n = world_size()
    cfg = prof.codec_cfg
    model = params_from_flax(prof.codec_params(), cfg).to(device)
    h, w, seed = prof.images[prof.rate_image]
    x = synthetic_image(h, w, seed=seed)[None].astype(np.float32) / 255.0
    run = make_sharded_rate_fn(model, make_mesh(data=1, spatial=n))
    with exact_math():
        rate = float(run(x)[0])
        with torch.no_grad():
            one = float(rate_loss_list(x.size, model(
                torch.from_numpy(x).to(device)))[0])
    same_on_every_rank(repr(rate), "the spatial rate")
    rel = abs(rate - one) / abs(one)
    check(rel <= 1e-5, f"spatial={n} rate {rate} vs one card's {one}")
    res = {"rate": rate, "one_card_rate": one, "rel": rel}
    if timing:
        with exact_math():
            res["rate_ms"] = host_ms(lambda: run(x), device, STEP_RUNS)
            with torch.no_grad():
                xd = torch.from_numpy(x).to(device)
                res["one_card_rate_ms"] = host_ms(
                    lambda: rate_loss_list(x.size, model(xd))[0], device,
                    STEP_RUNS)
    say(f"spatial={n} rate of {prof.rate_image}: {rate:.6f} on every rank, "
        f"one card's {one:.6f} ({rel:.3g} relative)"
        + (f"; {res['rate_ms']:.2f} ms (one card "
           f"{res['one_card_rate_ms']:.2f})" if timing else ""))
    return res


# ---- (e) the runner ---------------------------------------------------------

@contextlib.contextmanager
def counting_saves():
    """Count this process's checkpoint writes."""
    saved, save = [], CheckpointManager.save

    def counted(self, name, *args, **kwargs):
        saved.append(name)
        return save(self, name, *args, **kwargs)

    CheckpointManager.save = counted
    try:
        yield saved
    finally:
        CheckpointManager.save = save


def runner(device: torch.device, prof: Profile) -> dict:
    """Part (e): ``llicti_torch.main CONFIG --mesh`` in every rank, two
    steps of the config at ``num_data_shards = n``, then a resume of its
    checkpoint for one more."""
    n = world_size()
    tmp = tempfile.mkdtemp(prefix="llicti_dryrun_") if rank() == 0 else ""
    root = all_gather_bytes([tmp.encode()])[0].decode()
    raw = prof.step_raw
    tr = raw["train"]
    per_step = tr["batch_size"] * tr.get("grad_acc_iters", 2)
    res = {}
    for label, epochs, images, resume in (("train", 1, 2 * per_step, False),
                                          ("resume", 2, per_step, True)):
        cfg = dict(raw, exp_name="dryrun_runner", experiments_root=root,
                   mode="train",
                   train=dict(tr, num_data_shards=n, max_epoch=epochs,
                              resume_training=resume,
                              checkpoint_file="checkpoint"),
                   data={"synthetic": True, "synthetic_len": images})
        path = os.path.join(root, f"{label}.json")
        if rank() == 0:
            with open(path, "w") as f:
                json.dump(cfg, f)
        barrier()
        with counting_saves() as saved:
            trainer = runner_main([path, "--mesh", "--device",
                                   device.type])[-1]
        barrier()
        check(trainer.mesh is not None and trainer.mesh.size == n,
              f"{label}: the runner's mesh is not {n} ranks")
        check(trainer.current_iteration == (2 if label == "train" else 3),
              f"{label}: at iteration {trainer.current_iteration}")
        counts = [int(b) for b in all_gather_bytes([str(len(saved))
                                                    .encode()])]
        check(counts[0] > 0 and not any(counts[1:]),
              f"{label}: checkpoint writes a rank {counts}")
        ckpt = os.path.join(root, "dryrun_runner", "checkpoints",
                            "checkpoint.pt")
        check(os.path.exists(ckpt), f"{label}: no checkpoint")
        same_on_every_rank(digest(trainer.model),
                           f"{label}: the runner's parameters")
        res[label] = {"iteration": trainer.current_iteration,
                      "checkpoint_writes": counts}
        say(f"runner --mesh ({label}): iteration "
            f"{trainer.current_iteration}, parameters equal on every rank, "
            f"checkpoint writes a rank {counts}")
        del trainer
    barrier()
    if rank() == 0:
        shutil.rmtree(root, ignore_errors=True)
    return res


# ---- the machine ------------------------------------------------------------

def card_lines() -> List[str]:
    """``nvidia-smi``'s name and power limit, a line a card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi failed: {e}"]
    return [line.strip() for line in out.splitlines() if line.strip()]


def machine() -> dict:
    count = torch.cuda.device_count()
    nccl = torch.cuda.nccl.version()
    return {"nccl": ".".join(map(str, nccl)) if isinstance(nccl, tuple)
            else str(nccl),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "cards": card_lines(),
            "peer_access_from_0": [torch.cuda.can_device_access_peer(0, j)
                                   for j in range(1, count)]}


# ---- driving ----------------------------------------------------------------

def run(parts: str, prof: Profile, device: torch.device,
        timing: bool = False) -> dict:
    """Parts ``parts`` (of "abcde") in order, inside a joined process
    group; each under its own limit.  -> this rank's results."""
    res = {"rank": rank(), "world": world_size(), "device": str(device)}
    if device.type == "cuda":
        with deadline("build", LIMITS["build"]):
            _kernels.lib()
        torch.cuda.reset_peak_memory_stats(device)
    for part in parts:
        with deadline(part, LIMITS[part]):
            if part == "a":
                res["a"] = jax_dryrun(device, prof.train_cfg)
            elif part == "b":
                res["b"] = sharded_codec(device, prof, timing)
            elif part == "c":
                res["c"] = steps(device, prof, 1, timing)
            elif part == "d":
                check(world_size() % 2 == 0, "needs an even world")
                res["d"] = {"step": steps(device, prof, 2, timing),
                            "rate": spatial_rate(device, prof, timing)}
            elif part == "e":
                res["e"] = runner(device, prof)
            else:
                raise ValueError(f"no part {part!r}")
    if device.type == "cuda":
        res["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2 ** 20
        if rank() == 0:
            res["machine"] = machine()
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="the multi-device dry run, one process a card "
                    "(torchrun --nproc_per_node=N -m "
                    "llicti_torch.parallel.dryrun)")
    ap.add_argument("--device", default="cuda",
                    help='"cpu": gloo at tiny widths, to rehearse')
    ap.add_argument("--time", action="store_true",
                    help="add the multi-card figures")
    args = ap.parse_args(argv)
    if not initialize(device=args.device):
        raise SystemExit("dryrun: run it under torchrun with two or more "
                         "processes (torchrun --nproc_per_node=N -m "
                         "llicti_torch.parallel.dryrun)")
    device = (torch.device("cuda", torch.cuda.current_device())
              if args.device != "cpu" else torch.device("cpu"))
    if device.type == "cpu":
        torch.set_num_threads(1)
    prof = full_profile() if device.type == "cuda" else tiny_profile()
    t0 = time.perf_counter()
    res = run("abcde", prof, device, args.time)
    res["seconds"] = time.perf_counter() - t0
    ranks = all_gather_bytes([json.dumps(res).encode()])
    say(f"dryrun ok: parts abcde on {world_size()} ranks "
        f"({dist.get_backend()}, {device.type}) in {res['seconds']:.1f} s; "
        f"peak MiB a rank {[json.loads(r).get('peak_mib') for r in ranks]}")
    for r in ranks:
        say(r.decode())
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
