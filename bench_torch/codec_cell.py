"""Cell ``flagship_codec_512x768``: the codec as its users run it.

The flagship ``ModelConfig()`` with the trained weights
(``llicti_torch/weights/bench_params.npz``), the device backend with
Kernel 1 tables, 1024 rANS lanes; 512x768 RGB images
``synthetic_image(512, 768, seed=S + i)``.  One client in a closed loop:
(a) single-image round trips, (b) back-to-back calls of resident
``prepare_decode`` / ``prepare_encode`` closures, (c) K = 8 batch
container round trips on 8 distinct images.
"""
from __future__ import annotations

import statistics
import time
from contextlib import contextmanager
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from llicti_torch import Codec, ModelConfig, load_npz, synthetic_image
from llicti_torch import codec as cmod

from . import gates, work
from .measure import profile, summary

H, W = 512, 768
LANES = 1024
BATCH_K = 8
TRIPS, CLOSURE_CALLS, BATCH_TRIPS = 100, 100, 40
HOST_HEADER_CALLS = 20
# the first image's container at seed 42 (every recorded flagship
# container at 1024 lanes, sha256 3cab0436...); another count is printed,
# not failed: bpsp and its bound decide
SEED42_BYTES = 861_769


def make_codec(device="cuda", cfg: ModelConfig = None, params=None,
               lanes: int = LANES) -> Codec:
    return Codec(cfg or ModelConfig(),
                 load_npz() if params is None else params, device=device,
                 num_lanes=lanes)


def images(seed: int, count: int, h: int = H, w: int = W) -> List[np.ndarray]:
    return [synthetic_image(h, w, seed=seed + i) for i in range(count)]


def single_trips(codec: Codec, imgs: Sequence[np.ndarray], clock) -> Dict:
    """(a) compress then decompress each image, each call timed; every
    image lossless (byte-equal, and ``last_ycocg_err`` 0 from an untimed
    second decode) and its coder closure within +-1 %."""
    enc, dec, nbytes, closure = [], [], [], []
    for i, img in enumerate(imgs):
        label = f"single image {i}"
        streams, ms = clock.host(lambda: codec.compress(img))
        enc.append(ms)
        closure.append(gates.coder_closure(
            codec.last_slice_bits, codec.last_ideal_bits, label))
        out, ms = clock.host(lambda: codec.decompress(streams))
        dec.append(ms)
        gates.lossless(img, out, label)
        codec.decompress(streams, xorg=img)
        gates.gate(codec.last_ycocg_err == 0, f"{label}: last_ycocg_err "
                   f"{codec.last_ycocg_err}")
        nbytes.append(Codec.num_bytes(streams))
    return {"encode_ms": enc, "decode_ms": dec, "bytes": nbytes,
            "closure": closure}


def resident(codec: Codec, img: np.ndarray, calls: int, clock) -> Dict:
    """(b) ``calls`` back-to-back calls of a ``prepare_decode`` closure of
    ``img``'s container, then of a ``prepare_encode`` closure of ``img``,
    after one call of each; the last decode equals ``img`` and the last
    encode's stream has the words of ``compress``."""
    streams = codec.compress(img)
    words = sum(map(sum, codec.last_slice_bits)) // 16
    h, w = img.shape[:2]
    decode, encode = codec.prepare_decode(streams), codec.prepare_encode(img)
    decode()
    encode()
    rgb, dec = clock.events(decode, calls)
    gates.lossless(img, rgb[0, :h, :w].cpu().numpy(), "resident decode")
    (cursors, _, _, _), enc = clock.events(encode, calls)
    got = int(cursors[0, -1])
    gates.gate(got == words, f"resident encode: {got} words, compress "
               f"{words}")
    return {"decode_ms": dec, "encode_ms": enc}


def batch_trips(codec: Codec, imgs: Sequence[np.ndarray], trips: int,
                clock) -> Dict:
    """(c) ``trips`` round trips of a batch container of ``imgs``:
    compress_batch, then decompress_batch, each timed; every image
    byte-equal to its input and each image's coder closure within
    +-1 %."""
    enc, dec = [], []
    for t in range(trips):
        streams, ms = clock.host(lambda: codec.compress_batch(imgs))
        enc.append(ms)
        for k, (act, ideal) in enumerate(zip(codec.last_slice_bits_batch,
                                             codec.last_ideal_bits_batch)):
            gates.coder_closure(act, ideal, f"batch trip {t} image {k}")
        outs, ms = clock.host(lambda: codec.decompress_batch(streams))
        dec.append(ms)
        for k, (img, out) in enumerate(zip(imgs, outs)):
            gates.lossless(img, out, f"batch trip {t} image {k}")
    return {"encode_ms": enc, "decode_ms": dec}


def forward_flops(model: torch.nn.Module, h: int, w: int,
                  batch: int = 1) -> int:
    """Float operations of one forward of ``model`` at [batch, h, w, 3],
    counted by ``FlopCounterMode`` as ``Trainer.flops_estimation`` counts
    them (the convs)."""
    device = next(model.parameters()).device
    x = torch.zeros((batch, h, w, 3), device=device)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x)
    return counter.get_total_flops()


def metrics(single: Dict, res: Dict, batch: Dict, flops: int, h: int,
            w: int, k: int) -> Dict[str, Dict]:
    """The cell's end-to-end metrics from its samples: {name: {value,
    and what is printed beside it}}."""
    mpix = h * w / 1e6
    dec_mean = statistics.fmean(res["decode_ms"])
    enc_mean = statistics.fmean(res["encode_ms"])
    trips = [(e + d) / k for e, d in zip(batch["encode_ms"],
                                         batch["decode_ms"])]
    return {
        "encode_ms": dict(summary(single["encode_ms"], 0.9),
                          value=statistics.median(single["encode_ms"])),
        "decode_ms": dict(summary(single["decode_ms"], 0.9),
                          value=statistics.median(single["decode_ms"])),
        "resident_decode_mpix_s": {
            "value": mpix / dec_mean * 1e3, "n": len(res["decode_ms"]),
            "decode_call_mean_ms": dec_mean,
            "decode_call": summary(res["decode_ms"], 0.9),
            "encode_call_mean_ms": enc_mean,
            "resident_encode_mpix_s": mpix / enc_mean * 1e3,
            "encode_call": summary(res["encode_ms"], 0.9)},
        "batch8_ms_per_image": dict(
            summary(trips, 0.75), value=statistics.median(trips),
            encode_ms_per_image=statistics.median(batch["encode_ms"]) / k,
            decode_ms_per_image=statistics.median(batch["decode_ms"]) / k),
        "bpsp": {"value": statistics.fmean(single["bytes"]) * 8
                 / (h * w * 3), "n": len(single["bytes"]),
                 "closure_pct": [100 * min(single["closure"]),
                                 100 * max(single["closure"])]},
        "decode_mfu": {
            "value": flops / (dec_mean / 1e3) / work.F32_FLOP_PER_S,
            "flops": flops, "peak_flop_per_s": work.F32_FLOP_PER_S,
            "peak": "float32 without tensor cores: every codec pass runs "
                    "under exact_math() with TF32 off"},
    }


def run(seed: int, clock, device="cuda", cfg: ModelConfig = None,
        params=None, h: int = H, w: int = W, lanes: int = LANES,
        trips: int = TRIPS, closure_calls: int = CLOSURE_CALLS,
        batch_trips_n: int = BATCH_TRIPS, batch_k: int = BATCH_K):
    """The cell's traffic, gates and metrics.  -> (set-up numbers,
    metrics)."""
    t0 = time.perf_counter()
    codec = make_codec(device, cfg, params, lanes)
    imgs = images(seed, max(trips, batch_k), h, w)
    setup = {"codec_and_images_s": time.perf_counter() - t0}
    out, setup["first_round_trip_ms"] = clock.host(
        lambda: codec.decompress(codec.compress(imgs[0])))
    gates.lossless(imgs[0], out, "first round trip")
    single = single_trips(codec, imgs[:trips], clock)
    if seed == 42 and (h, w, lanes) == (H, W, LANES):
        setup["seed42_first_image_bytes"] = single["bytes"][0]
        setup["seed42_expected_bytes"] = SEED42_BYTES
    res = resident(codec, imgs[0], closure_calls, clock)
    bimgs = imgs[:batch_k]
    _, setup["first_batch_round_trip_ms"] = clock.host(
        lambda: codec.decompress_batch(codec.compress_batch(bimgs)))
    batch = batch_trips(codec, bimgs, batch_trips_n, clock)
    flops = forward_flops(codec.model, h, w)
    return setup, metrics(single, res, batch, flops, h, w, batch_k)


# ---- the traced run -------------------------------------------------------

@contextmanager
def kernel_work():
    """Within: every launch of Kernels 1-3 that the codec makes adds its
    bound (bench_torch/work.py, on the launch's own inputs) to
    ``bounds[kernel]``; yields that dict.  Each launch's data-dependent
    count (saturated terms, words) waits for the card: for an untimed
    run."""
    bounds = {"kernel1": 0.0, "kernel2": 0.0, "kernel3": 0.0}
    k1, k2, k3 = cmod.gmm_cdf_from_pmap, cmod.rans_decode, \
        cmod.rans_encode_chain

    def cdf_pmap(pts, pm, y2, M, s0, m0, w0, upd, logistic, sym_ch, minv):
        out = k1(pts, pm, y2, M, s0, m0, w0, upd, logistic, sym_ch, minv)
        spec = (M, s0, m0, w0, tuple(upd))
        sat = 0 if logistic else work.cdf_pmap_saturated(pts, pm, y2, spec)
        bounds["kernel1"] += work.bound(*work.cdf_pmap_work(
            pm.shape[0], pts.shape[0], spec, sym_ch, sat, logistic))[0]
        return out

    def decode(cum, words, states, offset):
        before = offset.clone()
        out = k2(cum, words, states, offset)
        read = int((offset - before).sum())
        bounds["kernel2"] += work.bound(work.rans_decode_bytes(
            cum.shape[0] * cum.shape[1], cum.shape[-1], read,
            states.numel()), 0)[0]
        return out

    def encode(starts, freqs, offsets, states, cursor, buf):
        before = cursor.clone()
        out = k3(starts, freqs, offsets, states, cursor, buf)
        written = int((cursor - before).sum())
        bounds["kernel3"] += work.bound(work.rans_encode_bytes(
            starts.numel(), written, states.numel()), 0)[0]
        return out

    cmod.gmm_cdf_from_pmap, cmod.rans_decode, cmod.rans_encode_chain = \
        cdf_pmap, decode, encode
    try:
        yield bounds
    finally:
        cmod.gmm_cdf_from_pmap, cmod.rans_decode, cmod.rans_encode_chain = \
            k1, k2, k3


def _trip_profile(encode, decode) -> Dict:
    """Profiles of one encode call and one decode call, summed."""
    e, d = profile(encode), profile(decode)
    wall, busy = e["wall_ms"] + d["wall_ms"], e["busy_ms"] + d["busy_ms"]
    groups = {g: {"ms": e["groups"][g]["ms"] + d["groups"][g]["ms"],
                  "launches": e["groups"][g]["launches"]
                  + d["groups"][g]["launches"]} for g in e["groups"]}
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "launches": e["launches"] + d["launches"],
            "encode_launches": e["launches"],
            "decode_launches": d["launches"], "groups": groups}


def trace(seed: int) -> Dict[str, Dict]:
    """The per-layer metrics of one single-image round trip and one K = 8
    batch round trip (after a warm-up of each), and the encoder's
    host_header."""
    codec = make_codec()
    imgs = images(seed, BATCH_K)
    img = imgs[0]
    codec.decompress(codec.compress(img))
    codec.decompress_batch(codec.compress_batch(imgs))
    with kernel_work() as single_bounds:
        codec.decompress(codec.compress(img))
    with kernel_work() as batch_bounds:
        codec.decompress_batch(codec.compress_batch(imgs))
    streams = codec.compress(img)
    single = _trip_profile(lambda: codec.compress(img),
                           lambda: codec.decompress(streams))
    bstreams = codec.compress_batch(imgs)
    batch = _trip_profile(lambda: codec.compress_batch(imgs),
                          lambda: codec.decompress_batch(bstreams))
    out = {}
    for suffix, prof, bounds in (("", single, single_bounds),
                                 ("_batch8", batch, batch_bounds)):
        for k in ("kernel1", "kernel2", "kernel3"):
            g = prof["groups"][k]
            out[f"{k}_ms{suffix}"] = {"value": g["ms"],
                                      "launches": g["launches"]}
            out[f"{k}_roofline{suffix}"] = {
                "value": bounds[k] / g["ms"] if g["ms"] else None,
                "bound_ms": bounds[k], "kernel_ms": g["ms"]}
        out[f"conv_ms{suffix}"] = {
            "value": prof["groups"]["conv"]["ms"],
            "launches": prof["groups"]["conv"]["launches"]}
        out[f"cudnn_transpose_ms{suffix}"] = {
            "value": prof["groups"]["cudnn_transpose"]["ms"],
            "launches": prof["groups"]["cudnn_transpose"]["launches"]}
        out[f"device_idle_share{suffix}"] = {
            "value": prof["idle_share"], "busy_ms": prof["busy_ms"],
            "wall_ms": prof["wall_ms"]}
    out["launches_per_round_trip"] = {
        "value": single["launches"], "encode": single["encode_launches"],
        "decode": single["decode_launches"]}
    times = []
    for _ in range(HOST_HEADER_CALLS):
        t0 = time.perf_counter()
        cmod.host_header(img[None], codec.cfg.dwtlevels)
        times.append(1e3 * (time.perf_counter() - t0))
    out["host_header_ms"] = {"value": statistics.median(times),
                             "n": len(times)}
    return out
