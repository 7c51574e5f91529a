#!/usr/bin/env python3
"""Smoke run of the PyTorch port (llicti_torch) on one CUDA card.

Usage: python3 chip_smoke.py        (from the repository root, one GPU)
       python3 chip_smoke.py --phase-13d   (two or more GPUs: the kernels'
                                            build and phase 13 (d) alone)

Phases, each of which raises on failure:
  1. print the card (nvidia-smi name and power limit); require CUDA;
  2. build the CUDA kernels from llicti_torch/csrc, print the build time,
     ptxas's registers / stack frame / spills of every kernel (Kernel 1's
     instances and the wide decode must have no stack frame and no
     spills, Kernel 3's two kernels no spills) and Kernel 1's
     occupancy; check the normal mixture term's saturation shortcut
     against the full formula on every float;
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (the finest band of a 512x768 image, 1024 lanes),
     and time both: Kernel 1 in its normal and logistic branches, Kernel 4
     (gmm_cdf_table_int32) on gmm_slice_params of the same parameter map,
     the rANS decode, and the rANS encode on the finest Y slice alone and
     on the image's whole 45-slice chain (Codec.encode_inputs) in one
     call; each kernel's bound (bytes over 3.35 TB/s or float operations
     over 67 TFLOP/s, the H100 SXM's published peaks) is computed from the
     inputs timed, with the work counts of llbench/work.py;
  3b. the rANS decode against its plain version on synthetic tables of
     P = 2 ... 513 with rows below cum[0] and at or above cum[P-2], n not a
     multiple of N, N = 1000 and 1024: random states and words, and a round
     trip through the encoder;
  3c. the rANS encode chain against its plain version on chains of mixed
     slice sizes (empty, shorter than N, not a multiple of N, masked
     padding) at N = 1, 33, 1000, 1024, with freq 1, freq near 2^16 and
     carried states 2^16 and 2^32 - 1, each decoded back by Kernel 2;
  4. check the CUDA model against the CPU one on a small crop;
  4b. the band epilogue (ops/band_epilogue.py) against its plain version
     (PyTorch's passes on the card) at the main path's shapes, bit for
     bit with -0.0, +-inf and NaN strewn in: layer 0's 1-3 unit maps of
     the finest band (256x384, Ch 352) at K = 1 in place and at K = 8
     written channel-major, with ReLU and without; the trunk's middle conv
     in place (K = 1 and the K = 8 stack, [1, 352, 2048, 384]); the last
     conv (Co 60) written NHWC at both; 310x598's finest band (155x299,
     the scalar kernels) and an NHWC last tile short of a block's pixels;
     each timed beside its bound (bytes
     over 3.35 TB/s) and beside the PyTorch passes it replaces (the bias
     adds, the unit sums, the clamp, the NHWC copy); then its launches
     over a K = 8 batch container round trip, conv_layers a band net (90);
  5. the main path: Codec.compress -> serialize -> deserialize ->
     decompress of synthetic_image(512, 768, seed=42) with the trained
     flagship weights, byte-exact, with every kernel's launch count > 0
     (the encode's at most 2, the band epilogue's conv_layers a band net,
     90); prints the container's sha256 and size;
  6. the same round trip on a 310x598 image (odd sizes, pad flags);
  7. Kernel 4's path (it lies on no codec path, in this package or the JAX
     one): tables of the finest band from gmm_slice_params, rANS-encoded
     at the true symbols and decoded back;
  8. the variants: one byte-exact round trip of the 512x768 image per
     coded configuration at flagship widths and depth (clrjnt 2 / 1 / 0 /
     0+seqmd x normal / logistic, GDN1, mwsa_joint, combine_layers1toL),
     plus 310x598 for clrjnt 1 and 0+seqmd; the trained weights for
     clrjnt 2 logistic, init_params(cfg, seed=0) for the rest (so only
     losslessness and the kernels mean anything there, not the bits);
     clrjnt 1 normal also: Kernel 1's launches by mixture terms in each
     direction (15 at ten, Y's 2M, and 30 at five), every (scale, band)
     map of a K = 8 batch and of one image bit-equal to the benchmark's
     reference (``llbench/reference/clrjnt1.py``: layer 0 at groups 2,
     where the codec holds its kernel ungrouped), and the K = 8 batch
     container lossless;
  9. the serving path, each part driven with the launch counts set to 0
     just before it and read just after: (a) Kernels 2 and 3 batched over
     K = 8 images synthetic_image(512, 768, seed=42+k), one launch / one
     call, bit-identical to their plain versions on the finest Y slices
     and on the eight 45-slice chains, timed a launch and an image beside
     K = 1's with each bound, and the card's resident decode clusters
     (cudaOccupancyMaxActiveClusters); (b) the batch container of the
     eight: compress_batch -> serialize -> deserialize -> decompress_batch
     lossless, 45 Kernel 2 launches and at most 2 of Kernel 3, its
     sha256 BATCH_SHA (the container of the same images when the trunk
     ran at batch K), every (scale, band) parameter map of the eight
     from the trunk at batch 1 (band_params_batched, the batch's path)
     bit-equal to the one at batch K (band_params), eight copies of one
     image giving eight identical blobs, and prepare_decode_batch's
     closure; (c) compress_many / decompress_many
     of six images, byte-equal to six compress calls with equal per-image
     accounting; (d) prepare_decode / prepare_encode closures equal to the
     wire paths, one call of each under set_sync_debug_mode("error") and a
     torch.profiler trace with no Memcpy HtoD/DtoH, then ms an image over
     30 back-to-back calls; (e) size_bucket=64 on four ragged sizes; (f)
     two_stage on 512x768 and 310x598, cross-decoded with the fused codec
     both ways; (g) the decoder's staging block: widen_words against its
     plain version on random rows, lengths and column ranges, the batch
     container decoded 20 times after a warm-up (lossless, one widen
     launch each, staging_counts reused >= 99 % and never waited), the
     two-stage codec's split decodes (two widen launches), no
     cudaHostAlloc in a profiler trace of a steady-state decode, the
     widen's ms beside its bound and the staging's host ms beside the
     unpack it replaced.  Wall time and peak memory of each part are
     printed;
  10. the slice of the rate forward and the host backend, each part with
     the launch counts set to 0 just before it and read just after: (a) C2,
     the flagship container's num_bytes within max(0.1 %, 16 B) of the JAX
     package's 861,767 and its sha256 PR 2's (3cab0436...9336cc, checked in
     phase 5); (b) C1, a new codec's round trip with all four cuDNN / TF32
     flags flipped after it is built, again between compress and
     decompress and again before its resident closures: the same sha256,
     byte-exact decode and closures, the flags read back as the caller set
     them after every call; (c) backend="host" round trips of 512x768 and
     310x598, lossless with last_ycocg_err 0 and no hand-kernel launch, its
     bytes and bpsp against the device container, encode / decode ms
     (medians of 5) and peak memory; (d) the rate forward of the flagship
     at 512x768 under exact_math against the CPU forward of the same
     weights (per-(scale, band, colour) sums within 1e-4 relative, maps
     within rtol 1e-4 and atol RATE_ATOL bits), its ms, and the est/act gap
     against phase 5's container;
  11. training at flagship width, each part with the launch counts of
     Kernels 1-4 set to 0 just before it and read just after (all must
     stay 0): (a) one train step of the trained weights on a
     [2, 2, 160, 160, 3] TrainLoader batch (synthetic set, seed 1337) under
     exact_math on the card and on the CPU: the loss within 1e-5 and the
     breakdown within 1e-4 relative, every gradient within 1e-2 of its
     max|g_cpu| and card and CPU alike within
     dryrun.FLOAT64_GRAD_REL_L2 (relative L2, under exact_math) of the
     step's float64 gradient (dryrun.float64_step), Adam's step count,
     and the step rule of
     llicti_torch.parallel.dryrun (step_rule: the gradients within
     CARD_CPU_GRAD_REL_L2 of the CPU's, every parameter within 2 lr, and
     beyond 1e-3 lr only where the float64 gradient is float noise), its
     readings printed beside the share within 1e-3 lr, and whether a
     second card step is bit-identical; (b) the Trainer on the card at
     configs/paper_a.json's train settings over 320 synthetic images: five
     finite losses, checkpoint and model_best, a resume with equal
     parameters and Adam state that runs iterations 5-10, and the loop's
     ms from a step's end to the next's; (c) ms an optimiser step (batch
     2 x 32 of 160^2) under PyTorch's default flags and under exact_math,
     patches a second, peak memory, and the loader's ms a batch on its
     own, beside the card's name and power limit;
  12. the rest of the port, each part with the launch counts set to 0
     just before it and read just after: (a) Kernels 2 and 3 above 1024
     lanes, at each N of LANES (2048 ... 131072; 98304 decodes the slice
     in one step, 131072 leaves lanes with no symbol) on the finest Y
     slice and the 45-slice chain, bit-identical to the plain versions and
     timed with their bounds beside N = 1024's; edge tables and chains at
     N = 1025, 8192, 16385 and 131072; the wide decode on K = 8 images'
     Y slices in one launch at N = 2048 and at N = 20000 (two lanes a
     thread, states in device memory), bit-identical; flagship round
     trips at N = 2048, 4096 and 20000, byte-exact, with the wide
     variants' launch counts; K = 8 batch containers at N = 2048 and
     20000, byte-exact, all their rANS launches wide, bytes and ms an
     image beside N = 1024's; (b) the float-CDF path
     (Codec(use_kernel_cdf=False), the JAX package's default): 512x768 and
     310x598 byte-exact with no Kernel 1 launch and 45 / 2 of Kernels 2 /
     3, num_bytes within max(0.1 %, 16 B) of JAX's 861,767, ms beside
     Kernel 1's; (c) the CLI's encode and decode on the card (PNG, or .npy
     without PIL): the decoded file equals the input, the blob the codec's;
     (d) the Trainer's eval_model over three images (the trained weights
     from a port .pt) and the eval protocol over a temporary corpus of 2
     valid + 2 test images: lossless, JAX's keys, rate from the bytes,
     coder gaps within +-1 %; (e) flops_est on the card equal to the CPU's;
  13. multi-device (llicti_torch.parallel), each part with the launch counts
     set to 0 just before it and read just after: (a) in a one-rank NCCL
     group, ShardedCodec at G = 1 and G = 4 (N = 128) on 512x768 and
     310x598 with the trained weights: lossless, last_ycocg_err 0, the
     header bytes JAX's, num_bytes within max(0.1 %, 16 B) of JAX's (CPU
     constants, JAX_SP), 45 Kernel 2 launches a decode, 2 of Kernel 3 an
     encode, none of Kernel 1; encode / decode ms (medians of 5) and peak
     memory at 512x768; (b) Kernels 2 and 3 at the sharded shapes (K = 4
     shards of the finest Y slice in one launch, the four 45-slice chains
     in one call) bit-identical to their plain versions, timed with their
     bounds; (c) two processes on the one card (this script with
     --sp-rank R 2 PORT gloo DIR), gloo over CUDA tensors staged through
     host memory, each running parts (b)-(d) of
     llicti_torch.parallel.dryrun, whose checks raise in the rank: the
     sharded codec at G = 2 and 4 (lossless, the same container on both
     ranks, JAX's header, num_bytes within max(0.1 %, 16 B) of JAX's and
     within 16 B of the one-process container), a data-parallel paper_a
     step (2 x 32 patches of 160^2, 16 a rank) and a spatial = 2 step
     (patch 128) against one card's under step_rule (no hand-kernel
     launch, the loss within 1e-4, equal losses and parameters on both
     ranks), and the spatial = 2 rate of 512x768 within 1e-5 of one
     device's; (d) with
     two or more cards, the same parts one process a card under NCCL
     (this script with --sp-rank R WORLD PORT nccl DIR): the sharded codec
     at G = n and 2n, a data-parallel and a data n/2 x spatial 2 paper_a
     step against one card's, the spatial = n rate; on
     one card it says, on a line of its own, that it did not run.
The line before the last is {"kernels": [...]}: Kernel 2's and Kernel 3's
rows also carry the batch figures (batch_k, batch_ms, batch_plain_ms,
batch_bound_ms, batch_launches) and phase 13's (sharded_launches over a
G = 4 encode / decode, and "sharded": the K = 4 launch / call's ms,
plain_ms, bound_ms, max_abs_err beside G = 1's and G = 4's round-trip ms
and peak memory); rans_decode_wide and rans_encode_wide are
Kernels 2 and 3 above 1024 lanes (N = 2048's figures, each N's under
"lanes", the decode's with its steps and us a step on the Y slice, and
its K = 8 launch at N = 2048 as batch_*, at N = 20000 under
"wide_batch_lanes", and the K = 8 batch containers' bytes, ms an image and
launches by N under "batch_container_lanes"); band_epilogue's row holds
phase 4b's cases (ms, bound_ms, passes_ms), its launches over the main
path's round trip and a batch one's (batch_launches); widen_words's
holds phase 9 (g)'s (ms, plain_ms, bound_ms at the batch container's
shape, the cases, staging_counts, the host staging's and the old
unpack's ms); the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Tuple

import numpy as np
import torch

from llicti_torch import (Codec, ModelConfig, _kernels, cli, eval_protocol,
                          load_npz, synthetic_image)
from llicti_torch import codec as cmod
from llicti_torch.codec import exact_math
from llicti_torch.coder import rans
from llicti_torch.config import (DataConfig, LLICTIConfig, TrainConfig,
                                 config_from_json, replace)
from llicti_torch.data import ImageDataset, TrainLoader, load_rgb
from llicti_torch.ops import cdf
from llicti_torch.ops.band_epilogue import (band_epilogue, band_epilogue_plain,
                                            unfused_passes)
from llicti_torch.ops.bounds import lower_bound
from llicti_torch.ops.color import rgb_int_to_ycocg_r_int
from llicti_torch.ops.gmm import SCALE_BOUND_NORMAL, cdf_sampling_points
from llicti_torch.ops.wavelet import lazy_dwt
from llicti_torch.parallel import (ShardedCodec, dryrun, initialize,
                                   make_sp_mesh)
from llicti_torch.parallel.dryrun import FLOAT64_GRAD_REL_L2, float64_step
from llicti_torch.training import Trainer, make_optimizer, make_train_step
from llicti_torch.utils import CheckpointManager
from llicti_torch.weights import BENCH_PARAMS, init_params, params_from_flax

from llbench.work import (ENTRY_OPS, F32_FLOP_PER_S, HBM_BYTES_PER_S,
                          NORMAL_OPS, NORMAL_SAT_OPS, bound_s, cdf_work,
                          rans_decode_bytes, rans_encode_bytes)

# (label, ModelConfig knobs, trained weights?, also 310x598?)
VARIANTS = [
    ("clrjnt2 normal", {}, False, False),
    ("clrjnt2 logistic", {"distribution": "logistic"}, True, False),
    ("clrjnt1 normal", {"clr_joint_mode": 1}, False, True),
    ("clrjnt1 logistic", {"clr_joint_mode": 1, "distribution": "logistic"},
     False, True),
    ("clrjnt0 normal", {"clr_joint_mode": 0}, False, False),
    ("clrjnt0 logistic", {"clr_joint_mode": 0, "distribution": "logistic"},
     False, False),
    ("clrjnt0+seqmd normal", {"clr_joint_mode": 0, "clrjnt0seqmd": True},
     False, True),
    ("clrjnt0+seqmd logistic", {"clr_joint_mode": 0, "clrjnt0seqmd": True,
                                "distribution": "logistic"}, False, True),
    ("clrjnt2 GDN1", {"activfun": "GDN1"}, False, False),
    ("clrjnt2 mwsa_joint", {"mwsa_joint": True}, False, False),
    ("clrjnt2 combine_layers1toL", {"combine_layers1toL": True}, False,
     False),
]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, setup=None) -> float:
    """Mean milliseconds of fn(*setup(i)) over ``iters`` runs, by CUDA
    events around the whole loop (after one warm-up).  The loop is queued
    behind a ~10 ms device-side wait, so that a wrapper's host work does
    not show in a kernel's time."""
    args = [setup(i) if setup else () for i in range(iters + 1)]
    fn(*args[0])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    t0.record()
    for i in range(1, iters + 1):
        fn(*args[i])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| of two integer tensors of one shape (0 if empty)."""
    check(a.shape == b.shape, f"shapes {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def bound(nbytes: float, flops: float) -> Tuple[float, str]:
    """(``bound_s`` in ms, what sets it: "bytes" or "operations")."""
    by_bytes = nbytes / HBM_BYTES_PER_S >= flops / F32_FLOP_PER_S
    return 1e3 * bound_s(nbytes, flops), "bytes" if by_bytes else "operations"


# float operations of one logistic mixture term (csrc/cdf.cuh)
LOGISTIC_OPS = 8


def cdf_pmap_saturated(pts: torch.Tensor, pm: torch.Tensor,
                       y2: torch.Tensor, spec) -> int:
    """Normal mixture terms of Kernel 1 on these inputs whose erf
    saturates (|z| / sqrt(2) > 10.5, the shortcut of csrc/cdf.cuh)."""
    M, s0, m0, _, upd = spec
    std = lower_bound(pm[:, s0:s0 + M], SCALE_BOUND_NORMAL)
    mean = pm[:, m0:m0 + M]
    for coef0, ych in upd:
        mean = mean + pm[:, coef0:coef0 + M] * y2[:, ych:ych + 1]
    inv = 1.0 / std
    sat = 0
    for x in range(M):
        z = (pts[None, :] - mean[:, x:x + 1]) * inv[:, x:x + 1]
        sat += int(((z * cdf._SQRT2_INV).abs() > 10.5).sum())
    return sat


def cdf_table_saturated(pts: torch.Tensor, stdevs: torch.Tensor,
                        means: torch.Tensor) -> int:
    """Saturated normal terms of Kernel 4 on pre-sliced parameters."""
    z = (pts[None, None, None, None, :] - means[..., None]) \
        / lower_bound(stdevs, SCALE_BOUND_NORMAL)[..., None]
    return int(((z * cdf._SQRT2_INV).abs() > 10.5).sum())


def cdf_table_work(rows: int, P: int, X: int,
                   saturated: int) -> Tuple[int, int]:
    """(bytes, float operations) of Kernel 4: three parameters of each of
    the X mixtures a pixel read, the points read, the table written."""
    flops = ((rows * P * X - saturated) * NORMAL_OPS
             + saturated * NORMAL_SAT_OPS + rows * P * ENTRY_OPS)
    return 4 * (3 * rows * X + P + rows * P), flops


def kernel_phase(codec, img):
    """Kernels vs plain versions at the finest band of ``img``; per kernel
    (max |d|, mean ms, mean plain ms, bound ms, bound_by)."""
    cfg, dev = codec.cfg, codec.device
    minmax, _ = cmod.host_header(img[None], cfg.dwtlevels)
    ranges = [cmod.clr_range(clr, minmax) for clr in range(3)]
    x = torch.from_numpy(img[None].copy()).to(dev)
    y_list, _, _ = lazy_dwt(codec._to_y(rgb_int_to_ycocg_r_int(x)),
                            cfg.dwtlevels, pad=True)
    y0 = y_list[0]
    h, w = y0.shape[1], y0.shape[2]
    n = h * w
    with torch.inference_mode(), exact_math():
        pmap = codec.model.band_params(y0[..., :3].contiguous(), 0, 0)
    pm = pmap[0].reshape(n, -1).contiguous()
    y2 = y0[0].reshape(n, -1).contiguous()
    results = {}

    def compare_tables(label, cum, pcum):
        d = (cum.long() - pcum.long()).abs()
        mism = int((d > 0).sum())
        check(mism == 0, f"{label}: {mism} entries differ from the plain "
              "version")
        check(bool((cum[..., -1] == 65536).all()), "last entry != 2^16")
        check(bool((cum[..., 1:] > cum[..., :-1]).all()),
              "rows not increasing")
        return int(d.max()), mism, d.numel()

    def report(label, P, err, mism, size, ms, plain_ms, bnd, extra=""):
        print(f"{label} n={n} P={P}: max|d|={err} "
              f"mismatches={mism}/{size}, kernel {ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}), "
              f"{100.0 * bnd[0] / ms:.1f}% of it{extra}")

    def cdf_case(clr, minv, maxv, logistic=False):
        spec = cmod.pmap_cdf_spec(cfg, 0, clr)
        M, s0, m0, w0, upd = spec
        sch = cmod.sym_channel(cfg, 0, clr)
        pts = cdf_sampling_points(minv, maxv).to(dev)
        args = (pts, pm, y2, M, s0, m0, w0, upd, logistic, sch, minv)
        cum, st, fr = cdf.gmm_cdf_from_pmap(*args)
        pcum, pst, pfr = cdf.gmm_cdf_from_pmap_plain(*args)
        torch.cuda.synchronize()
        P = cum.shape[1]
        label = f"kernel1{' logistic' if logistic else ''} clr={clr}"
        err, mism, size = compare_tables(label, cum, pcum)
        check(bool(torch.equal(st, pst) and torch.equal(fr, pfr)),
              f"{label}: (start, freq) != the plain version's")
        ms = cuda_ms(lambda: cdf.gmm_cdf_from_pmap(*args), 20)
        plain_ms = cuda_ms(lambda: cdf.gmm_cdf_from_pmap_plain(*args), 5)
        sat = 0 if logistic else cdf_pmap_saturated(pts, pm, y2, spec)
        nbytes, flops = cdf_work(n, P, spec, sch, sat)
        if logistic:  # every term in full
            flops = n * P * (M * LOGISTIC_OPS + ENTRY_OPS)
        bnd = bound(nbytes, flops)
        report(label, P, err, mism, size, ms, plain_ms, bnd,
               f"; {sat} of {n * P * M} mixture terms saturated "
               f"({100 * sat / (n * P * M):.1f}%), "
               f"{flops / (ms * 1e9):.2f} TFLOP/s of needed work")
        return (cum, st, fr), (err, ms, plain_ms) + bnd

    def table_case(clr, minv, maxv):
        """Kernel 4 on gmm_slice_params of the same parameter map."""
        params = [t.contiguous() for t in
                  cmod.gmm_slice_params(cfg, pmap, y0, 0, clr)]
        pts = cdf_sampling_points(minv, maxv).to(dev)
        cum = cdf.gmm_cdf_table_int32(pts, *params)
        pcum = cdf.gmm_cdf_table_int32_plain(pts, *params)
        torch.cuda.synchronize()
        P = cum.shape[-1]
        err, mism, size = compare_tables(f"kernel4 clr={clr}", cum, pcum)
        ms = cuda_ms(lambda: cdf.gmm_cdf_table_int32(pts, *params), 20)
        plain_ms = cuda_ms(
            lambda: cdf.gmm_cdf_table_int32_plain(pts, *params), 5)
        bnd = bound(*cdf_table_work(
            n, P, params[0].shape[-1],
            cdf_table_saturated(pts, params[0], params[1])))
        report(f"kernel4 clr={clr}", P, err, mism, size, ms, plain_ms, bnd)
        return (err, ms, plain_ms) + bnd

    def summary(cases, widest):
        """(max |d| over every case, then the means of ms, plain ms and
        bound ms over the image's three colour slices, bound_by)"""
        return (max([c[0] for c in cases] + widest),
                sum(c[1] for c in cases) / 3, sum(c[2] for c in cases) / 3,
                sum(c[3] for c in cases) / 3,
                max(cases, key=lambda c: c[3])[4])

    # Kernel 1 on the three slices of the band (the image's ranges), then
    # at the widest tables: Y at P=257 and Co at P=513; both branches
    sf, tables, k1 = [], [], []
    for clr in range(3):
        (cum, st, fr), res = cdf_case(clr, *ranges[clr])
        sf.append((st, fr))
        tables.append(cum)
        k1.append(res)
    widest = [cdf_case(0, -127, 128)[1][0], cdf_case(1, -256, 255)[1][0]]
    results["cdf"] = summary(k1, widest)
    k1l = [cdf_case(clr, *ranges[clr], logistic=True)[1]
           for clr in range(3)]
    widest = [cdf_case(0, -127, 128, True)[1][0],
              cdf_case(1, -256, 255, True)[1][0]]
    results["cdf_logistic"] = summary(k1l, widest)
    k4 = [table_case(clr, *ranges[clr]) for clr in range(3)]
    results["table"] = summary(k4, [table_case(0, -127, 128)[0],
                                    table_case(1, -256, 255)[0]])

    # Kernel 3: encode the three slices (reverse order) one call each,
    # kernel vs plain
    N = codec.N
    cap = 3 * n + N

    def enc(fn):
        states, cursor, buf = fresh_carry(N, cap, dev)
        for st, fr in reversed(sf):
            fn(st, fr, states, cursor, buf)
        return states, cursor, buf

    ks, kc, kb = enc(rans.rans_encode)
    ps, pc, pb = enc(rans.rans_encode_plain)
    torch.cuda.synchronize()
    total = int(kc[0])
    check(int(pc[0]) == total, "rANS encode kernel != plain word count")
    enc_err = max(max_abs(ks, ps), max_abs(kb[:total], pb[:total]))
    check(enc_err == 0, "rANS encode kernel != plain version")
    blob = rans.pack_stream_packed(kb[:total].cpu().numpy(), ks.cpu().numpy())
    print(f"kernel3 encode: 3 slices x {n} symbols, N={N}: "
          f"{total} words, identical stream bytes and states")
    st0, fr0 = sf[0]

    def fresh_enc(_):
        return fresh_carry(N, cap, dev)

    s, c, b = fresh_enc(0)
    rans.rans_encode(st0, fr0, s, c, b)
    words0 = int(c[0])
    enc_ms = cuda_ms(lambda s, c, b: rans.rans_encode(st0, fr0, s, c, b), 20,
                     fresh_enc)
    enc_plain = cuda_ms(
        lambda s, c, b: rans.rans_encode_plain(st0, fr0, s, c, b), 3,
        fresh_enc)
    bnd = bound(rans_encode_bytes(n, words0, N), 0)
    results["encode_slice"] = (enc_err, enc_ms, enc_plain) + bnd
    steps = -(-n // N)
    print(f"kernel3 encode, Y slice alone (a chain of one, {words0} "
          f"words): kernel {enc_ms:.5f} ms ({1e6 * enc_ms / steps:.1f} ns "
          f"per step of {steps}), plain {enc_plain:.5f} ms, bound "
          f"{bnd[0]:.5f} ms ({bnd[1]})")

    # Kernel 2: decode the blob, kernel vs plain; symbols must round-trip
    states_np, words_np = rans.unpack_stream(blob, N)
    words = torch.from_numpy(words_np).to(dev)

    def dec(fn):
        states = torch.from_numpy(states_np.astype(np.int64)).to(dev)
        offset = torch.zeros((1,), dtype=torch.int32, device=dev)
        syms = [fn(cum, words, states, offset) for cum in tables]
        return syms, states, offset

    ksy, kst, koff = dec(rans.rans_decode)
    psy, pst, poff = dec(rans.rans_decode_plain)
    torch.cuda.synchronize()
    dec_err = max([max_abs(a, b) for a, b in zip(ksy, psy)]
                  + [max_abs(kst, pst), max_abs(koff, poff)])
    check(dec_err == 0, "rANS decode kernel != plain version")
    for clr in range(3):
        true_sym = (torch.round(y2[:, cmod.sym_channel(cfg, 0, clr)] * 255.0)
                    .int() - ranges[clr][0])
        check(torch.equal(ksy[clr], true_sym), "decoded symbols != encoded")
    check(int(koff[0]) == total, "decoder read a different word count")
    print("kernel2 decode: identical symbols, states and offset; "
          "symbols round-trip")

    def fresh_dec(_):
        return (torch.from_numpy(states_np.astype(np.int64)).to(dev),
                torch.zeros((1,), dtype=torch.int32, device=dev))

    s, o = fresh_dec(0)
    rans.rans_decode(tables[0], words, s, o)
    P0 = tables[0].shape[1]
    dec_ms = cuda_ms(lambda s, o: rans.rans_decode(tables[0], words, s, o),
                     20, fresh_dec)
    dec_plain = cuda_ms(
        lambda s, o: rans.rans_decode_plain(tables[0], words, s, o), 3,
        fresh_dec)
    bnd = bound(rans_decode_bytes(n, P0, int(o[0]), N), 0)
    results["decode"] = (dec_err, dec_ms, dec_plain) + bnd
    steps = -(-n // N)
    print(f"kernel2 decode, Y slice P={P0}, {int(o[0])} words: kernel "
          f"{dec_ms:.5f} ms "
          f"({1e3 * dec_ms / steps:.3f} us per step of {steps}), plain "
          f"{dec_plain:.5f} ms, bound {bnd[0]:.5f} ms ({bnd[1]})")
    return results


def fresh_carry(N: int, cap: int, dev, x0=None):
    """(states, cursor, buf) of an encode that starts from ``x0`` (int64
    [N]; 2^16 in every lane if None), cursor 0 and an empty buffer."""
    states = (torch.full((N,), rans.RANS_L, dtype=torch.int64, device=dev)
              if x0 is None else x0.clone())
    return (states, torch.zeros((1,), dtype=torch.int32, device=dev),
            torch.zeros((cap,), dtype=torch.int32, device=dev))


def chain_outputs(starts, freqs, offsets, carry):
    """Kernel 3 and rans_encode_chain_plain on the same chain from copies
    of one carry: ((cursors, states, cursor, buf) of each), max |d|."""
    outs = []
    for fn in (rans.rans_encode_chain, rans.rans_encode_chain_plain):
        s, c, b = (t.clone() for t in carry)
        outs.append((fn(starts, freqs, offsets, s, c, b), s, c, b))
    torch.cuda.synchronize()
    err = max(max_abs(k, p) for k, p in zip(*outs))
    return outs[0], err


def chain_inputs(codec, imgs):
    """(starts, freqs int32 [K, n_total], offsets, slice sizes, word cap)
    of the encode chains of one image or of a list of images of one shape
    (Codec.encode_inputs), slices in encode order."""
    sf, cap = codec.encode_inputs(imgs)
    starts = torch.cat([st for st, _ in reversed(sf)], dim=1)
    freqs = torch.cat([fr for _, fr in reversed(sf)], dim=1)
    sizes = [fr.shape[1] for _, fr in reversed(sf)]
    offsets = torch.tensor(np.cumsum([0] + sizes), dtype=torch.int64)
    return starts, freqs, offsets, sizes, cap


def chain_phase(codec, img):
    """Kernel 3 on the main path's chain: the 45 slices of ``img`` in one
    call, against rans_encode_chain_plain; timed as a whole chain.
    Returns ((max |d|, ms, plain ms, bound ms, bound_by), steps)."""
    dev, N = codec.device, codec.N
    starts, freqs, offsets, sizes, cap = chain_inputs(codec, img)
    starts, freqs = starts[0], freqs[0]  # the 1-D form of one chain
    (cursors, _, cursor, _), err = chain_outputs(
        starts, freqs, offsets, fresh_carry(N, cap, dev))
    check(err == 0, "Kernel 3 chain != rans_encode_chain_plain (words, "
          "per-slice cursors or states)")
    total = int(cursor[0])
    check(total <= cap and int(cursors[-1]) == total, "chain cursors")

    def run(s, c, b):
        rans.rans_encode_chain(starts, freqs, offsets, s, c, b)

    ms = cuda_ms(run, 20, lambda _: fresh_carry(N, cap, dev))
    plain_ms = cuda_ms(lambda s, c, b: rans.rans_encode_chain_plain(
        starts, freqs, offsets, s, c, b), 1,
        lambda _: fresh_carry(N, cap, dev))
    steps = sum(-(-n // N) for n in sizes)
    bnd = bound(rans_encode_bytes(starts.numel(), total, N), 0)
    print(f"kernel3 encode chain: {len(sizes)} slices, {starts.numel()} "
          f"symbols, N={N}, {steps} steps -> {total} words; identical "
          f"words, per-slice cursors and states; kernel {ms:.5f} ms "
          f"({1e6 * ms / steps:.1f} ns per step), plain {plain_ms:.5f} ms, "
          f"bound {bnd[0]:.5f} ms ({bnd[1]})")
    return (err, ms, plain_ms) + bnd, steps


def encode_edge_phase(dev, lanes=(1, 33, 1000, 1024)):
    """Kernel 3 against rans_encode_chain_plain on chains of mixed slice
    sizes (n = 0, n < N, n not a multiple of N, all-masked slices, masked
    padding) at N = ``lanes``; freq 1 and freq near 2^16 (tables
    of P = 4 with unit rows, P = 2), carried states at 2^16 and 2^32 - 1.
    Each chain round-trips through Kernel 2.  Returns the chain count."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    for N in lanes:
        # (symbols, masked entries after them) per slice, decode order
        sizes = [(0, 0), (1, 0), (N - 1, 0), (3 * N + 7, 0), (N, 0),
                 (0, N + 3), (2 * N + N // 2, 5), (5, 2 * N)]
        tables, syms, st_fr = [], [], []
        for k, (n, pad) in enumerate(sizes):
            P = (2, 4, 33, 257)[k % 4]
            cum = synthetic_tables(gen, n, P, dev)
            sym = torch.randint(0, P - 1, (n,), generator=gen, device=dev)
            if P in (2, 4):  # every third symbol: freq 65535, or 1
                cum[::3] = torch.tensor([[1, 65536], [1, 2, 3, 65536]][P // 4],
                                        dtype=torch.int32, device=dev)
                sym[::3] = 0
            lo = cum.gather(1, sym[:, None])[:, 0]
            fr = cum.gather(1, sym[:, None] + 1)[:, 0] - lo
            masked = torch.randint(0, 1 << 16, (pad,), generator=gen,
                                   device=dev)
            st_fr.append((torch.cat([lo, masked]).int(),
                          torch.cat([fr, torch.zeros_like(masked)]).int()))
            tables.append(cum)
            syms.append(sym.int())
        starts = torch.cat([st for st, _ in reversed(st_fr)])
        freqs = torch.cat([fr for _, fr in reversed(st_fr)])
        check(bool((freqs == 1).any() and (freqs >= 65533).any()
                   and (freqs == 0).any()), f"N={N}: an edge freq is missing")
        offsets = torch.tensor(np.cumsum(
            [0] + [fr.shape[0] for _, fr in reversed(st_fr)]),
            dtype=torch.int64)
        x0 = torch.randint(1 << 16, 1 << 32, (N,), generator=gen, device=dev)
        x0[::2] = 1 << 16
        x0[1::3] = (1 << 32) - 1
        cap = freqs.numel() + N
        (cursors, states, cursor, buf), err = chain_outputs(
            starts, freqs, offsets, fresh_carry(N, cap, dev, x0))
        check(err == 0, f"encode N={N}: Kernel 3 != rans_encode_chain_plain")
        total = int(cursor[0])
        blob = rans.pack_stream_packed(buf[:total].cpu().numpy(),
                                       states.cpu().numpy())
        sn, wn = rans.unpack_stream(blob, N)
        states = torch.from_numpy(sn.astype(np.int64)).to(dev)
        offset = torch.zeros((1,), dtype=torch.int32, device=dev)
        words = torch.from_numpy(wn).to(dev)
        for cum, sym in zip(tables, syms):
            check(torch.equal(rans.rans_decode(cum, words, states, offset),
                              sym), f"N={N}: Kernel 2 lost symbols")
        check(int(offset[0]) == total and torch.equal(states, x0),
              f"N={N}: the decode did not return to the carried states")
        print(f"kernel3 edge N={N}: (symbols, masked) per slice in decode "
              f"order {sizes} -> {total} words, cursors in encode order "
              f"{cursors.tolist()}; identical to the plain version; Kernel 2 "
              "decodes every symbol back to the carried states")
    return len(lanes)


def synthetic_tables(gen, n: int, P: int, dev):
    """[n, P] int32 rows, strictly increasing, last entry 2^16, of three
    kinds: a first entry in [1, 4) (the coder takes no frequency of 2^16);
    a first entry in [20000, 40000), so that
    slots below it decode to s = -1; nearly all mass on the last symbol, so
    that most slots are at or above cum[P-2]."""
    kind = torch.randint(0, 3, (n,), generator=gen, device=dev)
    first = torch.where(
        kind == 1, torch.randint(20000, 40000, (n,), generator=gen,
                                 device=dev),
        torch.randint(1, 4, (n,), generator=gen, device=dev))
    span = 65536 - first - (P - 1)
    wts = -torch.log(torch.rand((n, P - 1), generator=gen, device=dev)
                     .clamp_min(1e-12))
    wts[:, -1] += torch.where(kind == 2, 1e3 * P, 0.0)
    inc = (wts / wts.sum(1, keepdim=True) * span[:, None]).floor().long()
    inc[:, -1] += span - inc.sum(1)
    inc += 1
    cum = torch.cat([first[:, None], first[:, None] + inc.cumsum(1)], 1)
    return cum.int().contiguous()


def decode_edge_phase(dev, lanes=(1000, 1024)):
    """Kernel 2 against rans_decode_plain on synthetic tables at N =
    ``lanes``; returns the number of cases (every one bit-identical)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cases = 0
    for N in lanes:
        for P in (2, 31, 32, 33, 97, 257, 513):
            n = 5 * N + 37
            cum = synthetic_tables(gen, n, P, dev)
            check(bool((cum[:, -1] == 65536).all()
                       and (cum[:, 1:] > cum[:, :-1]).all()), "bad table")
            # random states and words: every branch of the search
            st0 = torch.randint(1 << 16, 1 << 32, (N,), generator=gen,
                                device=dev)
            words = torch.randint(0, 1 << 16, (n + 3 * N,), generator=gen,
                                  device=dev).int()
            outs = []
            for fn in (rans.rans_decode, rans.rans_decode_plain):
                states = st0.clone()
                offset = torch.full((1,), 7, dtype=torch.int32, device=dev)
                outs.append((fn(cum, words, states, offset), states, offset))
            (ks, kx, ko), (ps, px, po) = outs
            check(torch.equal(ks, ps) and torch.equal(kx, px)
                  and torch.equal(ko, po),
                  f"decode N={N} P={P}: kernel != plain version")
            below = int((ks == -1).sum())
            top = int((ks == P - 2).sum())
            check(below > 0 and top > 0,
                  f"N={N} P={P}: an edge of the search was not reached")
            # a round trip through the encoder
            sym = torch.randint(0, P - 1, (n,), generator=gen, device=dev)
            lo = cum.gather(1, sym[:, None])[:, 0]
            fr = cum.gather(1, sym[:, None] + 1)[:, 0] - lo
            states = torch.full((N,), rans.RANS_L, dtype=torch.int64,
                                device=dev)
            cursor = torch.zeros((1,), dtype=torch.int32, device=dev)
            buf = torch.zeros((n + N,), dtype=torch.int32, device=dev)
            rans.rans_encode(lo.int(), fr.int(), states, cursor, buf)
            total = int(cursor[0])
            blob = rans.pack_stream_packed(buf[:total].cpu().numpy(),
                                           states.cpu().numpy())
            sn, wn = rans.unpack_stream(blob, N)
            states = torch.from_numpy(sn.astype(np.int64)).to(dev)
            offset = torch.zeros((1,), dtype=torch.int32, device=dev)
            back = rans.rans_decode(cum, torch.from_numpy(wn).to(dev),
                                    states, offset)
            check(torch.equal(back, sym.int()) and int(offset[0]) == total,
                  f"N={N} P={P}: round trip lost symbols")
            cases += 1
            print(f"kernel2 edge N={N} P={P} n={n}: identical symbols, "
                  f"states, offset ({below} rows below cum[0], {top} at "
                  f"or above cum[P-2]); round trip exact")
    return cases


def model_phase(codec, params, img):
    """The CUDA model and codec against the CPU ones on a small crop."""
    crop = np.ascontiguousarray(img[:64, :96])
    cpu = Codec(codec.cfg, params, device="cpu", num_lanes=codec.N)
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.uniform(-0.4, 0.4, (1, 32, 48, 12))
                         .astype(np.float32))
    with torch.inference_mode(), exact_math():
        for b in range(3):
            a = cpu.model.band_params(y[..., :3 * (b + 1)].contiguous(), 0, b)
            g = codec.model.band_params(
                y[..., :3 * (b + 1)].contiguous().to(codec.device), 0, b)
            err = float((a - g.cpu()).abs().max())
            print(f"model band {b}: CUDA vs CPU pmap max|d|={err:.3e}")
            check(torch.allclose(a, g.cpu(), rtol=1e-4, atol=1e-5),
                  "CUDA pmap differs from the CPU pmap")
    s_cpu, s_gpu = cpu.compress(crop), codec.compress(crop)
    check(s_cpu[0][0][:13] == s_gpu[0][0][:13]
          and s_cpu[0][1:4] == s_gpu[0][1:4], "headers differ")
    b_cpu, b_gpu = Codec.num_bytes(s_cpu), Codec.num_bytes(s_gpu)
    print(f"64x96 crop: CPU {b_cpu} bytes, CUDA {b_gpu} bytes")
    check(abs(b_cpu - b_gpu) <= max(0.001 * b_cpu, 16), "sizes differ")
    check(np.array_equal(codec.decompress(s_gpu)[0], crop), "crop lossy")


EPILOGUE_SPECIALS = (-0.0, 0.0, float("inf"), float("-inf"), float("nan"))


def epilogue_inputs(gen, shape, dev):
    """Normal float32 values on the card with -0.0, +0.0, +-inf and NaN
    strewn in."""
    t = torch.randn(shape, generator=gen, device=dev)
    flat = t.view(-1)
    k = min(500, flat.numel() // 10)
    where = torch.randint(0, flat.numel(), (k,), generator=gen, device=dev)
    flat[where] = torch.tensor(EPILOGUE_SPECIALS, device=dev).repeat(100)[:k]
    return t


def epilogue_phase(codec, imgs):
    """Phase 4b: the band epilogue against its plain version, timed; its
    launches over a batch round trip (phase 5 counts a single one's).
    -> {"cases": rows of (label, ms, bound ms, PyTorch passes' ms),
    "batch_launches": a batch round trip's}."""
    dev, cfg = codec.device, codec.cfg
    gen = torch.Generator(device=dev).manual_seed(24)
    Ch, Co, h, w = 352, 60, 256, 384
    K = len(imgs)
    cases = [(f"layer 0 K=1 U={U}{' ReLU' if r else ''}", (1, Ch, h, w), U,
              r, "k1") for U in (1, 2, 3) for r in (True, False)]
    cases += [(f"layer 0 K={K} U={U}{' ReLU' if r else ''}", (K, Ch, h, w),
               U, r, "channel_major")
              for U in (1, 2, 3) for r in (True, False)]
    cases += [("trunk K=1 ReLU", (1, Ch, h, w), 1, True, "k1"),
              (f"trunk K={K} ReLU", (1, Ch, K * h, w), 1, True, "k1"),
              ("last conv K=1 NHWC", (1, Co, h, w), 1, False, "nhwc"),
              (f"last conv K={K} NHWC", (1, Co, K * h, w), 1, False, "nhwc")]
    # the scalar kernels (rows of 155 x 299 pixels, 310x598's finest band,
    # are not whole float4s) and a last tile of fewer pixels than a block's
    cases += [("layer 0 K=1 U=3 ReLU, odd", (1, Ch, 155, 299), 3, True, "k1"),
              (f"layer 0 K={K} U=2, odd", (K, Ch, 155, 299), 2, False,
               "channel_major"),
              ("last conv NHWC, odd", (1, Co, 155, 299), 1, False, "nhwc"),
              ("last conv NHWC, a short last tile", (1, Co, 100, 36), 1,
               False, "nhwc")]
    rows = []
    for label, shape, U, relu, layout in cases:
        maps = [epilogue_inputs(gen, shape, dev) for _ in range(U)]
        biases = [epilogue_inputs(gen, shape[1:2], dev) for _ in range(U)]
        want = band_epilogue_plain(maps, biases, relu, nhwc=layout == "nhwc")
        check(torch.equal(unfused_passes(maps, biases, relu, layout)
                          .reshape(-1).view(torch.int32),
                          want.reshape(-1).view(torch.int32)),
              f"band epilogue {label}: the plain version is not PyTorch's "
              "passes")
        if layout == "channel_major":
            buf = torch.empty((shape[1], shape[0]) + shape[2:], device=dev)
            out = buf.transpose(0, 1)
        elif layout == "k1":
            out = torch.empty(shape, device=dev)
        else:
            out = None
        got = band_epilogue(maps, biases, relu=relu, out=out,
                            nhwc=layout == "nhwc")
        torch.cuda.synchronize()
        check(torch.equal(got.reshape(-1).view(torch.int32),
                          want.reshape(-1).view(torch.int32)),
              f"band epilogue {label}: not bit-equal to its plain version")
        if layout == "k1":  # in place, into the first map
            got = band_epilogue(maps, biases, relu=relu, out=maps[0])
            check(torch.equal(got.reshape(-1).view(torch.int32),
                              want.reshape(-1).view(torch.int32)),
                  f"band epilogue {label}: in place not bit-equal")
            maps[0] = epilogue_inputs(gen, shape, dev)
        del want, got
        n = math.prod(shape)
        ms = cuda_ms(lambda: band_epilogue(maps, biases, relu=relu, out=out,
                                           nhwc=layout == "nhwc"), 10)
        lib_ms = cuda_ms(lambda: unfused_passes(maps, biases, relu, layout),
                         5)
        bound_ms, _ = bound(4 * (U + 1) * n + 4 * U * shape[1], 0)
        rows.append((label, ms, bound_ms, lib_ms))
        print(f"band epilogue {label} {list(shape)}: bit-equal to its plain "
              f"version; {ms:.4f} ms, bound {bound_ms:.4f} ms (bytes, "
              f"{100 * bound_ms / ms:.1f} %), PyTorch's passes {lib_ms:.4f} "
              f"ms")
        del maps, biases, out
        torch.cuda.empty_cache()
    S = cfg.num_scales
    per_trip = 2 * 3 * S * cfg.conv_layers
    band_epilogue.launches = 0
    outs = codec.decompress_batch(codec.compress_batch(imgs))
    batch = band_epilogue.launches
    check(all(np.array_equal(o, im) for o, im in zip(outs, imgs)),
          "band epilogue: the batch round trip is lossy")
    check(batch == per_trip, f"band epilogue launches: {batch} a batch "
          f"round trip, expected {per_trip}")
    print(f"band epilogue launches: {batch} a K={K} batch round trip; "
          f"{card_line()}")
    return {"cases": rows, "batch_launches": batch}


def round_trip(codec, img, label: str):
    """One timed compress -> serialize -> deserialize -> decompress."""
    H, W = img.shape[:2]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streams = codec.compress(img)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    blob = Codec.serialize(streams)
    back = Codec.deserialize(blob)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = codec.decompress(back, xorg=img)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    check(out.shape == (1, H, W, 3) and out.dtype == np.uint8,
          f"{label}: decoded shape {out.shape} {out.dtype}")
    check(np.array_equal(out[0], img), f"{label}: decoded image != input")
    check(codec.last_ycocg_err == 0, f"{label}: ycocg err "
          f"{codec.last_ycocg_err}")
    act = sum(sum(r) for r in codec.last_slice_bits)
    ideal = sum(sum(r) for r in codec.last_ideal_bits)
    gap = (act - ideal) / ideal * 100
    check(len(codec.last_slice_bits) == codec.cfg.num_scales
          and all(len(r) == 9 for r in codec.last_slice_bits),
          "slice bits table shape")
    check(abs(gap) <= 1.0, f"{label}: coder closure gap {gap:+.3f}% > 1%")
    nbytes = len(blob)
    bpsp = Codec.num_bytes(streams) * 8 / img.size
    print(f"{label}: container sha256 {hashlib.sha256(blob).hexdigest()}, "
          f"{nbytes} bytes")
    print(f"{label}: lossless, {nbytes} bytes serialized, bpsp {bpsp:.4f}, "
          f"stream bits {act} vs ideal {ideal:.1f} ({gap:+.3f}%), "
          f"encode {1e3 * (t1 - t0):.2f} ms, decode {1e3 * (t3 - t2):.2f} "
          f"ms, peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
          f"MiB")
    return streams, hashlib.sha256(blob).hexdigest()


def table_path(codec, img):
    """Kernel 4's path: the finest band's three tables from
    gmm_slice_params (Kernel 4), rANS-encoded at the true symbols and
    decoded back to them."""
    cfg, dev, N = codec.cfg, codec.device, codec.N
    minmax, _ = cmod.host_header(img[None], cfg.dwtlevels)
    x = torch.from_numpy(img[None].copy()).to(dev)
    y0 = lazy_dwt(codec._to_y(rgb_int_to_ycocg_r_int(x)), cfg.dwtlevels,
                  pad=True)[0][0]
    with torch.inference_mode(), exact_math():
        pmap = codec.model.band_params(y0[..., :3].contiguous(), 0, 0)
    tables, syms, sf = [], [], []
    for clr in range(3):
        minv, maxv = cmod.clr_range(clr, minmax)
        pts = cdf_sampling_points(minv, maxv).to(dev)
        params = [t.contiguous() for t in
                  cmod.gmm_slice_params(cfg, pmap, y0, 0, clr)]
        cum = cdf.gmm_cdf_table_int32(pts, *params).reshape(-1, len(pts))
        sym = (torch.round(y0[..., cmod.sym_channel(cfg, 0, clr)] * 255.0)
               .int() - minv).reshape(-1, 1).long()
        lo = cum.gather(1, sym)[:, 0]
        sf.append((lo, cum.gather(1, sym + 1)[:, 0] - lo))
        tables.append(cum)
        syms.append(sym[:, 0].int())
    states = torch.full((N,), rans.RANS_L, dtype=torch.int64, device=dev)
    cursor = torch.zeros((1,), dtype=torch.int32, device=dev)
    buf = torch.zeros((3 * syms[0].numel() + N,), dtype=torch.int32,
                      device=dev)
    for st, fr in reversed(sf):
        rans.rans_encode(st, fr, states, cursor, buf)
    total = int(cursor[0])
    blob = rans.pack_stream_packed(buf[:total].cpu().numpy(),
                                   states.cpu().numpy())
    states_np, words_np = rans.unpack_stream(blob, N)
    states = torch.from_numpy(states_np.astype(np.int64)).to(dev)
    offset = torch.zeros((1,), dtype=torch.int32, device=dev)
    words = torch.from_numpy(words_np).to(dev)
    for cum, sym in zip(tables, syms):
        check(torch.equal(rans.rans_decode(cum, words, states, offset), sym),
              "Kernel 4 tables: decoded symbols != encoded")
    print(f"kernel4 path: 3 tables x {syms[0].numel()} pixels -> {total} "
          f"words -> decoded symbols identical")


def clrjnt1_checks(codec, img):
    """clr_joint_mode 1 on the codec's normal path: Kernel 1's launches by
    mixture terms in each direction of a 512x768 round trip (15 at ten
    terms, Y's 2M, and 30 at five, Co's and Cg's), every (scale, band)
    map of a K = 8 batch (the trunk at batch 1, layer 0 held ungrouped)
    and of one image bit-equal to the benchmark's reference (layer 0 at
    groups 2, the trunk at batch K), and the K = 8 batch container
    decoded lossless."""
    from llbench.reference import clrjnt1, model as ref_model
    from llbench.reference.codec import float32_math
    by = cdf.gmm_cdf_from_pmap.launches_by_mixtures
    for direction in ("compress", "decompress"):
        by.clear()
        if direction == "compress":
            streams = codec.compress(img)
        else:
            check(np.array_equal(codec.decompress(streams)[0], img),
                  "clrjnt1: decoded image != input")
        torch.cuda.synchronize()
        check(dict(by) == {10: 15, 5: 30}, f"clrjnt1 {direction}: Kernel 1 "
              f"launches by mixture terms {dict(by)}, expected "
              "{10: 15, 5: 30}")
    print(f"clrjnt1 Kernel 1 launches by terms a direction: {dict(by)}")
    cfg = codec.cfg
    keys = {f.name: getattr(codec.cfg, f.name)
            for f in dataclasses.fields(cfg)}
    ref = clrjnt1.build(clrjnt1.Clrjnt1Config(keys), ref_model.from_flax(
        init_params(cfg, 0)), "cuda")
    imgs = [synthetic_image(512, 768, seed=42 + k) for k in range(BATCH_K)]
    x = torch.from_numpy(np.stack(imgs)).cuda()
    y = codec._front(x)
    c = cfg.cond_channels
    equal = 0
    with torch.inference_mode():
        for scl in range(cfg.num_scales):
            for b in range(3):
                yc = y[scl][..., :c * (b + 1)].contiguous()
                with exact_math():
                    got = codec.model.band_params_batched(yc, scl, b)
                    one = codec.model.band_params(yc[:1], scl, b)
                with float32_math():
                    want = ref.band(scl, b).params(yc)
                    want1 = ref.band(scl, b).params(yc[:1])
                check(torch.equal(got, want) and torch.equal(one, want1),
                      f"clrjnt1 scale {scl} band {b}: maps differ from the "
                      f"reference's by {float((got - want).abs().max())}, "
                      f"{float((one - want1).abs().max())} (K = 8, 1)")
                equal += 2
    t0 = time.perf_counter()
    batch = codec.compress_batch(imgs)
    outs = codec.decompress_batch(batch)
    torch.cuda.synchronize()
    check(all(np.array_equal(o, im) for o, im in zip(outs, imgs)),
          "clrjnt1: K = 8 batch container decoded != input")
    print(f"clrjnt1: {equal} maps bit-equal to the reference's (15 (scale, "
          f"band) at K = 8 and 1); K = 8 batch container of "
          f"{Codec.num_bytes(batch)} bytes lossless, round trip "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms")


def variants_phase(img, odd):
    """One round trip per coded configuration; returns the logistic
    branch's launches over the logistic configurations' counted runs and
    those of the flagship's logistic twin (clrjnt 2) at 512x768."""
    t0 = time.perf_counter()
    trained = load_npz()
    logistic_launches = per_trip = 0
    for label, kw, use_trained, also_odd in VARIANTS:
        cfg = ModelConfig(**kw)
        codec = Codec(cfg, trained if use_trained else init_params(cfg, 0),
                      device="cuda", num_lanes=1024)
        logistic = cfg.distribution == "logistic"
        for im in (img, odd) if also_odd else (img,):
            H, W = im.shape[:2]
            codec.decompress(codec.compress(im))  # warm-up
            k1 = cdf.gmm_cdf_from_pmap
            k1.launches = k1.logistic_launches = 0
            round_trip(codec, im, f"{label} {H}x{W}")
            check(k1.launches > 0, f"{label}: Kernel 1 was not launched")
            check(k1.logistic_launches == (k1.launches if logistic else 0),
                  f"{label}: Kernel 1 ran the wrong branch")
            logistic_launches += k1.logistic_launches
            if label == "clrjnt2 logistic" and im is img:
                per_trip = k1.logistic_launches
        if label == "clrjnt1 normal":
            clrjnt1_checks(codec, img)
        del codec
        torch.cuda.empty_cache()
    print(f"variants phase: {len(VARIANTS)} configurations in "
          f"{time.perf_counter() - t0:.2f} s")
    return logistic_launches, per_trip


BATCH_K = 8  # images of the serving phase's batch container
# Kernel 2 on the finest Y slice and Kernel 3 on the 45-slice chain at
# K = 1 before the batched kernels, NVIDIA H100 80GB HBM3 at 700 W (PERF.md)
K1_EARLIER_MS = (0.294, 0.110)


def batch_carry(K: int, N: int, cap: int, dev):
    """(states, cursor, buf) of K encodes from 2^16 lanes, cursor 0."""
    return (torch.full((K, N), rans.RANS_L, dtype=torch.int64, device=dev),
            torch.zeros((K,), dtype=torch.int32, device=dev),
            torch.zeros((K, cap), dtype=torch.int32, device=dev))


def batch_y_tables(codec, imgs):
    """The finest Y slices of K images of one shape as the batch container
    codes them (the batch's union Y range): (cum int32 [K, n, P], start,
    freq and the true symbols [K, n])."""
    cfg, dev = codec.cfg, codec.device
    K = len(imgs)
    batch = np.stack(imgs)
    minmax, _ = cmod.host_header(batch, cfg.dwtlevels)
    minv, maxv = cmod.clr_range(0, minmax)  # the batch's union Y range
    x = torch.from_numpy(batch).to(dev)
    y0 = lazy_dwt(codec._to_y(rgb_int_to_ycocg_r_int(x)), cfg.dwtlevels,
                  pad=True)[0][0]
    n = y0.shape[1] * y0.shape[2]
    with torch.inference_mode(), exact_math():
        pmap = codec.model.band_params(y0[..., :3].contiguous(), 0, 0)
    M, s0, m0, w0, upd = cmod.pmap_cdf_spec(cfg, 0, 0)
    sch = cmod.sym_channel(cfg, 0, 0)
    y2 = y0.reshape(K * n, -1).contiguous()
    cum, st, fr = cdf.gmm_cdf_from_pmap(
        cdf_sampling_points(minv, maxv).to(dev),
        pmap.reshape(K * n, -1).contiguous(), y2, M, s0, m0, w0, upd, False,
        sch, minv)
    true_sym = (torch.round(y2[:, sch] * 255.0).int() - minv).view(K, n)
    return cum.view(K, n, -1), st.view(K, n), fr.view(K, n), true_sym


def batched_decode(cum, states, buf, totals, true_sym):
    """Kernel 2 on K images' slices in one launch, words zero-padded per
    row, against rans_decode_plain bit for bit, from the encoder's final
    states, words and word counts; timed.  -> (max |d|, ms, plain ms,
    bound (ms, by))."""
    K, n, P = cum.shape
    N, dev = states.shape[1], cum.device
    unpacked = [rans.unpack_stream(rans.pack_stream_packed(
        buf[k, :t].cpu().numpy(), states[k].cpu().numpy()), N)
        for k, t in enumerate(totals)]
    W = max(w.size for _, w in unpacked)
    words = torch.zeros((K, W), dtype=torch.int32, device=dev)
    for k, (_, w) in enumerate(unpacked):
        words[k, :w.size] = torch.from_numpy(w).to(dev)
    states0 = torch.from_numpy(np.stack([sn for sn, _ in unpacked])
                               .astype(np.int64)).to(dev)

    def fresh_dec(_):
        return (states0.clone(),
                torch.zeros((K,), dtype=torch.int32, device=dev))

    outs = []
    for fn in (rans.rans_decode, rans.rans_decode_plain):
        s, o = fresh_dec(0)
        outs.append((fn(cum, words, s, o), s, o))
    torch.cuda.synchronize()
    (ksy, kst, koff), (psy, pst, poff) = outs
    err = max(max_abs(ksy, psy), max_abs(kst, pst), max_abs(koff, poff))
    check(err == 0, f"batched Kernel 2 (K={K}, N={N}) != plain")
    check(torch.equal(ksy, true_sym),
          f"batched Kernel 2 (N={N}) lost symbols")
    check(koff.tolist() == totals,
          f"batched Kernel 2 (N={N}) read other word counts")
    ms = cuda_ms(lambda s, o: rans.rans_decode(cum, words, s, o), 20,
                 fresh_dec)
    plain = cuda_ms(lambda s, o: rans.rans_decode_plain(cum, words, s, o), 1,
                    fresh_dec)
    bnd = bound(rans_decode_bytes(K * n, P, sum(totals), K * N), 0)
    return err, ms, plain, bnd


def batched_kernel_phase(codec, imgs, kres):
    """Kernels 2 and 3 on K images in one launch (one call) against their
    plain versions, bit for bit: the finest Y slice of each image, and
    Kernel 3 also on the K whole chains.  Returns the batch figures of the
    decode and encode rows."""
    dev, N = codec.device, codec.N
    K = len(imgs)
    cum, st, fr, true_sym = batch_y_tables(codec, imgs)
    n, P = cum.shape[1:]

    # Kernel 3, the K images' Y slices in one call
    offsets = torch.tensor([0, n], dtype=torch.int64)
    cap = n + N
    (_, states, cursor, buf), enc_err = chain_outputs(
        st, fr, offsets, batch_carry(K, N, cap, dev))
    check(enc_err == 0, f"batched Kernel 3 (K={K}, Y slice) != plain")
    totals = cursor.tolist()
    y_ms = cuda_ms(lambda s, c, b: rans.rans_encode_chain(
        st, fr, offsets, s, c, b), 20, lambda _: batch_carry(K, N, cap, dev))
    y_plain = cuda_ms(lambda s, c, b: rans.rans_encode_chain_plain(
        st, fr, offsets, s, c, b), 1, lambda _: batch_carry(K, N, cap, dev))
    y_bnd = bound(rans_encode_bytes(K * n, sum(totals), K * N), 0)

    dec_err, dec_ms, dec_plain, dec_bnd = batched_decode(
        cum, states, buf, totals, true_sym)
    clusters = rans.decode_max_clusters(N)

    # Kernel 3 on the K images' whole chains, one call
    starts, freqs, offs, sizes, ccap = chain_inputs(codec, imgs)
    (_, _, ccur, _), ch_err = chain_outputs(
        starts, freqs, offs, batch_carry(K, N, ccap, dev))
    check(ch_err == 0, f"batched Kernel 3 (K={K}, 45-slice chains) != plain")
    check(max(ccur.tolist()) <= ccap, "a chain overran its buffer")
    ch_ms = cuda_ms(lambda s, c, b: rans.rans_encode_chain(
        starts, freqs, offs, s, c, b), 20,
        lambda _: batch_carry(K, N, ccap, dev))
    ch_plain = cuda_ms(lambda s, c, b: rans.rans_encode_chain_plain(
        starts, freqs, offs, s, c, b), 1,
        lambda _: batch_carry(K, N, ccap, dev))
    ch_bnd = bound(rans_encode_bytes(starts.numel(), sum(ccur.tolist()),
                                     K * N), 0)

    k1_dec, k1_chain = kres["decode"][1], kres["encode"][1]
    k1_y = kres["encode_slice"][1]
    print(f"batched kernel2 decode, K={K} Y slices P={P} n={n}: identical "
          f"symbols, states, offsets; {dec_ms:.5f} ms a launch, "
          f"{dec_ms / K:.5f} ms an image (K=1: {k1_dec:.5f}), plain "
          f"{dec_plain:.5f} ms, bound {dec_bnd[0]:.5f} ms ({dec_bnd[1]}); "
          f"the card holds {clusters} decode clusters at once")
    print(f"batched kernel3 encode, K={K} Y slices: identical words, "
          f"cursors, states; {y_ms:.5f} ms a call, {y_ms / K:.5f} ms an image "
          f"(K=1: {k1_y:.5f}), plain {y_plain:.5f} ms, bound "
          f"{y_bnd[0]:.5f} ms ({y_bnd[1]})")
    print(f"batched kernel3 encode, K={K} whole chains ({len(sizes)} slices, "
          f"{starts.shape[1]} symbols each): identical words, per-slice "
          f"cursors, states; {ch_ms:.5f} ms a call, {ch_ms / K:.5f} ms an "
          f"image (K=1: {k1_chain:.5f}), plain {ch_plain:.5f} ms, bound "
          f"{ch_bnd[0]:.5f} ms ({ch_bnd[1]})")
    print(f"K=1 against the single-image kernels' earlier times (rANS decode "
          f"{K1_EARLIER_MS[0]} ms, chain {K1_EARLIER_MS[1]} ms): decode "
          f"{k1_dec / K1_EARLIER_MS[0]:.3f}x, chain "
          f"{k1_chain / K1_EARLIER_MS[1]:.3f}x")
    return ({"batch_k": K, "batch_ms": dec_ms, "batch_plain_ms": dec_plain,
             "batch_bound_ms": dec_bnd[0], "batch_max_abs_err": dec_err,
             "max_clusters": clusters},
            {"batch_k": K, "batch_ms": ch_ms, "batch_plain_ms": ch_plain,
             "batch_bound_ms": ch_bnd[0],
             "batch_max_abs_err": max(enc_err, ch_err),
             "batch_y_slice_ms": y_ms, "batch_y_slice_bound_ms": y_bnd[0]})


def reset_counts(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters, label: str):
    """The counts since reset_counts; each kernel must have launched."""
    got = {name: fn.launches for name, fn in counters.items()}
    check(all(v > 0 for v in got.values()),
          f"{label}: a kernel of the path was not launched: {got}")
    return got


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def peak_mib() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 20


def event_ms_per_call(fn, calls: int) -> float:
    """Mean ms of back-to-back calls of ``fn`` by CUDA events (host work
    included: a closure's launches are its cost), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(calls):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / calls


def no_copy_call(fns):
    """One call of each closure under set_sync_debug_mode("error") and a
    torch.profiler trace: -> (device events, host<->card copies)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            for fn in fns:
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sorted({e.name for e in events if "Memcpy HtoD" in e.name
                     or "Memcpy DtoH" in e.name})
    return len(device), copies


def batch1_maps(codec, imgs) -> int:
    """Check every (scale, band) parameter map of a batch from the trunk
    at batch 1 (the codec's path for K > 1) bit-equal to the trunk's at
    batch K; -> the number of maps."""
    c = codec.cfg.cond_channels
    with torch.inference_mode(), exact_math():
        y_list = codec._front(torch.from_numpy(np.stack(imgs)).cuda())
        for scl, y_lev in enumerate(y_list):
            for b in range(3):
                y = y_lev[..., :c * (b + 1)].contiguous()
                check(torch.equal(codec.model.band_params_batched(y, scl, b),
                                  codec.model.band_params(y, scl, b)),
                      f"scale {scl} band {b}: the trunk at batch 1 changed "
                      "the parameter map")
    return 3 * len(y_list)


def widen_cases(dev) -> int:
    """widen_words against its plain version on random int16 rows and
    lengths (a full row and an empty one in each), over whole rows, a head
    and a tail of columns; -> the number of cases."""
    gen = torch.Generator().manual_seed(27)
    cases = 0
    for K, W in ((1, 1), (1, 430_001), (8, 431_017), (3, 70_001),
                 (254, 5_000)):
        src = torch.randint(-32768, 32768, (K, W), dtype=torch.int16,
                            generator=gen)
        lengths = torch.randint(0, W + 1, (K,), generator=gen)
        lengths[0] = W
        lengths[-1] = 0 if K > 1 else W
        for cols in ((0, W), (0, W // 3), (W // 3, W)):
            want = rans.widen_words_plain(
                src, lengths, torch.full((K, W), -7, dtype=torch.int32),
                *cols)
            got = rans.widen_words(
                src.to(dev), lengths.to(dev),
                torch.full((K, W), -7, dtype=torch.int32, device=dev), *cols)
            check(torch.equal(got.cpu(), want),
                  f"widen_words K={K} W={W} columns {cols} != its plain "
                  "version")
            cases += 1
    return cases


def host_allocs(fns):
    """Names of the cudaHostAlloc calls a torch.profiler trace of one call
    of each of ``fns`` records, in the steady state: after two calls of
    each, which fill PyTorch's cache of pinned blocks as a caller that
    holds one result while it asks for the next does."""
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        kept = fn()
        kept = fn()  # noqa: F841
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if "cudaHostAlloc" in e.name]


def staging_phase(codec, split, imgs, blob: bytes, single, odd) -> dict:
    """The decoder's staging block and the widen kernel (phase 9 (g)):
    widen_words against its plain version; the K = 8 batch container
    ``blob`` decoded 20 times in a closed loop after a warm-up, lossless,
    one widen launch each, ``staging_counts`` reused in >= 99 % with no
    wait; the two-stage codec's split decodes of ``single`` (512x768) and
    ``odd`` lossless with two widen launches each; no cudaHostAlloc in a
    steady-state decode of either; the widen timed at the batch's shape
    beside its bound and its plain version, the staging's host ms beside
    the per-stream unpack it replaced; back-to-back decompress_dispatch
    calls' waits printed.  -> the widen's figures for the kernels line."""
    t0 = time.perf_counter()
    dev = codec.device
    cases = widen_cases(dev)
    batch = Codec.deserialize(blob)
    codec.decompress_batch(batch)  # warm-up
    codec.staging_counts.clear()
    rans.widen_words.launches = 0
    for _ in range(20):
        outs = codec.decompress_batch(batch)
        check(all(np.array_equal(o, im) for o, im in zip(outs, imgs)),
              "a staged batch decode is lossy")
    counts = dict(codec.staging_counts)
    share = counts.get("reused", 0) / max(
        1, counts.get("reused", 0) + counts.get("grown", 0))
    check(share >= 0.99 and not counts.get("waited"),
          f"20 batch decodes: staging_counts {counts}")
    check(rans.widen_words.launches == 20,
          f"{rans.widen_words.launches} widen launches in 20 batch decodes")
    for im, streams in ((imgs[0], single), (odd, split.compress(odd))):
        split.decompress(streams)  # warm-up
        rans.widen_words.launches = 0
        out = split.decompress(streams, xorg=im)
        check(np.array_equal(out[0], im) and split.last_ycocg_err == 0,
              f"two-stage split decode of {im.shape[:2]} lossy")
        check(rans.widen_words.launches == 2,
              f"{rans.widen_words.launches} widen launches in a split "
              "decode (head and tail: 2)")
    allocs = host_allocs([lambda: codec.decompress_batch(batch),
                          lambda: split.decompress(single)])
    check(not allocs, f"a steady-state decode called {allocs}")

    # the widen at the batch's shape; the staging against the unpack
    (staged,) = codec._decode_stage([[g[0] for g in batch[1:]]])
    K, W = staged.words.shape
    lengths = staged.small[K * codec.N:].to(dev)
    src = staged.words.to(dev)
    out = torch.empty((K, W), dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: rans.widen_words(src, lengths, out), 50)
    plain_ms = cuda_ms(lambda: rans.widen_words_plain(src, lengths, out, 0,
                                                      W), 20)
    bound_ms, by = bound(2 * int(lengths.sum()) + 4 * K * W, 0)
    blobs = [g[0] for g in batch[1:]]

    def unpack_rows():  # what the decoder did before the staging block
        unpacked = [rans.unpack_stream(b, codec.N) for b in blobs]
        words = np.zeros((K, max(w.size for _, w in unpacked)), np.int32)
        for k, (_, w) in enumerate(unpacked):
            words[k, :w.size] = w
        codec._host(words)
        return codec._host(np.stack([s for s, _ in unpacked])
                           .astype(np.int64))

    unpack_ms = median_ms(unpack_rows, 11)
    stage_ms = median_ms(lambda: codec._decode_stage([blobs]), 11)
    # decompress_dispatch does not synchronise: a stage may wait for the
    # copy of the one before
    codec.staging_counts.clear()
    rgbs = [codec.decompress_dispatch(single)[0] for _ in range(4)]
    torch.cuda.synchronize()
    check(all(np.array_equal(r[0].cpu().numpy(), imgs[0]) for r in rgbs),
          "queued decompress_dispatch calls are lossy")
    dispatch = dict(codec.staging_counts)
    print(f"staging: widen_words bit-equal to its plain version in {cases} "
          f"cases; 20 K={K} batch decodes lossless, staging_counts {counts}"
          f" (reuse share {100 * share:.2f} %), one widen launch each; "
          f"two-stage split decodes of 512x768 and 310x598 lossless, two "
          f"widen launches each; no cudaHostAlloc in a steady-state decode;"
          f" widen at [{K}, {W}] {ms:.4f} ms (bound {bound_ms:.4f} by {by},"
          f" plain {plain_ms:.4f}); host staging of the {K} streams "
          f"{stage_ms:.3f} ms against {unpack_ms:.3f} ms for the "
          f"per-stream unpack, zero-padded int32 rows and pinned copies; "
          f"4 queued decompress_dispatch calls: staging_counts {dispatch}; "
          f"phase {time.perf_counter() - t0:.2f} s")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "cases": cases, "staging_counts": counts,
            "stage_ms": stage_ms, "unpack_ms": unpack_ms}


def serving_phase(codec, params, kres, counters):
    """The serving path: batched kernels, the batch container, pipelined
    calls, resident closures, size_bucket and two_stage, each driven with
    the launch counts set to 0 just before it and read just after.
    Returns (the decode row's and the encode row's batch figures, per-path
    launches, the batch container's bytes and ms an image)."""
    cfg, N = codec.cfg, codec.N
    S = cfg.num_scales
    imgs = [synthetic_image(512, 768, seed=42 + k) for k in range(BATCH_K)]
    paths = {}
    t0 = time.perf_counter()
    dec_row, enc_row = batched_kernel_phase(codec, imgs, kres)
    print(f"serving: batched kernels in {time.perf_counter() - t0:.2f} s, "
          f"peak memory {peak_mib():.1f} MiB")

    # 2. the batch container
    t0 = time.perf_counter()
    codec.decompress_batch(codec.compress_batch(imgs))  # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    streams, enc_ms = timed(lambda: codec.compress_batch(imgs))
    got = {name: fn.launches for name, fn in counters.items()}
    check(got["rans_decode"] == 0 and 0 < got["rans_encode"] <= 2
          and got["gmm_cdf_from_pmap"] > 0,
          f"batch encode launches {got}: Kernel 3 at most 2, Kernel 2 none")
    blob = Codec.serialize(streams)
    batch_sha = hashlib.sha256(blob).hexdigest()
    check(batch_sha == BATCH_SHA, f"the batch container's sha256 "
          f"{batch_sha} is not {BATCH_SHA}")
    reset_counts(counters)
    outs, dec_ms = timed(lambda: codec.decompress_batch(
        Codec.deserialize(blob)))
    dgot = {name: fn.launches for name, fn in counters.items()}
    check(dgot["rans_decode"] == 9 * S and dgot["rans_encode"] == 0,
          f"batch decode launches {dgot}: Kernel 2 once a slice")
    paths["batch container"] = {"encode": got, "decode": dgot}
    for k, (im, out) in enumerate(zip(imgs, outs)):
        check(out.shape == im.shape and np.array_equal(out, im),
              f"batch container: image {k} lossy")
    sizes = [len(g[0]) for g in streams[1:]]
    bpsp = Codec.num_bytes(streams) * 8 / sum(im.size for im in imgs)
    trip = {"bytes": len(blob), "encode_ms_an_image": enc_ms / BATCH_K,
            "decode_ms_an_image": dec_ms / BATCH_K}
    print(f"serving: batch container K={BATCH_K} 512x768: lossless, "
          f"sha256 {batch_sha}, "
          f"{len(blob)} bytes ({bpsp:.4f} bpsp; blobs {sizes}), encode "
          f"{enc_ms:.2f} ms ({enc_ms / BATCH_K:.2f} an image), decode "
          f"{dec_ms:.2f} ms ({dec_ms / BATCH_K:.2f} an image), launches "
          f"encode {got} decode {dgot}, peak memory {peak_mib():.1f} MiB")
    print(f"serving: {batch1_maps(codec, imgs)} (scale, band) parameter "
          f"maps of the {BATCH_K} with the trunk at batch 1 bit-equal to "
          f"batch {BATCH_K}'s")
    same = codec.compress_batch([imgs[0]] * BATCH_K)
    check(all(g == same[1] for g in same[2:]),
          "eight copies of one image gave different blobs")
    fn = codec.prepare_decode_batch(streams)
    brgb = fn().cpu().numpy()
    check(all(np.array_equal(brgb[k], im) for k, im in enumerate(imgs)),
          "prepare_decode_batch's closure != the images")
    bclosure_ms = event_ms_per_call(fn, 10)
    print(f"serving: eight copies of seed 42 -> eight identical blobs; "
          f"prepare_decode_batch closure lossless, {bclosure_ms:.2f} ms a "
          f"call ({bclosure_ms / BATCH_K:.2f} an image, 10 calls); phase "
          f"{time.perf_counter() - t0:.2f} s")

    # 3. pipelined calls
    t0 = time.perf_counter()
    six = imgs[:6]
    singles, tables = [], []
    for im in six:
        singles.append(codec.compress(im))
        tables.append((codec.last_slice_bits, codec.last_ideal_bits))
    singles_ms = timed(lambda: [codec.compress(im) for im in six])[1]
    reset_counts(counters)
    manys, many_ms = timed(lambda: codec.compress_many(six))
    outs, dmany_ms = timed(lambda: codec.decompress_many(manys))
    paths["pipelined"] = read_counts(counters, "pipelined calls")
    check(manys == singles, "compress_many != six compress calls")
    check(codec.last_slice_bits_batch == [t[0] for t in tables],
          "compress_many's slice-bits tables != compress's")
    check(all(np.allclose(np.array(a), np.array(t[1]), rtol=1e-6, atol=0)
              for a, t in zip(codec.last_ideal_bits_batch, tables)),
          "compress_many's ideal-bits tables != compress's")
    check(all(np.array_equal(o[0], im) for o, im in zip(outs, six)),
          "decompress_many lossy")
    dsingles_ms = timed(lambda: [codec.decompress(m) for m in manys])[1]
    print(f"serving: compress_many of six 512x768 images == six compress "
          f"calls (bytes and per-image tables): {many_ms:.2f} ms against "
          f"{singles_ms:.2f} ms; decompress_many lossless {dmany_ms:.2f} ms "
          f"against {dsingles_ms:.2f} ms; phase "
          f"{time.perf_counter() - t0:.2f} s")

    # 4. resident closures
    t0 = time.perf_counter()
    img = imgs[0]
    single = codec.compress(img)
    dec_fn, enc_fn = codec.prepare_decode(single), codec.prepare_encode(img)
    reset_counts(counters)
    rgb = dec_fn()
    cursors, states, buf, _ideal = enc_fn()
    paths["resident"] = read_counts(counters, "resident closures")
    check(np.array_equal(rgb.cpu().numpy(), codec.decompress(single)),
          "prepare_decode's closure != decompress")
    total = int(cursors[0, -1])
    check(rans.pack_stream_packed(buf[0, :total].cpu().numpy(),
                                  states[0].cpu().numpy()) == single[1][0],
          "prepare_encode's closure does not repack into compress's blob")
    n_dev, copies = no_copy_call([dec_fn, enc_fn])
    check(n_dev > 0, "the profiler saw no device work")
    check(not copies, f"a closure copied between host and card: {copies}")
    dec_call = event_ms_per_call(dec_fn, 30)
    enc_call = event_ms_per_call(enc_fn, 30)
    print(f"serving: resident closures equal the wire paths; one call each "
          f"under set_sync_debug_mode('error'): no synchronisation, "
          f"{n_dev} device events, no Memcpy HtoD/DtoH; prepare_decode "
          f"{dec_call:.2f} ms an image, prepare_encode {enc_call:.2f} ms an "
          f"image (30 back-to-back calls, CUDA events); phase "
          f"{time.perf_counter() - t0:.2f} s")

    # 5. size_bucket
    t0 = time.perf_counter()
    bucketed = Codec(cfg, params, num_lanes=N, size_bucket=64)
    ragged = [(310, 598), (317, 605), (333, 577), (301, 640)]
    rimgs = [synthetic_image(h, w, seed=7 + i)
             for i, (h, w) in enumerate(ragged)]
    bucketed.decompress(bucketed.compress(rimgs[0]))  # warm-up
    reset_counts(counters)
    for (h, w), im in zip(ragged, rimgs):
        streams = bucketed.compress(im)
        out = bucketed.decompress(streams, xorg=im)
        check(out.shape == (1, h, w, 3) and np.array_equal(out[0], im)
              and bucketed.last_ycocg_err == 0,
              f"size_bucket {h}x{w}: lossy or wrong crop")
        check(np.frombuffer(streams[0][0][5:13], np.uint32).tolist()
              == [h, w], "size_bucket header lost the original size")
    paths["size_bucket"] = read_counts(counters, "size_bucket")
    check(len(bucketed.compiled_shapes) <= 2,
          f"padded shapes {bucketed.compiled_shapes}")
    print(f"serving: size_bucket=64 on {ragged}: lossless, cropped back, "
          f"padded shapes {sorted(bucketed.compiled_shapes)}; phase "
          f"{time.perf_counter() - t0:.2f} s")
    del bucketed

    # 6. two_stage
    t0 = time.perf_counter()
    split = Codec(cfg, params, num_lanes=N, two_stage=True)
    odd = synthetic_image(310, 598, seed=7)
    split.decompress(split.compress(odd))  # warm-up
    reset_counts(counters)
    for im in (img, odd):
        s_split, s_fused = split.compress(im), codec.compress(im)
        check(s_split == s_fused, "two_stage changed the encoder's bytes")
        for dec, s, label in ((split, s_split, "two-stage"),
                              (split, s_fused, "two-stage of fused"),
                              (codec, s_split, "fused of two-stage")):
            out = dec.decompress(s, xorg=im)
            check(np.array_equal(out[0], im) and dec.last_ycocg_err == 0,
                  f"{label} decode of {im.shape[:2]} lossy")
    paths["two_stage"] = read_counts(counters, "two_stage")
    split_ms = sorted(timed(lambda: split.decompress(single))[1]
                      for _ in range(5))
    fused_ms = sorted(timed(lambda: codec.decompress(single))[1]
                      for _ in range(5))
    print(f"serving: two_stage lossless on 512x768 and 310x598, same bytes "
          f"as the fused codec, cross-decodes both ways; decode 512x768 "
          f"median of 5: two-stage {split_ms[2]:.2f} ms, fused "
          f"{fused_ms[2]:.2f} ms; phase {time.perf_counter() - t0:.2f} s")
    print(f"serving launches by path: {json.dumps(paths)}")
    widen = staging_phase(codec, split, imgs, blob, single, odd)
    return dec_row, enc_row, paths, trip, widen


# the flagship container's sha256 since PR 2 (its first and last hex
# digits), and the JAX package's num_bytes of the same image, weights and
# N = 1024 on the CPU (use_pallas_cdf=False)
FLAGSHIP_SHA = ("3cab0436", "9336cc")
# the serving phase's batch container of eight images, as the codec wrote
# it with the trunk at batch K
BATCH_SHA = ("068327b06416e39b6efb6ee5f0926a61"
             "77159b7d7770a043ddfdd1745bb4f689")
JAX_FLAGSHIP_BYTES = 861_767
RATE_ATOL = 0.01  # bits: the card's self-information maps against the CPU's
FLAGS = ("cudnn.allow_tf32", "cuda.matmul.allow_tf32", "cudnn.benchmark",
         "cudnn.deterministic")


def read_flags():
    b = torch.backends
    return (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark,
            b.cudnn.deterministic)


def flip_flags():
    """Set the four flags to the opposite of their values; -> the new
    values."""
    b = torch.backends
    new = tuple(not v for v in read_flags())
    (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark,
     b.cudnn.deterministic) = new
    return new


def median_ms(fn, runs: int = 5) -> float:
    return sorted(timed(fn)[1] for _ in range(runs))[runs // 2]


def c2_check(streams) -> None:
    """The flagship container's size against the JAX package's."""
    nb = Codec.num_bytes(streams)
    tol = max(0.001 * JAX_FLAGSHIP_BYTES, 16)
    print(f"C2: flagship num_bytes {nb} against the JAX package's "
          f"{JAX_FLAGSHIP_BYTES} (CPU): {nb - JAX_FLAGSHIP_BYTES:+d} bytes, "
          f"limit +-{tol:.0f}")
    check(abs(nb - JAX_FLAGSHIP_BYTES) <= tol, "C2: the flagship container's "
          "size is not within max(0.1 %, 16 B) of the JAX package's")


def c1_check(cfg, params, img, sha, counters) -> None:
    """Encoder and decoder under the opposite of every flag: after the
    codec is built, and again between compress and decompress; the
    container keeps its sha256 and decodes byte-exactly, resident closures
    too, and every call leaves the flags it found."""
    saved = read_flags()
    try:
        codec = Codec(cfg, params, num_lanes=1024)
        reset_counts(counters)
        flipped = flip_flags()
        streams = codec.compress(img)
        check(read_flags() == flipped, "compress changed the caller's flags")
        blob = Codec.serialize(streams)
        check(hashlib.sha256(blob).hexdigest() == sha, "C1: under flipped "
              "flags the flagship container's sha256 changed")
        flipped = flip_flags()
        out = codec.decompress(Codec.deserialize(blob), xorg=img)
        check(read_flags() == flipped, "decompress changed the flags")
        check(np.array_equal(out[0], img) and codec.last_ycocg_err == 0,
              "C1: the decode under flipped flags is not byte-exact")
        dec_fn, enc_fn = codec.prepare_decode(streams), codec.prepare_encode(
            img)
        flipped = flip_flags()
        rgb = dec_fn().cpu().numpy()
        cursors, states, buf, _ = enc_fn()
        check(read_flags() == flipped, "a closure changed the flags")
        total = int(cursors[0, -1])
        check(np.array_equal(rgb[0], img) and rans.pack_stream_packed(
            buf[0, :total].cpu().numpy(), states[0].cpu().numpy())
            == streams[1][0], "C1: a resident closure under flipped flags "
              "does not match")
        got = read_counts(counters, "C1 round trip")
        print(f"C1: {FLAGS} flipped after the codec was built, between "
              f"compress and decompress and before the closures: sha256 "
              f"{sha[:8]}... kept, decode and closures byte-exact, the "
              f"caller's flags read back after every call; launches {got}")
    finally:
        b = torch.backends
        (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark,
         b.cudnn.deterministic) = saved


def host_phase(cfg, params, images, counters) -> None:
    """backend="host": lossless round trips with the host range coder,
    bytes and bpsp against the device container, ms (median of 5) and peak
    memory.  The host backend launches none of the hand kernels."""
    codec = Codec(cfg, params, num_lanes=1024, backend="host")
    for label, (img, dev_streams, _, _) in images.items():
        codec.decompress(codec.compress(img))  # warm-up
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters)
        streams = codec.compress(img)
        blob = Codec.serialize(streams)
        out = codec.decompress(Codec.deserialize(blob), xorg=img)
        got = {name: fn.launches for name, fn in counters.items()}
        check(out.shape == (1,) + img.shape and np.array_equal(out[0], img)
              and codec.last_ycocg_err == 0,
              f"host backend {label}: lossy (ycocg err "
              f"{codec.last_ycocg_err})")
        check(all(v == 0 for v in got.values()),
              f"host backend {label} launched a hand kernel: {got}")
        enc_ms = median_ms(lambda: codec.compress(img))
        dec_ms = median_ms(lambda: codec.decompress(streams))
        nb, dnb = Codec.num_bytes(streams), Codec.num_bytes(dev_streams)
        print(f"host backend {label}: lossless, last_ycocg_err 0, "
              f"{len(blob)} bytes serialized, bpsp {nb * 8 / img.size:.4f} "
              f"against the device container's {dnb * 8 / img.size:.4f} "
              f"({100 * (nb - dnb) / dnb:+.3f} %), encode {enc_ms:.2f} ms, "
              f"decode {dec_ms:.2f} ms (medians of 5), peak memory "
              f"{peak_mib():.1f} MiB, hand-kernel launches {got}")


def rate_phase(codec, params, img, act_bits, counters) -> None:
    """The rate forward of the flagship on the card under exact_math
    against the CPU forward of the same weights, its time, and the
    est/act gap against the main path's container."""
    cfg = codec.cfg
    x = torch.from_numpy(img[None].astype(np.float32) / 255.0)
    xd = x.to(codec.device)

    def forward():
        with torch.inference_mode(), exact_math():
            return codec.model(xd)

    forward()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    maps, _ = timed(forward)
    got = {name: fn.launches for name, fn in counters.items()}
    check(all(v == 0 for v in got.values()),
          f"the rate forward launched a hand kernel: {got}")
    ms = median_ms(forward)
    peak = peak_mib()
    t0 = time.perf_counter()
    cpu_model = params_from_flax(params, cfg)
    with torch.inference_mode():
        ref = cpu_model(x)
    cpu_s = time.perf_counter() - t0
    with torch.inference_mode():
        same = all(torch.equal(a.cpu(), b) for a, b in zip(
            codec.model.transform(xd), cpu_model.transform(x)))
    check(same, "rate forward: the card's float lifting and wavelet bands "
          "differ from the CPU's")
    maps = [m.cpu() for m in maps]
    check([m.shape for m in maps] == [r.shape for r in ref]
          and all(bool(torch.isfinite(m).all()) for m in maps),
          "rate forward: shapes differ or values are not finite")
    dev = max(float((m - r).abs().max()) for m, r in zip(maps, ref))
    sums = torch.stack([m.double().sum(dim=(0, 1, 2)) for m in maps])
    rsums = torch.stack([r.double().sum(dim=(0, 1, 2)) for r in ref])
    rel = float(((sums - rsums).abs() / rsums.abs()).max())
    print(f"rate forward 512x768: {[tuple(m.shape) for m in maps]}, card "
          f"{ms:.2f} ms (median of 5), peak memory {peak:.1f} MiB, CPU "
          f"{cpu_s:.2f} s; bands equal to the CPU's bit for bit; card "
          f"against CPU: largest map deviation "
          f"{dev:.3g} bits, per-slice sums {rel:.3g} relative")
    check(rel <= 1e-4, "rate forward: per-slice sums differ from the CPU's")
    for m, r in zip(maps, ref):
        check(torch.allclose(m, r, rtol=1e-4, atol=RATE_ATOL),
              f"rate forward: a map differs from the CPU's beyond "
              f"rtol 1e-4, atol {RATE_ATOL} bits")
    est = float(sums.sum())
    act = sum(sum(r) for r in act_bits)
    print(f"est/act: estimate {est:.0f} bits, the main path's container "
          f"{act} bits, gap {100 * (act - est) / est:+.2f} % (the JAX "
          f"package's own on this image: -2.19 %)")


def slice_phase(codec, params, counters, images) -> None:
    """The rate forward, the host backend, scoped exact math (C1) and the
    size against the JAX package (C2), on the main path's images; ``images``
    maps a label to (image, its device container, sha256, slice bits)."""
    img, flagship, sha, act_bits = images["512x768"]
    c2_check(flagship)
    t0 = time.perf_counter()
    c1_check(codec.cfg, params, img, sha, counters)
    print(f"C1 check: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    host_phase(codec.cfg, params, images, counters)
    print(f"host backend: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    rate_phase(codec, params, img, act_bits, counters)
    print(f"rate forward: {time.perf_counter() - t0:.2f} s")


TRAIN_SEED = 1337  # configs/paper_a.json's seed
TRAIN_LR = 1e-4  # configs/paper_a.json's learning rate
TIMED_STEPS = 6  # optimiser steps timed after the first, per flag setting


def train_snapshot(model, opt):
    """(parameters, gradients, Adam state) of a model after a step, on
    the CPU."""
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    state = {k: {key: v.detach().cpu() for key, v in s.items()}
             for k, s in opt.state_dict()["state"].items()}
    return params, grads, state


def one_train_step(cfg, params, batch, device):
    """One clip + Adam step of the trained flagship on ``batch`` [acc, B,
    H, W, 3] -> (metrics on the CPU, snapshot).  The step puts the model
    in channels-last."""
    model = params_from_flax(params, cfg).to(device).train()
    opt = make_optimizer(model, TRAIN_LR)
    step = make_train_step(model, opt)
    x = torch.from_numpy(batch).to(device)
    with exact_math():
        m = step(x)
    return ({k: v.cpu() for k, v in m.items()}, train_snapshot(model, opt))


def train_compare_batch():
    """Phase 11 (a)'s loader batch [2, 2, 160, 160, 3]."""
    ds = ImageDataset(synthetic_len=4, synthetic_size=160, seed=TRAIN_SEED)
    batch = next(iter(TrainLoader(ds, 2, 160, grad_acc=2, seed=TRAIN_SEED)))
    check(batch.shape == (2, 2, 160, 160, 3), f"batch {batch.shape}")
    return batch


def card_cpu_readings(gpu, cpu, g64) -> dict:
    """Phase 11 (a)'s readings of a card step against the CPU's (each
    ``one_train_step``'s result) with the step's float64 gradients
    ``g64``: the loss's and the breakdown's relative distance, the
    largest gradient deviation of the tensor's max|g_cpu| (and its
    tensor), each float32 gradient's relative L2 distance from float64
    (card, CPU) and the worst, and the step rule
    (``dryrun.step_rule``)."""
    (m_gpu, (p_gpu, g_gpu, s_gpu)), (m_cpu, (p_cpu, g_cpu, s_cpu)) = gpu, cpu
    names = list(p_cpu)
    g_dev, worst = 0.0, None  # card against CPU, of the tensor's max|g_cpu|
    for n in names:
        dev = float((g_gpu[n] - g_cpu[n]).abs().max() / g_cpu[n].abs().max())
        if dev >= g_dev:
            g_dev, worst = dev, n
    l2 = {n: [float((g[n].double() - g64[n]).norm() / g64[n].norm())
              for g in (g_gpu, g_cpu)] for n in names}
    return {
        "loss_rel": abs(float(m_gpu["loss"]) - float(m_cpu["loss"]))
        / abs(float(m_cpu["loss"])),
        "breakdown_rel": float(((m_gpu["breakdown"] - m_cpu["breakdown"])
                                .abs() / m_cpu["breakdown"].abs()).max()),
        "grad_dev": g_dev, "grad_dev_tensor": worst, "float64_l2": l2,
        "float64_l2_worst": max(max(v) for v in l2.values()),
        "adam_steps": sorted({float(s[k]["step"]) for s in (s_gpu, s_cpu)
                              for k in s}),
        "rule": dryrun.step_rule(
            [p_gpu[n] for n in names], [g_gpu[n] for n in names],
            [p_cpu[n] for n in names], [g_cpu[n] for n in names], TRAIN_LR,
            dryrun.CARD_CPU_GRAD_REL_L2, exact=[g64[n] for n in names])}


def check_card_cpu(r: dict) -> None:
    """Phase 11 (a)'s checks on :func:`card_cpu_readings`."""
    check(r["loss_rel"] <= 1e-5,
          "train step: the card's loss differs from the CPU's")
    check(r["breakdown_rel"] <= 1e-4,
          "train step: the breakdown differs from the CPU's")
    check(r["grad_dev"] <= 1e-2, "train step: a gradient of the card "
          "differs from the CPU's by more than 1e-2 of its max|g_cpu|")
    for n, (card, cpu) in r["float64_l2"].items():
        check(max(card, cpu) <= FLOAT64_GRAD_REL_L2, f"train step: the "
              f"gradient of {n} is further than {FLOAT64_GRAD_REL_L2} "
              f"(relative L2) from the float64 one: card {card:.3g}, CPU "
              f"{cpu:.3g}")
    check(r["rule"]["ok"], f"train step: the card's step against the CPU's "
          f"fails the step rule: {dryrun.rule_line(r['rule'])}")
    check(r["adam_steps"] == [1.0], f"train step: Adam's step count "
          f"{r['adam_steps']}")


def train_compare(counters) -> None:
    """(a) one train step on the card under exact_math against one on the
    CPU from the same trained weights and the same loader batch: the loss
    within 1e-5 and the breakdown within 1e-4 relative, every gradient
    within 1e-2 of its max|g_cpu| and, card and CPU alike, within
    FLOAT64_GRAD_REL_L2 (the bound under exact_math) of the step's float64
    gradient (``dryrun.float64_step``), Adam's step count, and the step rule
    (``dryrun.step_rule``: gradients within CARD_CPU_GRAD_REL_L2 of the
    CPU's, every parameter within 2 lr, beyond 1e-3 lr only where the
    float64 gradient is float noise).  Prints the readings, the old
    99.9 %-within-1e-3-lr rule's share beside them, and whether a second
    card step is bit-identical."""
    cfg = ModelConfig()
    params = load_npz()
    batch = train_compare_batch()
    reset_counts(counters)
    t0 = time.perf_counter()
    gpu = one_train_step(cfg, params, batch, "cuda")
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    read_zero_counts(counters, "the train step")
    _, (_, g_again, _) = one_train_step(cfg, params, batch, "cuda")
    g_gpu = gpu[1][1]
    differ = [n for n in g_gpu if not torch.equal(g_gpu[n], g_again[n])]
    t0 = time.perf_counter()
    cpu = one_train_step(cfg, params, batch, "cpu")
    cpu_s = time.perf_counter() - t0
    _, g64 = float64_step(params_from_flax(params, cfg),
                          torch.from_numpy(batch), 5.0)
    r = card_cpu_readings(gpu, cpu, g64)
    print(f"train step [2, 2, 160, 160, 3], trained flagship, lr "
          f"{TRAIN_LR}: card {gpu_s:.2f} s (first call), CPU {cpu_s:.2f} s; "
          f"loss card {float(gpu[0]['loss']):.6f} CPU "
          f"{float(cpu[0]['loss']):.6f} ({r['loss_rel']:.3g} relative, bound "
          f"1e-5); breakdown {r['breakdown_rel']:.3g} relative (bound 1e-4); "
          f"largest gradient deviation {r['grad_dev']:.3g} of the tensor's "
          f"max|g_cpu| ({r['grad_dev_tensor']}; bound 1e-2); gradients "
          f"against float64 at worst {r['float64_l2_worst']:.3g} relative "
          f"L2 (bound {FLOAT64_GRAD_REL_L2:g}); a second card step "
          f"bit-identical: "
          f"{not differ} ({len(differ)} gradient tensors differ"
          f"{': ' if differ else ''}{', '.join(differ[:4])})")
    print(f"train step, card against CPU, step rule: "
          f"{dryrun.rule_line(r['rule'])}")
    print("train step gradients against float64, relative L2 (card, CPU): "
          + ", ".join(f"{n} {a:.3g} {b:.3g}"
                      for n, (a, b) in r["float64_l2"].items()))
    check_card_cpu(r)


def states_equal(a, b) -> bool:
    """Model and Adam state of two trainers bit for bit."""
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    return (all(torch.equal(x, y) for x, y in zip(a.model.state_dict().values(),
                                                  b.model.state_dict().values()))
            and sa["param_groups"] == sb["param_groups"]
            and all(torch.equal(sa["state"][k][key], sb["state"][k][key])
                    for k in sa["state"] for key in sa["state"][k]))


def trainer_phase(counters, root: str) -> None:
    """(b) the Trainer on the card at configs/paper_a.json's train
    settings, 320 synthetic images (5 steps an epoch), one epoch, then a
    resume to the second."""
    base = config_from_json(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "configs", "paper_a.json"))
    check(base.model == ModelConfig(), "paper_a's model is not the flagship")
    cfg = replace(base, experiments_root=root,
                  train=replace(base.train, max_epoch=1),
                  data=replace(base.data, synthetic_len=320))
    losses, ends = [], []

    def recorded(tr):
        step = tr.train_step

        def run_step(batch):
            m = step(batch)
            losses.append(float(m["loss"]))  # waits for the step
            ends.append(time.perf_counter())
            return m
        tr.train_step = run_step
        return tr

    reset_counts(counters)
    t0 = time.perf_counter()
    tr = recorded(Trainer(cfg))
    check(tr.device.type == "cuda", "Trainer did not default to the card")
    tr.run()
    tr.finalize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(tr.current_iteration == 5, f"{tr.current_iteration} iterations, "
          "expected 5")
    # the Trainer's loop from one step's end to the next: loader wait,
    # upload, step and logging
    loop_ms = sorted(1e3 * (b - a) for a, b in zip(ends, ends[1:]))
    check(len(losses) == 5 and all(math.isfinite(v) for v in losses),
          f"a loss is not finite: {losses}")
    check(tr.ckpt.exists("checkpoint") and tr.ckpt.exists("model_best"),
          "checkpoint or model_best missing")
    tr2 = recorded(Trainer(replace(cfg, train=replace(
        cfg.train, resume_training=True, max_epoch=2))))
    check(tr2.current_iteration == 5, "the resume did not start at 5")
    check(states_equal(tr, tr2), "the resumed parameters or Adam state "
          "differ from those saved")
    tr2.run()
    check(tr2.current_iteration == 10, f"the resume ended at "
          f"{tr2.current_iteration}, expected 10")
    got = read_zero_counts(counters, "the Trainer")
    print(f"Trainer (paper_a train settings, 320 synthetic images): epoch 0 "
          f"in {wall:.1f} s with validation and checkpoints, "
          f"{loop_ms[len(loop_ms) // 2]:.1f} ms from a step's end to the "
          f"next's (median of {len(loop_ms)}, {card_line()}), losses "
          f"{[round(v, 4) for v in losses[:5]]}; resumed at iteration 5 with "
          f"equal parameters and Adam state, ran to 10, losses "
          f"{[round(v, 4) for v in losses[5:]]}; best valid loss "
          f"{tr2.best_valid_loss:.4f}; hand-kernel launches {got}")


def read_zero_counts(counters, label: str):
    got = {name: fn.launches for name, fn in counters.items()}
    check(all(v == 0 for v in got.values()),
          f"{label} launched a hand kernel: {got}")
    return got


def train_timing(counters) -> None:
    """(c) ms an optimiser step of the flagship at batch 32 x 160^2, acc
    2, from random weights: the median of TIMED_STEPS steps after the
    first, under PyTorch's default flags and under exact_math; patches a
    second, peak memory; the loader's ms a batch on its own."""
    cfg = ModelConfig()
    ds = ImageDataset(synthetic_len=320, synthetic_size=160, seed=TRAIN_SEED)
    loader = TrainLoader(ds, 32, 160, grad_acc=2, seed=TRAIN_SEED,
                         num_threads=2)
    t0 = time.perf_counter()
    batches = list(loader)
    load_ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    x = torch.from_numpy(batches[0]).pin_memory()
    _, up_ms = timed(lambda: x.to("cuda", non_blocking=True))
    xd = x.to("cuda")
    flags = "default flags " + str(read_flags())
    reset_counts(counters)
    for label, ctx in ((flags, contextlib.nullcontext),
                       ("exact_math", exact_math)):
        model = params_from_flax(init_params(cfg, TRAIN_SEED), cfg).cuda()
        step = make_train_step(model, make_optimizer(model, TRAIN_LR))
        torch.cuda.reset_peak_memory_stats()
        with ctx():
            times = [timed(lambda: step(xd))[1]
                     for _ in range(TIMED_STEPS + 1)]
        ms = sorted(times[1:])[TIMED_STEPS // 2]
        print(f"train step timing, {label}: first {times[0]:.1f} ms, median "
              f"of the next {TIMED_STEPS} {ms:.2f} ms (min {min(times[1:]):.2f},"
              f" max {max(times[1:]):.2f}), {64 / ms * 1e3:.1f} patches a "
              f"second, peak memory {peak_mib():.1f} MiB; {card_line()}")
        del model, step
        torch.cuda.empty_cache()
    read_zero_counts(counters, "the timed train steps")
    print(f"train loader: {load_ms:.1f} ms a batch of 64 patches on its own "
          f"(one epoch of {len(batches)} batches, 2 threads), upload "
          f"{up_ms:.2f} ms pinned; {card_line()}")


def train_phase(counters) -> None:
    """Phase 11: training at flagship width, each part with the launch
    counts set to 0 just before it and read just after."""
    t0 = time.perf_counter()
    train_compare(counters)
    print(f"train (a): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        trainer_phase(counters, root)
    print(f"train (b): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    train_timing(counters)
    print(f"train (c): {time.perf_counter() - t0:.2f} s")


# ---- phase 12: lanes above 1024, the float-CDF path, the CLI and eval ----

# Kernels 2 and 3 against plain at these: 98304 is the finest slice's n
# (one step), 131072 leaves lanes with no symbol
LANES = (2048, 4096, 5000, 8192, 16384, 16385, 20000, 98304, 131072)
EDGE_LANES = (1025, 8192, 16385, 131072)  # edge tables and chains
TRIP_LANES = (2048, 4096, 20000)  # flagship round trips
# the K = BATCH_K batched wide decode; at 20000 two lanes a thread
WIDE_BATCH_LANES = (2048, 20000)
BATCH_LANES = (2048, 20000)  # K = BATCH_K batch container round trips
# lanes of a wide decode cluster at one lane a thread (csrc/rans.cu:
# kWideCluster blocks of kWideThreads); past it a thread takes several
WIDE_THREAD_LANES = 16 * 1024
EVAL_SUMMARY_KEYS = {  # tools/eval_protocol.py's flush() summary
    "checkpoint", "devices", "n_images", "all_lossless", "max_abs_gap_pct",
    "max_abs_coder_gap_pct", "max_abs_gap_pct_exact_mult", "n_exact_mult",
    "mean_bpsp", "mean_bpsp_by_split", "per_image"}
RESULTS_KEYS = {"rate", "est_rate", "dist", "lossless", "per_image"}


def reset_wide() -> None:
    rans.rans_decode.wide_launches = 0
    rans.rans_encode_chain.wide_launches = 0


def read_wide():
    return {"rans_decode_wide": rans.rans_decode.wide_launches,
            "rans_encode_wide": rans.rans_encode_chain.wide_launches}


def finest_y(codec, img):
    """The finest band's Y slice of ``img`` as the codec codes it: (int32
    table [n, P], start, freq [n])."""
    cfg, dev = codec.cfg, codec.device
    minmax, _ = cmod.host_header(img[None], cfg.dwtlevels)
    ranges = [cmod.clr_range(clr, minmax) for clr in range(3)]
    x = torch.from_numpy(img[None].copy()).to(dev)
    y0 = lazy_dwt(codec._to_y(rgb_int_to_ycocg_r_int(x)), cfg.dwtlevels,
                  pad=True)[0][0]
    n = y0.shape[1] * y0.shape[2]
    with torch.inference_mode(), exact_math():
        pm = codec.model.band_params(y0[..., :3].contiguous(), 0, 0)
        return codec._tables(0, 0, pm[0].reshape(n, -1).contiguous(),
                             y0[0].reshape(n, -1).contiguous(), ranges,
                             codec._pts3(ranges))


def lanes_kernels(codec, img, kres):
    """Kernel 3 on the 45-slice chain and Kernel 2 on the finest Y slice at
    each N of LANES, against the plain versions (bit-identical), timed
    beside N = 1024's (phase 3).  -> {N: {"decode": row, "encode": row,
    "steps": the decode's steps}}, a row (max |d|, ms, plain ms, bound ms,
    bound_by)."""
    dev = codec.device
    cum, st0, fr0 = finest_y(codec, img)
    n, P = cum.shape
    starts, freqs, offsets, sizes, _ = chain_inputs(codec, img)
    starts, freqs = starts[0], freqs[0]
    out = {}
    for N in LANES:
        cap = starts.numel() + N  # a symbol emits at most one word
        (cursors, _, cursor, _), eerr = chain_outputs(
            starts, freqs, offsets, fresh_carry(N, cap, dev))
        check(eerr == 0, f"Kernel 3 at N={N} != rans_encode_chain_plain")
        total = int(cursor[0])
        check(int(cursors[-1]) == total, f"N={N}: chain cursors")

        def chain(fn):
            return lambda s, c, b: fn(starts, freqs, offsets, s, c, b)

        carry = lambda _: fresh_carry(N, cap, dev)  # noqa: E731
        ems = cuda_ms(chain(rans.rans_encode_chain), 20, carry)
        eplain = cuda_ms(chain(rans.rans_encode_chain_plain), 1, carry)
        steps = sum(-(-m // N) for m in sizes)
        ebnd = bound(rans_encode_bytes(starts.numel(), total, N), 0)

        s, c, b = fresh_carry(N, n + N, dev)
        rans.rans_encode(st0, fr0, s, c, b)
        words0 = int(c[0])
        sn, wn = rans.unpack_stream(rans.pack_stream_packed(
            b[:words0].cpu().numpy(), s.cpu().numpy()), N)
        words = torch.from_numpy(wn).to(dev)

        def fresh(_):
            return (torch.from_numpy(sn.astype(np.int64)).to(dev),
                    torch.zeros((1,), dtype=torch.int32, device=dev))

        outs = []
        for fn in (rans.rans_decode, rans.rans_decode_plain):
            sx, o = fresh(0)
            outs.append((fn(cum, words, sx, o), sx, o))
        torch.cuda.synchronize()
        derr = max(max_abs(a, b) for a, b in zip(*outs))
        check(derr == 0, f"Kernel 2 at N={N} != rans_decode_plain")
        sym = outs[0][0].long()[:, None]
        check(torch.equal(cum.gather(1, sym)[:, 0], st0)
              and int(outs[0][2][0]) == words0,
              f"N={N}: the decode did not return the encoded symbols")
        dms = cuda_ms(lambda sx, o: rans.rans_decode(cum, words, sx, o), 20,
                      fresh)
        dplain = cuda_ms(lambda sx, o: rans.rans_decode_plain(cum, words, sx,
                                                              o), 2, fresh)
        dbnd = bound(rans_decode_bytes(n, P, words0, N), 0)
        dsteps = -(-n // N)
        out[N] = {"decode": (derr, dms, dplain) + dbnd,
                  "encode": (eerr, ems, eplain) + ebnd, "steps": dsteps}
        clusters = rans.decode_max_clusters(N)
        check(clusters > 0, f"N={N}: no decode cluster fits on the card")
        d1, e1 = kres["decode"], kres["encode"]
        print(f"lanes N={N}: Kernel 2, Y slice P={P}: {dms:.5f} ms "
              f"({1e3 * dms / dsteps:.3f} us a step of {dsteps}; N=1024: "
              f"{d1[1]:.5f} ms, bound {d1[3]:.5f}), plain {dplain:.5f} ms, "
              f"bound {dbnd[0]:.5f} ms ({dbnd[1]}), {clusters} resident "
              f"clusters; Kernel 3, chain of {len(sizes)} slices, {steps} "
              f"steps: {ems:.5f} ms (N=1024: {e1[1]:.5f} ms, bound "
              f"{e1[3]:.5f}), plain {eplain:.5f} ms, bound {ebnd[0]:.5f} ms "
              f"({ebnd[1]}); both bit-identical to the plain versions; "
              f"{card_line()}")
    return out


def lanes_round_trips(cfg, params, img, counters):
    """Flagship round trips at each N of TRIP_LANES, byte-exact, with the
    launch counts (the wide variants' too) set to 0 just before and read
    just after.  -> the wide launches."""
    reset_counts(counters)
    reset_wide()
    for N in TRIP_LANES:
        codec = Codec(cfg, params, num_lanes=N)
        (streams, enc_ms) = timed(lambda: codec.compress(img))
        back = Codec.deserialize(Codec.serialize(streams))
        out, dec_ms = timed(lambda: codec.decompress(back, xorg=img))
        check(np.array_equal(out[0], img) and codec.last_ycocg_err == 0,
              f"N={N}: the flagship round trip is not byte-exact")
        nb = Codec.num_bytes(streams)
        print(f"lanes N={N}: 512x768 flagship lossless, last_ycocg_err 0, "
              f"{nb} bytes, bpsp {nb * 8 / img.size:.4f}, encode "
              f"{enc_ms:.2f} ms, decode {dec_ms:.2f} ms (first calls)")
    got = dict(read_counts(counters, "round trips at N > 1024"),
               **read_wide())
    check(all(v > 0 for v in got.values()),
          f"a wide variant was not launched: {got}")
    print(f"lanes round trips: launches {got}")
    return read_wide()


def wide_batch_phase(cfg, params):
    """Kernel 2 at each N of WIDE_BATCH_LANES on the finest Y slices of
    BATCH_K images in one launch (at N = 20000 a thread holds two lanes,
    their states in device memory between sub-steps, at states + img N),
    against rans_decode_plain bit for bit; -> {N: its batch figures}."""
    codec = Codec(cfg, params, num_lanes=WIDE_BATCH_LANES[0])
    imgs = [synthetic_image(512, 768, seed=42 + k) for k in range(BATCH_K)]
    cum, st, fr, true_sym = batch_y_tables(codec, imgs)  # the same at any N
    K, n, P = cum.shape
    out = {}
    for N in WIDE_BATCH_LANES:
        states, cursor, buf = batch_carry(K, N, n + N, codec.device)
        rans.rans_encode_chain(st, fr, torch.tensor([0, n], dtype=torch.int64),
                               states, cursor, buf)
        err, ms, plain, bnd = batched_decode(cum, states, buf,
                                             cursor.tolist(), true_sym)
        clusters = rans.decode_max_clusters(N)
        steps, waves = -(-n // N), -(-K // clusters)
        lanes_a_thread = -(-N // WIDE_THREAD_LANES)
        out[N] = {"batch_k": K, "batch_lanes": N, "batch_ms": ms,
                  "batch_plain_ms": plain, "batch_bound_ms": bnd[0],
                  "batch_max_abs_err": err, "max_clusters": clusters}
        first = out[WIDE_BATCH_LANES[0]]
        if N != WIDE_BATCH_LANES[0]:  # the keys N = 2048's row had
            out[N].update(batch_bound_by=bnd[1], steps=steps, waves=waves,
                          lanes_a_thread=lanes_a_thread,
                          us_a_step=1e3 * ms / steps)
        print(f"batched wide kernel2 decode, N={N}, K={K} Y slices P={P} "
              f"n={n}: identical symbols, states, offsets; {ms:.5f} ms a "
              f"launch ({steps} steps, {lanes_a_thread} lane(s) a thread, "
              f"{waves} wave(s) of the {clusters} clusters the card holds "
              f"at once), {ms / K:.5f} ms an image, plain {plain:.5f} ms, "
              f"bound {bnd[0]:.5f} ms ({bnd[1]}); N={WIDE_BATCH_LANES[0]}: "
              f"{first['batch_ms']:.5f} ms, bound "
              f"{first['batch_bound_ms']:.5f}; {card_line()}")
    return out


def batch_lanes_phase(cfg, params, counters, at_1024):
    """Batch containers of BATCH_K images at each N of BATCH_LANES:
    compress_batch -> serialize -> deserialize -> decompress_batch
    byte-exact, with the launch counts (the wide variants' too) set to 0
    just before each direction and read just after; bytes and ms an image
    beside N = 1024's (``at_1024``, the serving phase's).  -> {N: figures},
    N = 1024's among them."""
    imgs = [synthetic_image(512, 768, seed=42 + k) for k in range(BATCH_K)]
    S = cfg.num_scales
    out = {1024: at_1024}
    for N in BATCH_LANES:
        codec = Codec(cfg, params, num_lanes=N)
        codec.decompress_batch(codec.compress_batch(imgs))  # warm-up
        reset_counts(counters)
        reset_wide()
        streams, enc_ms = timed(lambda: codec.compress_batch(imgs))
        got = dict({name: fn.launches for name, fn in counters.items()},
                   **read_wide())
        check(got["rans_decode"] == 0 and 0 < got["rans_encode"] <= 2
              and got["rans_encode_wide"] == got["rans_encode"]
              and got["gmm_cdf_from_pmap"] > 0,
              f"batch encode at N={N}, launches {got}: Kernel 3 at most 2, "
              "all wide, Kernel 2 none")
        blob = Codec.serialize(streams)
        reset_counts(counters)
        reset_wide()
        outs, dec_ms = timed(lambda: codec.decompress_batch(
            Codec.deserialize(blob)))
        dgot = dict({name: fn.launches for name, fn in counters.items()},
                    **read_wide())
        check(dgot["rans_decode"] == dgot["rans_decode_wide"] == 9 * S
              and dgot["rans_encode"] == 0,
              f"batch decode at N={N}, launches {dgot}: the wide Kernel 2 "
              "once a slice")
        for k, (im, o) in enumerate(zip(imgs, outs)):
            check(o.shape == im.shape and np.array_equal(o, im),
                  f"batch container at N={N}: image {k} lossy")
        out[N] = {"bytes": len(blob), "encode_ms_an_image": enc_ms / BATCH_K,
                  "decode_ms_an_image": dec_ms / BATCH_K,
                  "encode_launches": got, "decode_launches": dgot}
        print(f"batch container K={BATCH_K} 512x768 at N={N}: byte-exact, "
              f"{len(blob)} bytes (N=1024: {at_1024['bytes']}), encode "
              f"{enc_ms / BATCH_K:.2f} ms an image (N=1024: "
              f"{at_1024['encode_ms_an_image']:.2f}), decode "
              f"{dec_ms / BATCH_K:.2f} ms an image (N=1024: "
              f"{at_1024['decode_ms_an_image']:.2f}); launches encode {got} "
              f"decode {dgot}; {card_line()}")
    return out


def float_cdf_phase(cfg, params, images, k1_codec, counters):
    """Codec(use_kernel_cdf=False), the JAX package's default float-CDF
    path: byte-exact round trips with no Kernel 1 launch and Kernels 2 and
    3 as usual, num_bytes against JAX's, ms beside Kernel 1's."""
    codec = Codec(cfg, params, num_lanes=1024, use_kernel_cdf=False)
    rows = {}
    for label, img in images.items():
        codec.decompress(codec.compress(img))  # warm-up
        reset_counts(counters)
        streams = codec.compress(img)
        out = codec.decompress(Codec.deserialize(Codec.serialize(streams)),
                               xorg=img)
        got = {name: fn.launches for name, fn in counters.items()}
        check(np.array_equal(out[0], img) and codec.last_ycocg_err == 0,
              f"float CDF {label}: not byte-exact")
        check(got == {"gmm_cdf_from_pmap": 0, "rans_decode": 45,
                      "rans_encode": 2}, f"float CDF {label}: launches {got}")
        nb = Codec.num_bytes(streams)
        if label == "512x768":
            tol = max(0.001 * JAX_FLAGSHIP_BYTES, 16)
            check(abs(nb - JAX_FLAGSHIP_BYTES) <= tol,
                  f"float CDF: num_bytes {nb} not within {tol:.0f} of the "
                  f"JAX package's {JAX_FLAGSHIP_BYTES}")
        torch.cuda.reset_peak_memory_stats()
        enc = median_ms(lambda: codec.compress(img))
        dec = median_ms(lambda: codec.decompress(streams))
        peak = peak_mib()
        k1_streams = k1_codec.compress(img)
        k1_enc = median_ms(lambda: k1_codec.compress(img))
        k1_dec = median_ms(lambda: k1_codec.decompress(k1_streams))
        rows[label] = (enc, dec, k1_enc, k1_dec)
        print(f"float CDF {label}: lossless, last_ycocg_err 0, {nb} bytes "
              f"(JAX's float path on the 512x768 CPU run: "
              f"{JAX_FLAGSHIP_BYTES}; Kernel 1's: "
              f"{Codec.num_bytes(k1_streams)}), launches {got}; encode "
              f"{enc:.2f} ms, decode {dec:.2f} ms (Kernel 1's {k1_enc:.2f} / "
              f"{k1_dec:.2f}; medians of 5), peak memory {peak:.1f} MiB; "
              f"{card_line()}")
    return rows


def save_image(path_stem: str, img) -> str:
    """A PNG where PIL imports, else a uint8 .npy; -> the file."""
    try:
        from PIL import Image
    except ImportError:
        np.save(path_stem + ".npy", img)
        return path_stem + ".npy"
    Image.fromarray(img).save(path_stem + ".png")
    return path_stem + ".png"


def cli_phase(cfg, params, img, counters, root: str) -> None:
    """The CLI's encode then decode on the card: the decoded file equals
    the input, the blob the codec's serialize(compress(img))."""
    inp = save_image(os.path.join(root, "cli_in"), img)
    blob_path = os.path.join(root, "cli.llic")
    out_path = os.path.join(root, "cli_out.png")
    args = ["--ckpt", BENCH_PARAMS]
    reset_counts(counters)
    _, enc_ms = timed(lambda: cli.main(["encode", inp, blob_path] + args))
    _, dec_ms = timed(lambda: cli.main(["decode", blob_path, out_path]
                                       + args))
    got = read_counts(counters, "the CLI")
    written = out_path if inp.endswith(".png") else out_path + ".npy"
    check(np.array_equal(load_rgb(written), img), "CLI: decoded != input")
    with open(blob_path, "rb") as f:
        blob = f.read()
    check(blob == Codec.serialize(Codec(cfg, params).compress(img)),
          "CLI: the blob is not the codec's serialize(compress(img))")
    print(f"CLI ({os.path.splitext(inp)[1]} in, {os.path.basename(written)} "
          f"out, 512 lanes): 512x768 {len(blob)} bytes, byte-exact; encode "
          f"{enc_ms:.1f} ms, decode {dec_ms:.1f} ms wall (each call loads "
          f"the weights and builds its codec); launches {got}")


def eval_phase(cfg, params, counters, root: str) -> None:
    """eval_model of the Trainer (trained weights from a port .pt) over a
    test set of three images, then the eval protocol over a corpus of 2
    valid + 2 test images: lossless, JAX's keys, rate from the bytes,
    coder gaps within +-1 %."""
    test_dir = os.path.join(root, "test_set")
    os.makedirs(test_dir)
    images = [synthetic_image(512, 768, seed=42),
              synthetic_image(310, 598, seed=7),
              synthetic_image(384, 512, seed=3)]
    for k, im in enumerate(images):
        save_image(os.path.join(test_dir, f"im{k}"), im)
    lcfg = LLICTIConfig(exp_name="eval", mode="eval_model", model=cfg,
                        train=TrainConfig(),
                        data=DataConfig(train_dirs=(test_dir,),
                                        valid_dir=test_dir,
                                        test_dir=test_dir),
                        experiments_root=root)
    model = params_from_flax(params, cfg)
    CheckpointManager(lcfg.checkpoint_dir).save("model_best", {
        "model": model.state_dict(),
        "optimizer": make_optimizer(model, TRAIN_LR).state_dict(),
        "step": 0}, {})
    reset_counts(counters)
    tr = Trainer(lcfg)
    check(tr.device.type == "cuda", "Trainer did not default to the card")
    _, wall = timed(tr.run)
    got = read_counts(counters, "eval_model")
    with open(os.path.join(lcfg.out_dir, "results.json")) as f:
        res = json.load(f)
    check(set(res) == RESULTS_KEYS, f"results.json keys {sorted(res)}")
    per = res["per_image"]
    check(res["lossless"] and len(per) == 3 and all(r["ok"] for r in per),
          "eval_model: an image is not lossless")
    codec = Codec(cfg, params, num_lanes=512)
    rate = float(np.mean([Codec.num_bytes(codec.compress(im)) * 8 / im.size
                          for im in images]))
    check(abs(res["rate"] - rate) <= 1e-12 * rate,
          f"eval_model: rate {res['rate']} != bytes x 8 / pixels {rate}")
    check(all(abs(r["coder_gap_pct"]) <= 1.0 for r in per),
          "eval_model: a coder gap is beyond +-1 %")
    rows = [(round(r["bpsp"], 4), round(r["est_gap_pct"], 2),
             round(r["coder_gap_pct"], 3), round(r["enc_t"], 4),
             round(r["dec_t"], 4)) for r in per]
    print(f"eval_model (3 images, 512 lanes, trained weights from a port "
          f".pt): rate {res['rate']:.4f}, est_rate {res['est_rate']:.4f}, "
          f"lossless; per image (bpsp, est gap %, coder gap %, enc / dec "
          f"s): {rows}; run {wall / 1e3:.2f} s; launches {got}; "
          f"{card_line()}")

    corpus = os.path.join(root, "corpus")
    for split, specs in (("valid", [(512, 512, 1), (384, 640, 2)]),
                         ("test", [(310, 598, 7), (512, 768, 42)])):
        os.makedirs(os.path.join(corpus, split))
        for k, (h, w, seed) in enumerate(specs):
            save_image(os.path.join(corpus, split, f"{split}{k}"),
                       synthetic_image(h, w, seed=seed))
    for var in ("SKIP", "ONLY", "APPEND", "BUCKET", "BUCKET_SIZE",
                "PLATFORM"):
        os.environ.pop(f"LLICTI_EVAL_{var}", None)
    reset_counts(counters)
    summary, wall = timed(lambda: eval_protocol.main(
        os.path.join(root, "eval_out"), root=corpus))
    got = read_counts(counters, "the eval protocol")
    per = summary["per_image"]
    check(set(summary) == EVAL_SUMMARY_KEYS,
          f"eval protocol summary keys {sorted(summary)}")
    check(summary["all_lossless"] and summary["n_images"] == 6
          and not any(r.get("crashed") for r in per),
          "eval protocol: an image crashed or is not lossless")
    check(summary["max_abs_coder_gap_pct"] <= 1.0,
          "eval protocol: a coder gap is beyond +-1 %")
    head = {k: v for k, v in summary.items() if k != "per_image"}
    times = [(r["split"], r["h"], r["w"], r["enc_t"], r["dec_t"])
             for r in per]
    print(f"eval protocol (1024 lanes, Kernel 1): {json.dumps(head)}; warm "
          f"enc / dec s per image {times}; run {wall / 1e3:.2f} s; "
          f"launches {got}; {card_line()}")


def flops_phase(cfg, root: str) -> None:
    """flops_est on the card equals the CPU's count."""
    lcfg = LLICTIConfig(exp_name="flops", mode="flops_est", model=cfg,
                        train=TrainConfig(),
                        data=DataConfig(synthetic=True, synthetic_len=4),
                        experiments_root=root)
    tr = Trainer(lcfg)
    tr.run()
    flops, ms = timed(tr.flops_estimation)
    cpu = Trainer(lcfg, device="cpu").flops_estimation()
    check(flops == cpu > 0, f"flops: card {flops} != CPU {cpu}")
    print(f"flops_est (3x512x512): {flops} flops on the card and the CPU "
          f"({flops / 2e9:.2f} GMac), {ms:.1f} ms on the card")


def port_phase(cfg, params, img, odd, codec, kres, counters, trip):
    """Phase 12; -> (lanes rows, wide batch figures, wide launches, batch
    container figures by N)."""
    t0 = time.perf_counter()
    rows = lanes_kernels(codec, img, kres)
    print(f"kernel2 edge cases above 1024 lanes: "
          f"{decode_edge_phase(codec.device, EDGE_LANES)} tables "
          "bit-identical")
    print(f"kernel3 edge cases above 1024 lanes: "
          f"{encode_edge_phase(codec.device, EDGE_LANES)} chains "
          "bit-identical and round-tripped")
    batch = wide_batch_phase(cfg, params)
    wide = lanes_round_trips(cfg, params, img, counters)
    print(f"phase 12 (a) lanes: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    trips = batch_lanes_phase(cfg, params, counters, trip)
    print(f"phase 12 (a2) batch containers above 1024 lanes: "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    float_cdf_phase(cfg, params, {"512x768": img, "310x598": odd}, codec,
                    counters)
    print(f"phase 12 (b) float CDF: {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        cli_phase(cfg, params, img, counters, root)
        print(f"phase 12 (c) CLI: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        eval_phase(cfg, params, counters, root)
        print(f"phase 12 (d) eval: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        flops_phase(cfg, root)
        print(f"phase 12 (e) flops: {time.perf_counter() - t0:.2f} s")
    return rows, batch, wide, trips


# ---- phase 13: multi-device: the row-sharded codec, DP and spatial ------

SP_LANES = 128  # the JAX ShardedCodec's default lanes a shard
SP_SHARDS = 4
# the JAX package's ShardedCodec on the CPU (G fake devices, N = 128, the
# trained weights; tools/jax_sharded_reference.py --shards G): (G, image)
# -> (num_bytes, header hex), G = 1, 2, 4 and 8; kept in the dry run,
# whose part (b) holds the multi-card containers against them
JAX_SP = dryrun.JAX_SP
SP_TIMEOUT = 600  # seconds the two-rank run and phase 13 (d) may take


def sharded_round_trips(cfg, params, images, counters):
    """ShardedCodec at G = 1 and 4 (one rank, N = 128): each image's round
    trip lossless with last_ycocg_err 0, its header JAX's, num_bytes
    within max(0.1 %, 16 B) of JAX's, 9S Kernel 2 launches a decode and 2
    of Kernel 3 an encode, none of Kernel 1; the 512x768 encode and
    decode ms (medians of 5) and peak memory.  -> ({G: figures}, the G = 4
    codec, its 512x768 container)."""
    S = cfg.num_scales
    out, codec, flagship = {}, None, None
    for G in (1, SP_SHARDS):
        codec = ShardedCodec(cfg, params, mesh=make_sp_mesh(G),
                             num_lanes=SP_LANES)
        for label, img in images.items():
            codec.decompress(codec.compress(img))  # warm-up
            reset_counts(counters)
            streams = codec.compress(img)
            torch.cuda.synchronize()
            enc = {n: fn.launches for n, fn in counters.items()}
            reset_counts(counters)
            dec_img = codec.decompress(streams, xorg=img)
            dec = {n: fn.launches for n, fn in counters.items()}
            nb = ShardedCodec.num_bytes(streams)
            jnb, jhdr = JAX_SP[(G, label)]
            check(np.array_equal(dec_img[0], img), f"G={G} {label}: lossy")
            check(codec.last_ycocg_err == 0, f"G={G} {label}: YCoCg error")
            check(len(streams[1]) == G, f"G={G}: {len(streams[1])} blobs")
            check(streams[0][0].hex() == jhdr, f"G={G} {label}: header "
                  f"{streams[0][0].hex()} is not JAX's {jhdr}")
            check(abs(nb - jnb) <= max(0.001 * jnb, 16), f"G={G} {label}: "
                  f"num_bytes {nb} not within max(0.1 %, 16 B) of JAX's {jnb}")
            check(enc["rans_encode"] == 2 and enc["rans_decode"] == 0
                  and dec["rans_decode"] == 9 * S and dec["rans_encode"] == 0
                  and enc["gmm_cdf_from_pmap"] == dec["gmm_cdf_from_pmap"]
                  == 0, f"G={G} {label}: launches encode {enc}, decode {dec}")
            row = {"num_bytes": nb, "jax_num_bytes": jnb,
                   "encode_launches": enc, "decode_launches": dec}
            if label == "512x768":
                torch.cuda.reset_peak_memory_stats()
                row["encode_ms"] = median_ms(lambda: codec.compress(img))
                row["decode_ms"] = median_ms(lambda: codec.decompress(streams))
                row["peak_mib"] = peak_mib()
                row["sha256"] = hashlib.sha256(
                    ShardedCodec.serialize(streams)).hexdigest()
                if G == SP_SHARDS:
                    flagship = streams
            print(f"sharded codec G={G} N={SP_LANES} {label}: {nb} bytes "
                  f"(JAX {jnb}, {nb - jnb:+d}), lossless, header JAX's, "
                  f"launches encode {enc} decode {dec}"
                  + (f"; encode {row['encode_ms']:.2f} ms, decode "
                     f"{row['decode_ms']:.2f} ms (medians of 5), peak "
                     f"{row['peak_mib']:.1f} MiB, sha256 {row['sha256']}; "
                     f"{card_line()}" if "encode_ms" in row else ""))
            out.setdefault(G, {})[label] = row
    return out, codec, flagship


def sharded_kernels(codec, img):
    """Kernels 2 and 3 at the sharded path's shapes (K = 4 shards, N = 128)
    against their plain versions, bit for bit: the finest Y slice's four
    shards in one launch / call (float-CDF tables, as the codec builds
    them), and Kernel 3 on the image's four 45-slice chains in one call.
    -> (decode row, encode row)."""
    cfg, dev, N, K = codec.cfg, codec.device, codec.N, codec.G
    inner = codec._codec
    minmax, _ = cmod.host_header(img[None], cfg.dwtlevels)
    ranges = [cmod.clr_range(clr, minmax) for clr in range(3)]
    with torch.no_grad(), exact_math():
        y0 = inner._front(torch.from_numpy(img[None].copy()).to(dev))[0]
        n = y0.shape[1] * y0.shape[2]
        pm = inner.model.band_params(
            y0[..., :cfg.cond_channels].contiguous(), 0, 0).reshape(n, -1)
        y2 = y0.reshape(n, -1).contiguous()
        cum, st, fr = inner._tables(0, 0, pm, y2, ranges,
                                    inner._pts3(ranges))
    m = n // K
    cum, st, fr = cum.view(K, m, -1), st.view(K, m), fr.view(K, m)
    P = cum.shape[-1]
    sch = cmod.sym_channel(cfg, 0, 0)
    true_sym = (torch.round(y2[:, sch] * 255.0).int() - ranges[0][0]).view(
        K, m)

    # Kernel 3 on the four shards' Y slices, then Kernel 2 decoding them
    offsets = torch.tensor([0, m], dtype=torch.int64)
    cap = m + N
    (_, states, cursor, buf), enc_err = chain_outputs(
        st, fr, offsets, batch_carry(K, N, cap, dev))
    check(enc_err == 0, f"Kernel 3 (K={K} shards, Y slice) != plain")
    totals = cursor.tolist()
    words = torch.zeros((K, max(totals)), dtype=torch.int32, device=dev)
    for k, t in enumerate(totals):
        words[k, :t] = buf[k, :t].flip(0)  # the stream's order
    states0 = states.clone()

    def fresh(_):
        return (states0.clone(),
                torch.zeros((K,), dtype=torch.int32, device=dev))

    outs = []
    for fn in (rans.rans_decode, rans.rans_decode_plain):
        s, o = fresh(0)
        outs.append((fn(cum, words, s, o), s, o))
    torch.cuda.synchronize()
    (ksy, kst, koff), (psy, pst, poff) = outs
    dec_err = max(max_abs(ksy, psy), max_abs(kst, pst), max_abs(koff, poff))
    check(dec_err == 0, f"Kernel 2 (K={K} shards) != plain")
    check(torch.equal(ksy, true_sym), "Kernel 2 lost the shards' symbols")
    dec_ms = cuda_ms(lambda s, o: rans.rans_decode(cum, words, s, o), 20,
                     fresh)
    dec_plain = cuda_ms(lambda s, o: rans.rans_decode_plain(cum, words, s,
                                                            o), 1, fresh)
    dec_bnd = bound(rans_decode_bytes(K * m, P, sum(totals), K * N), 0)

    # Kernel 3 on the four shards' whole chains, one call
    starts, freqs, offs, ccap = codec.encode_inputs(img)
    (_, _, ccur, _), ch_err = chain_outputs(
        starts, freqs, offs, batch_carry(K, N, ccap, dev))
    check(ch_err == 0, f"Kernel 3 (K={K} shards' 45-slice chains) != plain")
    ch_ms = cuda_ms(lambda s, c, b: rans.rans_encode_chain(
        starts, freqs, offs, s, c, b), 20,
        lambda _: batch_carry(K, N, ccap, dev))
    ch_plain = cuda_ms(lambda s, c, b: rans.rans_encode_chain_plain(
        starts, freqs, offs, s, c, b), 1,
        lambda _: batch_carry(K, N, ccap, dev))
    ch_bnd = bound(rans_encode_bytes(starts.numel(), sum(ccur.tolist()),
                                     K * N), 0)
    print(f"sharded kernel2 decode, K={K} shards of the finest Y slice "
          f"(P={P}, {m} symbols a shard, N={N}, {-(-m // N)} steps): "
          f"identical symbols, states, offsets; {dec_ms:.5f} ms a launch, "
          f"plain {dec_plain:.5f} ms, bound {dec_bnd[0]:.5f} ms "
          f"({dec_bnd[1]}); {card_line()}")
    print(f"sharded kernel3 encode, K={K} shards' chains ({len(offs) - 1} "
          f"slices, {starts.shape[1]} symbols each, N={N}): identical words, "
          f"per-slice cursors, states; {ch_ms:.5f} ms a call, plain "
          f"{ch_plain:.5f} ms, bound {ch_bnd[0]:.5f} ms ({ch_bnd[1]})")
    return ({"shards": K, "lanes": N, "ms": dec_ms, "plain_ms": dec_plain,
             "bound_ms": dec_bnd[0], "max_abs_err": dec_err},
            {"shards": K, "lanes": N, "ms": ch_ms, "plain_ms": ch_plain,
             "bound_ms": ch_bnd[0], "max_abs_err": max(enc_err, ch_err)})


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sp_worker(rank: int, world: int, port: int, backend: str,
              out_dir: str) -> None:
    """One of ``world`` ranks running parts (b)-(d) of
    ``llicti_torch.parallel.dryrun``, whose checks raise in the rank:
    under gloo (phase 13 (c)) two ranks on the one card, gloo over CUDA
    tensors staged through host memory; under nccl (phase 13 (d)) one
    rank a card.  Writes rank{rank}.json to ``out_dir``."""
    import torch.distributed as dist
    initialize(f"localhost:{port}", world, rank, backend=backend,
               device="cuda")
    check(dist.get_backend() == backend and dist.get_world_size() == world,
          f"the {world}-rank {backend} group")
    res = dryrun.run("bcd", dryrun.full_profile(), torch.device(
        "cuda", torch.cuda.current_device()))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def spawn_ranks(backend: str, world: int):
    """``world`` processes of sp_worker under ``backend``; every rank's
    results.  The first rank to fail, or the time limit, stops them all
    (a rank whose peers are gone would wait in its next collective)."""
    port = free_port()
    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, os.path.abspath(__file__), "--sp-rank"]
        logs = [open(os.path.join(out, f"rank{r}.log"), "w+")
                for r in range(world)]
        procs = [subprocess.Popen(cmd + [str(r), str(world), str(port),
                                         backend, out],
                                  stdout=log, stderr=subprocess.STDOUT,
                                  text=True) for r, log in enumerate(logs)]
        end, killed = time.monotonic() + SP_TIMEOUT, set()
        try:
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.monotonic() < end):
                time.sleep(0.5)
        finally:
            for r, p in enumerate(procs):
                if p.poll() is None:
                    p.kill()
                    killed.add(r)
                p.wait()
        # every rank that failed on its own (its peers may fail in their
        # next collective), then those stopped here
        errors = []
        for r in sorted(range(world), key=lambda r: r in killed):
            logs[r].seek(0)
            tail = "\n".join(logs[r].read().strip().splitlines()[-15:])
            logs[r].close()
            if procs[r].returncode != 0:
                errors.append(
                    f"{backend} rank {r} of {world} " + (
                        "stopped after the time limit or a peer's failure"
                        if r in killed else
                        f"failed ({procs[r].returncode})") + f":\n{tail}")
        check(not errors, "\n".join(errors))
        return [json.load(open(os.path.join(out, f"rank{r}.json")))
                for r in range(world)]


def ranks_line(r0: dict) -> str:
    """Rank 0's results of the dry run's parts (b)-(d): the containers,
    the steps' step-rule readings (the old 99.9 % rule's share beside),
    the spatial rate and peak memory."""
    step = r0["d"]["step"]
    return ("; ".join(f"{k}: {v['num_bytes']} bytes (JAX "
                      f"{v.get('jax_num_bytes')}), one process "
                      + ("equal" if v["equal_to_one_process"] else
                         f"{v['num_bytes'] - v['one_process_num_bytes']:+d}"
                         " B") for k, v in r0["b"].items())
            + f"; DP step loss {r0['c']['loss']:.6f} (one card "
            f"{r0['c']['one_card_loss']:.6f}): {dryrun.rule_line(r0['c'])}"
            f"; one card against itself, images reversed: "
            f"{dryrun.rule_line(r0['c']['one_card_self'])}; {step['mesh']} "
            f"step loss {step['loss']:.6f}: {dryrun.rule_line(step)}; "
            f"spatial={r0['world']} rate {r0['d']['rate']['rate']:.6f} (one "
            f"card {r0['d']['rate']['one_card_rate']:.6f}); peak "
            f"{r0['peak_mib']:.0f} MiB a rank")


def two_rank_phase():
    """Phase 13 (c): two processes on the one card (gloo, CUDA tensors
    staged through host memory), each running the dry run's parts
    (b)-(d), whose checks raise in the rank.  -> rank 0's results."""
    t0 = time.perf_counter()
    r0, _ = spawn_ranks("gloo", 2)
    print(f"phase 13 (c), two ranks on one card under gloo, the dry run's "
          f"parts (b)-(d): {ranks_line(r0)}; {card_line()}; "
          f"{time.perf_counter() - t0:.2f} s")
    return r0


def multi_device_phase(cfg, params, images, counters):
    """Phase 13: the row-sharded codec on one rank of a one-rank NCCL
    group, its kernels at K = 4 shards, then two ranks on the card.  ->
    (sharded decode row, sharded encode row, launches on the sharded
    path)."""
    import torch.distributed as dist
    initialize(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        t0 = time.perf_counter()
        rows, codec, _ = sharded_round_trips(cfg, params, images, counters)
        print(f"phase 13 (a) sharded round trips: "
              f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        dec_row, enc_row = sharded_kernels(codec, images["512x768"])
        print(f"phase 13 (b) sharded kernels: {time.perf_counter() - t0:.2f} s")
    finally:
        dist.destroy_process_group()
    two_rank_phase()
    flag = rows[SP_SHARDS]["512x768"]
    for r in (dec_row, enc_row):
        r.update({f"g{G}_{k}": rows[G]["512x768"][k] for G in rows
                  for k in ("encode_ms", "decode_ms", "peak_mib")})
    launches = {"rans_decode": flag["decode_launches"]["rans_decode"],
                "rans_encode": flag["encode_launches"]["rans_encode"],
                "gmm_cdf_from_pmap": flag["encode_launches"][
                    "gmm_cdf_from_pmap"] + flag["decode_launches"][
                    "gmm_cdf_from_pmap"]}
    return dec_row, enc_row, launches


def multi_card_phase():
    """Phase 13 (d): one rank a card under NCCL, each running the dry
    run's parts (b)-(d), whose checks (the same container, losses and
    rate on every rank among them) raise in the rank.  On one card it
    says that it did not run.  -> rank 0's results, or None."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"phase 13 (d) needs two or more cards and did not run: "
              f"{n} card here")
        return None
    t0 = time.perf_counter()
    ranks = spawn_ranks("nccl", n)  # each rank checks its parts itself
    r0 = ranks[0]
    print(f"phase 13 (d), {n} cards under NCCL, one rank a card: "
          f"{ranks_line(r0)}; peak MiB a rank "
          f"{[round(r['peak_mib'], 1) for r in ranks]}; "
          f"{r0['machine']['cards']}; {time.perf_counter() - t0:.2f} s")
    return r0


def build_phase():
    """Build the kernels; print and check ptxas's report, Kernel 1's
    occupancy and the saturation shortcuts."""
    t0 = time.perf_counter()
    _kernels.lib()
    print(f"kernels built (nvcc) and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    table = _kernels.ptxas_table()
    check(len(table) > 0, "ptxas reported no kernel")
    for r in table:
        print(f"ptxas {r['kernel']}: {r['registers']} registers, "
              f"{r['stack']} B stack frame, {r['spill_stores']} B spill "
              f"stores, {r['spill_loads']} B spill loads")
    k1 = [r for r in table if "cdf_pmap_kernel" in r["kernel"]]
    check(len(k1) == 32, f"{len(k1)} Kernel 1 instances, expected 32")
    check(all(r["stack"] == 0 and r["spill_stores"] == 0
              and r["spill_loads"] == 0 for r in k1),
          "a Kernel 1 instance has a stack frame or spills")
    k3 = [r for r in table if "rans_encode" in r["kernel"]]
    check(len(k3) == 2, f"{len(k3)} Kernel 3 kernels, expected 2")
    check(all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in k3),
          "a Kernel 3 kernel spills")
    epi = [r for r in table if "band_epilogue" in r["kernel"]]
    check(len(epi) == 24, f"{len(epi)} band epilogue instances, expected 24")
    check(all(r["stack"] == 0 and r["spill_stores"] == 0
              and r["spill_loads"] == 0 for r in epi),
          "a band epilogue instance has a stack frame or spills")
    wide = [r for r in table if "rans_decode_wide_kernel" in r["kernel"]]
    check(len(wide) == 1, f"{len(wide)} wide decode kernels, expected 1")
    check(all(r["stack"] == 0 and r["spill_stores"] == 0
              and r["spill_loads"] == 0 for r in wide),
          "the wide decode kernel has a stack frame or spills")
    widen = [r for r in table if "widen_words_kernel" in r["kernel"]]
    check(len(widen) == 1 and widen[0]["stack"] == 0
          and widen[0]["spill_stores"] == 0,
          f"the widen kernel: {widen} (one, no stack frame, no spills)")
    for M in (5, 10):
        for logistic in (False, True):
            blocks, threads = cdf.pmap_occupancy(M, logistic)
            check(blocks > 0, "Kernel 1 cannot be resident")
            print(f"kernel1 M={M} {'logistic' if logistic else 'normal'}: "
                  f"{blocks} blocks of {threads} threads per SM")
    bad = cdf.saturation_mismatches(torch.device("cuda"))
    check(bad == 0, f"the saturation shortcut differs on {bad} inputs")
    print("kernel1 saturation shortcut: equal to the full formula on all "
          "2^32 floats")


def ok_line() -> str:
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def main() -> None:
    if sys.argv[1:2] == ["--sp-rank"]:  # one rank of phase 13 (c) or (d)
        sp_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5], sys.argv[6])
        return
    print(card_line())
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    build_phase()
    if sys.argv[1:2] == ["--phase-13d"]:
        check(multi_card_phase() is not None,
              "--phase-13d needs two or more cards")
        print(ok_line())
        return

    cfg = ModelConfig()
    params = load_npz()
    codec = Codec(cfg, params, num_lanes=1024)
    check(codec.device.type == "cuda", "Codec did not default to the card")
    img = synthetic_image(512, 768, seed=42)
    kres = kernel_phase(codec, img)
    kres["encode"], steps = chain_phase(codec, img)
    print(f"kernel2 edge cases: {decode_edge_phase(codec.device)} tables "
          "bit-identical")
    print(f"kernel3 edge cases: {encode_edge_phase(codec.device)} chains "
          "bit-identical and round-tripped")
    model_phase(codec, params, img)
    epilogue = epilogue_phase(codec, [synthetic_image(512, 768, seed=42 + k)
                                      for k in range(BATCH_K)])

    counters = {"gmm_cdf_from_pmap": cdf.gmm_cdf_from_pmap,
                "rans_decode": rans.rans_decode,
                "rans_encode": rans.rans_encode_chain}
    # the main path's kernels: the later phases count the ported ones
    main_path = dict(counters, band_epilogue=band_epilogue)
    codec.decompress(codec.compress(img))  # warm-up
    for fn in list(main_path.values()) + [cdf.gmm_cdf_table_int32]:
        fn.launches = 0
    flagship, flagship_sha = round_trip(codec, img, "512x768 flagship")
    flagship_bits = codec.last_slice_bits
    check(flagship_sha.startswith(FLAGSHIP_SHA[0])
          and flagship_sha.endswith(FLAGSHIP_SHA[1]),
          f"the flagship container's sha256 {flagship_sha} is not PR 2's")
    launches = {name: fn.launches for name, fn in main_path.items()}
    print(f"main path launches: {launches}")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the main path was not launched")
    check(launches["rans_encode"] <= 2,
          f"Kernel 3 made {launches['rans_encode']} launches in one encode")
    epi_trip = 2 * 3 * cfg.num_scales * cfg.conv_layers
    check(launches["band_epilogue"] == epi_trip,
          f"the band epilogue made {launches['band_epilogue']} launches in "
          f"the round trip, expected {epi_trip}")
    # Kernel 4 lies on no codec path: its count over the round trip is 0
    per_trip = dict(launches,
                    gmm_cdf_table_int32=cdf.gmm_cdf_table_int32.launches)
    check(per_trip["gmm_cdf_table_int32"] == 0,
          "Kernel 4 was launched on the codec path")
    odd = synthetic_image(310, 598, seed=7)
    codec.decompress(codec.compress(odd))  # warm-up
    before = {name: fn.launches for name, fn in main_path.items()}
    odd_streams, _ = round_trip(codec, odd, "310x598")
    check(all(fn.launches > before[name] for name, fn in main_path.items()),
          "310x598 round trip skipped a kernel")

    cdf.gmm_cdf_table_int32.launches = 0
    table_path(codec, img)
    launches["gmm_cdf_table_int32"] = cdf.gmm_cdf_table_int32.launches
    check(launches["gmm_cdf_table_int32"] > 0, "Kernel 4 was not launched")
    logistic, per_trip["gmm_cdf_from_pmap_logistic"] = variants_phase(img,
                                                                      odd)
    launches["gmm_cdf_from_pmap_logistic"] = logistic
    check(logistic > 0, "Kernel 1's logistic branch was not launched")
    t0 = time.perf_counter()
    dec_row, enc_row, paths, trip, widen = serving_phase(codec, params,
                                                         kres, counters)
    print(f"serving phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    slice_phase(codec, params, counters, {
        "512x768": (img, flagship, flagship_sha, flagship_bits),
        "310x598": (odd, odd_streams, None, None)})
    print(f"rate / host backend / exact-math phase: "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    train_phase(dict(counters, gmm_cdf_table_int32=cdf.gmm_cdf_table_int32,
                     band_epilogue=band_epilogue))
    print(f"training phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    lanes, wide_batch, wide, trips = port_phase(cfg, params, img, odd, codec,
                                                kres, counters, trip)
    print(f"phase 12 (lanes, float CDF, CLI, eval, flops): "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    sp_dec, sp_enc, sp_launches = multi_device_phase(
        cfg, params, {"512x768": img, "310x598": odd}, counters)
    print(f"phase 13 (multi-device): {time.perf_counter() - t0:.2f} s")
    multi_card_phase()
    check("jax" not in sys.modules, "jax was imported")
    check(not any(m.startswith("llicti_tpu") for m in sys.modules),
          "the JAX package was imported")

    rows = [
        ("gmm_cdf_from_pmap", "llicti_torch/csrc/cdf_pmap.cu",
         "llicti_tpu/ops/cdf_pallas.py:134", "cdf"),
        ("gmm_cdf_from_pmap_logistic", "llicti_torch/csrc/cdf_pmap_logistic.cu",
         "llicti_tpu/ops/cdf_pallas.py:134", "cdf_logistic"),
        ("gmm_cdf_table_int32", "llicti_torch/csrc/cdf_table.cu",
         "llicti_tpu/ops/cdf_pallas.py:192", "table"),
        ("rans_decode", "llicti_torch/csrc/rans.cu",
         "llicti_tpu/coder/rans_device.py:231", "decode"),
        ("rans_encode", "llicti_torch/csrc/rans.cu",
         "llicti_tpu/coder/rans_device.py:142", "encode"),
    ]
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "launches_per_round_trip": per_trip[name],
                "max_abs_err": kres[key][0], "ms": kres[key][1],
                "plain_ms": kres[key][2], "bound_ms": kres[key][3],
                "bound_by": kres[key][4], "library_ms": None}
               for name, src, rep, key in rows]
    # Kernel 3's row is the whole 45-slice chain; beside it its steps and
    # the finest Y slice encoded alone
    kernels[-1].update(steps=steps, y_slice_ms=kres["encode_slice"][1],
                       y_slice_bound_ms=kres["encode_slice"][3])
    # the serving phase's batch figures (K = 8, one launch / one call) and
    # launches per batch-container round trip
    batch = paths["batch container"]
    kernels[0]["batch_launches"] = (batch["encode"]["gmm_cdf_from_pmap"]
                                    + batch["decode"]["gmm_cdf_from_pmap"])
    kernels[3].update(dec_row, batch_launches=batch["decode"]["rans_decode"])
    kernels[4].update(enc_row, batch_launches=batch["encode"]["rans_encode"])
    # phase 13's sharded path (G = 4 shards, N = 128, one rank): launches
    # over a 512x768 encode / decode, and the K = 4 launch / call
    kernels[0]["sharded_launches"] = sp_launches["gmm_cdf_from_pmap"]
    kernels[3].update(sharded_launches=sp_launches["rans_decode"],
                      sharded=sp_dec)
    kernels[4].update(sharded_launches=sp_launches["rans_encode"],
                      sharded=sp_enc)
    # the N > 1024 variants: N = 2048's figures, each N's beside them;
    # launches over phase 12's round trips at TRIP_LANES
    for name, key, rep in (("rans_decode_wide", "decode",
                            "llicti_tpu/coder/rans_device.py:231"),
                           ("rans_encode_wide", "encode",
                            "llicti_tpu/coder/rans_device.py:142")):
        r = lanes[2048][key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "llicti_torch/csrc/rans.cu", "replaces": rep,
            "launches": wide[name],
            "max_abs_err": max(lanes[N][key][0] for N in LANES), "ms": r[1],
            "plain_ms": r[2], "bound_ms": r[3], "bound_by": r[4],
            "library_ms": None, "lanes": {
                str(N): {"ms": lanes[N][key][1], "plain_ms": lanes[N][key][2],
                         "bound_ms": lanes[N][key][3],
                         "max_abs_err": lanes[N][key][0]}
                for N in LANES}})
    for N in LANES:  # the decode's steps and time a step on the Y slice
        kernels[-2]["lanes"][str(N)].update(
            steps=lanes[N]["steps"],
            us_a_step=1e3 * lanes[N]["decode"][1] / lanes[N]["steps"])
    # the K = 8 launch at N = 2048 as batch_*, at 20000 (two lanes a
    # thread) under wide_batch_lanes; the batch containers by N
    kernels[-2].update(wide_batch[WIDE_BATCH_LANES[0]])
    kernels[-2]["wide_batch_lanes"] = {str(N): wide_batch[N]
                                       for N in WIDE_BATCH_LANES[1:]}
    kernels[-2]["batch_container_lanes"] = {str(N): r
                                            for N, r in trips.items()}
    # the band epilogue replaces no TPU kernel: its cases of phase 4b
    kernels.append({
        "name": "band_epilogue", "route": "cuda",
        "source": "llicti_torch/csrc/band_epilogue.cu", "replaces": None,
        "launches": launches["band_epilogue"],
        "launches_per_round_trip": per_trip["band_epilogue"],
        "batch_launches": epilogue["batch_launches"], "cases": {
            label: {"ms": ms, "bound_ms": bound_ms, "passes_ms": passes_ms}
            for label, ms, bound_ms, passes_ms in epilogue["cases"]}})
    # the widen replaces no TPU kernel: phase 9 (g)'s figures, at the K = 8
    # batch container's shape
    kernels.append(dict(name="widen_words", route="cuda",
                        source="llicti_torch/csrc/rans_widen.cu",
                        replaces=None, **widen))
    print(json.dumps({"kernels": kernels}))
    print(ok_line())


if __name__ == "__main__":
    main()
