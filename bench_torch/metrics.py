"""The benchmark's cells and metrics: the one list the command prints from.

Every end-to-end metric names its cell, unit, direction and bound: the
relative amount by which its value may worsen before a change counts as a
regression: at least 1.5x the widest relative spread, (max - min) / min,
between the medians of repeated runs on one NVIDIA H100 80GB HBM3 at
700 W (the codec cell nine over four calls, the training cell eleven over
six; PERF.md §2 and §5); bpsp 0.1 %, the port's parity rule against the
JAX package.  Every per-layer metric names the cells that
report it; the traced run (``--trace``) alone prints them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

CODEC = "flagship_codec_512x768"
TRAIN = "paper_a_train_step"
CELLS = (CODEC, TRAIN)


class Metric(NamedTuple):
    cell: str
    unit: str
    better: str  # "lower" or "higher"
    bound: Optional[float]  # relative regression bound
    definition: str


class LayerMetric(NamedTuple):
    cells: Tuple[str, ...]
    unit: str
    definition: str


METRICS = {
    "encode_ms": Metric(
        CODEC, "ms", "lower", 0.70,
        "median of 100 single-image compress calls, host clock, "
        "synchronised on both sides"),
    "decode_ms": Metric(
        CODEC, "ms", "lower", 0.75,
        "median of the 100 decompress calls of those containers"),
    "resident_decode_mpix_s": Metric(
        CODEC, "MP/s", "higher", 0.50,
        "0.393216 MP over the mean ms of 100 back-to-back prepare_decode "
        "closure calls, CUDA events"),
    "batch8_ms_per_image": Metric(
        CODEC, "ms", "lower", 0.12,
        "median of 40 compress_batch + decompress_batch round trips of 8 "
        "distinct images, over 8"),
    "bpsp": Metric(
        CODEC, "bits/subpixel", "lower", 0.001,
        "container bytes x 8 / (H W 3), mean over the 100 single images"),
    "decode_mfu": Metric(
        CODEC, "share", "higher", 0.50,
        "FlopCounterMode's float operations of one forward at 1x512x768x3 "
        "over the mean resident decode time and 67 TFLOP/s (float32, TF32 "
        "off under exact_math)"),
    "train_step_ms": Metric(
        TRAIN, "ms", "lower", 0.03,
        "median of 100 make_train_step optimiser steps on [2, 32, 160, "
        "160, 3] pinned batches uploaded non-blocking in the step, host "
        "clock, synchronised, after 5 warm-up steps"),
    "trainer_step_ms": Metric(
        TRAIN, "ms", "lower", 0.20,
        "median of 40 iterations of the Trainer's own loop (loader on 2 "
        "host threads, upload, step, logging), from one step's start to "
        "the next's"),
    "train_mfu": Metric(
        TRAIN, "share", "higher", 0.03,
        "3 x the forward float operations of a step's 64 patches of 160^2 "
        "over train_step_ms and the peak of the step's math mode (495 "
        "TFLOP/s with cuDNN's TF32 allowed, PyTorch's default; else 67)"),
}

LAYER_METRICS = {
    "kernel1_ms": LayerMetric(
        (CODEC,), "ms", "device ms of Kernel 1 in one single-image round "
        "trip, with launches"),
    "kernel2_ms": LayerMetric((CODEC,), "ms", "the same, Kernel 2"),
    "kernel3_ms": LayerMetric((CODEC,), "ms", "the same, Kernel 3"),
    "kernel1_ms_batch8": LayerMetric(
        (CODEC,), "ms", "device ms of Kernel 1 in one K = 8 batch round "
        "trip, with launches"),
    "kernel2_ms_batch8": LayerMetric((CODEC,), "ms", "the same, Kernel 2"),
    "kernel3_ms_batch8": LayerMetric((CODEC,), "ms", "the same, Kernel 3"),
    "kernel1_roofline": LayerMetric(
        (CODEC,), "share", "Kernel 1's bound (bench_torch/work.py, the "
        "single round trip's launches) over its device ms"),
    "kernel2_roofline": LayerMetric((CODEC,), "share", "the same, Kernel 2"),
    "kernel3_roofline": LayerMetric((CODEC,), "share", "the same, Kernel 3"),
    "kernel1_roofline_batch8": LayerMetric(
        (CODEC,), "share", "the same over the K = 8 round trip, Kernel 1"),
    "kernel2_roofline_batch8": LayerMetric(
        (CODEC,), "share", "the same, Kernel 2"),
    "kernel3_roofline_batch8": LayerMetric(
        (CODEC,), "share", "the same, Kernel 3"),
    "conv_ms": LayerMetric(
        (CODEC, TRAIN), "ms", "device ms of cuDNN's convs: a single-image "
        "round trip; a training step"),
    "conv_ms_batch8": LayerMetric(
        (CODEC,), "ms", "the same in a K = 8 batch round trip"),
    "cudnn_transpose_ms": LayerMetric(
        (CODEC, TRAIN), "ms", "device ms of cuDNN's genericTranspose_kernel:"
        " a single-image round trip; a training step"),
    "cudnn_transpose_ms_batch8": LayerMetric(
        (CODEC,), "ms", "the same in a K = 8 batch round trip"),
    "device_idle_share": LayerMetric(
        (CODEC, TRAIN), "share", "1 - device busy (the union of the device "
        "intervals) / wall: a single-image round trip; a training step"),
    "device_idle_share_batch8": LayerMetric(
        (CODEC,), "share", "the same over a K = 8 batch round trip"),
    "launches_per_round_trip": LayerMetric(
        (CODEC,), "launches", "kernel launches (no copies or fills) of one "
        "single-image round trip, with the encode / decode split"),
    "host_header_ms": LayerMetric(
        (CODEC,), "ms", "median host ms of the encoder's host_header "
        "(codec.py) on one image"),
    "fwd_ms": LayerMetric(
        (TRAIN,), "ms", "CUDA events: the forwards of a step's two "
        "microbatches (median of 5 steps)"),
    "bwd_ms": LayerMetric((TRAIN,), "ms", "the same, their backwards"),
    "optimizer_ms": LayerMetric(
        (TRAIN,), "ms", "the same, the division, clip and Adam step"),
    "loader_ms_per_batch": LayerMetric(
        (TRAIN,), "ms", "the TrainLoader alone (2 host threads): wall ms "
        "a batch of 64 patches over 8 batches"),
}


def names(cell: str, traced: bool):
    """The metric names a run of ``cell`` prints, in the table's order: the
    end-to-end ones, or with ``traced`` the per-layer ones."""
    if traced:
        return [n for n, m in LAYER_METRICS.items() if cell in m.cells]
    return [n for n, m in METRICS.items() if m.cell == cell]
