"""The sequential-colour cell (``llicti_A_seq.codec_single``): its
reference runs with the program and JAX blocked, a tiny copy of the cell
runs through the command's own path and fails on a flipped byte, and the
readers of ``llicti.seq`` read their span, or nothing without it."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, load, run_cell
from llbench.cell import Outcome
from llbench.run import reader
from llbench.trace import Trace

CELL = "llicti_A_seq.codec_single"
TINY_SEQ = "tiny_A_seq.codec_single"
# the cell's widths but chs 8 and two scales: seconds on the CPU
TINY_MODEL = {"chs": [8, 1], "dwtlevels": [0, 1], "evens": [4, 4],
              "odds": [3, 3], "useprevlevNN": [False, True]}
TINY_PARAMS = {"height": 40, "width": 64, "lanes": 16, "pool": 2,
               "sample": 2, "traced": 1}

_BLOCKED_CHILD = r"""
import json, sys

BLOCKED = ("jax", "jaxlib", "flax", "llicti_tpu", "llicti_torch")


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


for mod in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[mod]
sys.meta_path.insert(0, Blocker())

import numpy as np
import torch
from llbench.data import synthetic_images
from llbench.reference import codec, model, seq

keys = json.load(open("llbench/configs/llicti_A_seq.json"))["model"]
assert seq.forward_flops(keys, 512, 768) == 75_084_337_152
keys.update(%r)
cfg = seq.SeqConfig(keys)
net = seq.build(cfg, model.from_flax(seq.seeded_weights(cfg, 0)), "cpu")
img = list(synthetic_images(1, 24, 32, 3, "cpu").numpy())
out = seq.SeqEncoder(net, 8, "cpu").encode(img)
assert len(out["slices"]) == 18 and out["words"].shape == (1, 18)
with codec.float32_math():
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("OK")
"""


def test_seq_reference_runs_without_the_program_and_jax():
    """The configuration file's reference (and its FLOP count, 75.08 GFLOP
    at 512 x 768) in a process that refuses JAX, the JAX package and the
    program; its encoder runs under TF32 off."""
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_CHILD % (TINY_MODEL,)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


@pytest.fixture
def tiny_seq(tiny_bench):
    """The tiny copy of the sequential-colour cell in the benchmark's
    copy: its configuration and workload files and its entries."""
    cfg = load("llbench", "configs", "llicti_A_seq.json")
    cfg["name"] = "tiny_A_seq"
    cfg["model"].update(TINY_MODEL)
    wl = load("llbench", "workloads", CELL + ".json")
    wl["config"] = "tiny_A_seq"
    wl["params"].update(TINY_PARAMS)
    for path, obj in ((("configs", "tiny_A_seq.json"), cfg),
                      (("workloads", TINY_SEQ + ".json"), wl)):
        with open(os.path.join(tiny_bench, "llbench", *path), "w") as f:
            json.dump(obj, f)
    bench_path = os.path.join(tiny_bench, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    entry = dict(next(w for w in bench["workloads"] if w["name"] == CELL),
                 name=TINY_SEQ, config="tiny_A_seq")
    bench["workloads"].append(entry)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY_SEQ)
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    return TINY_SEQ


def test_tiny_seq_cell_is_correct_and_traced(tiny_seq):
    """Untraced: correct, with the cell's end-to-end metrics; traced: the
    idle time under ``llicti.seq`` read (on the CPU no CUDA event, so
    ``seq_device_ms`` is missing, as are the kernels' shares)."""
    out = run_cell(tiny_seq)
    assert out["correct"] is True and out["failed"] == 0
    assert {"mpix_s", "decode_ms_p95", "bpsp", "setup_s"} == set(
        out["metrics"])
    traced = run_cell(tiny_seq, trace=1)
    assert traced["correct"] is True
    assert traced["metrics"]["seq_idle_ms"]["value"] > 0
    assert "seq_device_ms" in traced["missing"]
    assert traced["metrics"]["codec_mfu"]["value"] > 0


def test_tiny_seq_cell_with_a_flipped_byte_is_not_correct(tiny_seq,
                                                          monkeypatch):
    from llicti_torch import codec as cmod
    compress = cmod.Codec.compress

    def altered(self, rgb):
        streams = compress(self, rgb)
        blob = bytearray(streams[1][0])
        blob[-1] ^= 0x01
        return [streams[0], [bytes(blob)]]

    monkeypatch.setattr(cmod.Codec, "compress", altered)
    out = run_cell(tiny_seq)
    assert out["correct"] is False
    assert out["checks"]["container_bytes_off"]["value"] > 0


# a band of one image over [0, 100] us: kernels busy in [30, 40]; the host
# in the band's llicti.interp over [20, 50], llicti.seq inside it over
# [22, 48]
KERNELS = [("conv", 30.0, 40.0)]
HOST = [("llicti.decompress", 0.0, 100.0), ("llicti.band", 10.0, 90.0),
        ("llicti.interp", 20.0, 50.0), ("llicti.seq", 22.0, 48.0)]


def outcome(host, units=1):
    return Outcome(attempted=1, failed=0, setup_s=0.0, window={}, checks=[],
                   memory_peak_bytes=0,
                   trace=Trace(KERNELS, host, 0.0, 100.0, units))


def test_seq_idle_reads_the_idle_time_under_the_span():
    """[22, 30] and [40, 48] are idle under llicti.seq: 16 us, a part of
    the band loop's idle time; per unit over two units."""
    read = reader("layer_metrics", "seq_idle_ms")
    assert read(outcome(HOST)) == pytest.approx(0.016)
    assert read(outcome(HOST, units=2)) == pytest.approx(0.008)
    assert reader("layer_metrics", "enqueue_idle_ms")(outcome(HOST)) \
        == pytest.approx(0.070)
    busy = [("llicti.decompress", 0.0, 100.0), ("llicti.seq", 31.0, 39.0)]
    assert read(outcome(busy)) == 0.0  # the span open, never idle


def test_seq_readers_give_none_without_the_span():
    """A program without ``llicti.seq`` (another block, or the parent
    program): both readers give None and raise nothing."""
    other = [s for s in HOST if s[0] != "llicti.seq"]
    for name in ("seq_idle_ms", "seq_device_ms"):
        assert reader("layer_metrics", name)(outcome(other)) is None
        o = outcome(other)
        o.trace = None
        assert reader("layer_metrics", name)(o) is None


def test_seq_controls_read_the_tiny_cell(tiny_seq, capsys):
    """``llbench.seq_controls`` reads the program against the reference on
    every pool image, then the TF32 control (on the CPU TF32 changes
    nothing: the card's readings are in PERF.md)."""
    from llbench import seq_controls
    seq_controls.main(["--workload", tiny_seq, "--control-seeds", "5",
                       "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["side"] for x in lines] == ["program"] * 2 + ["control_tf32"]
    assert all(x["container_bytes_off"] == 0 and x["wrong_subpixels"] == 0
               for x in lines[:2])
