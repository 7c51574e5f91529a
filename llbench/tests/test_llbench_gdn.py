"""The GDN1 cell (``llicti_A_gdn.codec_batch8``): its reference runs with
the program and JAX blocked, a tiny copy of the cell runs correct and
traced through the command's own path and fails on a flipped byte, the
controls read, and the readers of ``llicti.gdn`` read hand-built traces,
or nothing without the span."""
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

CELL = "llicti_A_gdn.codec_batch8"
TINY_GDN = "tiny_A_gdn.codec_batch2"
# the cell's widths but chs 8 and two scales: seconds on the CPU
TINY_MODEL = {"chs": [8, 1], "dwtlevels": [0, 1], "evens": [4, 4],
              "odds": [3, 3], "useprevlevNN": [False, True]}
TINY_PARAMS = {"height": 40, "width": 64, "lanes": 16, "batch": 2,
               "pool": 4, "sample": 2, "traced": 1}

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

import torch
from llbench.data import synthetic_images
from llbench.reference import codec, gdn

keys = json.load(open("llbench/configs/llicti_A_gdn.json"))["model"]
assert gdn.forward_flops(keys, 512, 768) == 245_303_156_736
keys.update(%r)
cfg = gdn.GdnConfig(keys)
net = gdn.build(cfg, gdn.from_flax(gdn.seeded_weights(cfg, 0)), "cpu")
imgs = list(synthetic_images(2, 24, 32, 3, "cpu").numpy())
out = codec.Encoder(net, 8, "cpu").encode_batch(imgs)
assert len(out["slices"]) == 18 and out["words"].shape == (2, 18)
with codec.float32_math():
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("OK")
"""


def test_gdn_reference_runs_without_the_program_and_jax():
    """The configuration file's reference (and its FLOP count, 245.30
    GFLOP at 512 x 768) in a process that refuses JAX, the JAX package and
    the program; its batch encoder runs under TF32 off."""
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_CHILD % (TINY_MODEL,)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


@pytest.fixture
def tiny_gdn(tiny_bench):
    """The tiny copy of the GDN1 cell in the benchmark's copy: its
    configuration and workload files and its entries."""
    cfg = load("llbench", "configs", "llicti_A_gdn.json")
    cfg["name"] = "tiny_A_gdn"
    cfg["model"].update(TINY_MODEL)
    wl = load("llbench", "workloads", CELL + ".json")
    wl["config"] = "tiny_A_gdn"
    wl["params"].update(TINY_PARAMS)
    for path, obj in ((("configs", "tiny_A_gdn.json"), cfg),
                      (("workloads", TINY_GDN + ".json"), wl)):
        with open(os.path.join(tiny_bench, "llbench", *path), "w") as f:
            json.dump(obj, f)
    bench_path = os.path.join(tiny_bench, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    entry = dict(next(w for w in bench["workloads"] if w["name"] == CELL),
                 name=TINY_GDN, config="tiny_A_gdn")
    bench["workloads"].append(entry)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY_GDN)
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    return TINY_GDN


def test_tiny_gdn_cell_is_correct_and_traced(tiny_gdn):
    """Untraced: correct, with the cell's end-to-end metrics; traced:
    correct, the codec's span metrics read (on the CPU no CUDA event, so
    ``gdn_ms`` and ``gdn_roofline`` are missing, as are the kernels'
    shares)."""
    out = run_cell(tiny_gdn)
    assert out["correct"] is True and out["failed"] == 0
    assert {"mpix_s", "bpsp", "setup_s"} == set(out["metrics"])
    traced = run_cell(tiny_gdn, trace=1)
    assert traced["correct"] is True
    assert {"gdn_ms", "gdn_roofline"} <= set(traced["missing"])
    assert traced["metrics"]["codec_mfu"]["value"] > 0
    assert traced["metrics"]["enqueue_idle_ms"]["value"] > 0


def test_tiny_gdn_cell_with_a_flipped_byte_is_not_correct(tiny_gdn,
                                                          monkeypatch):
    from llicti_torch import codec as cmod
    compress_batch = cmod.Codec.compress_batch

    def altered(self, imgs):
        streams = compress_batch(self, imgs)
        blob = bytearray(streams[1][0])
        blob[-1] ^= 0x01
        return [streams[0], [bytes(blob)]] + streams[2:]

    monkeypatch.setattr(cmod.Codec, "compress_batch", altered)
    out = run_cell(tiny_gdn)
    assert out["correct"] is False
    assert out["checks"]["container_bytes_off"]["value"] > 0


def test_gdn_controls_read_the_tiny_cell(tiny_gdn, capsys):
    """``llbench.gdn_controls`` reads the program against the reference on
    every pool batch, then the TF32 control (on the CPU TF32 changes
    nothing: the card's readings are in PERF.md) and the diagonal-gamma
    fault, which changes the container."""
    from llbench import gdn_controls
    gdn_controls.main(["--workload", tiny_gdn, "--control-seeds", "5",
                       "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["side"] for x in lines] == (["program"] * 2 + [
        "control_tf32", "fault_diagonal_gamma"])
    assert all(x["container_bytes_off"] == 0 and x["wrong_subpixels"] == 0
               for x in lines[:2])
    assert lines[3]["container_bytes_off"] > 0
    assert lines[3]["wrong_subpixels"] == 0  # a fault that still decodes


class _Events:
    """Stands in for ``llicti_torch.tracing.device_ms``'s readings."""

    def __init__(self, ms):
        self.ms = ms

    def device_ms(self):
        return self.ms


def outcome(units, gdn_work):
    trace = Trace([("conv", 30.0, 40.0)],
                  [("llicti.decompress", 0.0, 100.0),
                   ("llicti.gdn", 20.0, 50.0)], 0.0, 100.0, units)
    return Outcome(attempted=units, failed=0, setup_s=0.0, window={},
                   checks=[], memory_peak_bytes=0, trace=trace,
                   extra={"gdn_work": gdn_work})


def test_gdn_readers_read_hand_built_traces(monkeypatch):
    """Two traced units whose ``llicti.gdn`` spans took 3 + 5 ms of device
    time: 4 ms a unit; each unit's 67 GFLOP take 1 ms at 67 TFLOP/s, its
    1.675 GB 0.5 ms at 3.35 TB/s: 1 ms a unit, 25 % of the roofline."""
    from llicti_torch import tracing
    monkeypatch.setattr(tracing, "device_ms",
                        _Events({"llicti.gdn": [3.0, 5.0],
                                 "llicti.seq": [100.0]}).device_ms)
    o = outcome(2, [(67e9, 1.675e9), (67e9, 1.675e9)])
    assert reader("layer_metrics", "gdn_ms")(o) == pytest.approx(4.0)
    assert reader("layer_metrics", "gdn_roofline")(o) == pytest.approx(25.0)
    # memory-bound work: 6.7 GB a unit is 2 ms against 0.5 of operations
    o = outcome(2, [(33.5e9, 6.7e9), (33.5e9, 6.7e9)])
    assert reader("layer_metrics", "gdn_roofline")(o) == pytest.approx(50.0)


def test_gdn_readers_give_none_without_the_span(monkeypatch):
    """A program without ``llicti.gdn`` (a ReLU model, or the parent
    program), or a run without a trace or without ``gdn_work``: both
    readers give None and raise nothing."""
    from llicti_torch import tracing
    monkeypatch.setattr(tracing, "device_ms",
                        _Events({"llicti.seq": [1.0]}).device_ms)
    for o in (outcome(1, [(1e9, 1e6)]), outcome(1, [])):
        assert reader("layer_metrics", "gdn_ms")(o) is None
        assert reader("layer_metrics", "gdn_roofline")(o) is None
    o = outcome(1, [(1e9, 1e6)])
    o.trace = None
    assert reader("layer_metrics", "gdn_ms")(o) is None
    assert reader("layer_metrics", "gdn_roofline")(o) is None
    monkeypatch.setattr(tracing, "device_ms",
                        _Events({"llicti.gdn": [2.0]}).device_ms)
    assert reader("layer_metrics", "gdn_roofline")(outcome(1, [])) is None
