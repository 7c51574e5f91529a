"""The clr_joint_mode 1 cell (``llicti_A_clrjnt1.codec_batch8``) and the
row-sharded cell (``llicti_A.codec_sharded_g4_4chip``): their references
run with the program and JAX blocked, tiny copies of the cells run
correct and traced through the command's own path (the sharded one on
four CPU ranks) and fail on a flipped byte, the Kernel 1 work counts of
the existing cells do not move, and the readers of the ten-term Kernel 1
launches and of ``llicti.halo`` read hand-built traces, or nothing."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, load, run_cell
from llbench import work
from llbench.cell import Outcome
from llbench.run import reader
from llbench.trace import Trace

CELL = "llicti_A_clrjnt1.codec_batch8"
SHARDED = "llicti_A.codec_sharded_g4_4chip"
TINY_J1 = "tiny_A_clrjnt1.codec_batch2"
TINY_SP = "tiny_A.codec_sharded_g4"
# the cell's widths but chs 8 and two scales: seconds on the CPU
TINY_MODEL = {"chs": [8, 1], "dwtlevels": [0, 1], "evens": [4, 4],
              "odds": [3, 3], "useprevlevNN": [False, True]}
TINY_PARAMS = {"height": 40, "width": 64, "lanes": 16, "batch": 2,
               "pool": 4, "sample": 2, "traced": 1}
# the trained flagship's model at two scales (its one interpolator, which
# every scale shares) on a 64 x 64 image: 16 rows a rank
TINY_SP_MODEL = {"chs": [88, 1], "dwtlevels": [0, 1], "evens": [4, 4],
                 "odds": [3, 3], "useprevlevNN": [False, True]}
TINY_SP_PARAMS = {"height": 64, "width": 64, "lanes": 8, "pool": 2,
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

import torch
from llbench.data import synthetic_images, trained_weights
from llbench.reference import clrjnt1, codec, model, sharded

keys = json.load(open("llbench/configs/llicti_A_clrjnt1.json"))["model"]
assert clrjnt1.forward_flops(keys, 512, 768) == 83_703_595_008
keys.update(%r)
cfg = clrjnt1.Clrjnt1Config(keys)
net = clrjnt1.build(cfg, model.from_flax(clrjnt1.seeded_weights(cfg, 0)),
                    "cpu")
imgs = list(synthetic_images(2, 24, 32, 3, "cpu").numpy())
out = clrjnt1.Clrjnt1Encoder(net, 8, "cpu").encode_batch(imgs)
assert len(out["slices"]) == 18 and out["words"].shape == (2, 18)
assert [s[2][0] for s in out["slices"][:3]] == [10, 5, 5]
a = json.load(open("llbench/configs/llicti_A.json"))
flagship = model.build(model.Config(a["model"]),
                       model.from_flax(trained_weights(a["weights"])), "cpu")
img = synthetic_images(1, 128, 64, 3, "cpu").numpy()[0]
out = sharded.encode(flagship, img, 4, 8, "cpu", blocks=2)
assert len(out["streams"][1]) == 4 and out["words"].shape == (4, 45)
with codec.float32_math():
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("OK")
"""


def test_references_run_without_the_program_and_jax():
    """The clr_joint_mode 1 reference (its FLOP count at 512 x 768, 83.70
    GFLOP; Y's slices at ten terms, Co's and Cg's at five) and the sharded
    one, in a process that refuses JAX, the JAX package and the program;
    their encoders run under TF32 off."""
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_CHILD % (TINY_MODEL,)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


def _add_cell(root, cell, tiny, config, model, params):
    """A tiny copy of ``cell`` in the benchmark's copy at ``root``: its
    configuration (``config`` of the cell's, ``model`` keys changed) and
    workload files and its entries, with the cell's metrics."""
    wl = load("llbench", "workloads", cell + ".json")
    cfg = load("llbench", "configs", wl["config"] + ".json")
    cfg["name"] = config
    cfg["model"].update(model)
    wl["config"] = config
    wl["params"].update(params)
    for path, obj in ((("configs", config + ".json"), cfg),
                      (("workloads", tiny + ".json"), wl)):
        with open(os.path.join(root, "llbench", *path), "w") as f:
            json.dump(obj, f)
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["workloads"].append(dict(
        next(w for w in bench["workloads"] if w["name"] == cell),
        name=tiny, config=config))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if cell in m.get("workloads", []):
            m["workloads"].append(tiny)
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    return tiny


@pytest.fixture
def tiny_j1(tiny_bench):
    return _add_cell(tiny_bench, CELL, TINY_J1, "tiny_A_clrjnt1", TINY_MODEL,
                     TINY_PARAMS)


@pytest.fixture
def tiny_sp(tiny_bench, monkeypatch):
    """The tiny sharded cell, each of its four CPU ranks on one thread."""
    import torch
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield _add_cell(tiny_bench, SHARDED, TINY_SP, "tiny_A_sp", TINY_SP_MODEL,
                    TINY_SP_PARAMS)
    torch.set_num_threads(threads)


def test_tiny_clrjnt1_cell_is_correct_and_traced(tiny_j1):
    """Untraced: correct, with the cell's end-to-end metrics; traced:
    correct, the codec's span metrics read; on the CPU no kernel launches,
    so the ten-term Kernel 1 metrics are missing."""
    out = run_cell(tiny_j1, seconds=5.0)
    assert out["correct"] is True and out["failed"] == 0
    assert {"mpix_s", "bpsp", "setup_s"} == set(out["metrics"])
    traced = run_cell(tiny_j1, seconds=5.0, trace=1)
    assert traced["correct"] is True
    assert {"kernel1_m10_ms", "kernel1_m10_roofline"} <= set(
        traced["missing"])
    assert traced["metrics"]["codec_mfu"]["value"] > 0
    assert traced["metrics"]["enqueue_idle_ms"]["value"] > 0


def test_tiny_clrjnt1_cell_with_a_flipped_byte_is_not_correct(tiny_j1,
                                                              monkeypatch):
    from llicti_torch import codec as cmod
    compress_batch = cmod.Codec.compress_batch

    def altered(self, imgs):
        streams = compress_batch(self, imgs)
        blob = bytearray(streams[1][0])
        blob[-1] ^= 0x01
        return [streams[0], [bytes(blob)]] + streams[2:]

    monkeypatch.setattr(cmod.Codec, "compress_batch", altered)
    out = run_cell(tiny_j1, seconds=5.0)
    assert out["correct"] is False
    assert out["checks"]["container_bytes_off"]["value"] > 0


def test_tiny_sharded_cell_on_four_ranks_is_correct_and_traced(tiny_sp):
    """Four CPU ranks (gloo), one 32-row block each: correct untraced and
    traced, the halo span read on rank 0, the memory the worst rank's."""
    out = run_cell(tiny_sp, seconds=2.0)
    assert out["correct"] is True and out["failed"] == 0
    assert out["device"]["count"] == 4
    assert {"mpix_s", "bpsp", "setup_s"} == set(out["metrics"])
    traced = run_cell(tiny_sp, seconds=2.0, trace=1)
    assert traced["correct"] is True
    assert traced["metrics"]["halo_ms"]["value"] > 0
    assert traced["metrics"]["enqueue_idle_ms"]["value"] > 0


def test_tiny_sharded_cell_with_a_flipped_byte_is_not_correct(tiny_sp,
                                                              monkeypatch):
    """A flipped last byte of shard 0's stream, on every rank: the
    container is off the reference's by one byte (the decode of the
    altered stream is not compared)."""
    from llicti_torch.parallel import codec_sp
    compress = codec_sp.ShardedCodec.compress

    def altered(self, rgb):
        streams = compress(self, rgb)
        blob = bytearray(streams[1][0])
        blob[-1] ^= 0x01
        return [streams[0], [bytes(blob)] + streams[1][1:]]

    monkeypatch.setattr(codec_sp.ShardedCodec, "compress", altered)
    out = run_cell(tiny_sp, seconds=2.0)
    assert out["correct"] is False
    assert out["checks"]["container_bytes_off"]["value"] > 0


def test_clrjnt1_controls_read_the_tiny_cell(tiny_j1, capsys):
    """``llbench.clrjnt1_controls`` reads the program against the reference
    on every pool batch, then the TF32 control (on the CPU TF32 changes
    nothing: the card's readings are in PERF.md) and the fault of Y coded
    with M terms, which changes the container."""
    from llbench import clrjnt1_controls
    clrjnt1_controls.main(["--workload", tiny_j1, "--control-seeds", "5",
                           "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["side"] for x in lines] == (["program"] * 2 + [
        "control_tf32", "fault_y_m_terms"])
    assert all(x["container_bytes_off"] == 0 and x["wrong_subpixels"] == 0
               for x in lines[:2])
    assert lines[3]["container_bytes_off"] > 0


def test_sharded_controls_read_the_tiny_cell(tiny_sp, capsys):
    """``llbench.sharded_controls``: one process holding the G = 4 shards
    against the reference in one block on both pool images, then the TF32
    control (nothing on the CPU)."""
    from llbench import sharded_controls
    sharded_controls.main(["--workload", tiny_sp, "--control-seeds", "5",
                           "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["side"] for x in lines] == ["program"] * 2 + ["control_tf32"]
    assert all(x["container_bytes_off"] == 0 and x["wrong_subpixels"] == 0
               for x in lines[:2])


def test_kernel1_counts_of_the_existing_cells_do_not_move():
    """``work.cdf_work`` of llicti_A's three colours at the finest band of
    a 512 x 768 image (P 256, 160 saturated terms): the numbers every
    existing cell's ``kernel1_roofline`` divides by; and the ten-term
    share of llicti_A's slices is nothing."""
    from llbench.traffic.codec_seeded_clrjnt1 import terms_work
    M, c = 5, 3
    rows, P, sat = 256 * 384, 256, 160
    got = [work.cdf_work(rows, P, (M, clr * M, (3 + clr) * M,
                                   (6 + clr) * M, upd), c + clr, sat)
           for clr, upd in enumerate(((), ((9 * M, c),),
                                      ((10 * M, c), (11 * M, c + 1))))]
    assert got == [(107_742_208, 3_095_393_152),
                   (110_101_504, 3_095_393_152),
                   (112_460_800, 3_095_393_152)]
    spec = (M, 0, 3 * M, 6 * M, ())
    ref = {"slices": [(rows, P, spec, c, sat)] * 9}
    assert terms_work(ref, 10) == 0
    assert terms_work(ref, 5) == pytest.approx(
        18 * work.bound_s(*work.cdf_work(rows, P, spec, c, sat)))


def outcome(kernels, work_m10, host=()):
    trace = Trace(kernels, [("llicti.decompress", 0.0, 1e5)] + list(host),
                  0.0, 1e5, 2)  # microseconds
    return Outcome(attempted=2, failed=0, setup_s=0.0, window={}, checks=[],
                   memory_peak_bytes=0, trace=trace,
                   extra={"work_m10": work_m10})


K10 = "void llicti::cdf_pmap_kernel<false, 10>(llicti::PmapArgs)"
K5 = "void llicti::cdf_pmap_kernel<false, 5>(llicti::PmapArgs)"


def test_ten_term_readers_read_hand_built_traces():
    """Two units whose 10-term launches took 3 + 5 ms (the 5-term launch
    left out): 4 ms a unit; their least time 2 ms: 25 %."""
    o = outcome([(K10, 0.0, 3000.0), (K5, 3000.0, 9000.0),
                 (K10, 10000.0, 15000.0)], [1e-3, 1e-3])
    assert reader("layer_metrics", "kernel1_m10_ms")(o) == pytest.approx(4.0)
    assert reader("layer_metrics", "kernel1_m10_roofline")(
        o) == pytest.approx(25.0)


def test_ten_term_readers_give_none_without_the_launches():
    """A trace of 5-term launches alone, a run without work counts or
    without a trace: None, and nothing raised."""
    o = outcome([(K5, 0.0, 3000.0)], [1e-3])
    assert reader("layer_metrics", "kernel1_m10_ms")(o) is None
    assert reader("layer_metrics", "kernel1_m10_roofline")(o) is None
    o = outcome([(K10, 0.0, 3000.0)], [])
    assert reader("layer_metrics", "kernel1_m10_roofline")(o) is None
    o.trace = None
    assert reader("layer_metrics", "kernel1_m10_ms")(o) is None
    assert reader("layer_metrics", "kernel1_m10_roofline")(o) is None


def test_halo_reader_reads_the_span_or_nothing():
    """Host ms a unit inside ``llicti.halo`` (6 ms over 2 units); None
    without the span (the parent program) or without a trace."""
    o = outcome([], [], [("llicti.halo", 10000.0, 12000.0),
                         ("llicti.halo", 50000.0, 54000.0)])
    assert reader("layer_metrics", "halo_ms")(o) == pytest.approx(3.0)
    o = outcome([], [])
    assert reader("layer_metrics", "halo_ms")(o) is None
    o.trace = None
    assert reader("layer_metrics", "halo_ms")(o) is None
