"""Runs of tiny cells on the CPU through the command's own path (every
step of a run but the look for a card): the last line's keys, a cell
added from data files alone, and ``correct`` false under each fault the
cells can have."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from conftest import TINY, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_tiny_cell_prints_the_contract_keys(tiny_bench, cell, capsys):
    out = run_cell(cell)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    assert list(out) == KEYS  # "checks" last
    assert set(out["device"]) == DEVICE_KEYS
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0 and "setup_s" in out["metrics"]
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())


def test_traced_run_prints_per_layer_metrics(tiny_bench):
    out = run_cell("tiny_B.train_step", trace=1)
    assert list(out) == KEYS[:5] + ["breakdown", "missing", "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "train_mfu" in out["metrics"] and "setup_s" not in out["metrics"]
    assert out["correct"] is True


def test_traced_run_names_a_metric_its_reader_missed(tiny_bench,
                                                     monkeypatch, capsys):
    """A per-layer metric the cell lists whose reader finds nothing (here
    the host header's) is left out of ``metrics`` and named under
    ``missing`` and on standard error."""
    from llbench import run
    reader = run.reader
    monkeypatch.setattr(run, "reader", lambda kind, name: (
        (lambda o: None) if name == "host_header_ms" else reader(kind, name)))
    out = run_cell("tiny_A.codec_single", trace=1)
    assert "host_header_ms" not in out["metrics"]
    assert "host_header_ms" in out["missing"]  # on the CPU: the kernels' too
    listed = [m["name"] for m in run.cell_metrics(
        run.load_json(tiny_bench, "BENCHMARK.json"), "tiny_A.codec_single",
        True)]
    assert sorted(out["missing"] + list(out["metrics"])) == sorted(listed)
    assert "missing host_header_ms" in capsys.readouterr().err


@pytest.mark.parametrize("name,conv", [
    ("void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1, "
     "false, false, true>(int, int)", True),
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_"
     "tilesize256x64x8_execute_kernel__5x_cudnn", True),
    ("sm80_xmma_dgrad_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_"
     "execute_kernel__5x_cudnn", True),
    ("_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemm"
     "ConvolutionE", True),
    ("void cudnn::cnn::wgrad_alg0_engine<float, 128, 6, 7, 3, 3, 5, false, "
     "512>(int)", True),
    ("void cutlass__5x_cudnn::Kernel<cutlass__5x_cudnn::reduction::kernel::"
     "ReduceSplitK<cutlass__5x_cudnn::MatrixShape<4, 128>>>(Params)", True),
    ("void tensorTransformGeneric<float, float, float, true, false, false, "
     "(cudnnKernelDataType_t)0>(cudnnTensorTransformStruct)", False),
    ("void nchwAddPaddingKernel<float, float, float, true, "
     "(cudnnKernelDataType_t)0>(int, int)", False),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32_cublas",
     False),
    ("ampere_sgemm_128x64_nn", False),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_32x6_nn_"
     "align4>(Params)", False),
    ("void cudnn::engines_precompiled::genericTranspose_kernel<float, float, "
     "float, true, (cudnnKernelDataType_t)0>(float)", False),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)",
     False),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>>(int)", False),
])
def test_conv_group_takes_cudnns_convolutions_and_no_gemm(name, conv):
    from llbench import readers
    from llbench.trace import Trace
    t = Trace([(name, 0.0, 10.0)], [], 0.0, 20.0, 1)
    assert (t.group_s(readers.CONV, readers.NOT_CONV)[1] == 1) is conv


# ---- faults planted in the program under a run -------------------------------

def flip_byte(monkeypatch):
    """A container altered where it is produced: one byte of the rANS
    stream flipped."""
    from llicti_torch import codec as cmod
    compress, batch = cmod.Codec.compress, cmod.Codec.compress_batch

    def altered(streams):
        blob = bytearray(streams[1][0])
        blob[-1] ^= 0x01
        return [streams[0], [bytes(blob)]] + streams[2:]

    monkeypatch.setattr(cmod.Codec, "compress",
                        lambda self, rgb: altered(compress(self, rgb)))
    monkeypatch.setattr(cmod.Codec, "compress_batch",
                        lambda self, imgs: altered(batch(self, imgs)))


def alter_pixel(monkeypatch):
    """A decoded image altered where it is produced: one subpixel off."""
    from llicti_torch import codec as cmod
    decompress, batch = cmod.Codec.decompress, cmod.Codec.decompress_batch

    def off(img):
        img = np.array(img)
        img.reshape(-1)[0] ^= 1
        return img

    monkeypatch.setattr(cmod.Codec, "decompress",
                        lambda self, s, *a, **k: off(decompress(self, s)))
    monkeypatch.setattr(cmod.Codec, "decompress_batch",
                        lambda self, s: [off(x) for x in batch(self, s)])


def state_unchanged(monkeypatch):
    """A step that returns its state unchanged: Adam's step skipped."""
    from llicti_torch.training import steps
    monkeypatch.setattr(steps, "apply_gradients", lambda opt, clip=5.0: None)


def half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from llicti_torch.training import steps
    accumulate = steps.accumulate

    def half(model, batch, numel, halo=None):
        part = batch[:, :batch.shape[1] // 2]
        return accumulate(model, part, part[0].numel(), halo)

    monkeypatch.setattr(steps, "accumulate", half)


@pytest.mark.parametrize("cell,fault", [
    ("tiny_A.codec_single", flip_byte), ("tiny_A.codec_single", alter_pixel),
    ("tiny_A.codec_batch2", flip_byte), ("tiny_A.codec_batch2", alter_pixel),
    ("tiny_B.train_step", state_unchanged), ("tiny_B.train_step", half_batch),
], ids=lambda v: getattr(v, "__name__", v))
def test_fault_is_not_correct(tiny_bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = run_cell(cell)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_dp_without_the_exchange_is_not_correct(tiny_bench, monkeypatch,
                                                tmp_path):
    """The exchange between cards left out, on every rank: rank 0 here,
    the others through a ``sitecustomize`` on their path."""
    from llicti_torch.parallel import train
    fault = "lambda t, group=None: t"
    site = tmp_path / "fault"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "import llicti_torch.parallel.train as train\n"
        f"train.all_reduce_sum = {fault}\n")
    monkeypatch.setenv("PYTHONPATH", f"{site}:{os.environ['PYTHONPATH']}")
    monkeypatch.setattr(train, "all_reduce_sum", eval(fault))
    out = run_cell("tiny_B.train_dp4")
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_jax_in_another_rank_leaves_no_result(tiny_bench, monkeypatch,
                                              tmp_path, capfd):
    """JAX loaded in a rank other than rank 0 (through a
    ``sitecustomize`` on the other ranks' path): that rank exits non-zero,
    and rank 0 prints no result."""
    site = tmp_path / "jax"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "import sys, types\nsys.modules['jax'] = types.ModuleType('jax')\n")
    monkeypatch.setenv("PYTHONPATH", f"{site}:{os.environ['PYTHONPATH']}")
    with pytest.raises(RuntimeError, match="a rank exited with"):
        run_cell("tiny_B.train_dp4")
    out, err = capfd.readouterr()
    assert out == ""
    assert "rank 1 loaded jax" in err and "rank 0 loaded" not in err


def test_controls_read_a_cell_of_several_ranks(tiny_bench, capsys):
    """``llbench.controls`` runs the program of a multi-card cell on its
    ranks and reads every number of the comparison, the compared ones
    under their limits."""
    from llbench import controls
    controls.main(["--workload", "tiny_B.train_dp4", "--seeds",
                   str(2 ** 31 + 5), "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["side"] for x in lines] == ["program"]
    limits = json.load(open(os.path.join(
        tiny_bench, "llbench", "workloads", "tiny_B.train_dp4.json")))["limits"]
    assert {"loss_gap", "grad_norm_gap", "update_norm_gap"} <= set(lines[0])
    assert all(lines[0][k] <= v for k, v in limits.items())


def test_no_card_exits_without_a_result(capsys):
    """Without the cards a cell asks for, the command exits non-zero and
    prints no result."""
    from llbench import run
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as exit_:
        run.main(["--workload", "llicti_A.codec_single", "--seed", "1",
                  "--seconds", "1", "--trace", "0"])
    assert exit_.value.code != 0
    assert capsys.readouterr().out == ""
