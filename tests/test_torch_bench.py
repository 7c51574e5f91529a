"""The port's benchmark (``bench_torch``) on the CPU: its traffic and gates
at a tiny configuration without timing, the gates failing on wrong
outputs, the percentile rule, the FLOP count, the kernels' work counts
against the recorded bounds, the printed metric names against the metric
table, its imports, and the command refusing to run without a card."""
import torch_helpers  # first: caps torch's threads
import ast
import io
import math
import re
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from bench_torch import codec_cell, gates, train_cell, work
from bench_torch.__main__ import main, report
from bench_torch.measure import NoClock, percentile
from bench_torch.metrics import CELLS, CODEC, METRICS, TRAIN, names
from llicti_torch import Codec, ModelConfig, synthetic_image
from llicti_torch import codec as cmod
from llicti_torch.config import DataConfig, LLICTIConfig, TrainConfig
from llicti_torch.models.llicti import LLICTIModel
from llicti_torch.ops.gmm import cdf_sampling_points
from llicti_torch.training import Trainer
from llicti_torch.weights import init_params, params_from_flax

ROOT = Path(__file__).resolve().parent.parent
TINY = ModelConfig(**torch_helpers.TINY)


def tiny_train_config(root) -> LLICTIConfig:
    return LLICTIConfig(
        model=TINY, experiments_root=str(root),
        train=TrainConfig(batch_size=2, patch_size=32, grad_acc_iters=2,
                          learning_rate=1e-3),
        data=DataConfig(synthetic=True))


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """Both cells at a tiny configuration on the CPU, untimed: ((set-up,
    metrics) of the codec cell, the same of the training cell)."""
    codec = codec_cell.run(
        42, NoClock, device="cpu", cfg=TINY, params=init_params(TINY, 0),
        h=32, w=48, lanes=16, trips=2, closure_calls=2, batch_trips_n=1,
        batch_k=2)
    cfg = tiny_train_config(tmp_path_factory.mktemp("exp"))
    return codec, train_cell.run(7, NoClock, device="cpu", cfg=cfg,
                                 steps=2, warmup=1, trainer_steps=2,
                                 pinned=2)


def test_cells_run_and_pass_their_gates_on_the_cpu(tiny_runs):
    """Both cells' traffic and gates at a tiny configuration, untimed: the
    containers lossless within the closure, the float32 train step within
    the float64 rule; every metric the table names is measured (NaN where
    it is a time)."""
    (_, m), (_, t) = tiny_runs
    assert sorted(m) == sorted(names(CODEC, False))
    assert 0 < m["bpsp"]["value"] < 24 and m["bpsp"]["n"] == 2
    assert all(abs(g) <= 100 * gates.CLOSURE
               for g in m["bpsp"]["closure_pct"])
    assert math.isnan(m["decode_ms"]["value"])
    assert m["decode_mfu"]["flops"] > 0
    assert sorted(t) == sorted(names(TRAIN, False))
    step = t["train_step_ms"]
    assert step["loss_rel_float64"] <= gates.LOSS_REL
    assert step["grad_l2_float64"] <= gates.GRAD_L2_BOUND
    assert step["update_l2_float64"] <= gates.UPDATE_L2_BOUND
    assert step["timed_loss_rel"] <= gates.TIMED_LOSS_REL
    assert step["timed_grad_l2"] <= gates.TIMED_GRAD_L2_BOUND
    assert step["timed_update_l2"] <= gates.TIMED_UPDATE_L2_BOUND
    assert step["adam_l2_own_gradients"] <= gates.ADAM_L2_BOUND
    assert t["trainer_step_ms"]["n"] == 2
    # 3 x the forward of 2 x 2 patches of 32^2
    model = params_from_flax(init_params(TINY, 0), TINY)
    assert t["train_mfu"]["flops_per_step"] == 3 * 4 * \
        codec_cell.forward_flops(model, 32, 32)


def test_gates_fail_on_a_flipped_byte_an_image_off_by_one_and_a_gap():
    codec = Codec(TINY, init_params(TINY, 0), device="cpu", num_lanes=16)
    img = synthetic_image(32, 48, seed=3)
    streams = codec.compress(img)
    gates.lossless(img, codec.decompress(streams), "intact")
    payload = bytearray(streams[1][0])
    payload[len(payload) // 2] ^= 0x5A
    bad = [streams[0], [bytes(payload)]]
    with pytest.raises(gates.GateFailed, match="differs"):
        gates.lossless(img, codec.decompress(bad), "flipped byte")
    off = img.copy()
    off[5, 7, 1] += 1
    with pytest.raises(gates.GateFailed, match="differs"):
        gates.lossless(off, codec.decompress(streams), "off by one")
    assert abs(gates.coder_closure([[1009]], [[1000.0]], "inside")) < 0.01
    for act in (1011, 989):
        with pytest.raises(gates.GateFailed, match="closure"):
            gates.coder_closure([[act]], [[1000.0]], "outside")


_ADAM_STEP = torch.optim.Adam.step
_FORWARD = LLICTIModel.forward


def _timed_only():
    """Whether the step runs at PyTorch's default flags, not under
    ``exact_math()`` (which makes cuDNN deterministic)."""
    return not torch.backends.cudnn.deterministic


def _no_update(self, closure=None):
    return None


def _mis_scaled(self, closure=None):  # the step at 1.01 x its lr
    for group in self.param_groups:
        group["lr"] *= 1.01
    try:
        return _ADAM_STEP(self)
    finally:
        for group in self.param_groups:
            group["lr"] /= 1.01


def _moments_lost(self, closure=None):  # each step starts Adam afresh
    self.state.clear()
    return _ADAM_STEP(self)


def _zeroed_band(self, x, halo=None):  # band 1 passes back no gradient
    out = []
    for si in _FORWARD(self, x, halo):
        w = si.shape[-1] // 3
        out.append(torch.cat((si[..., :w], si[..., w:2 * w].detach(),
                              si[..., 2 * w:]), dim=-1))
    return out


def _mis_scaled_timed(self, closure=None):
    return (_mis_scaled if _timed_only() else _ADAM_STEP)(self)


def _zeroed_band_timed(self, x, halo=None):
    return (_zeroed_band if _timed_only() else _FORWARD)(self, x, halo)


_ADAM, _MODEL = (torch.optim.Adam, "step"), (LLICTIModel, "forward")


@pytest.mark.parametrize("where,fault,half,what", [
    (_ADAM, _no_update, "(i)", "the update of"),
    (_ADAM, _mis_scaled, "(i)", "the update of"),
    (_ADAM, _moments_lost, "(i)", "the update of"),
    (_MODEL, _zeroed_band, "(i)", "the gradient of"),
    (_MODEL, _zeroed_band_timed, "(ii)", "the gradient of"),
    (_ADAM, _mis_scaled_timed, "(ii)", "Adam on its own gradients"),
], ids=["no_update", "mis_scaled", "moments_lost", "zeroed_band",
        "zeroed_band_timed_only", "mis_scaled_timed_only"])
def test_train_gate_fails_a_wrong_update(where, fault, half, what,
                                         monkeypatch, tmp_path):
    """The training cell's gate, in two halves: (i) the first timed
    step's code path run again under ``exact_math()`` from the same state,
    against the step in float64 and a plain Adam's update on its
    gradients; (ii) the timed step against (i)'s, and its update against
    a plain Adam's on its own gradients.  A step that leaves the weights
    unchanged, one at 1.01 x its learning rate, one that loses Adam's
    moments and one whose band 1 passes back no gradient each fail (i);
    a zeroed band and a 1.01 x lr that only the timed step (PyTorch's
    default flags) takes each fail (ii), the second only against Adam on
    the step's own gradients (TF32's noise hides 1 % from (i)'s step)."""
    monkeypatch.setattr(*where, fault)
    with pytest.raises(gates.GateFailed, match=re.escape(f"gate {half}")) \
            as err:
        train_cell.train_steps(tiny_train_config(tmp_path), 7, NoClock,
                               device="cpu", steps=1, warmup=3, pinned=2)
    assert what in str(err.value)


def test_percentile_needs_ten_samples_beyond_it():
    assert percentile(range(100), 0.9) == 89
    assert percentile(range(99), 0.9) is None
    assert percentile(range(40), 0.75) == 29
    assert percentile(range(39), 0.75) is None
    assert percentile([], 0.5) is None


def test_flop_count_is_the_trainers(tmp_path):
    """FlopCounterMode's count of the flagship at 128^2, as
    Trainer.flops_estimation gives it."""
    cfg = ModelConfig()
    model = params_from_flax(init_params(cfg, 0), cfg)
    flops = codec_cell.forward_flops(model, 128, 128)
    assert flops == 2_108_722_176
    tr = Trainer(LLICTIConfig(experiments_root=str(tmp_path)), device="cpu")
    assert tr.flops_estimation(128, 128) == flops


# The data-dependent counts of the flagship's 512x768 image (seed 42,
# trained weights, 1024 lanes), as chip_smoke.py printed them on an NVIDIA
# H100: Kernel 1's saturated normal terms of each colour slice of the
# finest band, the words Kernel 2 reads decoding its Y slice, the words of
# the 45-slice chain
SATURATED = (40_825_586, 27_527_234, 16_381_588)
Y_WORDS = 29_711
CHAIN_WORDS = 428_245


def test_work_counts_give_the_recorded_bounds():
    """The work counts at the flagship's shapes give PERF.md §6's bounds:
    Kernel 1 0.02355 ms (mean of the three slices), Kernel 2 0.00121 ms
    (the Y slice), Kernel 3 0.00333 ms (the chain)."""
    cfg = ModelConfig()
    img = synthetic_image(512, 768, seed=42)
    minmax, _ = cmod.host_header(img[None], cfg.dwtlevels)
    n = 256 * 384  # the finest band's coded pixels
    bounds = []
    for clr in range(3):
        P = cdf_sampling_points(*cmod.clr_range(clr, minmax)).shape[0]
        bounds.append(work.bound(*work.cdf_pmap_work(
            n, P, cmod.pmap_cdf_spec(cfg, 0, clr),
            cmod.sym_channel(cfg, 0, clr), SATURATED[clr], False))[0])
        if clr == 0:
            P0 = P
    assert round(sum(bounds) / 3, 5) == 0.02355
    assert round(work.bound(work.rans_decode_bytes(
        n, P0, Y_WORDS, 1024), 0)[0], 5) == 0.00121
    # every subpixel but the coarsest band's, which the header holds raw
    chain = 3 * (512 * 768 - (512 // 32) * (768 // 32))
    assert round(work.bound(work.rans_encode_bytes(
        chain, CHAIN_WORDS, 1024), 0)[0], 5) == 0.00333


def test_printed_metric_names_are_the_tables(tiny_runs):
    (setup, m), (_, t) = tiny_runs
    m = dict(m)
    out = io.StringIO()
    with redirect_stdout(out):
        report(CODEC, setup, m, False)
        report(TRAIN, {}, t, False)
    printed = re.findall(r"^\S+ metric (\S+) = ", out.getvalue(), re.M)
    assert sorted(printed) == sorted(METRICS)
    for cell in CELLS:
        assert set(names(cell, True)).isdisjoint(METRICS)
    del m["bpsp"]
    with pytest.raises(RuntimeError, match="table names"):
        report(CODEC, setup, m, False)


def test_command_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--cell", CODEC])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_bench_imports_no_jax_and_chip_smoke_counts_with_it():
    files = sorted((ROOT / "bench_torch").glob("*.py"))
    assert len(files) >= 7
    allowed = {"torch", "numpy", "llicti_torch"} | set(
        sys.stdlib_module_names)
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] in allowed, f"{path}: imports {mod}"
    # one definition of the work counts: chip_smoke.py imports them
    smoke = ast.parse((ROOT / "chip_smoke.py").read_text())
    defined = {n.name for n in ast.walk(smoke)
               if isinstance(n, ast.FunctionDef)}
    defined |= {t.id for n in ast.walk(smoke) if isinstance(n, ast.Assign)
                for target in n.targets for t in ast.walk(target)
                if isinstance(t, ast.Name)}
    assert not defined & {"bound", "term_ops", "HBM_BYTES_PER_S",
                          "F32_FLOP_PER_S", "NORMAL_OPS", "ENTRY_OPS",
                          "GRAD_L2_BOUND"}
    assert "bench_torch.work" in set(_imports(ROOT / "chip_smoke.py"))
