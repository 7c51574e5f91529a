"""The port's on-card tools on the CPU: the FLOP count, the kernels' work
counts against the recorded bounds, one definition of what the tools
share (the float64 reference step, its bound and the work counts), and
the profiling tool's kernel groups against the program's real kernel
names."""
import torch_helpers  # first: caps torch's threads
import ast
import importlib.util
from pathlib import Path

import pytest

from llbench import work
from llicti_torch import ModelConfig, synthetic_image
from llicti_torch import codec as cmod
from llicti_torch.config import LLICTIConfig
from llicti_torch.ops.gmm import cdf_sampling_points
from llicti_torch.training import Trainer

ROOT = Path(__file__).resolve().parent.parent


def test_flop_count_is_the_trainers(tmp_path):
    """FlopCounterMode's count of the flagship's forward at 128^2, as
    Trainer.flops_estimation gives it."""
    tr = Trainer(LLICTIConfig(experiments_root=str(tmp_path)), device="cpu")
    assert tr.flops_estimation(128, 128) == 2_108_722_176


# The data-dependent counts of the flagship's 512x768 image (seed 42,
# trained weights, 1024 lanes), as chip_smoke.py printed them on an NVIDIA
# H100: Kernel 1's saturated normal terms of each colour slice of the
# finest band, the words Kernel 2 reads decoding its Y slice, the words of
# the 45-slice chain
SATURATED = (40_825_586, 27_527_234, 16_381_588)
Y_WORDS = 29_711
CHAIN_WORDS = 428_245


def bound_ms(nbytes, flops=0):
    return round(1e3 * work.bound_s(nbytes, flops), 5)


def test_work_counts_give_the_recorded_bounds():
    """The work counts (``llbench/work.py``) at the flagship's shapes give
    PERF.md §6's bounds: Kernel 1 0.02355 ms (mean of the three slices),
    Kernel 2 0.00121 ms (the Y slice), Kernel 3 0.00333 ms (the chain)."""
    cfg = ModelConfig()
    img = synthetic_image(512, 768, seed=42)
    minmax, _ = cmod.host_header(img[None], cfg.dwtlevels)
    n = 256 * 384  # the finest band's coded pixels
    Ps = [cdf_sampling_points(*cmod.clr_range(clr, minmax)).shape[0]
          for clr in range(3)]
    bounds = [1e3 * work.bound_s(*work.cdf_work(
        n, P, cmod.pmap_cdf_spec(cfg, 0, clr), cmod.sym_channel(cfg, 0, clr),
        SATURATED[clr])) for clr, P in enumerate(Ps)]
    assert round(sum(bounds) / 3, 5) == 0.02355
    assert bound_ms(work.rans_decode_bytes(n, Ps[0], Y_WORDS, 1024)) \
        == 0.00121
    # every subpixel but the coarsest band's, which the header holds raw
    chain = 3 * (512 * 768 - (512 // 32) * (768 // 32))
    assert bound_ms(work.rans_encode_bytes(chain, CHAIN_WORDS, 1024)) \
        == 0.00333


def _imports(path: Path):
    """(module, names) of each absolute import in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from ((a.name, ()) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, tuple(a.name for a in node.names)


def test_one_definition_of_what_the_tools_share():
    """chip_smoke.py defines no float64 step, no gradient bound and none
    of the work counts: it imports the step and its bound from
    ``llicti_torch.parallel.dryrun`` and the counts from
    ``llbench.work``.  Nothing outside ``experiments/`` imports the
    retired ``bench_torch``."""
    smoke = ROOT / "chip_smoke.py"
    tree = ast.parse(smoke.read_text())
    defined = {n.name for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef)}
    defined |= {t.id for n in ast.walk(tree) if isinstance(n, ast.Assign)
                for target in n.targets for t in ast.walk(target)
                if isinstance(t, ast.Name)}
    imported = dict(_imports(smoke))
    from_work = set(imported["llbench.work"])
    assert {"HBM_BYTES_PER_S", "F32_FLOP_PER_S", "NORMAL_OPS",
            "NORMAL_SAT_OPS", "ENTRY_OPS", "cdf_work", "rans_decode_bytes",
            "rans_encode_bytes", "bound_s"} <= from_work
    assert not defined & (from_work | {
        "float64_step", "float64_grads", "FLOAT64_GRAD_REL_L2",
        "GRAD_L2_BOUND", "cdf_pmap_work", "STATE_BYTES"})
    assert {"float64_step", "FLOAT64_GRAD_REL_L2"} <= set(
        imported["llicti_torch.parallel.dryrun"])
    assert not (ROOT / "bench_torch").exists()
    skip = {ROOT / d for d in ("experiments", ".git")}
    for path in ROOT.rglob("*.py"):
        if skip.isdisjoint(path.parents):
            assert not any(mod.split(".")[0] == "bench_torch"
                           for mod, _ in _imports(path)), path


@pytest.fixture(scope="module")
def profile_tool():
    """``tools/profile_torch_codec.py`` as a module."""
    path = ROOT / "tools" / "profile_torch_codec.py"
    spec = importlib.util.spec_from_file_location("profile_torch_codec",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,group", [
    ("void llicti::cdf_pmap_kernel<false, 5>(llicti::PmapArgs)", "kernel1"),
    ("(anonymous namespace)::rans_decode_kernel(int const*, int const*, "
     "long long, long long, long long*, int const*, int*)", "kernel2"),
    ("(anonymous namespace)::rans_decode_wide_kernel(int const*, int "
     "const*, long long, long long, long long*, int const*, int*)",
     "kernel2"),
    ("(anonymous namespace)::rans_encode_lanes_kernel(int const*, int "
     "const*, ChainPlan, long long, int, unsigned int*, unsigned int*)",
     "kernel3"),
    ("(anonymous namespace)::rans_encode_place_kernel(int*, ChainPlan, "
     "long long, int, int*, int*)", "kernel3"),
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_"
     "tilesize32x32x8_stage3_warpsize1x2x1_g1_ffma_aligna4_alignc4", "conv"),
    ("void wgrad_alg0_engine_NHWC<float, 128, 5, 5, 3, 3, 3, false, 512>"
     "(int, int, int, float const*, int, float*, float const*, "
     "kernel_grad_params, unsigned long long, int, float, int, int, int, "
     "int)", "conv"),
    ("void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1, "
     "false, false, true>(int, int, int, float const*, int, float*, float "
     "const*, kernel_conv_params, unsigned long long, int, float, float, "
     "int, float const*, float const*, bool, int, int)", "conv"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, "
     "float, true, false, (cudnnKernelDataType_t)0>(cudnn::engines_"
     "precompiled::nchw2nhwc_params_t<float>, float const*, float*)",
     "transpose"),
    ("void cudnn::engines_precompiled::nhwcToNchwKernel<float, float, "
     "float, true, false, (cudnnKernelDataType_t)0>(cudnn::engines_"
     "precompiled::nhwc2nchw_params_t<float>, float const*, float*)",
     "transpose"),
    ("void genericTranspose_kernel<float, float>(cudnnTensorStruct, float "
     "const*, cudnnTensorStruct, float*, float, float)", "transpose"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage"
     "<4096ul>)", "nccl"),
    ("ampere_sgemm_128x64_nn", "other"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul>)", "other"),
], ids=["cdf_pmap", "rans_decode", "rans_decode_wide", "rans_encode_lanes",
        "rans_encode_place", "xmma_fprop_nchw", "wgrad_nhwc",
        "implicit_convolve_sgemm", "nchw_to_nhwc", "nhwc_to_nchw",
        "generic_transpose", "nccl_all_reduce", "cublas_sgemm",
        "elementwise"])
def test_profile_tool_files_kernels_under_the_benchmarks_groups(
        name, group, profile_tool):
    """``tools/profile_torch_codec.py`` files each of the program's kernels
    under the group the benchmark reads it in (``llbench/readers.py``):
    the wide decode under Kernel 2, cuDNN's NHWC engines under the convs,
    its NCHW <-> NHWC changes under the transposes, cuBLAS under none."""
    assert profile_tool.group_of(name) == group
