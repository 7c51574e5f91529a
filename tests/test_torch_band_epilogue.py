"""The band epilogue (``ops/band_epilogue.py``) on the CPU: its plain
version bit-equal to the chain of PyTorch passes it replaces (each conv's
bias add, layer 0's unit sums, ReLU's clamp, the NHWC copy:
``unfused_passes``, which ``chip_smoke.py`` also times on the card) in
each layout the interpolator gives it; the interpolator's fused path (no
gradient, NCHW convs) bit-equal to its module path under autograd; a
training step that never enters it; and a CPU codec that runs the plain
version, 3 calls a band net, and launches no kernel."""
import torch_helpers  # noqa: F401  (first: caps torch's threads)

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from llicti_torch import Codec, ModelConfig
from llicti_torch.data.dataset import synthetic_image
from llicti_torch.models import interpolator
from llicti_torch.ops import band_epilogue as band_epilogue_module
from llicti_torch.ops.band_epilogue import (_pixels_contiguous,
                                            band_epilogue,
                                            band_epilogue_plain,
                                            unfused_passes)
from llicti_torch.training import steps
from llicti_torch.weights import init_params, params_from_flax

SPECIALS = (-0.0, 0.0, float("inf"), float("-inf"), float("nan"))


def with_specials(gen, shape):
    """Normal float32 values with -0.0, +0.0, +-inf and NaN strewn in."""
    t = torch.randn(shape, generator=gen)
    flat = t.view(-1)
    where = torch.randperm(flat.numel(), generator=gen)[:5 * len(SPECIALS)]
    for i, j in enumerate(where.tolist()):
        flat[j] = SPECIALS[i % len(SPECIALS)]
    return t


@pytest.mark.parametrize("layout", ["k1", "channel_major", "nhwc"])
@pytest.mark.parametrize("relu", [False, True], ids=["identity", "relu"])
@pytest.mark.parametrize("U", [1, 2, 3])
def test_plain_version_equals_the_passes_it_replaces(U, relu, layout):
    gen = torch.Generator().manual_seed(100 * U + 10 * relu + len(layout))
    K, C, h, w = (1, 12, 9, 14) if layout == "k1" else (3, 12, 9, 14)
    maps = [with_specials(gen, (K, C, h, w)) for _ in range(U)]
    biases = [with_specials(gen, (C,)) for _ in range(U)]
    want = unfused_passes(maps, biases, relu, layout)
    if layout == "nhwc":
        got = band_epilogue(maps, biases, relu=relu, nhwc=True)
        assert got.shape == (K, h, w, C) and got.is_contiguous()
    elif layout == "channel_major":
        buf = torch.empty((C, K, h, w))
        got = band_epilogue(maps, biases, relu=relu,
                            out=buf.transpose(0, 1))
        assert got.data_ptr() == buf.data_ptr()
    else:  # in place, into the first map
        keep = [m.clone() for m in maps]
        got = band_epilogue(maps, biases, relu=relu, out=maps[0])
        assert got.data_ptr() == maps[0].data_ptr()
        maps = keep
    assert torch.equal(got.reshape(-1).view(torch.int32),
                       want.reshape(-1).view(torch.int32))
    # the wrapper on CPU tensors is its plain version, and counts nothing
    assert band_epilogue.launches == 0
    plain = band_epilogue_plain(maps, biases, relu=relu,
                                nhwc=layout == "nhwc")
    assert torch.equal(plain.reshape(-1).view(torch.int32),
                       want.reshape(-1).view(torch.int32))


def test_a_map_without_bias_is_taken_as_it_is(calls):
    x = torch.tensor([-0.0, 1.5, float("nan")]).view(1, 3, 1, 1)
    got = band_epilogue([x, x], [None, None])
    assert torch.equal(got.view(-1).view(torch.int32),
                       (x + x).view(-1).view(torch.int32))
    assert str(float(band_epilogue([x], [None]).view(-1)[0])) == "-0.0"
    assert calls["calls"] == 2
    # written onto itself with nothing to add: left as it is, no pass
    assert band_epilogue([x], [None], out=x) is x and calls["calls"] == 2


def test_layout_and_argument_checks():
    x = torch.zeros(2, 4, 3, 5)
    assert _pixels_contiguous(x)
    assert _pixels_contiguous(torch.zeros(4, 2, 3, 5).transpose(0, 1))
    assert not _pixels_contiguous(x.contiguous(
        memory_format=torch.channels_last))
    assert _pixels_contiguous(torch.zeros(2, 4, 7, 1))
    with pytest.raises(ValueError, match="1 to 3 maps"):
        band_epilogue([x] * 4, [None] * 4)
    with pytest.raises(ValueError, match="bias of shape"):
        band_epilogue([x], [torch.zeros(3)])
    with pytest.raises(ValueError, match="maps of shapes"):
        band_epilogue([x, torch.zeros(2, 4, 3, 4)], [None, None])
    with pytest.raises(ValueError, match="writes a new tensor"):
        band_epilogue([x], [None], out=x, nhwc=True)


def tiny_cfg(act="ReLU", seq=False, **kw):
    extra = dict(clr_joint_mode=0, clrjnt0seqmd=True) if seq else {}
    return ModelConfig(chs=(8, 8), evens=(4, 4), odds=(3, 3),
                       dwtlevels=(0, 1), useprevlevNN=(False, True),
                       activfun=act, **extra, **kw)


def tiny_model(cfg):
    """Random weights, and biases drawn anew so that every add counts."""
    model = params_from_flax(init_params(cfg, 5), cfg)
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model


@pytest.fixture
def calls(monkeypatch):
    """The runs of the band epilogue's plain version (a launch on the
    card)."""
    n = {"calls": 0}

    def counted(*args, **kwargs):
        n["calls"] += 1
        return band_epilogue_plain(*args, **kwargs)

    monkeypatch.setattr(band_epilogue_module, "band_epilogue_plain", counted)
    return n


def replicate_halo(t, top, bottom):
    """One rank's halo of a whole image: its own edge rows repeated."""
    return F.pad(t.permute(0, 3, 1, 2), (0, 0, top, bottom),
                 mode="replicate").permute(0, 2, 3, 1)


@pytest.mark.parametrize("act", ["ReLU", "PReLU", "GDN1"])
@pytest.mark.parametrize("seq", [False, True], ids=["joint", "seq"])
def test_fused_path_equals_the_module_path_under_autograd(act, seq, calls):
    cfg = tiny_cfg(act, seq)
    model = tiny_model(cfg)
    c = cfg.cond_channels
    gen = torch.Generator().manual_seed(3)
    y = torch.rand((2, 13, 19, 4 * c), generator=gen)
    for b in range(3):
        net = model._band_model(0, b)
        y_cond, y_pred = y[..., :c * (b + 1)].contiguous(), y[..., :c]
        if seq:
            want = [net.params_from_base(net.band_base(y_cond), y_pred, clr)
                    for clr in range(3)]
        else:
            want = [net.get_params(y_cond),
                    net.get_params(y_cond, replicate_halo)]
        want.append(net(y_cond, y_pred))
        assert calls["calls"] == 0  # autograd: the modules alone
        with torch.inference_mode():
            if seq:
                got = [net.params_from_base(net.band_base(y_cond), y_pred,
                                            clr) for clr in range(3)]
            else:
                got = [net.get_params(y_cond),
                       net.get_params(y_cond, replicate_halo)]
                if act != "GDN1":  # the dense conv of GDN1 sums in
                    # another order at another batch on the CPU
                    got.append(net.get_params_batched(y_cond))
                    want.insert(2, want[0])
            got.append(net(y_cond, y_pred))
        assert calls["calls"] > 0
        calls["calls"] = 0
        for g, w in zip(got, want):
            assert g.is_contiguous() and torch.equal(g, w.detach())
    assert band_epilogue.launches == 0


@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["nchw", "channels_last"])
def test_training_gradients_take_the_module_path(channels_last, calls,
                                                 monkeypatch):
    cfg = tiny_cfg()
    model = tiny_model(cfg)
    ref = copy.deepcopy(model)
    batch = torch.from_numpy(np.stack([
        synthetic_image(16, 16, seed=s) for s in (1, 2)])[None]
        .astype(np.float32) / 255)

    def step(m):  # -> the gradients the step leaves in .grad
        if channels_last:  # divided by acc = 1, clipped, then SGD at lr 0
            opt = torch.optim.SGD(m.parameters(), lr=0.0)
            steps.make_train_step(m, opt)(batch)
        else:
            steps.accumulate(m, batch, batch[0].numel())
        return [p.grad for p in m.parameters()]

    got = step(model)
    assert calls["calls"] == 0 and band_epilogue.launches == 0
    # the reference: the module path by construction
    monkeypatch.setattr(interpolator.Interpolator, "_fused",
                        lambda self, x: False)
    want = step(ref)
    for (name, _), g, w in zip(model.named_parameters(), got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("seq", [False, True], ids=["joint", "seq"])
def test_cpu_codec_runs_the_plain_version_three_times_a_band_net(seq,
                                                                 calls):
    cfg = tiny_cfg(seq=seq)
    codec = Codec(cfg, init_params(cfg, 5), num_lanes=8, device="cpu")
    img = synthetic_image(32, 48, seed=4)
    streams = codec.compress(img)
    S = cfg.num_scales
    # a band net: layer 0, the middle trunk conv, the last trunk conv; the
    # sequential-colour model runs its trunk once a colour, and band 0's
    # depthwise layer 0 keeps its bias, leaving nothing to finish
    per_scale = 2 + 3 * 3 * 2 if seq else 3 * 3
    assert calls["calls"] == per_scale * S
    calls["calls"] = 0
    assert np.array_equal(codec.decompress(streams)[0], img)
    assert calls["calls"] == per_scale * S
    assert band_epilogue.launches == 0


@pytest.mark.parametrize("name", [
    "void llicti::band_epilogue_kernel<3, true, true>(llicti::EpilogueArgs)",
    "void llicti::band_epilogue_nhwc_kernel<1, false, true>("
    "llicti::EpilogueArgs, int)",
    "void at::native::elementwise_kernel<128, 2, at::native::"
    "gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<float> > >(int)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int)",
    "void at::native::unrolled_elementwise_kernel<at::native::"
    "direct_copy_kernel_cuda(at::TensorIteratorBase&)>(int)",
], ids=["planar", "nhwc", "add", "vectorized_add", "unrolled_copy"])
def test_elementwise_group_holds_the_epilogue_and_no_conv_reads_it(name):
    """The benchmark files the band epilogue's kernels, with PyTorch's
    elementwise ones, under ``elementwise_ms`` and under no group that
    ``conv_ms``, the transposes or the hand kernels' rooflines read."""
    from llbench import readers
    from llbench.layer_metrics.elementwise_ms import ELEMENTWISE
    low = name.lower()
    assert any(p in low for p in ELEMENTWISE)
    assert not any(p in low for p in readers.CONV + readers.NOT_CONV)


def test_elementwise_ms_reads_the_group_an_image():
    """``elementwise_ms.codec`` sums the group's device time over the
    traced images, and reads nothing where the group launched nothing."""
    from types import SimpleNamespace

    from llbench.layer_metrics import elementwise_ms
    from llbench.trace import Trace
    kernels = [("void llicti::band_epilogue_kernel<1, true, true>("
                "llicti::EpilogueArgs)", 0.0, 1000.0),
               ("void at::native::vectorized_elementwise_kernel<4>(int)",
                1000.0, 3000.0),
               ("sm80_xmma_fprop_implicit_gemm_f32f32_cudnn", 3000.0,
                4000.0)]
    o = SimpleNamespace(trace=Trace(kernels, [], 0.0, 5000.0, units=2))
    assert elementwise_ms.read(o) == pytest.approx(1.5)  # 3 ms, 2 images
    o = SimpleNamespace(trace=Trace(kernels[2:], [], 0.0, 5000.0, units=2))
    assert elementwise_ms.read(o) is None
    assert elementwise_ms.read(SimpleNamespace(trace=None)) is None


def test_cpu_maps_keep_their_bits_at_flagship_widths(calls):
    """At the flagship's widths (Ch = 352, groups of 88) the CPU's convs
    take the bias into their own sums, which a separate add would round
    otherwise: on the CPU the fused path keeps each conv's bias, so its
    maps are the module path's bit for bit."""
    cfg = ModelConfig()
    model = tiny_model(cfg)
    gen = torch.Generator().manual_seed(5)
    y = torch.rand((1, 8, 12, 4 * cfg.cond_channels), generator=gen)
    for b in range(3):
        y_cond = y[..., :cfg.cond_channels * (b + 1)].contiguous()
        want = model.band_params(y_cond, 0, b)
        with torch.inference_mode():
            got = model.band_params(y_cond, 0, b)
        assert torch.equal(got, want.detach())
    assert calls["calls"] == 9
