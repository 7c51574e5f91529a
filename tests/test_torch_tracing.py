"""The port's spans (``llicti_torch/tracing.py``): nothing recorded while
no profiler records; under a CPU ``torch.profiler`` the documented span
tree of a codec round trip (single and batch containers) and of a
training step, with the codec's bytes unchanged; the device timings of
the latest traced stretch only."""
import torch_helpers  # noqa: F401  (first: caps torch's threads)

import numpy as np
import pytest
import torch

from llicti_torch import Codec, ModelConfig, tracing
from llicti_torch.training import make_optimizer, make_train_step
from llicti_torch.weights import init_params, params_from_flax

CFG = ModelConfig(chs=(4, 4), evens=(4, 4), odds=(3, 3), dwtlevels=(0, 1),
                  useprevlevNN=(False, True))
S = CFG.num_scales


@pytest.fixture(scope="module")
def codec():
    return Codec(CFG, init_params(CFG), num_lanes=16, device="cpu")


def images(k):
    rng = np.random.default_rng(k)
    return [rng.integers(0, 256, (21, 18, 3), dtype=np.uint8)
            for _ in range(k)]


class Node:
    def __init__(self, name, a, b):
        self.name, self.a, self.b, self.kids = name, a, b, []

    def names(self):
        return [k.name for k in self.kids]


def span_tree(prof):
    """The program's spans of a profile as a forest, each span under the
    innermost one that holds it; checks that a child closes before its
    parent and that siblings never overlap."""
    evs = sorted(((e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name.startswith("llicti.")),
                 key=lambda e: (e[1], -e[2]))
    roots, stack = [], []
    for name, a, b in evs:
        while stack and stack[-1].b <= a:
            stack.pop()
        node = Node(name, a, b)
        if stack:
            assert b <= stack[-1].b, f"{name} outlives {stack[-1].name}"
            stack[-1].kids.append(node)
        else:
            roots.append(node)
        stack.append(node)

    def siblings_apart(nodes):
        for x, y in zip(nodes, nodes[1:]):
            assert x.b <= y.a, f"{x.name} overlaps {y.name}"
        for n in nodes:
            siblings_apart(n.kids)
    siblings_apart(roots)
    return roots


def check_pass(node, decode):
    """The children of one pass's entry span, and of each of its spans."""
    bands = [k for k in node.kids if k.name == "llicti.band"]
    assert len(bands) == 3 * S  # one a scale and band
    per_colour = (["llicti.kernel1", "llicti.kernel2"] if decode
                  else ["llicti.kernel1"])
    for band in bands:
        assert band.names() == ["llicti.interp"] + 3 * per_colour
    def check_fetch(k):  # one wait: one synchronisation
        assert k.names() == ["llicti.wait"]
        assert not k.kids[0].kids

    for k in node.kids:
        if k.name == "llicti.fetch":
            check_fetch(k)
        elif k.name == "llicti.stage":
            # the upload, then the colour ranges reduced on the device and
            # fetched
            assert k.names() == ["llicti.upload", "llicti.host_header"]
            assert not k.kids[0].kids
            assert k.kids[1].names() == ["llicti.fetch"]
            check_fetch(k.kids[1].kids[0])
        elif k.name != "llicti.band":
            assert not k.kids, k.name
    return node.names()


# the children of each pass's entry span, in order
ENCODE = (["llicti.stage", "llicti.wavelet"]
          + 3 * S * ["llicti.band"]
          + ["llicti.kernel3", "llicti.fetch", "llicti.pack", "llicti.fetch",
             "llicti.pack", "llicti.pack"])
DECODE = (["llicti.unpack", "llicti.unpack", "llicti.upload"]
          + S * (["llicti.wavelet"] + 3 * ["llicti.band"])
          + ["llicti.wavelet", "llicti.fetch"])


def test_no_profiler_records_nothing(codec, monkeypatch):
    """Off path: every span is the one shared no-op context, no
    record_function is entered and no CUDA event made, also over a whole
    round trip and a training step."""
    def refuse(*args, **kwargs):
        raise AssertionError("a span recorded without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("llicti.band") is tracing.OFF
    assert tracing.span("llicti.forward", torch.device("cuda")) is tracing.OFF
    assert tracing.entry("llicti.step") is tracing.OFF
    with tracing.span("llicti.band") as inside:
        assert inside is None
    img = images(1)[0]
    assert np.array_equal(codec.decompress(codec.compress(img))[0], img)
    model = params_from_flax(init_params(CFG), CFG)
    make_train_step(model, make_optimizer(model, 1e-3))(
        torch.rand(1, 2, 16, 16, 3))
    assert tracing.device_ms() == {}


def test_round_trip_span_tree(codec):
    """compress then decompress of one image under a profiler: one entry
    span each (compress's inner compress_many opens none), the documented
    children in order, and the same container as without the profiler."""
    img = images(1)[0]
    plain = codec.compress(img)
    with torch.profiler.profile() as prof:
        traced = codec.compress(img)
        out = codec.decompress(traced)
    assert traced == plain
    assert np.array_equal(out[0], img)
    enc, dec = span_tree(prof)
    assert (enc.name, dec.name) == ("llicti.compress", "llicti.decompress")
    assert check_pass(enc, decode=False) == ENCODE
    assert check_pass(dec, decode=True) == DECODE
    assert tracing.device_ms() == {}  # no CUDA span on the CPU


def test_batch_round_trip_span_tree(codec):
    """compress_batch / decompress_batch of two images: the same tree,
    one band span a scale and band for both images, the same bytes."""
    imgs = images(2)
    plain = codec.compress_batch(imgs)
    with torch.profiler.profile() as prof:
        traced = codec.compress_batch(imgs)
        outs = codec.decompress_batch(traced)
    assert traced == plain
    assert all(np.array_equal(o, i) for o, i in zip(outs, imgs))
    enc, dec = span_tree(prof)
    assert (enc.name, dec.name) == ("llicti.compress", "llicti.decompress")
    assert check_pass(enc, decode=False) == ENCODE
    assert check_pass(dec, decode=True) == DECODE


def test_train_step_span_tree():
    """A step of two microbatches: the step holds a forward and a
    backward a microbatch, then the optimiser."""
    torch.manual_seed(0)
    model = params_from_flax(init_params(CFG), CFG)
    step = make_train_step(model, make_optimizer(model, 1e-3))
    with torch.profiler.profile() as prof:
        step(torch.rand(2, 2, 16, 16, 3))
    (root,) = span_tree(prof)
    assert root.name == "llicti.step"
    assert root.names() == 2 * ["llicti.forward", "llicti.backward"] + [
        "llicti.optimizer"]
    assert tracing.device_ms() == {}


def test_device_timings_are_cleared_at_a_new_traced_stretch(monkeypatch):
    """The timings kept from a stretch go when a span first finds a
    profiler recording after finding none."""
    monkeypatch.setitem(tracing._state.events, "llicti.forward",
                        [("start", "end")])
    with tracing.span("llicti.forward"):  # no profiler: nothing changes
        pass
    assert "llicti.forward" in tracing._state.events
    with torch.profiler.profile():
        with tracing.span("llicti.band"):
            pass
    assert tracing._state.events == {} and tracing.device_ms() == {}
