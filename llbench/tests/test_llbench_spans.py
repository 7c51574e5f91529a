"""The arithmetic of the metrics that read the program's spans
(``llbench/spans.py``), on traces built by hand: idle time split at span
edges, the codec layers partitioning it, division by the units, and
nothing read from a trace without a program span."""
from __future__ import annotations

import pytest

from conftest import ROOT  # noqa: F401  (puts the checkout on sys.path)
from llbench import spans
from llbench.cell import Outcome
from llbench.run import reader
from llbench.trace import Trace

# a compress of one image over [0, 100] us: kernels busy in [30, 40] and
# [60, 70]; the host stages in [0, 20] (its header in [5, 15]), uploads in
# [20, 25], runs a band in [25, 80] (Kernel 1 in [50, 65]) and packs in
# [80, 95]; nothing is open in [95, 100]
KERNELS = [("conv", 30.0, 40.0), ("cdf_pmap", 60.0, 70.0)]
HOST = [("llicti.compress", 0.0, 95.0), ("llicti.stage", 0.0, 20.0),
        ("llicti.host_header", 5.0, 15.0), ("llicti.upload", 20.0, 25.0),
        ("llicti.band", 25.0, 80.0), ("llicti.kernel1", 50.0, 65.0),
        ("llicti.pack", 80.0, 95.0), ("aten::empty", 52.0, 53.0),
        ("llbench.compress", 0.0, 95.0)]


def trace(units=1, host=HOST, kernels=KERNELS):
    return Trace(kernels, host, 0.0, 100.0, units)


def test_idle_gaps_are_split_at_span_edges():
    """The gap [0, 30] lies under stage (with its header), upload and the
    band; [40, 60] under the band and Kernel 1, split at 50; [70, 100]
    under Kernel 1, the band, pack and no span."""
    got = spans.idle_by_span(trace())
    assert got == pytest.approx({
        "llicti.stage": 10.0, "llicti.host_header": 10.0,
        "llicti.upload": 5.0, "llicti.band": 5.0 + 10.0 + 10.0,
        "llicti.kernel1": 10.0 + 0.0, "llicti.pack": 15.0, None: 5.0})
    assert sum(got.values()) == pytest.approx(100.0 - 20.0)


def test_the_codec_layers_partition_the_idle_time():
    t = trace()
    parts = {w: spans.idle_ms(t, w)
             for w in ("stage", "enqueue", "pack", "unspanned")}
    assert parts == pytest.approx({"stage": 0.025, "enqueue": 0.035,
                                   "pack": 0.015, "unspanned": 0.005})
    idle_ms = (t.window_s - t.busy_s) * 1e3
    assert sum(parts.values()) == pytest.approx(idle_ms)


def test_an_entry_span_with_no_child_open_is_unspanned():
    host = [("llicti.step", 10.0, 90.0), ("llicti.forward", 10.0, 40.0),
            ("llicti.backward", 40.0, 80.0)]
    t = trace(host=host, kernels=[("k", 20.0, 30.0)])
    # idle: [0, 10] no span, [10, 20] and [30, 40] forward, [40, 80]
    # backward, [80, 90] the step alone, [90, 100] no span
    assert spans.idle_ms(t, "unspanned") == pytest.approx(0.030)
    assert spans.idle_ms(t, "enqueue") == pytest.approx(0.060)


def test_quantities_are_per_unit():
    one, four = trace(1), trace(4)
    for w in ("stage", "enqueue", "pack", "unspanned"):
        assert spans.idle_ms(four, w) == pytest.approx(
            spans.idle_ms(one, w) / 4)
    assert spans.host_ms(one, "llicti.host_header") == pytest.approx(0.010)
    assert spans.host_ms(four, "llicti.host_header") == pytest.approx(
        0.0025)


def test_no_program_span_reads_nothing():
    bare = trace(host=[(n, a, b) for n, a, b in HOST
                       if not n.startswith("llicti.")])
    assert spans.idle_by_span(bare) is None
    assert spans.idle_by_span(None) is None
    for w in ("stage", "enqueue", "pack", "unspanned"):
        assert spans.idle_ms(bare, w) is None
    assert spans.host_ms(bare, "llicti.wait") is None
    assert spans.host_ms(trace(), "llicti.wait") is None


def test_spans_outside_the_stretch_are_not_read():
    host = [("llicti.compress", -50.0, -10.0), ("llicti.pack", 100.0, 120.0)]
    assert spans.idle_by_span(trace(host=host)) is None


@pytest.mark.parametrize("name", [
    "stage_idle_ms", "enqueue_idle_ms", "pack_idle_ms",
    "unspanned_idle_ms.codec", "unspanned_idle_ms.train",
    "unspanned_idle_ms.dp", "wait_ms", "header_ms", "forward_ms.train",
    "backward_ms.dp", "optimizer_ms.train"])
def test_readers_give_none_without_program_spans(name):
    """Each reader of a program span gives None, and raises nothing, on
    an outcome whose trace holds none of the program's spans or that has
    no trace: its metric goes under ``missing``."""
    bare = trace(host=[("llbench.step", 0.0, 100.0)])
    for t in (bare, None):
        o = Outcome(attempted=1, failed=0, setup_s=0.0, window={},
                    checks=[], memory_peak_bytes=0, trace=t)
        assert reader("layer_metrics", name)(o) is None
