"""BENCHMARK.json against the benchmark's contract, and every cell
resolved by name to its files."""
from __future__ import annotations

import os
import re

import pytest

from conftest import ROOT, load

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
WIDTHS = re.compile(r".*(_dim|_rank)$|^(chs|evens|odds|num_mixtures)$")
BENCH = load("BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert one_line(word) and not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.fullmatch(entry["name"]) and one_line(entry["source"])
    assert one_line(entry["why"]) and len(entry["reduced"]) <= 16
    assert entry["file"].startswith(BENCH["paths"][0] + "/")
    cfg = load(entry["file"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert not any(WIDTHS.match(k) for k in entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


@pytest.mark.parametrize("cell", CELLS)
def test_workload_resolves(cell):
    """Each cell's workload file names its configuration, its generator, its
    parameters and limits; each of its metrics has a reader."""
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] in (1, 4) and one_line(entry["why"])
    for key in ("name", "config", "traffic"):
        assert NAME.fullmatch(entry[key])
    wl = load("llbench", "workloads", cell + ".json")
    assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert os.path.isfile(os.path.join(ROOT, "llbench", "configs",
                                       wl["config"] + ".json"))
    assert os.path.isfile(os.path.join(ROOT, "llbench", "traffic",
                                       wl["generator"] + ".py"))
    assert wl["limits"] and wl["params"] and wl["who"]
    from llbench import run
    e2e = run.cell_metrics(BENCH, cell, False)
    layers = run.cell_metrics(BENCH, cell, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layers
    for m in e2e:
        assert os.path.isfile(run.reader_path("end_to_end", m["name"]))
    for m in layers:
        assert os.path.isfile(run.reader_path("layer_metrics", m["name"]))
        assert m["moves"] in {x["name"] for x in e2e}


def test_reader_of_a_name_with_a_part_falls_back_to_its_stem():
    """``conv_ms.train`` has no file of its own: ``conv_ms.py`` reads it;
    a file of the full name, where there is one, comes first."""
    from llbench import run
    assert run.reader_path("layer_metrics", "conv_ms.train").endswith(
        os.path.join("layer_metrics", "conv_ms.py"))
    assert run.reader_path("layer_metrics", "train_mfu").endswith(
        os.path.join("layer_metrics", "train_mfu.py"))
    assert callable(run.reader("end_to_end", "dp_step_ms"))


def test_cells_and_pairs_unique():
    assert len(set(CELLS)) == len(CELLS) and 1 <= len(CELLS) <= 24
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_names_and_units(m):
    assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    if m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_names_unique_and_setup_bound():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25


def test_check_fits_its_budget_at_24_cells():
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell to compile,
    1200 s spare: inside 43200 s."""
    s = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "llbench")):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert PATH.fullmatch(rel), rel
