"""Fixtures of the benchmark's own tests: tiny cells added to a copy of
the benchmark from data files alone, and the card check.  Run from the
repository's root: ``python -m pytest llbench/tests -q``."""
from __future__ import annotations

import copy
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# tiny cells: each stands in for the cell of the same traffic, at a size
# the CPU runs in seconds (the codec cells keep the trained flagship's
# widths, which its weights fix)
TINY = {
    "tiny_A.codec_single": ("llicti_A.codec_single", "tiny_A",
                            {"height": 40, "width": 64, "lanes": 16,
                             "pool": 2, "sample": 2, "traced": 1}),
    "tiny_A.codec_batch2": ("llicti_A.codec_batch8", "tiny_A",
                            {"height": 40, "width": 64, "lanes": 16,
                             "batch": 2, "pool": 4, "sample": 2,
                             "traced": 1}),
    "tiny_B.train_step": ("llicti_B.train_step", "tiny_B",
                          {"pinned": 3, "traced": 1}),
    "tiny_B.train_dp4": ("llicti_A.train_dp4", "tiny_B",
                         {"pinned": 3, "traced": 1}),
}
TINY_CONFIGS = {
    "tiny_A": ("llicti_A", {}, {}),
    "tiny_B": ("llicti_B", {"chs": [8, 1]},
               {"batch_size": 4, "patch_size": 32}),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "python -m pytest llbench/tests -m card")
    return torch.device("cuda")


def load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def add_tiny_cells(root: str) -> None:
    """Add the tiny cells to the benchmark copied to ``root``: a
    configuration file and a workload file each, and their entries in
    BENCHMARK.json, with the metrics of the cells they stand for."""
    bench = load(root, "BENCHMARK.json")
    for name, (src, _, _) in TINY_CONFIGS.items():
        cfg = load(root, "llbench", "configs", src + ".json")
        _, model, train = TINY_CONFIGS[name]
        cfg["name"] = name
        cfg["model"].update(model)
        cfg["train"].update(train)
        with open(os.path.join(root, "llbench", "configs",
                               name + ".json"), "w") as f:
            json.dump(cfg, f)
    for name, (src, config, params) in TINY.items():
        wl = load(root, "llbench", "workloads", src + ".json")
        wl["config"] = config
        wl["params"].update(params)
        with open(os.path.join(root, "llbench", "workloads",
                               name + ".json"), "w") as f:
            json.dump(wl, f)
        entry = copy.deepcopy(next(w for w in bench["workloads"]
                                   if w["name"] == src))
        entry.update(name=name, config=config)
        bench["workloads"].append(entry)
        for m in bench["end_to_end"] + bench["per_layer"]:
            if src in m.get("workloads", []):
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """A copy of the benchmark with the tiny cells added, which
    ``llbench.run`` reads its files from."""
    from llbench import run
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(ROOT, "llbench"),
                    os.path.join(root, "llbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    add_tiny_cells(root)
    monkeypatch.setattr(run, "ROOT", root)
    # a multi-card cell's other ranks run the copy, with the program here
    monkeypatch.setenv("PYTHONPATH", ROOT)
    monkeypatch.setattr(run, "HERE", os.path.join(root, "llbench"))
    return root


def run_cell(name: str, seconds: float = 3.0, trace: int = 0,
             seed: int = 2 ** 31 + 11) -> dict:
    """One run of a cell on the CPU, as the command runs it."""
    from llbench import run
    return run.main(["--workload", name, "--seed", str(seed), "--seconds",
                     str(seconds), "--trace", str(trace)], device="cpu")
