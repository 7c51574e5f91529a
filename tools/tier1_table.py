#!/usr/bin/env python3
"""Per-file and slowest-test tables of a pytest run, from its JUnit XML.

Usage: python3 tools/tier1_table.py RUN.xml [--log RUN.log] [--top 30]
                                    [--match test_torch_]

RUN.xml is what ``pytest --junitxml=RUN.xml`` wrote (a test's time there
is its setup, call and teardown, so a module fixture's cost lands on the
first test that uses it).  Prints, as Markdown:

* the suite's totals (tests, failures, errors, skips, the summed test
  seconds);
* the files whose name contains ``--match`` (all files if empty): tests,
  passes, summed seconds, and, with ``--log``, the pytest-xdist worker
  that ran them, read from a ``-v`` run's ``[gwN] ... PASSED file::test``
  lines (``--dist loadfile`` sends a whole file to one worker);
* the workers' summed seconds over all files (with ``--log``);
* the ``--top`` slowest tests of the whole suite.
"""
from __future__ import annotations

import argparse
import re
import xml.etree.ElementTree as ET
from collections import defaultdict


def cases(path: str):
    """-> [(file, test name, seconds, outcome)] of the XML's testcases."""
    out = []
    for tc in ET.parse(path).getroot().iter("testcase"):
        file = tc.get("file") or (
            tc.get("classname", "").replace(".", "/") + ".py")
        outcome = "passed"
        for tag in ("failure", "error", "skipped"):
            if tc.find(tag) is not None:
                outcome = tag
        out.append((file, tc.get("name"), float(tc.get("time", 0.0)),
                    outcome))
    return out


def workers(path: str):
    """-> {file: {worker}} from a -v log's ``[gwN] ... file::test``."""
    seen = defaultdict(set)
    pat = re.compile(r"\[(gw\d+)\].*?\s(\S+\.py)::")
    with open(path, errors="replace") as f:
        for line in f:
            m = pat.search(line)
            if m:
                seen[m.group(2)].add(m.group(1))
    return seen


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("xml")
    ap.add_argument("--log")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--match", default="test_torch_")
    args = ap.parse_args()
    rows = cases(args.xml)
    by_file = defaultdict(lambda: [0, 0, 0.0])
    for file, _, sec, outcome in rows:
        by_file[file][0] += 1
        by_file[file][1] += outcome == "passed"
        by_file[file][2] += sec
    counts = defaultdict(int)
    for *_, outcome in rows:
        counts[outcome] += 1
    print(f"{len(rows)} tests: {dict(counts)}; summed test time "
          f"{sum(r[2] for r in rows):.1f} s\n")
    owner = workers(args.log) if args.log else {}
    print("| file | tests | passed | s | worker |")
    print("| --- | --- | --- | --- | --- |")
    picked = sorted((f for f in by_file if args.match in f),
                    key=lambda f: -by_file[f][2])
    for f in picked:
        n, ok, sec = by_file[f]
        print(f"| {f} | {n} | {ok} | {sec:.1f} | "
              f"{','.join(sorted(owner.get(f, ()))) or '-'} |")
    print(f"| all {len(picked)} files | {sum(by_file[f][0] for f in picked)}"
          f" | {sum(by_file[f][1] for f in picked)} | "
          f"{sum(by_file[f][2] for f in picked):.1f} | |\n")
    if owner:
        load = defaultdict(float)
        for f, (_, _, sec) in by_file.items():
            for w in owner.get(f, ()):
                load[w] += sec / len(owner[f])
        print("workers' summed seconds: " + ", ".join(
            f"{w} {s:.1f}" for w, s in sorted(load.items())) + "\n")
    print("| test | s |")
    print("| --- | --- |")
    for file, name, sec, _ in sorted(rows, key=lambda r: -r[2])[:args.top]:
        print(f"| {file}::{name} | {sec:.1f} |")


if __name__ == "__main__":
    main()
