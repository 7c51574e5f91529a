#!/usr/bin/env python3
"""Instructions of each loop of a kernel, from ``cuobjdump -sass`` output.

Usage: cuobjdump -sass llicti_torch/_build/libllicti_kernels.so > k.sass
       python3 tools/sass_loops.py k.sass NAME_SUBSTRING [...]

For every function whose mangled name contains one of the substrings,
prints its instruction count and each loop (a branch back to an earlier
address): its address range, its instruction count, and the counts of its
multi-function-unit (MUFU), float (F*), shuffle (SHFL) and load/store
(LD*/ST*) instructions.  A loop's count is static: the instructions one
trip runs if it takes no branch inside it.
"""
from __future__ import annotations

import gzip
import re
import sys

_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def functions(text: str):
    """{mangled name: [(address, opcode, operands)]}"""
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def loops(insns):
    """(start, end) address ranges of backward branches, outermost first."""
    spans = []
    for addr, op, args in insns:
        if op.startswith("BRA"):
            t = _TARGET.search(args)
            if t and int(t.group(1), 16) < addr:
                spans.append((int(t.group(1), 16), addr))
    return sorted(set(spans), key=lambda s: (s[0], -s[1]))


def summary(insns) -> str:
    ops = [op for _, op, _ in insns]
    groups = {"MUFU": 0, "F*": 0, "SHFL": 0, "LD/ST": 0}
    for op in ops:
        if op.startswith("MUFU"):
            groups["MUFU"] += 1
        elif op.startswith("F"):
            groups["F*"] += 1
        elif op.startswith("SHFL"):
            groups["SHFL"] += 1
        elif op.startswith(("LD", "ST")):
            groups["LD/ST"] += 1
    return f"{len(ops)} instructions (" + ", ".join(
        f"{k} {v}" for k, v in groups.items()) + ")"


def main() -> None:
    path, keys = sys.argv[1], sys.argv[2:]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        funcs = functions(f.read())
    for name, insns in funcs.items():
        if not any(k in name for k in keys):
            continue
        print(f"{name}: {summary(insns)}")
        for a, b in loops(insns):
            body = [i for i in insns if a <= i[0] <= b]
            print(f"  loop {a:#x}-{b:#x}: {summary(body)}")


if __name__ == "__main__":
    main()
