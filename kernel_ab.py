#!/usr/bin/env python3
"""Kernel 2, the rANS decode, of this tree against another tree's on one
CUDA card.

Usage: python3 kernel_ab.py OTHER_TREE [--lanes N ...] [--variants]
       [--out FILE]

Builds this tree's kernels and OTHER_TREE/llicti_torch/csrc/rans.cu
alone into a library of its own (a `git archive` of an earlier commit
unpacked into a git-ignored directory will do).  At each N (default
1024, 2048, 4096, 16384) it encodes the finest Y slice of
synthetic_image(512, 768, seed=42) under the trained flagship weights
with this tree's Kernel 3, holds both trees' decodes bit for bit against
rans_decode_plain, and times them in turns (other, this, this, other)
with CUDA events behind a device-side wait.  --variants also builds this
tree's rans.cu with the wide decode's cluster at 8 blocks, and with its
blocks capped at 512 threads, and times them in the same turns.  It also
checks that the 1024-lane flagship container keeps its sha256.  Prints
ptxas's report of every decode built and one JSON line (also to --out),
with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (FLAGSHIP_SHA, bound, card_line, check, cuda_ms,
                        finest_y, fresh_carry)
from llicti_torch import Codec, ModelConfig, _kernels, load_npz, \
    synthetic_image
from llicti_torch.coder import rans

# variant name -> (text of rans.cu, its replacement)
VARIANTS = {
    "cluster8": ("constexpr int kWideCluster = 16;",
                 "constexpr int kWideCluster = 8;"),
    "threads512": ("constexpr int kWideThreads = 1024;",
                   "constexpr int kWideThreads = 512;"),
}
ROUNDS = 20  # launches a timing


def build_variant(src: Path, name: str, edit=None) -> ctypes.CDLL:
    """rans.cu (edited) alone into _build/ab/<name>.so; prints the wide
    decode's ptxas line."""
    out = _kernels.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    text = src.read_text()
    if edit is not None:
        check(edit[0] in text, f"{name}: {edit[0]!r} is not in {src}")
        text = text.replace(edit[0], edit[1])
    cu = out / f"{name}.cu"
    cu.write_text(text)
    lib = out / f"{name}.so"
    res = subprocess.run([_kernels._nvcc()] + _kernels.COMPILE_FLAGS
                         + ["-shared", "-o", str(lib), str(cu)],
                         capture_output=True, text=True)
    check(res.returncode == 0, f"{name}: nvcc failed:\n{res.stderr}")
    for r in _kernels.ptxas_table(res.stdout + res.stderr):
        if "rans_decode" in r["kernel"]:
            print(f"{name} ptxas {r['kernel']}: {r['registers']} registers, "
                  f"{r['stack']} B stack, {r['spill_stores']} / "
                  f"{r['spill_loads']} B spills")
    handle = ctypes.CDLL(str(lib))
    for fn in ("llicti_rans_decode", "llicti_rans_decode_max_clusters"):
        getattr(handle, fn).argtypes = _kernels._SIGNATURES[fn]
        getattr(handle, fn).restype = ctypes.c_int
    return handle


def accepts(lib, N: int) -> bool:
    """Whether lib's decode takes N lanes (an older tree may take fewer)."""
    clusters = ctypes.c_int(0)
    return lib.llicti_rans_decode_max_clusters(N, ctypes.byref(clusters)) \
        == 0


def decoder(lib, cum, words, N):
    """fn(states, offset) -> syms: one launch of lib's decode."""
    n, P = cum.shape
    stream = _kernels.stream_ptr(cum.device)

    def run(states, offset):
        syms = torch.empty((n,), dtype=torch.int32, device=cum.device)
        err = lib.llicti_rans_decode(
            cum.data_ptr(), words.data_ptr(), words.numel(), words.numel(),
            states.data_ptr(), offset.data_ptr(), syms.data_ptr(), n, P, N,
            1, stream)
        check(err == 0, f"llicti_rans_decode returned {err}")
        return syms
    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--lanes", type=int, nargs="+",
                    default=[1024, 2048, 4096, 16384])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    card = card_line()
    print(card)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: CUDA is not available")
    this = _kernels.lib()
    for r in _kernels.ptxas_table():
        if "rans_decode" in r["kernel"]:
            print(f"this ptxas {r['kernel']}: {r['registers']} registers, "
                  f"{r['stack']} B stack, {r['spill_stores']} / "
                  f"{r['spill_loads']} B spills")
    libs = {"this": this,
            "other": build_variant(Path(args.other) / "llicti_torch" / "csrc"
                                   / "rans.cu", "other")}
    if args.variants:
        for name, edit in VARIANTS.items():
            libs[name] = build_variant(_kernels.SRC_DIR / "rans.cu", name,
                                       edit)
    order = ["other", "this"] + [v for v in libs if v not in
                                 ("other", "this")]
    turns = order + order[::-1]

    cfg, params = ModelConfig(), load_npz()
    codec = Codec(cfg, params, num_lanes=1024)
    img = synthetic_image(512, 768, seed=42)
    sha = hashlib.sha256(Codec.serialize(codec.compress(img))).hexdigest()
    check(sha.startswith(FLAGSHIP_SHA[0]) and sha.endswith(FLAGSHIP_SHA[1]),
          f"the flagship container's sha256 {sha} changed")
    cum, st0, fr0 = finest_y(codec, img)
    n, P = cum.shape
    dev = cum.device
    searched = math.ceil(math.log2(P + 1))
    rows = {}
    for N in args.lanes:
        s, c, b = fresh_carry(N, n + N, dev)
        rans.rans_encode(st0, fr0, s, c, b)
        total = int(c[0])
        sn, wn = rans.unpack_stream(rans.pack_stream_packed(
            b[:total].cpu().numpy(), s.cpu().numpy()), N)
        words = torch.from_numpy(wn).to(dev)

        def fresh(_):
            return (torch.from_numpy(sn.astype(np.int64)).to(dev),
                    torch.zeros((1,), dtype=torch.int32, device=dev))

        sx, o = fresh(0)
        ref = (rans.rans_decode_plain(cum, words, sx, o), sx, o)
        fns = {}
        for name in order:
            if not accepts(libs[name], N):
                print(f"N={N}: {name} refuses {N} lanes")
                continue
            fns[name] = decoder(libs[name], cum, words, N)
            sx, o = fresh(0)
            got = (fns[name](sx, o), sx, o)
            torch.cuda.synchronize()
            check(all(torch.equal(a, r) for a, r in zip(got, ref))
                  and int(o[0]) == total,
                  f"N={N}: {name}'s decode != rans_decode_plain")
        times = {name: [] for name in fns}
        for name in turns:
            if name in fns:
                times[name].append(cuda_ms(fns[name], ROUNDS, fresh))
        steps = -(-n // N)
        bnd = bound(4 * n * (searched + 1) + 4 * total + 16 * N, 0)
        rows[str(N)] = {"steps": steps, "bound_ms": bnd[0],
                        "bound_by": bnd[1], "words": total, "ms": times}
        print(f"N={N} ({steps} steps, bound {bnd[0]:.5f} ms): " + "; ".join(
            f"{name} {', '.join(f'{t:.5f}' for t in ts)} ms "
            f"({1e3 * min(ts) / steps:.2f} us a step)"
            for name, ts in times.items()) + f"; {card}")
    out = {"card": card, "sha256": sha, "slice": [n, P], "lanes": rows}
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    sys.exit(main())
