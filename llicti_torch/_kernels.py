"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file compiles with ``nvcc`` into one shared library
with a plain C interface under ``_build/``, loaded with ctypes.  The build
runs at first use (never at import: the CPU tests import every module),
and again whenever a source is newer than the library.  ptxas's ``-v``
report (registers, stack frame and spills of every kernel) is kept in
``_build/ptxas.txt``; :func:`ptxas_table` parses it.  Each C entry point
launches on the stream it is given and returns ``cudaGetLastError()``;
:func:`check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import torch

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
LIB_PATH = BUILD_DIR / "libllicti_kernels.so"
PTXAS_PATH = BUILD_DIR / "ptxas.txt"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # pts, pmap, y, cum, start, freq, n, P, CO, YC, M, std0, mean0, w0,
    # n_upd, upd_coef0, upd_ych0, upd_coef1, upd_ych1, sym_ch, minv,
    # logistic, scale_bound, stream
    "llicti_cdf_pmap": [_P, _P, _P, _P, _P, _P] + [_I] * 16 + [_F, _P],
    # pts, stdev, means, weights, cum, n, P, X, stream
    "llicti_cdf_table": [_P] * 5 + [_I] * 3 + [_P],
    # M, logistic, threads (out) -> resident blocks per SM
    "llicti_cdf_pmap_occupancy": [_I, _I, _P],
    # mismatch count (out), stream
    "llicti_cdf_check_saturation": [_P, _P],
    # cum, words, n_words, words_stride, states, offset, syms, n, P, N, K,
    # stream
    "llicti_rans_decode": [_P, _P, _L, _L, _P, _P, _P, _I, _I, _I, _I, _P],
    # N, resident clusters (out)
    "llicti_rans_decode_max_clusters": [_I, _P],
    # starts, freqs, plan (host), n_slices, steps, states, cursor, buf,
    # cap, cursors, scratch, N, K, stream
    "llicti_rans_encode_chain": [_P, _P, _P, _I, _L, _P, _P, _P, _I, _P,
                                 _P, _I, _I, _P],
    # steps, N, K, scratch int32 words (out)
    "llicti_rans_encode_scratch": [_L, _I, _I, _P],
    # src, src_stride, lengths, dst, dst_stride, col0, col1, K, stream
    "llicti_widen_words": [_P, _L, _P, _P, _L, _L, _L, _I, _P],
    # x0, x1, x2, b0, b1, b2, out, strides (host), U, N, C, P, relu, nhwc,
    # stream
    "llicti_band_epilogue": [_P] * 8 + [_I, _L, _L, _L, _I, _I, _P],
}


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "cannot be built")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _build() -> None:
    """One ``nvcc -c`` per source, all started together, then one link
    into ``LIB_PATH``; ptxas's report goes beside it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for src in sorted(SRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc] + COMPILE_FLAGS + ["-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = [(p, p.communicate()) for p in procs]
    errors = [f"{p.args[-1]}: nvcc failed ({p.returncode}):\n{err}"
              for p, (_, err) in results if p.returncode != 0]
    if errors:
        raise RuntimeError("\n".join(errors))
    PTXAS_PATH.write_text(
        "".join(o + e for _, (o, e) in results))
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    res = subprocess.run([nvcc] + ARCH_FLAGS + ["-shared", "-o", str(tmp)]
                         + [str(o) for o in objs],
                         capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, LIB_PATH)


def _load() -> ctypes.CDLL:
    handle = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.llicti_error_string.argtypes = [ctypes.c_int]
    handle.llicti_error_string.restype = ctypes.c_char_p
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            newest = max(p.stat().st_mtime for p in _sources())
            if not LIB_PATH.exists() or LIB_PATH.stat().st_mtime < newest:
                _build()
            _lib = _load()
    return _lib


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_PROPS = re.compile(r"Function properties for (\S+)")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_table(text: Optional[str] = None) -> List[Dict[str, object]]:
    """Per kernel of the last build: {kernel (demangled where c++filt
    exists), registers, stack, spill_stores, spill_loads}."""
    if text is None:
        text = PTXAS_PATH.read_text()
    rows, cur, props = [], None, None
    for line in text.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
            continue
        m = _PTXAS_PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        if cur is None:
            continue
        m = _PTXAS_FRAME.search(line)
        if m and props == cur["kernel"]:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _PTXAS_REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and rows:
        names = subprocess.run([cxxfilt], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True,
            check=True).stdout.splitlines()
        for r, name in zip(rows, names):
            r["kernel"] = name
    return rows


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = lib().llicti_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_ptr(device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
