"""Host range coder of the host backend: C++ source, g++ build, ctypes.

Port of ``llicti_tpu/coder/__init__.py``.  ``csrc/rangecoder.cpp`` is a
copy of the JAX package's coder: a 32-bit binary arithmetic coder over
uint16 CDF rows with torchac's contract (row[0] == 0, strictly increasing
modulo 2^16, the last entry wrapping to 0 and read as 2^16).  It is built
with g++ into ``_build/`` at first use (never at import), and again when
the source is newer than the library; each build writes a per-process
temporary file and moves it into place, so processes that build at once
do not clash.  A failed build raises.

  encode_lohi(lo_u16, hi_u16) -> bytes          # (cdf[s], cdf[s+1]) a symbol
  encode_cdf(cdf_u16[n, Lp], syms_i16) -> bytes # full rows
  decode_cdf(cdf_u16[n, Lp], data) -> syms_i16
  decode_shared_cdf(cdf_row_u16[Lp], n, data) -> syms_i16

Every call takes numpy arrays and releases the GIL, so independent streams
can be coded at once on a thread pool.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from .._kernels import BUILD_DIR, SRC_DIR

SRC = SRC_DIR / "rangecoder.cpp"
LIB_PATH = BUILD_DIR / "librangecoder.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    res = subprocess.run(
        ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         str(SRC), "-o", str(tmp)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}) to build the "
                           f"range coder:\n{res.stderr}")
    os.replace(tmp, LIB_PATH)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if (not LIB_PATH.exists()
                    or LIB_PATH.stat().st_mtime < SRC.stat().st_mtime):
                _build()
            lib = ctypes.CDLL(str(LIB_PATH))
            u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
            i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i64, i32 = ctypes.c_int64, ctypes.c_int32
            for name, args in (
                    ("rc_encode_lohi", [u16p, u16p, i64, u8p, i64]),
                    ("rc_encode_cdf", [u16p, i32, i16p, i64, u8p, i64]),
                    ("rc_decode_cdf", [u16p, i32, i64, u8p, i64, i16p]),
                    ("rc_decode_shared_cdf",
                     [u16p, i32, i64, u8p, i64, i16p])):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = i64
            _lib = lib
    return _lib


def _as(arr, dtype) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=dtype)


def _encode(call, n: int) -> bytes:
    """Run an encode entry point on growing output buffers until the
    stream fits."""
    cap = 2 * n + 1024
    while True:
        out = np.empty(cap, np.uint8)
        ln = call(out, cap)
        if ln >= 0:
            return out[:ln].tobytes()
        cap *= 4


def encode_lohi(lo: np.ndarray, hi: np.ndarray) -> bytes:
    """Encode symbols from their cumulative bounds (hi == 0 means 2^16)."""
    lib = _load()
    lo = _as(np.reshape(lo, -1), np.uint16)
    hi = _as(np.reshape(hi, -1), np.uint16)
    if lo.size != hi.size:
        raise ValueError(f"{lo.size} lows against {hi.size} highs")
    return _encode(lambda out, cap: lib.rc_encode_lohi(lo, hi, lo.size, out,
                                                       cap), lo.size)


def _rows(cdf: np.ndarray) -> np.ndarray:
    Lp = cdf.shape[-1]
    if Lp < 2:
        raise ValueError(f"a CDF row needs 2 entries or more, got {Lp}")
    return _as(np.reshape(cdf, (-1, Lp)), np.uint16)


def encode_cdf(cdf: np.ndarray, syms: np.ndarray) -> bytes:
    """Encode ``syms`` [n] (int16, each in [0, Lp - 2]) with one CDF row
    [n, Lp] (uint16) a symbol."""
    lib = _load()
    cdf = _rows(cdf)
    Lp = cdf.shape[1]
    syms = _as(np.reshape(syms, -1), np.int16)
    if cdf.shape[0] != syms.size:
        raise ValueError(f"{cdf.shape[0]} CDF rows for {syms.size} symbols")
    if syms.size and (syms.min() < 0 or syms.max() > Lp - 2):
        raise ValueError(f"a symbol lies outside [0, {Lp - 2}]")
    return _encode(lambda out, cap: lib.rc_encode_cdf(cdf, Lp, syms,
                                                      syms.size, out, cap),
                   syms.size)


def decode_cdf(cdf: np.ndarray, data: bytes,
               n: Optional[int] = None) -> np.ndarray:
    """Decode ``n`` symbols (every row of ``cdf`` [n, Lp] by default)."""
    lib = _load()
    cdf = _rows(cdf)
    n = cdf.shape[0] if n is None else n
    if not 0 <= n <= cdf.shape[0]:
        raise ValueError(f"{n} symbols from {cdf.shape[0]} CDF rows")
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.int16)
    if lib.rc_decode_cdf(cdf, cdf.shape[1], n, _as(buf, np.uint8), buf.size,
                         out) != 0:
        raise RuntimeError("range decode failed")
    return out


def decode_shared_cdf(cdf_row: np.ndarray, n: int,
                      data: bytes) -> np.ndarray:
    """Decode ``n`` symbols that all share one CDF row [Lp]."""
    lib = _load()
    row = _rows(cdf_row)
    if row.shape[0] != 1 or n < 0:
        raise ValueError("one CDF row and n >= 0 expected")
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.int16)
    if lib.rc_decode_shared_cdf(row[0], row.shape[1], n, _as(buf, np.uint8),
                                buf.size, out) != 0:
        raise RuntimeError("range decode failed")
    return out
