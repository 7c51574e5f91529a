"""Kernels 2 and 3: N-lane interleaved rANS decode and encode.

Port of ``llicti_tpu/coder/rans_device.py:41-42,142-228,231-294,316-350``.
Coder: uint32 lane states in [2^16, 2^32), 16-bit probabilities, N lanes
sharing one stream of 16-bit words.  Symbol i of a slice belongs to step
i // N and lane i % N; the decoder walks steps forward and refills lanes
in order 0..N-1, the encoder walks steps backward and emits in lane order
N-1..0.  Slices chain through the same lane states and stream, so an
image carries one N*4-byte state flush.  N is any count from 1 up, as
in the JAX package; above NARROW_LANES the decode launches its wide
variant (blocks of up to 1024 threads, and above 16384 lanes several
lanes a thread).

:func:`rans_decode` decodes one slice (one launch);
:func:`rans_encode_chain` encodes an image's whole chain of slices in one
call (two launches), and :func:`rans_encode` is its chain of one slice.
Both also take a batch of K images of one shape (the batch container):
every tensor gains a leading K axis, each image keeps its own lanes and
stream, and the K images still cost one decode launch a slice and one
encode call a chain.  On CUDA tensors they launch ``csrc/rans.cu``, on
CPU tensors they run the plain versions, which loop over images and steps
in Python with int64 tensors masked to 32 bits (torch's uint32 has too
few ops).  All update the carried state tensors in place: ``states``
int64 ``[N]`` (``[K, N]``) holding uint32 values, ``offset`` / ``cursor``
int32 ``[1]`` (``[K]``).

:func:`widen_words` turns the decoder's 16-bit words, copied to the card
as a container stores them, into the int32 rows :func:`rans_decode`
reads (one launch of ``csrc/rans_widen.cu``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _kernels

RANS_L = 1 << 16  # lower bound of the state interval
_MASK32 = 0xFFFFFFFF
# lanes of a decode: up to NARROW_LANES the narrow kernel, above it the
# wide one
NARROW_LANES = 1024
# the kernels hold lanes, symbol indices and word offsets in 32-bit ints
KERNEL_LANES = 1 << 30
MAX_SLICES = 1024  # an encode chain's offsets fit the kernels' parameters


def _check_carry(states, pos, name, batched: bool):
    """states int64 [N] with ``pos`` int32 [1], or [K, N] with [K]."""
    if states.dtype != torch.int64 or states.dim() != 1 + batched:
        raise ValueError(f"states must be int64 "
                         f"{'[K, N]' if batched else '[N]'}")
    N = states.shape[-1]
    if N < 1:
        raise ValueError(f"N={N} lanes: a coder needs at least one")
    if states.device.type == "cuda" and N > KERNEL_LANES:
        raise ValueError(f"N={N} lanes: the CUDA kernels index lanes, "
                         f"symbols and word offsets with 32-bit ints, so "
                         f"they take at most {KERNEL_LANES}")
    K = states.shape[0] if batched else 1
    if K < 1 or pos.dtype != torch.int32 or pos.shape != (K,):
        raise ValueError(f"{name} must be int32 [{'K' if batched else 1}], "
                         "K >= 1")


def _check_tensors(device, **tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")


# ---- decode ----------------------------------------------------------------

def rans_decode_plain(cum, words, states, offset) -> torch.Tensor:
    """Plain PyTorch version of :func:`rans_decode`; a batch decodes its
    images one after the other."""
    if cum.dim() == 3:
        return torch.stack([rans_decode_plain(cum[k], words[k], states[k],
                                              offset[k:k + 1])
                            for k in range(cum.shape[0])])
    n, P = cum.shape
    N = states.shape[0]
    W = words.shape[0]
    x = states.clone()
    off = int(offset[0])
    words64 = words.to(torch.int64)
    syms = torch.empty((n,), dtype=torch.int32, device=cum.device)
    for i0 in range(0, n, N):
        m = min(n, i0 + N) - i0
        xv = x[:m]
        block = cum[i0:i0 + m].to(torch.int64)
        slot = xv & 0xFFFF
        # s = (entries <= slot) - 1, the masked reductions of the JAX scan
        s = torch.searchsorted(block, slot[:, None], right=True)[:, 0] - 1
        start = torch.where(s >= 0, block.gather(1, s.clamp(min=0)[:, None])
                            [:, 0], 0)
        nxt = torch.where(s + 1 < P, block.gather(
            1, (s + 1).clamp(max=P - 1)[:, None])[:, 0], RANS_L)
        xn = ((nxt - start) * (xv >> 16) + slot - start) & _MASK32
        need = xn < RANS_L
        n64 = need.to(torch.int64)
        idx = off + torch.cumsum(n64, 0) - n64
        w = torch.zeros_like(xn)
        ok = need & (idx < W)
        w[ok] = words64[idx[ok]]
        x[:m] = torch.where(need, ((xn << 16) | w) & _MASK32, xn)
        syms[i0:i0 + m] = s.to(torch.int32)
        off += int(n64.sum())
    states.copy_(x)
    offset.fill_(off)
    return syms


def rans_decode(cum: torch.Tensor, words: torch.Tensor, states: torch.Tensor,
                offset: torch.Tensor) -> torch.Tensor:
    """Decode one slice of ``n`` symbols.

    cum ``[n, P]`` int32 tables (rows strictly increasing, last entry
    2**16); words ``[W]`` int32 holding the stream's 16-bit words (zeros
    are read past its end); states int64 ``[N]`` and offset int32 ``[1]``
    (the next word to read) are read and updated in place.  Returns the
    symbols, int32 ``[n]``.

    A batch of K images: cum ``[K, n, P]``, words ``[K, W]`` (each image's
    stream zero-padded to W; the rows may be a column slice of a wider
    tensor), states ``[K, N]``, offset ``[K]``; returns ``[K, n]``, still
    in one launch.
    """
    batched = cum.dim() == 3
    if cum.dtype != torch.int32 or cum.dim() != 2 + batched \
            or cum.shape[-1] < 2:
        raise ValueError("cum must be int32 [n, P >= 2] or [K, n, P >= 2]")
    if words.dtype != torch.int32 or words.dim() != 1 + batched:
        raise ValueError("words must be int32 "
                         f"{'[K, W]' if batched else '[W]'}")
    _check_carry(states, offset, "offset", batched)
    if batched and not cum.shape[0] == words.shape[0] == states.shape[0]:
        raise ValueError("cum, words and states differ in K")
    _check_tensors(cum.device, cum=cum, states=states, offset=offset)
    W = words.shape[-1]
    stride = words.stride(0) if batched else W
    if words.device != cum.device or (W > 1 and words.stride(-1) != 1) \
            or stride < W:
        raise ValueError("words must lie on cum's device, rows contiguous")
    if cum.device.type == "cpu":
        return rans_decode_plain(cum, words, states, offset)
    K = cum.shape[0] if batched else 1
    n, P = cum.shape[-2:]
    syms = torch.empty(cum.shape[:-1], dtype=torch.int32, device=cum.device)
    err = _kernels.lib().llicti_rans_decode(
        cum.data_ptr(), words.data_ptr(), W, stride, states.data_ptr(),
        offset.data_ptr(), syms.data_ptr(), n, P, states.shape[-1], K,
        _kernels.stream_ptr(cum.device))
    _kernels.check(err, "llicti_rans_decode")
    if n > 0:
        rans_decode.launches += 1
        rans_decode.wide_launches += int(states.shape[-1] > NARROW_LANES)
    return syms


rans_decode.launches = 0       # every launch of Kernel 2
rans_decode.wide_launches = 0  # those above NARROW_LANES lanes


def decode_max_clusters(N: int) -> int:
    """Clusters of the decode kernel at ``N`` lanes that the card holds at
    once: a batch of more images decodes in waves."""
    clusters = ctypes.c_int(0)
    _kernels.check(_kernels.lib().llicti_rans_decode_max_clusters(
        N, ctypes.byref(clusters)), "llicti_rans_decode_max_clusters")
    return clusters.value


# ---- encode ----------------------------------------------------------------

def rans_encode_chain_plain(starts, freqs, offsets, states, cursor,
                            buf) -> torch.Tensor:
    """Plain PyTorch version of :func:`rans_encode_chain`; a batch encodes
    its chains one after the other."""
    if starts.dim() == 2:
        return torch.stack([rans_encode_chain_plain(
            starts[k], freqs[k], offsets, states[k], cursor[k:k + 1], buf[k])
            for k in range(starts.shape[0])])
    cursors = []
    for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist()):
        rans_encode_plain(starts[a:b], freqs[a:b], states, cursor, buf)
        cursors.append(int(cursor[0]))
    return torch.tensor(cursors, dtype=torch.int32, device=starts.device)


def rans_encode_chain(starts: torch.Tensor, freqs: torch.Tensor,
                      offsets: torch.Tensor, states: torch.Tensor,
                      cursor: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """Encode a chain of slices, in order, each in reverse step order.

    starts/freqs int32 ``[n_total]``: the slices' (cum[s], cum[s+1] -
    cum[s]) concatenated in encode order; freq 0 marks a masked no-op.
    offsets int64 ``[n_slices + 1]`` on the host (they fix the launch
    shape and reach the kernels as a launch parameter): slice s is
    ``[offsets[s], offsets[s+1])``, from 0 to ``n_total``.  states int64 ``[N]``, cursor int32 ``[1]`` and buf int32
    ``[cap]`` are updated in place: the emitted words land at
    ``buf[cursor:]`` in encode order (the reverse of the stream order), and
    the cursor counts every word, so a cursor past ``cap`` means the buffer
    was too small.  Returns the cursor after each slice, int32
    ``[n_slices]``.  On a CUDA tensor: two launches (lane chains, then
    placement) whatever the number of slices.

    K chains of one plan (a batch of images of one shape): starts and
    freqs ``[K, n_total]``, states ``[K, N]``, cursor ``[K]``, buf ``[K,
    cap]``; returns ``[K, n_slices]``, still in two launches.
    """
    batched = starts.dim() == 2
    for name, t in (("starts", starts), ("freqs", freqs), ("buf", buf)):
        if t.dtype != torch.int32 or t.dim() != 1 + batched:
            raise ValueError(f"{name} must be int32 "
                             f"{'[K, k]' if batched else '[k]'}")
    if starts.shape != freqs.shape:
        raise ValueError("starts and freqs differ in shape")
    if (offsets.dtype != torch.int64 or offsets.dim() != 1
            or offsets.device.type != "cpu"):
        raise ValueError("offsets must be int64 [n_slices + 1] on the host")
    bounds = offsets.numpy()
    n = starts.shape[-1]
    if (len(bounds) < 2 or bounds[0] != 0 or bounds[-1] != n
            or (np.diff(bounds) < 0).any()):
        raise ValueError(f"offsets must rise from 0 to {n}")
    S = len(bounds) - 1
    if S > MAX_SLICES:
        raise ValueError(f"{S} slices: one call takes at most {MAX_SLICES}")
    if n >= 1 << 31:
        raise ValueError(f"{n} symbols: one call takes fewer than 2^31")
    _check_carry(states, cursor, "cursor", batched)
    K = starts.shape[0] if batched else 1
    if batched and not K == states.shape[0] == buf.shape[0]:
        raise ValueError("starts, states and buf differ in K")
    _check_tensors(starts.device, starts=starts, freqs=freqs, states=states,
                   cursor=cursor, buf=buf)
    if starts.device.type == "cpu":
        return rans_encode_chain_plain(starts, freqs, offsets, states,
                                       cursor, buf)
    N = states.shape[-1]
    ends = np.cumsum(-(-np.diff(bounds) // N))  # the chain's steps
    G = int(ends[-1])
    if G == 0:
        return cursor[..., None].expand(cursor.shape + (S,)).clone() \
            if batched else cursor.expand(S).clone()
    dev = starts.device
    plan = np.ascontiguousarray(np.concatenate([bounds, ends]), np.int32)
    lib = _kernels.lib()
    words = ctypes.c_longlong()
    lib.llicti_rans_encode_scratch(G, N, K, ctypes.byref(words))
    scratch = torch.empty((words.value,), dtype=torch.int32, device=dev)
    cursors = torch.empty(starts.shape[:-1] + (S,), dtype=torch.int32,
                          device=dev)
    err = lib.llicti_rans_encode_chain(
        starts.data_ptr(), freqs.data_ptr(), plan.ctypes.data, S, G,
        states.data_ptr(), cursor.data_ptr(), buf.data_ptr(), buf.shape[-1],
        cursors.data_ptr(), scratch.data_ptr(), N, K,
        _kernels.stream_ptr(dev))
    _kernels.check(err, "llicti_rans_encode_chain")
    rans_encode_chain.launches += 2
    rans_encode_chain.wide_launches += 2 * (N > NARROW_LANES)
    return cursors


rans_encode_chain.launches = 0       # every launch of Kernel 3
rans_encode_chain.wide_launches = 0  # those above NARROW_LANES lanes


def rans_encode_plain(starts, freqs, states, cursor, buf) -> None:
    """Plain PyTorch version of :func:`rans_encode`."""
    n = starts.shape[0]
    N = states.shape[0]
    cap = buf.shape[0]
    x = states.clone()
    cur = int(cursor[0])
    T = -(-n // N)
    for t in range(T - 1, -1, -1):
        i0 = t * N
        m = min(n, i0 + N) - i0
        start = torch.zeros_like(x)
        freq = torch.zeros_like(x)
        start[:m] = starts[i0:i0 + m]
        freq[:m] = freqs[i0:i0 + m]
        val = freq > 0
        fs = freq.clamp(min=1)
        emit = val & (x >= ((fs << 16) & _MASK32))
        word = x & 0xFFFF
        xs = torch.where(emit, x >> 16, x)
        x = torch.where(val, (((xs // fs) << 16) + xs % fs + start) & _MASK32,
                        xs)
        # emission order: lanes N-1..0; exclusive prefix in that order
        e = emit.flip(0).to(torch.int64)
        pos = (cur + torch.cumsum(e, 0) - e).flip(0)
        keep = emit & (pos < cap)
        buf[pos[keep]] = word[keep].to(torch.int32)
        cur += int(e.sum())
    states.copy_(x)
    cursor.fill_(cur)


def rans_encode(starts: torch.Tensor, freqs: torch.Tensor,
                states: torch.Tensor, cursor: torch.Tensor,
                buf: torch.Tensor) -> None:
    """Encode one slice: :func:`rans_encode_chain` of a chain of one.

    starts/freqs int32 ``[n]``; states, cursor and buf as there.
    """
    rans_encode_chain(starts, freqs,
                      torch.tensor([0, starts.shape[0]], dtype=torch.int64),
                      states, cursor, buf)


# ---- stream assembly -------------------------------------------------------

def pack_stream_packed(packed_rev: np.ndarray,
                       final_states: np.ndarray) -> bytes:
    """[N states as uint32 LE][words as uint16 LE, decode order]; the words
    come in encode order, so one flip gives the decoder's order."""
    return (np.asarray(final_states, np.uint32).tobytes()
            + np.ascontiguousarray(
                np.asarray(packed_rev, np.uint16)[::-1]).tobytes())


def stream_words(data: bytes, num_lanes: int) -> int:
    """The number of 16-bit words in a rANS blob of ``num_lanes`` lane
    states; ValueError on a blob of another size."""
    if len(data) < 4 * num_lanes or (len(data) - 4 * num_lanes) % 2:
        raise ValueError(f"rANS blob of {len(data)} bytes does not fit "
                         f"{num_lanes} lanes")
    return (len(data) - 4 * num_lanes) // 2


def unpack_stream(data: bytes,
                  num_lanes: int) -> Tuple[np.ndarray, np.ndarray]:
    """-> (states uint32 [N], words int32 [W])."""
    stream_words(data, num_lanes)
    states = np.frombuffer(data[: 4 * num_lanes], np.uint32).copy()
    words = np.frombuffer(data[4 * num_lanes:], np.uint16).astype(np.int32)
    return states, words


# ---- the decode's words on the card ----------------------------------------

def widen_words_plain(src, lengths, out, col0: int, col1: int
                      ) -> torch.Tensor:
    """Plain PyTorch version of :func:`widen_words`."""
    cols = torch.arange(col0, col1, device=src.device)
    vals = src[:, col0:col1].to(torch.int32) & 0xFFFF
    out[:, col0:col1] = torch.where(cols < lengths[:, None], vals, 0)
    return out


def widen_words(src: torch.Tensor, lengths: torch.Tensor, out: torch.Tensor,
                col0: int = 0, col1: Optional[int] = None) -> torch.Tensor:
    """Widen K streams' 16-bit words into the int32 rows that
    :func:`rans_decode` reads: ``out[k, c]`` is ``src[k, c]`` read as
    uint16 where ``c < lengths[k]`` and 0 past it, for the columns ``c`` in
    ``[col0, col1)`` (all of them by default); the other columns of ``out``
    are left as they are.

    src int16 ``[K, W]`` (each word's 16 bits, as a container stores
    them), lengths int64 ``[K]`` (each stream's words, at most W), out
    int32 ``[K, W']`` with ``W' >= col1``; each row contiguous, all on one
    device.  On CUDA tensors one launch of ``csrc/rans_widen.cu``, on CPU
    tensors the plain version.  Returns ``out``.
    """
    if src.dtype != torch.int16 or src.dim() != 2:
        raise ValueError("src must be int16 [K, W]")
    K, W = src.shape
    col1 = W if col1 is None else col1
    if lengths.dtype != torch.int64 or lengths.shape != (K,):
        raise ValueError(f"lengths must be int64 [{K}]")
    if out.dtype != torch.int32 or out.dim() != 2 or out.shape[0] != K:
        raise ValueError(f"out must be int32 [{K}, W']")
    if not 0 <= col0 <= col1 <= min(W, out.shape[1]):
        raise ValueError(f"columns [{col0}, {col1}) outside src's {W} or "
                         f"out's {out.shape[1]}")
    for name, t in (("src", src), ("out", out)):
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name}'s rows must be contiguous")
    _check_tensors(src.device, lengths=lengths)
    if out.device != src.device:
        raise ValueError(f"out on {out.device}, expected {src.device}")
    if src.device.type == "cpu":
        return widen_words_plain(src, lengths, out, col0, col1)
    err = _kernels.lib().llicti_widen_words(
        src.data_ptr(), src.stride(0), lengths.data_ptr(), out.data_ptr(),
        out.stride(0), col0, col1, K, _kernels.stream_ptr(src.device))
    _kernels.check(err, "llicti_widen_words")
    if K and col1 > col0:
        widen_words.launches += 1
    return out


widen_words.launches = 0  # every launch of the widen
