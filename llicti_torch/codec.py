"""Lossless codec: compress / decompress, one image or a batch, and the
serving entry points, with the JAX package's two entropy-coding backends.

Port of ``llicti_tpu/codec.py`` for every configuration that codec codes:
clr_joint_mode 0, 1 and 2 (with clrjnt0seqmd), normal and logistic
mixtures, and any model knob (activation incl. GDN1, mwsa_joint,
combine_layers1toL, useprevlevNN).  One device pipeline with a leading K
axis serves every pass: K = 1 is the single image, K > 1 the batch
container (K images of one shape).  Per scale, coarse to fine, and per
band, one shared function (:meth:`Codec._band`) runs the interpolator conv
on the bands decoded so far and hands each colour's parameter rows to the
pass's coder, writing back what a decoder returns.

``backend="device"`` (the default): per colour the quantised CDF table of
all K images' pixels (Kernel 1; with ``use_kernel_cdf=False`` the float
mixture CDF in plain PyTorch, quantised to int32, the JAX package's
``use_pallas_cdf=False`` path and its default), then either the encoder's
(start, freq) or the rANS decode of the band of all K images in one launch
(Kernel 2).
The encoder encodes all 45 slices, in reverse decode order, into one
stream per image with one chain call of the rANS encoder (Kernel 3) for
the K images.  ``backend="host"``: the reference-parity range coder
(``coder/range_coder.py``, C++ on the host under torchac's uint16-CDF
contract) on float CDF tables built in plain PyTorch on the device
(:meth:`Codec._cdf_u16`); the encoder ships two uint16 a pixel to the host
and codes a scale's 9 streams on a thread pool, the decoder ships each
slice's table and decodes it on the host.  clr_joint_mode 1 codes a zero
channel in front of (Y, Co, Cg); with clrjnt0seqmd (device backend only)
the trunk runs once per colour on the band's layer-0 map plus the pixel's
colours decoded so far.

Bit-exactness: encoder and decoder must compute identical CDF tables.
Both run the same convs on conditioning tensors of identical shape,
layout and values, and the same CDF code; every int -> float conversion
is ``int.float() * INV255`` on both sides.  Every pass runs under
:func:`exact_math` (TF32 and cuDNN autotuning off, deterministic
algorithms on), which restores the caller's flags when it returns, so the
codec neither depends on nor changes the process's settings.  cuDNN may
pick another algorithm for another batch size, so an image's tables in a
batch of K need not equal its tables alone: a batch container decodes
only through the batch path (:meth:`Codec.decompress_batch`), at its own
K, and a single container only through the single path.  On the card a
batch of K > 1 runs the interpolator's trunk at batch 1, the K images
stacked along the height (:meth:`Interpolator.get_params_batched`), in
both directions.  ``num_lanes``, like K, is matched between encoder and
decoder; the container records neither.
``two_stage`` runs the same convs and kernels on the same shapes, so its
streams equal the fused codec's and each decodes the other's.

Containers (byte for byte the JAX package's formats):
  single: streams[0] = [header, minmax int16 x6, pad_int int16,
                        raw x00 RGB [1, lh, lw, 3], b''*5]
            header = S u8 | last_h, last_w u16 | orig_h, orig_w u32 |
                     head_words u32 (stream words of scales S-1..1)
          streams[1] = [rANS blob: N lane states u32 | words u16, decode
                        order]
  batch:  streams[0] = [255, K, S u8 | last_h, last_w u16 | origs u32
                        [K, 2], union minmax int16 x6, pad_int int16,
                        raw x00 RGB [K, lh, lw, 3], b''*5]
          streams[1 + k] = [image k's rANS blob]
  host:   streams[0] = the single container's without head_words (a
                       13-byte header)
          streams[1 + s] = the 9 range-coded streams of scale S-1-s
                           (coarse to fine), index b*3 + clr
With ``size_bucket`` the image is replicate-padded to bucket multiples
before coding; the header's pad flags, ``last_h``/``last_w``, minmax and
raw band describe the padded image, ``orig`` the size the decoder crops
to.
"""
from __future__ import annotations

import collections
import contextlib
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .coder import range_coder
from .coder.rans import (RANS_L, pack_stream_packed, rans_decode,
                         rans_encode_chain, stream_words, widen_words)
from .config import ModelConfig
from .models.interpolator import Interpolator, seq_colours
from .ops.cdf import gmm_cdf_from_pmap
from .ops.color import (rgb_int_to_ycocg_r_int, rgb_int_to_ycocg_r_int_np,
                        ycocg_r_int_to_rgb_int)
from .ops.gdn import GDN1
from .ops.gmm import (cdf_float_to_cum_int32, cdf_float_to_uint16,
                      cdf_sampling_points, cum_start_freq, gmm_cdf_table)
from .ops.wavelet import (band_coded_shape, interleave_scale, lazy_dwt,
                          pad_decoded_band, unpack_pad_flags)
from .tracing import entry, span
from .weights import params_from_flax

RANGE_BUCKET = 32
INV255 = np.float32(1.0 / 255.0)
_SHIFT = (127, 0, 0)  # Y is coded around 127/255


@contextlib.contextmanager
def exact_math():
    """For the duration of a pass, the arithmetic under which encoder and
    decoder compute identical CDF tables: cuDNN on, no autotuning,
    deterministic algorithms, TF32 off in cuDNN and in matmuls.  cuDNN
    picks a conv's algorithm when the conv is enqueued, so the context
    must cover the enqueue, not a later synchronisation.  The caller's
    values come back on exit, also after an exception."""
    matmul = torch.backends.cuda.matmul
    tf32 = matmul.allow_tf32
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        matmul.allow_tf32 = False
        try:
            yield
        finally:
            matmul.allow_tf32 = tf32


@functools.lru_cache(maxsize=None)
def _settle_cpu_math() -> None:
    """Run PyTorch's CPU exp and erfc once on one thread.  Their first call
    in a process, if it runs on several threads at once, can take another
    code path in one thread's share (a block of values ~1e-4 off, in about
    one process in ten on an 8-core CPU), so a CPU encoder's first CDF
    tables would differ from its decoder's; after one single-threaded call
    every call agrees."""
    x = torch.zeros(8)
    torch.exp(x)
    torch.special.erfc(x)


def _pass(name: str):
    """Run a codec method under inference mode and :func:`exact_math`, in
    the entry span ``name`` (``llicti.compress`` or ``llicti.decompress``)."""
    def wrap(method):
        @functools.wraps(method)
        def run(*args, **kwargs):
            with entry(name), torch.inference_mode(), exact_math():
                return method(*args, **kwargs)
        return run
    return wrap


def clr_offset(cfg: ModelConfig) -> int:
    """Channel of Y inside a band unit: clr_joint_mode 1 puts a zero
    channel in front of (Y, Co, Cg)."""
    return 1 if cfg.clr_joint_mode == 1 else 0


def sym_channel(cfg: ModelConfig, b: int, clr: int) -> int:
    """Channel of colour ``clr`` of band ``b`` inside a y_lev tensor."""
    return cfg.cond_channels * (b + 1) + clr_offset(cfg) + clr


def gmm_slice_params(cfg: ModelConfig, pmap, y_lev, b: int, clr: int):
    """(stdevs, means, weights) ``[..., M_eff]`` of colour ``clr`` of band
    ``b``, sliced out of the parameter map ``[..., CO]`` with the
    cross-colour mean updates applied from ``y_lev`` ``[..., YC]`` (the
    parameter layouts per clr_joint_mode; JAX ``codec.py:70-108``)."""
    M = cfg.num_mixtures
    if cfg.clr_joint_mode == 0:
        return (pmap[..., 3 * clr * M:(3 * clr + 1) * M],
                pmap[..., (3 * clr + 1) * M:(3 * clr + 2) * M],
                pmap[..., (3 * clr + 2) * M:(3 * clr + 3) * M])
    if cfg.clr_joint_mode == 1:
        if clr == 0:  # Y uses 2M mixtures
            return (pmap[..., 2 * M:4 * M], pmap[..., 4 * M:6 * M],
                    pmap[..., 6 * M:8 * M])
        i = clr - 1
        stdevs = pmap[..., (8 + i) * M:(9 + i) * M]
        means = pmap[..., (10 + i) * M:(11 + i) * M]
        weights = pmap[..., (12 + i) * M:(13 + i) * M]
        if clr == 2:  # mean_Cg += a * Co
            ch = sym_channel(cfg, b, 1)
            means = means + pmap[..., 14 * M:15 * M] * y_lev[..., ch:ch + 1]
        return stdevs, means, weights
    ch0 = sym_channel(cfg, b, 0)
    ch1 = sym_channel(cfg, b, 1)
    y0 = y_lev[..., ch0:ch0 + 1]
    y1 = y_lev[..., ch1:ch1 + 1]
    stdevs = pmap[..., clr * M:(clr + 1) * M]
    means = pmap[..., (3 + clr) * M:(4 + clr) * M]
    weights = pmap[..., (6 + clr) * M:(7 + clr) * M]
    if clr == 1:
        means = means + pmap[..., 9 * M:10 * M] * y0
    elif clr == 2:
        means = means + (pmap[..., 10 * M:11 * M] * y0
                         + pmap[..., 11 * M:12 * M] * y1)
    return stdevs, means, weights


def pmap_cdf_spec(cfg: ModelConfig, b: int, clr: int):
    """(M_eff, std0, mean0, w0, upd) columns of one colour in the raw pmap;
    ``upd`` holds the (coef_col, y_channel) cross-colour mean updates."""
    M = cfg.num_mixtures
    if cfg.clr_joint_mode == 0:
        return (M, 3 * clr * M, (3 * clr + 1) * M, (3 * clr + 2) * M, ())
    if cfg.clr_joint_mode == 1:
        if clr == 0:
            return (2 * M, 2 * M, 4 * M, 6 * M, ())
        i = clr - 1
        upd = ((14 * M, sym_channel(cfg, b, 1)),) if clr == 2 else ()
        return (M, (8 + i) * M, (10 + i) * M, (12 + i) * M, upd)
    ch0 = sym_channel(cfg, b, 0)
    ch1 = sym_channel(cfg, b, 1)
    upd = ()
    if clr == 1:
        upd = ((9 * M, ch0),)
    elif clr == 2:
        upd = ((10 * M, ch0), (11 * M, ch1))
    return (M, clr * M, (3 + clr) * M, (6 + clr) * M, upd)


def bucket_range(min_val: int, max_val: int) -> Tuple[int, int]:
    """Round a symbol range outward to RANGE_BUCKET multiples."""
    lo = (min_val // RANGE_BUCKET) * RANGE_BUCKET
    hi = -((-(max_val + 1)) // RANGE_BUCKET) * RANGE_BUCKET - 1
    return int(lo), int(hi)


def clr_range(clr: int, minmax: Sequence[int]) -> Tuple[int, int]:
    """Bucketed symbol range of one colour from the image's min/max; Y is
    clamped to [-127, 128]."""
    if clr == 0:
        lo, hi = bucket_range(int(minmax[0]) - 127, int(minmax[3]) - 127)
        return max(lo, -127), min(hi, 128)
    return bucket_range(int(minmax[clr]), int(minmax[3 + clr]))


def pad_flags_for_shape(h: int, w: int, levels: Sequence[int]):
    """(pad flags per level, packed pad int), from the shape alone."""
    flags = []
    pad_int = 0
    for lev in range(0, max(levels) + 1):
        if lev not in levels:
            continue
        st = 2 ** (lev + 1)
        of = st // 2
        h00 = -(-h // st)
        w00 = -(-w // st)
        h11 = (h - of + st - 1) // st
        w11 = (w - of + st - 1) // st
        padH, padW = h00 > h11, w00 > w11
        flags.append((padH, padW))
        pad_int = 4 * pad_int + 2 * int(padH) + int(padW)
    return flags, pad_int


def scale_shapes(S: int, last_h: int, last_w: int,
                 pad_flags) -> List[Tuple[int, int, int]]:
    """(scl, h, w) of every scale in decode order."""
    h, w = last_h, last_w
    shapes = [(S - 1, h, w)]
    for scl in range(S - 2, -1, -1):
        h = 2 * h - int(pad_flags[scl + 1][0])
        w = 2 * w - int(pad_flags[scl + 1][1])
        shapes.append((scl, h, w))
    return shapes


def words_cap(num_lanes: int, S: int, last_h: int, last_w: int,
              pad_flags, min_scl: int = 0) -> int:
    """Worst-case stream words of an image (each symbol emits at most one
    word), from its shape alone; ``min_scl=1`` gives the words that scales
    S-1..1, the head of a two-stage decode, can read."""
    total = num_lanes
    for scl, h, w in scale_shapes(S, last_h, last_w, pad_flags):
        if scl < min_scl:
            continue
        padH, padW = pad_flags[scl]
        for b in range(3):
            ch, cw = band_coded_shape(h, w, b, padH, padW)
            bucket = max(64, -(-(ch * cw) // 4096) * 4096)
            total += 3 * (-(-bucket // num_lanes) * num_lanes)
    return -(-total // 65536) * 65536




def _group(header: bytes, minmax, pad_int, raw: bytes) -> List[bytes]:
    return [header, np.array(minmax, np.int16).tobytes(),
            np.array([pad_int], np.int16).tobytes(), raw,
            b"", b"", b"", b"", b""]


def header_group(S, last_h, last_w, orig_h, orig_w, minmax, pad_int,
                 raw: bytes, head_words: Optional[int]) -> List[bytes]:
    """streams[0] of a single-image container; a host-backend container
    records no ``head_words`` (None)."""
    head = (b"" if head_words is None
            else np.array([head_words], np.uint32).tobytes())
    return _group(np.array([S], np.uint8).tobytes()
                  + np.array([last_h, last_w], np.uint16).tobytes()
                  + np.array([orig_h, orig_w], np.uint32).tobytes() + head,
                  minmax, pad_int, raw)


def batch_header_group(S, last_h, last_w, origs, minmax, pad_int,
                       raw: bytes) -> List[bytes]:
    """streams[0] of a batch container of ``len(origs)`` images."""
    K = len(origs)
    return _group(np.array([255, K, S], np.uint8).tobytes()
                  + np.array([last_h, last_w], np.uint16).tobytes()
                  + np.array(origs, np.uint32).reshape(K, 2).tobytes(),
                  minmax, pad_int, raw)


def host_header(rgb: np.ndarray, levels: Sequence[int]):
    """(per-colour [min..., max...] of YCoCg over all images, raw
    coarsest-x00 RGB bands [K, lh, lw, 3]) of a [K, H, W, 3] uint8 batch,
    on the host: the numpy twin of what :meth:`Codec._stage` reduces on the
    device."""
    ycocg = rgb_int_to_ycocg_r_int_np(rgb)
    minmax = ([int(ycocg[..., c].min()) for c in range(3)]
              + [int(ycocg[..., c].max()) for c in range(3)])
    stride = 2 ** (max(levels) + 1)
    raw = np.ascontiguousarray(rgb[:, ::stride, ::stride, :])
    return minmax, raw.astype(np.uint8)


def coded_shape(last_h: int, last_w: int, pad_flags) -> Tuple[int, int]:
    """The (padded) image size that a header's last_h, last_w and pad flags
    describe."""
    _, h, w = scale_shapes(len(pad_flags), last_h, last_w, pad_flags)[-1]
    return 2 * h - int(pad_flags[0][0]), 2 * w - int(pad_flags[0][1])


class Header(NamedTuple):
    """A parsed container header: one image, or a batch of K."""
    minmax: List[int]
    pad_flags: List[Tuple[bool, bool]]
    raw: np.ndarray               # coarsest x00 RGB, uint8 [K, lh, lw, 3]
    origs: List[Tuple[int, int]]  # each image's size before padding
    head_words: Optional[int]     # words of scales S-1..1 (single only)


def _checked_header(levels, last_h, last_w, origs, group, head_words):
    """The Header of streams[0] ``group``; ValueError unless it describes
    K = len(origs) images of ``levels``: the pad flags must be those of the
    padded size that last_h, last_w and the flags give, each original size
    must fit inside it, the raw bands must have its shape, and the colour
    ranges must be YCoCg-R's (wider ones would make huge CDF tables)."""
    if len(group) < 4 or len(group[2]) != 2:
        raise ValueError("inconsistent container header")
    minmax = [int(v) for v in np.frombuffer(group[1], np.int16)]
    pad_int = int(np.frombuffer(group[2], np.int16)[0])
    pad_flags = unpack_pad_flags(pad_int, len(levels))
    H, W = coded_shape(last_h, last_w, pad_flags)
    stride = 2 ** (max(levels) + 1)
    lo, hi = (0, -255, -255), (255, 255, 255)
    if (len(minmax) != 6 or min(H, W) <= stride // 2
            or (last_h, last_w) != (-(-H // stride), -(-W // stride))
            or pad_int != pad_flags_for_shape(H, W, levels)[1]
            or len(group[3]) != len(origs) * last_h * last_w * 3
            or not all(1 <= oh <= H and 1 <= ow <= W for oh, ow in origs)
            or not all(lo[c] <= minmax[c] <= minmax[3 + c] <= hi[c]
                       for c in range(3))):
        raise ValueError("inconsistent container header")
    raw = np.frombuffer(group[3], np.uint8).reshape(
        len(origs), last_h, last_w, 3)
    return Header(minmax, pad_flags, raw, list(origs), head_words)


def host_coded(streams: List[List[bytes]]) -> bool:
    """Whether a single-image container holds the host backend's groups
    of 9 range-coded streams (else one rANS stream)."""
    return len(streams) > 1 and len(streams[1]) == 9


def parse_container(streams: List[List[bytes]],
                    levels: Sequence[int]) -> Header:
    """The Header of a single-image container of either backend: one rANS
    stream, or S groups of 9 range-coded streams; ValueError on one that
    does not describe an image of ``levels`` (see
    :func:`_checked_header`)."""
    with span("llicti.unpack"):
        S = len(levels)
        device = len(streams) == 2 and len(streams[1]) == 1
        host = (len(streams) == 1 + S
                and all(len(g) == 9 for g in streams[1:]))
        if not (device or host) or len(streams[0]) < 4:
            raise ValueError("not a single-image container (one rANS "
                             f"stream, or {S} groups of 9 range-coded "
                             "streams)")
        hdr = streams[0][0]
        if len(hdr) < 13 or hdr[0] != len(levels):
            raise ValueError(
                f"header does not describe {len(levels)} scales")
        last_h, last_w = (int(v)
                          for v in np.frombuffer(hdr[1:5], np.uint16))
        orig = tuple(int(v) for v in np.frombuffer(hdr[5:13], np.uint32))
        head = (int(np.frombuffer(hdr[13:17], np.uint32)[0])
                if len(hdr) >= 17 else None)
        return _checked_header(levels, last_h, last_w, [orig], streams[0],
                               head)


def parse_batch_container(streams: List[List[bytes]],
                          levels: Sequence[int]) -> Header:
    """The Header of a batch container, validated as
    :func:`parse_container` validates a single one, plus its marker, K and
    the one blob of each image."""
    with span("llicti.unpack"):
        hdr = streams[0][0] if streams and streams[0] else b""
        if len(hdr) < 3 or hdr[0] != 255:
            raise ValueError("not a batch container")
        K, S = hdr[1], hdr[2]
        if S != len(levels):
            raise ValueError(
                f"header does not describe {len(levels)} scales")
        if (K < 1 or len(hdr) != 7 + 8 * K or len(streams) != 1 + K
                or any(len(g) != 1 for g in streams[1:])):
            raise ValueError("inconsistent batch container")
        last_h, last_w = (int(v)
                          for v in np.frombuffer(hdr[3:7], np.uint16))
        origs = [tuple(int(v) for v in row) for row in
                 np.frombuffer(hdr[7:], np.uint32).reshape(K, 2)]
        return _checked_header(levels, last_h, last_w, origs, streams[0],
                               None)


def serialize(streams: List[List[bytes]]) -> bytes:
    """Flatten the nested stream list into one length-prefixed blob."""
    out = [np.array([len(streams)], np.uint32).tobytes()]
    for group in streams:
        out.append(np.array([len(group)], np.uint32).tobytes())
        for s in group:
            out.append(np.array([len(s)], np.uint32).tobytes())
            out.append(s)
    return b"".join(out)


def deserialize(blob: bytes) -> List[List[bytes]]:
    off = 0

    def u32():
        nonlocal off
        if off + 4 > len(blob):
            raise ValueError("truncated container")
        v = int(np.frombuffer(blob[off:off + 4], np.uint32)[0])
        off += 4
        return v

    streams = []
    for _ in range(u32()):
        group = []
        for _ in range(u32()):
            ln = u32()
            if off + ln > len(blob):
                raise ValueError("truncated container")
            group.append(blob[off:off + ln])
            off += ln
        streams.append(group)
    return streams


def num_bytes(streams: List[List[bytes]]) -> int:
    return sum(len(s) for g in streams for s in g)


class _Staged(NamedTuple):
    """What the host holds of an encode of K images of one (padded) shape."""
    rgb: np.ndarray               # uint8 [K, H, W, 3]
    origs: List[Tuple[int, int]]
    minmax: List[int]             # YCoCg-R's, union over the K images
    raw: np.ndarray               # uint8 [K, lh, lw, 3]
    pad_flags: List[Tuple[bool, bool]]
    pad_int: int
    last_h: int
    last_w: int
    cap: int                      # words of each image's stream buffer
    ranges: List[Tuple[int, int]]


class _Words(NamedTuple):
    """A container's rANS streams staged on the host for its decode, in
    regions of the codec's staging blocks."""
    words: torch.Tensor   # int16 [K, W]: stream k's 16-bit words in row k,
                          # unwritten past its length
    small: torch.Tensor   # int64 [K * N + K]: the lane states [K, N], then
                          # each stream's length in words


class _DecodeInputs(NamedTuple):
    """A container's buffers on the device, ready to decode."""
    hdr: Header
    raw: torch.Tensor                  # uint8 [K, lh, lw, 3]
    words: torch.Tensor                # int32 [K, W]
    states: torch.Tensor               # int64 [K, N], updated in place
    head: Optional[torch.Tensor]       # two-stage: the columns scales
                                       # S-1..1 read
    tail_ready: Optional[torch.cuda.Event]  # two-stage split copy: scale 0
                                            # waits on it



class Codec:
    """Encoder/decoder around trained interpolator weights.

    ``params``: the JAX package's Flax parameters as numpy arrays (nested,
    or flat as :func:`llicti_torch.weights.load_npz` or
    :func:`llicti_torch.weights.init_params` give them).
    ``device`` is the CUDA card unless the caller asks for ``"cpu"``;
    without a card, a CUDA codec raises rather than falling back.
    ``num_lanes`` (any N >= 1, as in the JAX package) is an
    encoder/decoder-matched parameter: the container does not record it,
    nor ``use_kernel_cdf`` (True: the CDF tables from Kernel 1; False: the
    float mixture CDF of the host backend's tables in plain PyTorch on the
    device, quantised to int32 as the JAX package's default
    ``use_pallas_cdf=False`` does, with no Kernel 1 launch).
    ``size_bucket`` (a multiple of the coarsest stride, 0 for off)
    replicate-pads every image to bucket multiples, so a ragged set of
    images is coded at a few padded shapes (``compiled_shapes``, the JAX
    package's name); the decoder crops back.
    ``two_stage`` splits each decode at the finest scale: scales S-1..1 run
    on the stream's first ``head_words`` words while the rest copies to
    the card on a second CUDA stream.  ``backend="host"`` codes single
    images with the host range coder, ``num_threads`` streams at once;
    as in the JAX package, ``compress_many`` and ``prepare_encode`` code
    with the device coder whatever the backend, every decoder takes
    either backend's single containers (a host one synchronously; not
    ``prepare_decode``), and ``compress_batch``, ``two_stage`` and
    clrjnt0seqmd need the device backend (ValueError).  Codes what the
    JAX ``Codec`` codes and raises ``NotImplementedError`` on the rest:
    subtract_mean, ycocg=False, clrchs < 3, a single mixture, and
    clrjnt0seqmd with GDN1 (which couples the colours' channel groups).
    Every pass runs under :func:`exact_math` and leaves the process's
    cuDNN / TF32 flags as it found them.

    Accounting: after an encode, ``last_slice_bits_batch`` and
    ``last_ideal_bits_batch`` hold one [scale][b*3+clr] table per image
    (stream bits and the ideal bits of the coder's own tables), and
    ``last_slice_bits`` / ``last_ideal_bits`` their elementwise sums; the
    host backend keeps stream bits only (ideal bits None).
    ``staging_counts`` counts how each device-backend decode found the
    decoder's staging block (its rANS words' host buffer, reused from
    decode to decode): "reused", "grown" (allocated anew, larger) and
    "waited" (a copy out of it was still pending, as after an unsynchronised
    :meth:`decompress_dispatch`).
    """

    serialize = staticmethod(serialize)
    deserialize = staticmethod(deserialize)
    num_bytes = staticmethod(num_bytes)

    def __init__(self, cfg: ModelConfig, params, device="cuda",
                 num_lanes: int = 512, size_bucket: int = 0,
                 two_stage: bool = False, backend: str = "device",
                 num_threads: int = 8, use_kernel_cdf: bool = True):
        refused = [why for bad, why in (
            (cfg.clrchs != 3, "clrchs < 3"),
            (cfg.clr_joint_mode not in (0, 1, 2),
             f"clr_joint_mode={cfg.clr_joint_mode}"),
            (not cfg.ycocg, "ycocg=False"),
            (cfg.subtract_mean, "subtract_mean"),
            (cfg.num_mixtures < 2, "num_mixtures < 2"),
            (seq_colours(cfg) and cfg.activfun == "GDN1",
             "clrjnt0seqmd with GDN1")) if bad]
        if refused:
            raise NotImplementedError(
                f"the codec does not code {', '.join(refused)} (neither "
                "does the JAX package's)")
        if backend not in ("device", "host"):
            raise ValueError(f"backend={backend!r}: 'device' or 'host'")
        if backend == "host" and seq_colours(cfg):
            raise ValueError("clrjnt0seqmd codes through the device backend")
        if backend == "host" and two_stage:
            raise ValueError("two_stage splits the device backend's decode")
        if num_threads < 1:
            raise ValueError(f"num_threads={num_threads}: must be >= 1")
        if num_lanes < 1:
            raise ValueError(f"num_lanes={num_lanes}: must be >= 1")
        stride = 2 ** (max(cfg.dwtlevels) + 1)
        if size_bucket < 0 or size_bucket % stride:
            raise ValueError(f"size_bucket={size_bucket}: must be a "
                             f"multiple of {stride}")
        if two_stage and cfg.num_scales < 2:
            raise ValueError("two_stage splits the decode at the finest "
                             "scale: it needs two scales or more")
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Codec runs on the CUDA card by default and none is "
                "available; pass device='cpu' for the plain versions")
        if self.device.type == "cpu":
            _settle_cpu_math()
        self.backend = backend
        self.use_kernel_cdf = use_kernel_cdf
        self.num_threads = num_threads
        self.N = num_lanes
        self.size_bucket = size_bucket
        self.two_stage = two_stage
        self.compiled_shapes: set = set()
        self.logistic = cfg.distribution == "logistic"
        self.model = params_from_flax(params, cfg).to(self.device)
        # GDN1's effective beta and gamma, and a grouped layer 0's
        # ungrouped kernel, are constants of every pass: computed once
        # here, not in each call of a band net
        for mod in self.model.modules():
            if isinstance(mod, (GDN1, Interpolator)):
                mod.hold()
        self._pts: Dict[Tuple[int, int], torch.Tensor] = {}
        self._shift = torch.tensor(_SHIFT, dtype=torch.int32).to(self.device)
        self._side = (torch.cuda.Stream(self.device)
                      if two_stage and self.device.type == "cuda" else None)
        self.last_slice_bits: Optional[List[List[int]]] = None
        self.last_ideal_bits: Optional[List[List[float]]] = None
        self.last_slice_bits_batch: Optional[List[List[List[int]]]] = None
        self.last_ideal_bits_batch: Optional[List[List[List[float]]]] = None
        self.last_ycocg_err: Optional[int] = None
        # a row-sharded codec's (parallel.codec_sp) exchange of its layer-0
        # convs' boundary rows with the neighbouring ranks
        self._halo = None
        # the decoder's staging blocks (words; states and lengths), pinned
        # on a card, and the events after the copies out of them
        self._blocks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._block_copies: List[torch.cuda.Event] = []
        self.staging_counts: collections.Counter = collections.Counter()

    # ---- host <-> card ---------------------------------------------------
    def _host(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` as a host tensor, pinned on a CUDA codec so that its copy
        to the card is asynchronous."""
        if self.device.type != "cuda":
            return torch.from_numpy(np.require(arr, requirements=["C", "W"]))
        # one copy into a pinned block, also for a read-only array (a
        # header's raw band)
        pinned = torch.empty(arr.shape, pin_memory=True, dtype=torch.from_numpy(
            np.empty(0, arr.dtype)).dtype)
        np.copyto(pinned.numpy(), arr)
        return pinned

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return self._host(arr).to(self.device, non_blocking=True)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        with span("llicti.upload"):
            return self._to_device(arr)

    def _fetch(self, tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
        """Device tensors -> numpy arrays, after one synchronisation."""
        with span("llicti.fetch"):
            hosts = list(tensors)
            if self.device.type != "cpu":
                hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in tensors]
                for h, t in zip(hosts, tensors):
                    h.copy_(t, non_blocking=True)
            self._settle()
            return [h.numpy() for h in hosts]

    def _settle(self) -> None:
        """Wait for the work queued on the codec's stream (nothing to wait
        for on the CPU)."""
        with span("llicti.wait"):
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()

    # ---- shared pieces ---------------------------------------------------
    def _pts3(self, ranges) -> List[torch.Tensor]:
        for r in ranges:
            if r not in self._pts:
                self._pts[r] = cdf_sampling_points(*r).to(self.device)
        return [self._pts[r] for r in ranges]

    def _to_y(self, ycocg_int: torch.Tensor) -> torch.Tensor:
        return (ycocg_int - self._shift).float() * INV255

    def _band(self, y_lev: torch.Tensor, scl: int, b: int, padH: bool,
              padW: bool, code) -> None:
        """One band of K images, shared by every pass: the conv on the
        bands before it, then for each colour ``code(b, clr, pm, y2)`` on
        the band's coded pixels, ``pm`` ``[K*n, CO]`` the colour's
        parameter rows and ``y2`` ``[K*n, YC]`` the pixels' channels of
        ``y_lev``.  A decoder's code returns the colour's values int32
        ``[K*n]`` (symbol + range minimum), written back into ``y_lev`` in
        place before the next colour's rows are cut; an encoder's returns
        None."""
        with span("llicti.band"):
            cfg = self.cfg
            c = cfg.cond_channels
            K = y_lev.shape[0]
            ch, cw = band_coded_shape(y_lev.shape[1], y_lev.shape[2], b,
                                      padH, padW)
            n = ch * cw

            def coded_rows(t):  # [K, h, w, C] -> [K * ch * cw, C]
                return t[:, :ch, :cw].reshape(K * n, -1).contiguous()

            y_cond = y_lev[..., :c * (b + 1)].contiguous()
            seq = seq_colours(cfg)
            with span("llicti.interp"):
                if seq:
                    base = self.model.band_base(y_cond, scl, b, self._halo)
                elif K > 1 and self._halo is None \
                        and self.device.type == "cuda":
                    # the trunk at batch 1, where cuDNN launches no
                    # transposes around its last conv
                    with span("llicti.stack"):
                        pm = coded_rows(self.model.band_params_batched(
                            y_cond, scl, b))
                else:
                    pm = coded_rows(self.model.band_params(y_cond, scl, b,
                                                           self._halo))
            sch0 = sym_channel(cfg, b, 0)
            for clr in range(3):
                if seq:
                    # this colour's params from the pixel's colours decoded
                    # so far: both directions run the trunk on the same
                    # shapes
                    with span("llicti.interp"), \
                            span("llicti.seq", self.device):
                        pm = coded_rows(self.model.band_params_seq(
                            base, y_lev[..., sch0:sch0 + 2], scl, b, clr))
                # rebuilt per colour: decode writes each colour back before
                # the next one's cross-colour mean update reads it
                vals = code(b, clr, pm, coded_rows(y_lev))
                if vals is not None:
                    v = vals.view(K, ch, cw, 1).float() * INV255
                    y_lev[..., sym_channel(cfg, b, clr)] = pad_decoded_band(
                        v, b, padH, padW)[..., 0]

    def _cdf_float(self, pm, y2, pts, b: int, clr: int) -> torch.Tensor:
        """One colour's float mixture CDF ``[n, P]`` at ``pts``, from its
        mixture parameters (cross-colour mean updates from ``y2``); shared
        by both directions on the same shapes."""
        stdevs, means, weights = gmm_slice_params(self.cfg, pm, y2, b, clr)
        return gmm_cdf_table(pts, stdevs, means, weights,
                             logistic=self.logistic)

    def _tables(self, b, clr, pm, y2, ranges, pts3):
        """One colour's int32 CDF table [K*n, P] and the encoder's (start,
        freq) [K*n] at the pixels' symbols: Kernel 1, or with
        ``use_kernel_cdf=False`` the float mixture CDF quantised in plain
        PyTorch."""
        with span("llicti.kernel1"):
            sch = sym_channel(self.cfg, b, clr)
            if self.use_kernel_cdf:
                M, std0, mean0, w0, upd = pmap_cdf_spec(self.cfg, b, clr)
                return gmm_cdf_from_pmap(
                    pts3[clr], pm, y2, M, std0, mean0, w0, upd,
                    self.logistic, sch, ranges[clr][0])
            cum = cdf_float_to_cum_int32(self._cdf_float(pm, y2, pts3[clr],
                                                         b, clr))
            return (cum,) + cum_start_freq(cum, y2[:, sch], ranges[clr][0])

    def _front(self, rgb_dev: torch.Tensor) -> List[torch.Tensor]:
        """uint8 RGB [K, H, W, 3] on the device -> the encoder's per-scale
        band tensors (integer YCoCg-R, shifted, /255; padded lazy
        wavelet)."""
        with span("llicti.wavelet"):
            x = self._to_y(rgb_int_to_ycocg_r_int(rgb_dev))
            if clr_offset(self.cfg):
                x = torch.cat((torch.zeros_like(x[..., :1]), x), dim=-1)
            return lazy_dwt(x, self.cfg.dwtlevels, pad=True)[0]

    # ---- encode ----------------------------------------------------------
    def _prepare(self, rgb: np.ndarray) -> Tuple[np.ndarray, int, int]:
        """[H, W, 3] / [1, H, W, 3] uint8 -> (padded [1, H', W', 3], orig_h,
        orig_w); with ``size_bucket`` replicate-padded to bucket
        multiples."""
        rgb = np.asarray(rgb)
        if rgb.ndim == 3:
            rgb = rgb[None]
        if rgb.dtype != np.uint8 or rgb.ndim != 4 or rgb.shape[0] != 1 \
                or rgb.shape[-1] != 3:
            raise ValueError(f"expected [H, W, 3] uint8, got {rgb.dtype} "
                             f"{rgb.shape}")
        oh, ow = rgb.shape[1], rgb.shape[2]
        if self.size_bucket:
            B = self.size_bucket
            rgb = np.pad(rgb, ((0, 0), (0, -(-oh // B) * B - oh),
                               (0, -(-ow // B) * B - ow), (0, 0)),
                         mode="edge")
        H, W = rgb.shape[1], rgb.shape[2]
        if min(H, W) <= 2 ** max(self.cfg.dwtlevels):
            raise ValueError(f"{H}x{W} is too small for "
                             f"{self.cfg.num_scales} scales")
        self.compiled_shapes.add((H, W))
        return rgb, oh, ow

    def _batch(self, imgs: Sequence[np.ndarray]):
        """Images of one padded shape -> (uint8 [K, H', W', 3], each
        image's size before padding)."""
        if not len(imgs):
            raise ValueError("no images")
        prepped = [self._prepare(im) for im in imgs]
        if len({p[0].shape for p in prepped}) != 1:
            raise ValueError("a batch takes images of one shape (after "
                             "size_bucket padding)")
        return (np.concatenate([p[0] for p in prepped]),
                [(oh, ow) for _, oh, ow in prepped])

    def _stage(self, batches: Sequence[Sequence[np.ndarray]]):
        """Stage groups of images, each of one padded shape, for an encode:
        each group padded and joined on the host and uploaded (pinned,
        asynchronous); then every group's YCoCg-R [min..., max...] over its
        K images reduced on the device and fetched in one synchronisation,
        and its header built with the raw coarsest band.  The ranges set
        Kernel 1's sampling points, so they reach the host before any band
        is queued.  ->
        (a _Staged a group, its uint8 [K, H', W', 3] on the device)."""
        with span("llicti.stage"):
            host = [self._batch(imgs) for imgs in batches]
            devs = [self._upload(rgb) for rgb, _ in host]
            levels = self.cfg.dwtlevels
            stride = 2 ** (max(levels) + 1)
            with span("llicti.host_header"):
                mms = self._fetch([torch.cat(torch.aminmax(
                    rgb_int_to_ycocg_r_int(d).reshape(-1, 3), dim=0))
                    for d in devs])
                staged = []
                for (rgb, origs), mm in zip(host, mms):
                    H, W = rgb.shape[1], rgb.shape[2]
                    pad_flags, pad_int = pad_flags_for_shape(H, W, levels)
                    last_h, last_w = -(-H // stride), -(-W // stride)
                    minmax = [int(v) for v in mm]
                    staged.append(_Staged(
                        rgb, origs, minmax,
                        np.ascontiguousarray(rgb[:, ::stride, ::stride]),
                        pad_flags, pad_int, last_h, last_w,
                        words_cap(self.N, self.cfg.num_scales, last_h,
                                  last_w, pad_flags),
                        [clr_range(clr, minmax) for clr in range(3)]))
            return staged, devs

    def _encode_slices(self, rgb_dev: torch.Tensor, st: _Staged):
        """Queue the convs and CDF tables of an encode of ``rgb_dev`` (uint8
        [K, H, W, 3] on the card): the (start, freq) int32 ``[K, n]`` pair
        of every slice, in decode order."""
        pts3 = self._pts3(st.ranges)
        y_list = self._front(rgb_dev)
        K = rgb_dev.shape[0]
        sf = []

        def code(b, clr, pm, y2):
            _, start, freq = self._tables(b, clr, pm, y2, st.ranges, pts3)
            sf.append((start.view(K, -1), freq.view(K, -1)))

        for scl in range(self.cfg.num_scales - 1, -1, -1):
            padH, padW = st.pad_flags[scl]
            for b in range(3):
                self._band(y_list[scl], scl, b, padH, padW, code)
        return sf

    def _encode_queue(self, rgb_dev: torch.Tensor, st: _Staged):
        """Queue a whole encode of the K images of ``rgb_dev``: -> (cursors
        int32 [K, 45] in encode order, states int64 [K, N], buf int32 [K,
        cap], ideal bits float32 [K, 45] in decode order), on the device;
        nothing synchronises."""
        sf = self._encode_slices(rgb_dev, st)
        K = rgb_dev.shape[0]
        with span("llicti.kernel3"):
            # one chain per image, slices in encode order (the reverse of
            # decode order), all K chains in one call
            starts = torch.cat([start for start, _ in reversed(sf)], dim=1)
            freqs = torch.cat([freq for _, freq in reversed(sf)], dim=1)
            offsets = torch.from_numpy(np.cumsum(
                [0] + [freq.shape[1] for _, freq in reversed(sf)]))
            states = torch.full((K, self.N), RANS_L, dtype=torch.int64,
                                device=self.device)
            cursor = torch.zeros((K,), dtype=torch.int32, device=self.device)
            buf = torch.zeros((K, st.cap), dtype=torch.int32,
                              device=self.device)
            cursors = rans_encode_chain(starts, freqs, offsets, states,
                                        cursor, buf)
            ideal = torch.stack([
                torch.where(freq > 0, 16.0 - torch.log2(
                    freq.clamp(min=1).float()), 0.0).sum(dim=1)
                for _, freq in sf], dim=1)
        return cursors, states, buf, ideal

    def _slice_bits_table(self, cursors_row: np.ndarray) -> List[List[int]]:
        """One image's per-slice cursors (encode order) -> its
        [scale][b*3+clr] table of stream bits, coarsest scale first."""
        counts = np.diff(np.concatenate(
            [[0], cursors_row.astype(np.int64)]))[::-1]
        return [[int(v) * 16 for v in counts[s * 9:s * 9 + 9]]
                for s in range(self.cfg.num_scales)]

    def _ideal_bits_table(self, ideal_row: np.ndarray) -> List[List[float]]:
        return [[float(v) for v in ideal_row[s * 9:s * 9 + 9]]
                for s in range(self.cfg.num_scales)]

    def _encode(self, groups: Sequence[_Staged],
                devs: Sequence[torch.Tensor]):
        """Encode staged groups (``devs`` their images on the device): every
        group's device work is queued first, then one synchronisation
        fetches all cursors, states and ideal bits, and one more all
        payloads.  -> per group, per image (rANS blob, stream bits table,
        ideal bits table)."""
        outs = [self._encode_queue(d, st) for d, st in zip(devs, groups)]
        small = self._fetch([t for cursors, states, _, ideal in outs
                             for t in (cursors, states, ideal)])
        payloads = []
        with span("llicti.pack"):
            for st, (_, _, buf, _), cursors in zip(groups, outs,
                                                   small[0::3]):
                totals = [int(v) for v in cursors[:, -1]]
                if max(totals) > st.cap:
                    raise RuntimeError(f"rANS stream of {max(totals)} words "
                                       f"overran its {st.cap}-word buffer")
                payloads += [buf[k, :t] for k, t in enumerate(totals)]
        words = iter(self._fetch(payloads))
        with span("llicti.pack"):
            return [[(pack_stream_packed(next(words), states[k]),
                      self._slice_bits_table(cursors[k]),
                      self._ideal_bits_table(ideal[k]))
                     for k in range(cursors.shape[0])]
                    for cursors, states, ideal in zip(
                        small[0::3], small[1::3], small[2::3])]

    def _account(self, per_image) -> None:
        """Keep the accounting of an encode: one table per image, and their
        elementwise sums."""
        S = self.cfg.num_scales
        act = [a for _, a, _ in per_image]
        ideal = [i for _, _, i in per_image]
        self.last_slice_bits_batch = act
        self.last_ideal_bits_batch = ideal
        self.last_slice_bits = [[sum(t[s][i] for t in act) for i in range(9)]
                                for s in range(S)]
        self.last_ideal_bits = [[sum(t[s][i] for t in ideal)
                                 for i in range(9)] for s in range(S)]

    @_pass("llicti.compress")
    def compress(self, rgb: np.ndarray) -> List[List[bytes]]:
        """Encode one image: rgb ``[H, W, 3]`` or ``[1, H, W, 3]`` uint8,
        with the codec's backend.  Fills the accounting tables
        (``*_batch`` with one table)."""
        if self.backend == "host":
            return self._compress_host(rgb)
        return self.compress_many([rgb])[0]

    @_pass("llicti.compress")
    def compress_many(self, imgs: Sequence[np.ndarray]
                      ) -> List[List[List[bytes]]]:
        """Pipelined encode of several images, each into its own
        single-image container, byte-equal to what :meth:`compress` gives:
        the host work of all images first, then every upload (pinned,
        asynchronous), one synchronisation for all images' colour ranges,
        every image's device work, then one synchronisation for all
        cursors, states and ideal bits and one for all payloads.  The
        accounting keeps one table per image.  Codes
        with the device backend, whatever the codec's, as the JAX
        package's does."""
        groups, devs = self._stage([[im] for im in imgs])
        per = [g[0] for g in self._encode(groups, devs)]
        with span("llicti.pack"):
            self._account(per)
            S = self.cfg.num_scales
            return [[header_group(S, st.last_h, st.last_w, *st.origs[0],
                                  st.minmax, st.pad_int, st.raw.tobytes(),
                                  sum(sum(row) for row in act[:-1]) // 16),
                     [blob]]
                    for st, (blob, act, _) in zip(groups, per)]

    @_pass("llicti.compress")
    def compress_batch(self, imgs: Sequence[np.ndarray]) -> List[List[bytes]]:
        """Encode K <= 254 images of one shape (after ``size_bucket``
        padding) into one batch container: one K-batched pass, each image
        with its own lanes and stream, CDF ranges the union over the batch.
        Decodes only through :meth:`decompress_batch`.  Device backend
        only."""
        if self.backend != "device":
            raise ValueError("a batch container needs the device backend")
        if not 1 <= len(imgs) <= 254:
            raise ValueError(f"a batch holds 1..254 images, got {len(imgs)}")
        (st,), devs = self._stage([imgs])
        per = self._encode([st], devs)[0]
        with span("llicti.pack"):
            self._account(per)
            return ([batch_header_group(self.cfg.num_scales, st.last_h,
                                        st.last_w, st.origs, st.minmax,
                                        st.pad_int, st.raw.tobytes())]
                    + [[blob] for blob, _, _ in per])

    @_pass("llicti.compress")
    def encode_inputs(self, imgs):
        """The encoder's rANS inputs before any is encoded, of one image
        ``[H, W, 3]`` or of a list of images of one shape: (the (start,
        freq) int32 ``[K, n]`` pair of every slice in decode order, the
        word cap of each image's stream)."""
        (st,), (dev,) = self._stage(
            [[imgs] if isinstance(imgs, np.ndarray) else imgs])
        return self._encode_slices(dev, st), st.cap

    def prepare_encode(self, rgb: np.ndarray):
        """Stage one image on the card; returns a closure whose call queues
        the whole encode and returns its device tensors (cursors int32 [1,
        45] in encode order, states int64 [1, N], buf int32 [1, cap], ideal
        bits float32 [1, 45]).  Everything shape-derived is built here, so
        the call copies nothing between host and card and never
        synchronises.  Device backend, whatever the codec's (as the JAX
        package's)."""
        (st,), (rgb_dev,) = self._stage([[rgb]])
        self._pts3(st.ranges)
        self._settle()

        def encode():
            with torch.inference_mode(), exact_math():
                return self._encode_queue(rgb_dev, st)

        return encode

    # ---- host backend ----------------------------------------------------
    def _cdf_u16(self, pm, y2, pts, b: int, clr: int) -> torch.Tensor:
        """One colour's uint16 CDF table ``[n, P]`` of the host range
        coder."""
        return cdf_float_to_uint16(self._cdf_float(pm, y2, pts, b, clr))

    @staticmethod
    def _gather_lohi(cdfu: torch.Tensor, y: torch.Tensor, minv: int):
        """The encoder's two uint16 a pixel: (cdf[s], cdf[s + 1]) at each
        pixel's symbol s of values ``y`` ``[n]``."""
        sym = (torch.round(y * 255.0).to(torch.int32) - minv).long()[:, None]
        cc = cdfu.to(torch.int32)  # torch gathers no uint16
        return (cc.gather(1, sym)[:, 0].to(torch.uint16),
                cc.gather(1, sym + 1)[:, 0].to(torch.uint16))

    def _compress_host(self, rgb: np.ndarray) -> List[List[bytes]]:
        """Host-backend encode of one image: per scale, coarse to fine,
        the 9 slices' (lo, hi) in one fetch, then their 9 streams coded on
        the thread pool while the device computes the next scale."""
        cfg = self.cfg
        S = cfg.num_scales
        (st,), (dev,) = self._stage([[rgb]])
        pts3 = self._pts3(st.ranges)
        y_list = self._front(dev)
        jobs = []
        with ThreadPoolExecutor(self.num_threads) as pool:
            for scl in range(S - 1, -1, -1):
                lohi = []

                def code(b, clr, pm, y2):
                    minv = st.ranges[clr][0]
                    cdfu = self._cdf_u16(pm, y2, pts3[clr], b, clr)
                    lohi.extend(self._gather_lohi(
                        cdfu, y2[:, sym_channel(cfg, b, clr)], minv))

                padH, padW = st.pad_flags[scl]
                for b in range(3):
                    self._band(y_list[scl], scl, b, padH, padW, code)
                got = self._fetch(lohi)
                jobs.append([pool.submit(range_coder.encode_lohi, lo, hi)
                             for lo, hi in zip(got[0::2], got[1::2])])
            groups = [[job.result() for job in scale] for scale in jobs]
        self.last_slice_bits = [[8 * len(s) for s in g] for g in groups]
        self.last_slice_bits_batch = [self.last_slice_bits]
        self.last_ideal_bits = self.last_ideal_bits_batch = None
        return [header_group(S, st.last_h, st.last_w, *st.origs[0],
                             st.minmax, st.pad_int, st.raw.tobytes(),
                             None)] + groups

    def _decompress_host(self, hdr: Header, streams: List[List[bytes]]):
        """Host-backend decode: per slice, the table to the host, the
        range decode there and the symbols back.  -> (YCoCg int32, RGB
        uint8) [1, H, W, 3] at the padded size, on the device."""
        S = self.cfg.num_scales
        ranges = [clr_range(clr, hdr.minmax) for clr in range(3)]
        pts3 = self._pts3(ranges)

        def scale_code(scl):
            group = streams[S - scl]

            def code(b, clr, pm, y2):
                cdf = self._fetch([self._cdf_u16(pm, y2, pts3[clr], b,
                                                 clr)])[0]
                syms = range_coder.decode_cdf(cdf, group[b * 3 + clr])
                return self._upload(syms.astype(np.int32)) + ranges[clr][0]
            return code

        return self._decode_scales(hdr, self._upload(hdr.raw), scale_code)

    # ---- decode ----------------------------------------------------------
    def _staging(self, n_words: int, n_small: int):
        """The staging blocks, of at least ``n_words`` int16 and ``n_small``
        int64: the codec's own once every copy out of them has finished,
        else new ones, twice as large or as asked (pinned on a card; the
        old ones stay allocated until their copies have finished)."""
        blocks = self._blocks
        if (blocks is not None and blocks[0].numel() >= n_words
                and blocks[1].numel() >= n_small):
            pending = [e for e in self._block_copies if not e.query()]
            if pending:
                self.staging_counts["waited"] += 1
                for e in pending:
                    e.synchronize()
            self.staging_counts["reused"] += 1
        else:
            have = (0, 0) if blocks is None else (blocks[0].numel(),
                                                  blocks[1].numel())
            pin = self.device.type == "cuda"
            blocks = self._blocks = (
                torch.empty(max(n_words, 2 * have[0]), dtype=torch.int16,
                            pin_memory=pin),
                torch.empty(max(n_small, 2 * have[1]), dtype=torch.int64,
                            pin_memory=pin))
            self.staging_counts["grown"] += 1
        self._block_copies = []
        return blocks

    def _decode_stage(self, containers: Sequence[Sequence[bytes]]
                      ) -> List[_Words]:
        """Stage the rANS streams of one or more containers (each a list of
        K blobs) on the host, each container in its own region of the
        staging blocks: every blob's words written once into row k of a
        ``[K, W]`` view (W the container's longest stream), its lane states
        and length beside them.  Every blob is checked before anything is
        written."""
        with span("llicti.unpack"):
            N = self.N
            lengths = [[stream_words(b, N) for b in blobs]
                       for blobs in containers]
            widths = [max(ls) for ls in lengths]
            words, small = self._staging(
                sum(len(ls) * w for ls, w in zip(lengths, widths)),
                sum(len(ls) * (N + 1) for ls in lengths))
            out, wo, so = [], 0, 0
            for blobs, ls, W in zip(containers, lengths, widths):
                K = len(blobs)
                rows = words[wo:wo + K * W].view(K, W)
                meta = small[so:so + K * (N + 1)]
                wo, so = wo + K * W, so + K * (N + 1)
                rows_np, meta_np = rows.numpy().view(np.uint16), meta.numpy()
                for k, (b, n) in enumerate(zip(blobs, ls)):
                    rows_np[k, :n] = np.frombuffer(b, np.uint16, n, 4 * N)
                    meta_np[k * N:(k + 1) * N] = np.frombuffer(b, np.uint32,
                                                               N)
                meta_np[K * N:] = ls
                out.append(_Words(rows, meta))
            return out

    def _head_width(self, hdr: Header, W: int) -> int:
        """Words of each row that scales S-1..1 read: a single container
        records them (header byte 13); a batch's are bounded by the coarse
        scales' worst case, as the JAX package bounds them."""
        if hdr.head_words is not None:
            return min(W, hdr.head_words)
        _, lh, lw, _ = hdr.raw.shape
        return min(W, words_cap(self.N, self.cfg.num_scales, lh, lw,
                                hdr.pad_flags, min_scl=1))

    def _copy_in(self, host: torch.Tensor) -> torch.Tensor:
        """A new device tensor holding ``host``, copied asynchronously (a
        copy on the CPU too: the staging blocks are written again)."""
        return torch.empty(host.shape, dtype=host.dtype,
                           device=self.device).copy_(host, non_blocking=True)

    def _decode_upload(self, hdr: Header, staged: _Words,
                       split: bool) -> _DecodeInputs:
        """The decode's buffers on the card: the staged 16-bit rows and the
        lane states copied asynchronously out of the staging blocks, the
        rows widened there to the int32 rows Kernel 2 reads
        (:func:`widen_words`, zeros past each stream's end).  Two-stage:
        the coarse scales read the head columns; with ``split`` on a card,
        the columns after the head copy and widen on a second stream,
        which scale 0 waits on.  An event after the last copy out of the
        blocks on each stream tells the next stage when it may write
        them."""
        with span("llicti.upload"):
            raw = self._to_device(hdr.raw)
            K, W = staged.words.shape
            small = self._copy_in(staged.small)
            states = small[:K * self.N].view(K, self.N)
            lengths = small[K * self.N:]
            hw = self._head_width(hdr, W) if self.two_stage else W
            side = self._side if split else None
            cut = hw if side is not None else W
            words16 = torch.empty((K, W), dtype=torch.int16,
                                  device=self.device)
            dev = torch.empty((K, W), dtype=torch.int32, device=self.device)
            words16[:, :cut].copy_(staged.words[:, :cut], non_blocking=True)
            self._copied()
            widen_words(words16, lengths, dev, 0, cut)
            ready = None
            if side is not None:
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    words16[:, cut:].copy_(staged.words[:, cut:],
                                           non_blocking=True)
                    self._copied()
                    widen_words(words16, lengths, dev, cut, W)
                    ready = side.record_event()
                # allocated on the current stream, read on the side one
                words16.record_stream(side)
                small.record_stream(side)
            return _DecodeInputs(hdr, raw, dev, states,
                                 dev[:, :hw] if self.two_stage else None,
                                 ready)

    def _copied(self) -> None:
        """Mark the copies out of the staging blocks queued so far on the
        current stream: the next stage waits for them before it writes the
        blocks again."""
        if self.device.type == "cuda":
            self._block_copies.append(
                torch.cuda.current_stream(self.device).record_event())

    def _decode_scales(self, hdr: Header, raw: torch.Tensor, scale_code):
        """The scale loop of every decoder: per scale, coarse to fine, the
        band tensor seeded from the header's raw band (coarsest) or the
        scale decoded before it, then its three bands through
        :meth:`_band` with ``scale_code(scl)``'s per-colour code.  ->
        (YCoCg int32, RGB uint8), both [K, H, W, 3] at the padded size, on
        the device."""
        cfg = self.cfg
        c = cfg.cond_channels
        S = cfg.num_scales
        off = clr_offset(cfg)
        y_lev = None
        for scl in range(S - 1, -1, -1):
            with span("llicti.wavelet"):
                if scl == S - 1:
                    x00 = self._to_y(rgb_int_to_ycocg_r_int(raw))
                    lo, hi = off, off + 3
                else:
                    x00 = interleave_scale(y_lev, c,
                                           int(hdr.pad_flags[scl + 1][0]),
                                           int(hdr.pad_flags[scl + 1][1]))
                    lo, hi = 0, c
                y_lev = torch.zeros(x00.shape[:3] + (4 * c,),
                                    dtype=torch.float32, device=self.device)
                y_lev[..., lo:hi] = x00
            code = scale_code(scl)
            padH, padW = hdr.pad_flags[scl]
            for b in range(3):
                self._band(y_lev, scl, b, padH, padW, code)

        with span("llicti.wavelet"):
            crop_h = int(hdr.pad_flags[0][0])
            crop_w = int(hdr.pad_flags[0][1])
            y_c = interleave_scale(y_lev, c, crop_h, crop_w)
            ycocg = (torch.round(y_c[..., off:off + 3] * 255.0)
                     .to(torch.int32) + self._shift)
            return ycocg, ycocg_r_int_to_rgb_int(ycocg).to(torch.uint8)

    def _decode_queue(self, d: _DecodeInputs):
        """Queue a whole device-backend decode of K images: -> (YCoCg int32,
        RGB uint8), both [K, H, W, 3] at the padded size, on the device;
        nothing synchronises."""
        ranges = [clr_range(clr, d.hdr.minmax) for clr in range(3)]
        pts3 = self._pts3(ranges)
        K = d.words.shape[0]
        offset = torch.zeros((K,), dtype=torch.int32, device=self.device)

        def scale_code(scl):
            words = d.words
            if d.head is not None and scl > 0:
                words = d.head
            elif d.tail_ready is not None:
                torch.cuda.current_stream(self.device).wait_event(
                    d.tail_ready)

            def code(b, clr, pm, y2):
                cum, _, _ = self._tables(b, clr, pm, y2, ranges, pts3)
                with span("llicti.kernel2"):
                    syms = rans_decode(cum.view(K, -1, cum.shape[-1]),
                                       words, d.states, offset)
                    return syms.view(-1) + ranges[clr][0]
            return code

        return self._decode_scales(d.hdr, d.raw, scale_code)

    def _dispatch(self, streams: List[List[bytes]]):
        hdr = parse_container(streams, self.cfg.dwtlevels)
        if host_coded(streams):
            return self._decompress_host(hdr, streams) + (hdr,)
        staged, = self._decode_stage([[streams[1][0]]])
        ycocg, rgb = self._decode_queue(
            self._decode_upload(hdr, staged, split=True))
        return ycocg, rgb, hdr

    @_pass("llicti.decompress")
    def decompress_dispatch(self, streams: List[List[bytes]]):
        """Queue one image's decode; -> (RGB uint8 [1, H, W, 3] on the
        device at the padded size, orig_h, orig_w).  Nothing synchronises,
        so several images' decodes can be queued and fetched together; a
        host-backend container decodes synchronously."""
        _, rgb, hdr = self._dispatch(streams)
        return (rgb,) + hdr.origs[0]

    @_pass("llicti.decompress")
    def decompress(self, streams: List[List[bytes]],
                   xorg: Optional[np.ndarray] = None) -> np.ndarray:
        """Decode a single-image container of either backend back to
        ``[1, H, W, 3]`` uint8 RGB.

        ``xorg``: the original image, optional; when given, the decoded
        YCoCg integers (before the inverse colour transform) are checked
        against its transform and the largest error is kept in
        ``last_ycocg_err``.
        """
        ycocg, rgb, hdr = self._dispatch(streams)
        out = self._fetch([rgb])[0]
        if xorg is not None:
            self.last_ycocg_err = self._ycocg_err(ycocg, xorg)
        oh, ow = hdr.origs[0]
        return out[:, :oh, :ow]

    def _ycocg_err(self, ycocg: torch.Tensor, xorg: np.ndarray) -> int:
        """Largest |decoded YCoCg - transform of xorg|, xorg replicate-
        padded to the coded size as the encoder padded it."""
        xorg = np.asarray(xorg)
        xorg = xorg.reshape((-1,) + xorg.shape[-3:])
        H, W = ycocg.shape[1], ycocg.shape[2]
        xpad = np.pad(xorg, ((0, 0), (0, H - xorg.shape[1]),
                             (0, W - xorg.shape[2]), (0, 0)), mode="edge")
        org = rgb_int_to_ycocg_r_int(self._upload(xpad))
        return int((ycocg - org).abs().max())

    @_pass("llicti.decompress")
    def decompress_many(self, streams_list: Sequence[List[List[bytes]]]
                        ) -> List[np.ndarray]:
        """Pipelined decode of several single-image containers: every
        header parse and stream unpack first, then every upload (pinned,
        asynchronous), then every image's device work, then one
        synchronisation for all images.  With a host-backend container
        among them, every image decodes synchronously, one by one."""
        hdrs = [parse_container(s, self.cfg.dwtlevels) for s in streams_list]
        if any(host_coded(s) for s in streams_list):
            return [self.decompress(s) for s in streams_list]
        staged = self._decode_stage([[s[1][0]] for s in streams_list])
        inputs = [self._decode_upload(h, w, split=True)
                  for h, w in zip(hdrs, staged)]
        outs = self._fetch([self._decode_queue(d)[1] for d in inputs])
        return [o[:, :h.origs[0][0], :h.origs[0][1]]
                for o, h in zip(outs, hdrs)]

    def _resident(self, hdr: Header, blobs: Sequence[bytes]):
        """Stage a container on the card and return the closure that
        decodes it: -> RGB uint8 [K, H, W, 3] at the padded size."""
        staged, = self._decode_stage([blobs])
        d = self._decode_upload(hdr, staged, split=False)
        self._pts3([clr_range(clr, hdr.minmax) for clr in range(3)])
        self._settle()

        def decode():
            with torch.inference_mode(), exact_math():
                # the decode updates the lane states in place
                return self._decode_queue(
                    d._replace(states=d.states.clone()))[1]

        return decode

    def prepare_decode(self, streams: List[List[bytes]]):
        """Stage a single-image container on the card; returns a closure
        whose call queues its decode and returns the device RGB [1, H, W,
        3] (padded size).  Everything shape-derived (stream buffers,
        sampling grids, the two-stage head) is built here, so the call
        copies nothing between host and card and never synchronises.  A
        host-backend container raises ValueError (it decodes through
        :meth:`decompress`)."""
        hdr = parse_container(streams, self.cfg.dwtlevels)
        if host_coded(streams):
            raise ValueError("prepare_decode stages a device-backend "
                             "container; a host-backend one decodes "
                             "through decompress")
        return self._resident(hdr, [streams[1][0]])

    def prepare_decode_batch(self, streams: List[List[bytes]]):
        """:meth:`prepare_decode` for a batch container: the closure
        returns the device RGB [K, H, W, 3]."""
        return self._resident(
            parse_batch_container(streams, self.cfg.dwtlevels),
            [g[0] for g in streams[1:]])

    @_pass("llicti.decompress")
    def decompress_batch(self, streams: List[List[bytes]]
                         ) -> List[np.ndarray]:
        """Decode a batch container -> K ``[H, W, 3]`` uint8 images, each
        cropped to its original size; each slice of the K images is one
        decode launch."""
        hdr = parse_batch_container(streams, self.cfg.dwtlevels)
        staged, = self._decode_stage([[g[0] for g in streams[1:]]])
        _, rgb = self._decode_queue(
            self._decode_upload(hdr, staged, split=False))
        out = self._fetch([rgb])[0]
        return [out[k, :oh, :ow] for k, (oh, ow) in enumerate(hdr.origs)]
