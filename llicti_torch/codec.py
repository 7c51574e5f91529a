"""Lossless codec: the single-image compress / decompress round trip.

Port of the device-backend path of ``llicti_tpu/codec.py`` at K=1, for
every configuration that codec codes: clr_joint_mode 0, 1 and 2 (with
clrjnt0seqmd), normal and logistic mixtures, and any model knob
(activation incl. GDN1, mwsa_joint, combine_layers1toL, useprevlevNN).
Per scale, coarse to fine, and per band, one shared function
(:meth:`Codec._band`) runs the interpolator conv on the bands decoded so
far and, for each of the three colours, builds the quantised CDF table
(Kernel 1) and either collects the encoder's (start, freq) or
rANS-decodes the band (Kernel 2) and writes it back.  The encoder then
encodes all 45 slices, in reverse decode order, into one stream with one
chain call of the rANS encoder (Kernel 3).  clr_joint_mode 1 codes a
zero channel in front of (Y, Co, Cg); with clrjnt0seqmd the trunk runs
once per colour on the band's layer-0 map plus the pixel's colours
decoded so far.

Bit-exactness: encoder and decoder must compute identical CDF tables.
Both run the same convs on conditioning tensors of identical shape,
layout and values, with TF32 and cuDNN autotuning off and deterministic
algorithms on, and the same CDF kernel; every int -> float conversion is
``int.float() * INV255`` on both sides.

Container (byte for byte the JAX package's device-backend format):
  streams[0] = [header, minmax int16 x6, pad_int int16, raw x00 RGB, b''*5]
               header = S u8 | last_h, last_w u16 | orig_h, orig_w u32 |
                        head_words u32 (stream words of scales S-1..1)
  streams[1] = [rANS blob: N lane states u32 | words u16, decode order]
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .coder.rans import (RANS_L, pack_stream_packed, rans_decode,
                         rans_encode_chain, unpack_stream)
from .config import ModelConfig
from .models.interpolator import seq_colours
from .ops.cdf import gmm_cdf_from_pmap
from .ops.color import (rgb_int_to_ycocg_r_int, rgb_int_to_ycocg_r_int_np,
                        ycocg_r_int_to_rgb_int)
from .ops.gmm import cdf_sampling_points
from .ops.wavelet import (band_coded_shape, interleave_scale, lazy_dwt,
                          pad_decoded_band, unpack_pad_flags)
from .weights import params_from_flax

RANGE_BUCKET = 32
INV255 = np.float32(1.0 / 255.0)
_SHIFT = (127, 0, 0)  # Y is coded around 127/255


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
              pad_flags) -> int:
    """Worst-case stream words of an image (each symbol emits at most one
    word), from its shape alone."""
    total = num_lanes
    for scl, h, w in scale_shapes(S, last_h, last_w, pad_flags):
        padH, padW = pad_flags[scl]
        for b in range(3):
            ch, cw = band_coded_shape(h, w, b, padH, padW)
            bucket = max(64, -(-(ch * cw) // 4096) * 4096)
            total += 3 * (-(-bucket // num_lanes) * num_lanes)
    return -(-total // 65536) * 65536


def header_group(S, last_h, last_w, orig_h, orig_w, minmax, pad_int,
                 raw: bytes, head_words: int) -> List[bytes]:
    header = (np.array([S], np.uint8).tobytes()
              + np.array([last_h, last_w], np.uint16).tobytes()
              + np.array([orig_h, orig_w], np.uint32).tobytes()
              + np.array([head_words], np.uint32).tobytes())
    return [header, np.array(minmax, np.int16).tobytes(),
            np.array([pad_int], np.int16).tobytes(), raw,
            b"", b"", b"", b"", b""]


def host_header(rgb: np.ndarray, levels: Sequence[int]):
    """(per-colour [min..., max...] of YCoCg, raw coarsest-x00 RGB band) of
    a [1, H, W, 3] uint8 image, on the host."""
    ycocg = rgb_int_to_ycocg_r_int_np(rgb[0])
    minmax = ([int(ycocg[..., c].min()) for c in range(3)]
              + [int(ycocg[..., c].max()) for c in range(3)])
    stride = 2 ** (max(levels) + 1)
    raw = np.ascontiguousarray(rgb[:, ::stride, ::stride, :])
    return minmax, raw.astype(np.uint8)


def parse_container(streams: List[List[bytes]], levels: Sequence[int]):
    """-> (minmax, pad_flags, raw coarsest band [1, lh, lw, 3] uint8).

    Raises ValueError on a header that does not describe an image of
    ``levels`` (the size fixes the pad flags and the raw band's shape, and
    colour ranges outside YCoCg-R's would make huge CDF tables)."""
    if len(streams) != 2 or len(streams[0]) < 4 or len(streams[1]) != 1:
        raise ValueError("not a single-stream (device backend) container")
    hdr = streams[0][0]
    if len(hdr) < 13 or hdr[0] != len(levels):
        raise ValueError(f"header does not describe {len(levels)} scales")
    last_h, last_w = (int(v) for v in np.frombuffer(hdr[1:5], np.uint16))
    orig_h, orig_w = (int(v) for v in np.frombuffer(hdr[5:13], np.uint32))
    minmax = [int(v) for v in np.frombuffer(streams[0][1], np.int16)]
    pad_int = int(np.frombuffer(streams[0][2], np.int16)[0])
    stride = 2 ** (max(levels) + 1)
    lo, hi = (0, -255, -255), (255, 255, 255)
    if (len(minmax) != 6 or min(orig_h, orig_w) <= stride // 2
            or (last_h, last_w) != (-(-orig_h // stride),
                                    -(-orig_w // stride))
            or pad_int != pad_flags_for_shape(orig_h, orig_w, levels)[1]
            or len(streams[0][3]) != last_h * last_w * 3
            or not all(lo[c] <= minmax[c] <= minmax[3 + c] <= hi[c]
                       for c in range(3))):
        raise ValueError("inconsistent container header")
    raw = np.frombuffer(streams[0][3], np.uint8).reshape(
        1, last_h, last_w, 3)
    return minmax, unpack_pad_flags(pad_int, len(levels)), raw


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


class _DecodeCarry(NamedTuple):
    """Device state the rANS decode threads through the slices."""
    words: torch.Tensor    # int32 [W]
    states: torch.Tensor   # int64 [N]
    offset: torch.Tensor   # int32 [1]


class Codec:
    """Encoder/decoder around trained interpolator weights.

    ``params``: the JAX package's Flax parameters as numpy arrays (nested,
    or flat as :func:`llicti_torch.weights.load_npz` or
    :func:`llicti_torch.weights.init_params` give them).
    ``device`` is the CUDA card unless the caller asks for ``"cpu"``;
    without a card, a CUDA codec raises rather than falling back.
    ``num_lanes`` (<= 1024) is an encoder/decoder-matched parameter: the
    container does not record it.  Codes what the JAX ``Codec`` codes on
    its device backend and raises ``NotImplementedError`` on the rest:
    subtract_mean, ycocg=False, clrchs < 3, a single mixture, and
    clrjnt0seqmd with GDN1 (which couples the colours' channel groups).
    """

    serialize = staticmethod(serialize)
    deserialize = staticmethod(deserialize)
    num_bytes = staticmethod(num_bytes)

    def __init__(self, cfg: ModelConfig, params, device="cuda",
                 num_lanes: int = 512):
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
        if not 1 <= num_lanes <= 1024:
            raise ValueError(f"num_lanes={num_lanes}: must be in 1..1024")
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Codec runs on the CUDA card by default and none is "
                    "available; pass device='cpu' for the plain versions")
            # encoder and decoder must run bit-identical convs
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.benchmark = False
            torch.backends.cudnn.deterministic = True
        self.N = num_lanes
        self.logistic = cfg.distribution == "logistic"
        self.model = params_from_flax(params, cfg).to(self.device)
        self._pts: Dict[Tuple[int, int], torch.Tensor] = {}
        self.last_slice_bits: Optional[List[List[int]]] = None
        self.last_ideal_bits: Optional[List[List[float]]] = None
        self.last_ycocg_err: Optional[int] = None

    # ---- shared pieces ---------------------------------------------------
    def _pts3(self, ranges) -> List[torch.Tensor]:
        for r in ranges:
            if r not in self._pts:
                self._pts[r] = cdf_sampling_points(*r).to(self.device)
        return [self._pts[r] for r in ranges]

    def _to_y(self, ycocg_int: torch.Tensor) -> torch.Tensor:
        shift = torch.tensor(_SHIFT, dtype=torch.int32, device=self.device)
        return (ycocg_int - shift).float() * INV255

    def _band(self, y_lev: torch.Tensor, scl: int, b: int, padH: bool,
              padW: bool, ranges, pts3,
              dec: Optional[_DecodeCarry] = None):
        """One band, shared by both directions: the conv, then per colour
        the CDF table and either the encoder's (start, freq) (returned) or
        the rANS decode written back into ``y_lev`` in place."""
        cfg = self.cfg
        c = cfg.cond_channels
        ch, cw = band_coded_shape(y_lev.shape[1], y_lev.shape[2], b, padH,
                                  padW)

        def coded_rows(t):  # [1, h, w, C] -> [ch * cw, C]
            return t[0, :ch, :cw].reshape(ch * cw, -1).contiguous()

        y_cond = y_lev[..., :c * (b + 1)].contiguous()
        seq = seq_colours(cfg)
        if seq:
            base = self.model.band_base(y_cond, scl, b)
        else:
            pm = coded_rows(self.model.band_params(y_cond, scl, b))
        sch0 = sym_channel(cfg, b, 0)
        sf = []
        for clr in range(3):
            if seq:
                # this colour's params from the pixel's colours decoded so
                # far: both directions run the trunk on the same shapes
                pm = coded_rows(self.model.band_params_seq(
                    base, y_lev[..., sch0:sch0 + 2], scl, b, clr))
            # rebuilt per colour: decode writes each colour back before the
            # next one's cross-colour mean update reads it
            y2 = coded_rows(y_lev)
            minv = ranges[clr][0]
            M, std0, mean0, w0, upd = pmap_cdf_spec(cfg, b, clr)
            sch = sym_channel(cfg, b, clr)
            cum, start, freq = gmm_cdf_from_pmap(
                pts3[clr], pm, y2, M, std0, mean0, w0, upd, self.logistic,
                sch, minv)
            if dec is None:
                sf.append((start, freq))
                continue
            syms = rans_decode(cum, dec.words, dec.states, dec.offset)
            vals = (syms.view(1, ch, cw, 1) + minv).float() * INV255
            y_lev[..., sch] = pad_decoded_band(vals, b, padH, padW)[..., 0]
        return sf

    # ---- encode ----------------------------------------------------------
    @torch.inference_mode()
    def compress(self, rgb: np.ndarray) -> List[List[bytes]]:
        """Encode one image: rgb ``[H, W, 3]`` or ``[1, H, W, 3]`` uint8."""
        sf, cap, header = self.encode_inputs(rgb)
        S = self.cfg.num_scales
        # one chain, slices in encode order (the reverse of decode order)
        starts = torch.cat([start for start, _ in reversed(sf)])
        freqs = torch.cat([freq for _, freq in reversed(sf)])
        offsets = torch.tensor(
            np.cumsum([0] + [freq.shape[0] for _, freq in reversed(sf)]),
            dtype=torch.int64)
        states = torch.full((self.N,), RANS_L, dtype=torch.int64,
                            device=self.device)
        cursor = torch.zeros((1,), dtype=torch.int32, device=self.device)
        buf = torch.zeros((cap,), dtype=torch.int32, device=self.device)
        cursors = rans_encode_chain(starts, freqs, offsets, states, cursor,
                                    buf)
        ideal = torch.stack([
            torch.where(freq > 0, 16.0 - torch.log2(
                freq.clamp(min=1).float()), 0.0).sum()
            for _, freq in sf])

        cursors_np = cursors.cpu().numpy().astype(np.int64)
        total = int(cursors_np[-1])
        if total > cap:
            raise RuntimeError(f"rANS stream of {total} words overran its "
                               f"{cap}-word buffer")
        blob = pack_stream_packed(buf[:total].cpu().numpy(),
                                  states.cpu().numpy())
        counts = np.diff(np.concatenate([[0], cursors_np]))[::-1]
        self.last_slice_bits = [[int(v) * 16 for v in counts[s * 9:s * 9 + 9]]
                                for s in range(S)]
        ideal_np = ideal.cpu().numpy()
        self.last_ideal_bits = [[float(v) for v in ideal_np[s * 9:s * 9 + 9]]
                                for s in range(S)]
        head_words = sum(sum(row) for row in self.last_slice_bits[:-1]) // 16
        return [header_group(*header, head_words), [blob]]

    @torch.inference_mode()
    def encode_inputs(self, rgb: np.ndarray):
        """The encoder's rANS inputs of one image, before any is encoded:
        (the (start, freq) int32 pair of every slice in decode order, the
        stream's word cap, the header fields but ``head_words``)."""
        cfg = self.cfg
        rgb = np.asarray(rgb)
        if rgb.ndim == 3:
            rgb = rgb[None]
        if rgb.dtype != np.uint8 or rgb.ndim != 4 or rgb.shape[0] != 1 \
                or rgb.shape[-1] != 3:
            raise ValueError(f"expected [H, W, 3] uint8, got {rgb.dtype} "
                             f"{rgb.shape}")
        S = cfg.num_scales
        H, W = rgb.shape[1], rgb.shape[2]
        if min(H, W) <= 2 ** max(cfg.dwtlevels):
            raise ValueError(f"{H}x{W} is too small for {S} scales")
        pad_flags, pad_int = pad_flags_for_shape(H, W, cfg.dwtlevels)
        minmax, raw = host_header(rgb, cfg.dwtlevels)
        ranges = [clr_range(clr, minmax) for clr in range(3)]
        pts3 = self._pts3(ranges)

        x = self._to_y(rgb_int_to_ycocg_r_int(
            torch.from_numpy(np.ascontiguousarray(rgb)).to(self.device)))
        if clr_offset(cfg):
            x = torch.cat((torch.zeros_like(x[..., :1]), x), dim=-1)
        y_list, _, _ = lazy_dwt(x, cfg.dwtlevels, pad=True)
        sf = []  # (start, freq) per slice, decode order
        for scl in range(S - 1, -1, -1):
            padH, padW = pad_flags[scl]
            for b in range(3):
                sf += self._band(y_list[scl], scl, b, padH, padW, ranges,
                                 pts3)
        last_h, last_w = y_list[S - 1].shape[1], y_list[S - 1].shape[2]
        cap = words_cap(self.N, S, last_h, last_w, pad_flags)
        return sf, cap, (S, last_h, last_w, H, W, minmax, pad_int,
                         raw.tobytes())

    # ---- decode ----------------------------------------------------------
    @torch.inference_mode()
    def decompress(self, streams: List[List[bytes]],
                   xorg: Optional[np.ndarray] = None) -> np.ndarray:
        """Decode a container back to ``[1, H, W, 3]`` uint8 RGB.

        ``xorg``: the original image, optional; when given, the decoded
        YCoCg integers (before the inverse colour transform) are checked
        against its transform and the largest error is kept in
        ``last_ycocg_err``.
        """
        cfg = self.cfg
        c = cfg.cond_channels
        S = cfg.num_scales
        minmax, pad_flags, raw = parse_container(streams, cfg.dwtlevels)
        ranges = [clr_range(clr, minmax) for clr in range(3)]
        pts3 = self._pts3(ranges)
        states_np, words_np = unpack_stream(streams[1][0], self.N)
        dec = _DecodeCarry(
            words=torch.from_numpy(words_np).to(self.device),
            states=torch.from_numpy(states_np.astype(np.int64)).to(
                self.device),
            offset=torch.zeros((1,), dtype=torch.int32, device=self.device))

        off = clr_offset(cfg)
        y_lev = None
        for scl in range(S - 1, -1, -1):
            if scl == S - 1:
                x00 = self._to_y(rgb_int_to_ycocg_r_int(
                    torch.from_numpy(raw.copy()).to(self.device)))
                lo, hi = off, off + 3
            else:
                x00 = interleave_scale(y_lev, c, int(pad_flags[scl + 1][0]),
                                       int(pad_flags[scl + 1][1]))
                lo, hi = 0, c
            y_lev = torch.zeros(x00.shape[:3] + (4 * c,),
                                dtype=torch.float32, device=self.device)
            y_lev[..., lo:hi] = x00
            padH, padW = pad_flags[scl]
            for b in range(3):
                self._band(y_lev, scl, b, padH, padW, ranges, pts3, dec)

        crop_h, crop_w = int(pad_flags[0][0]), int(pad_flags[0][1])
        y_c = interleave_scale(y_lev, c, crop_h, crop_w)
        shift = torch.tensor(_SHIFT, dtype=torch.int32, device=self.device)
        ycocg = (torch.round(y_c[..., off:off + 3] * 255.0).to(torch.int32)
                 + shift)
        rgb = ycocg_r_int_to_rgb_int(ycocg).to(torch.uint8)
        if xorg is not None:
            xorg = np.asarray(xorg).reshape(ycocg.shape)
            org = rgb_int_to_ycocg_r_int(torch.from_numpy(
                np.ascontiguousarray(xorg)).to(self.device))
            self.last_ycocg_err = int((ycocg - org).abs().max())
        return rgb.cpu().numpy()
