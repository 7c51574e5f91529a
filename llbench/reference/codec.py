"""The reference encoder: the containers an image, or a batch of K images
of one shape, should be coded into.

Per scale, coarse to fine, and per band, the interpolator's parameter
map of the band's coded pixels; per colour the quantised CDF table of
the normal mixture (Abramowitz-Stegun erf, 2^16 total, one count a
symbol at least) and each pixel's (start, freq); then one N-lane
interleaved rANS stream an image (16-bit words, 32-bit states in
[2^16, 2^32)) over its 45 slices, in numpy.  The container layouts are
the published codec's:

  single: [[S u8 | last_h, last_w u16 | orig_h, orig_w u32 | head_words
            u32, minmax int16 x6, pad_int int16, coarsest x00 RGB, b''x5],
           [N states u32 | words u16, decode order]]
  batch:  [[255, K, S u8 | last_h, last_w u16 | origs u32 [K, 2], ...],
           [image 0's stream], ..., [image K-1's stream]]

Everything runs under :func:`float32_math` (TF32 off, deterministic
cuDNN), the precision the codec states; ``tf32=True`` computes in TF32
instead, the control of the comparison.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .model import (Model, band_coded_shape, lazy_dwt,
                    rgb_int_to_ycocg_r_int, rgb_int_to_ycocg_r_int_np)

RANS_L = 1 << 16
MASK32 = 0xFFFFFFFF
RANGE_BUCKET = 32
INV255 = np.float32(1.0 / 255.0)
SCALE_BOUND = 0.11 / 255.0
WEIGHT_BOUND = 1e-6
SQRT2_INV = np.float32(2 ** -0.5)
SATURATED = 10.5  # |z| / sqrt 2 beyond which the erf is +-1 in float32
# Abramowitz-Stegun 7.1.26 (|err| < 1.5e-7)
_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_P = 0.3275911


@contextlib.contextmanager
def float32_math(tf32: bool = False):
    """cuDNN on, no autotuning, deterministic algorithms, and TF32 in
    convs and matmuls only when ``tf32``; the caller's flags come back."""
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_tf32
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=tf32):
        matmul.allow_tf32 = tf32
        try:
            yield
        finally:
            matmul.allow_tf32 = old


# ---- the probability model's tables ---------------------------------------

def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32, device=like.device)


def _phi(z: torch.Tensor) -> torch.Tensor:
    """The standard normal CDF with the Abramowitz-Stegun erf."""
    x = z * _f32(SQRT2_INV, z)
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + _f32(_P, x) * ax)
    poly = _f32(_A[4], x)
    for a in (_A[3], _A[2], _A[1], _A[0]):
        poly = _f32(a, x) + t * poly
    poly = t * poly
    return 0.5 * (1.0 + s * (1.0 - poly * torch.exp(-ax * ax)))


def sampling_points(lo: int, hi: int, tail: float = 20.0) -> torch.Tensor:
    """float32 [P], P = hi - lo + 2: the interval edges (k - 0.5)/255 of
    the symbols lo..hi, the outer two pushed out by ``tail``/255."""
    n = hi - lo + 2
    start = np.float32(lo - 0.5)
    stop = np.float32(hi + 0.5)
    step = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
    pts = start * (np.float32(1.0) - step) + stop * step
    pts = np.concatenate([pts, [stop]]).astype(np.float32) / np.float32(255.0)
    pts[0] = np.float32((lo - 0.5 - tail) / 255.0)
    pts[-1] = np.float32((hi + 0.5 + tail) / 255.0)
    return torch.from_numpy(pts)


def cdf_tables(points, pm, y, M, std0, mean0, w0, upd, sym_ch, minv):
    """One colour's int32 CDF table [n, P] and (start, freq) [n] at the
    pixels' symbols, from the parameter rows ``pm`` [n, CO] and the
    pixels' channels ``y`` [n, YC]; and the count of mixture terms whose
    erf saturates."""
    std = torch.clamp_min(pm[:, std0:std0 + M], SCALE_BOUND)
    w = torch.clamp_min(pm[:, w0:w0 + M], WEIGHT_BOUND)
    wsum = w[:, 0]
    for x in range(1, M):
        wsum = wsum + w[:, x]
    w = w / (_f32(1e-9, w) + wsum)[:, None]
    mean = pm[:, mean0:mean0 + M]
    for coef0, ych in upd:
        mean = mean + pm[:, coef0:coef0 + M] * y[:, ych:ych + 1]
    inv = 1.0 / std
    acc = torch.zeros((pm.shape[0], points.shape[0]), dtype=torch.float32,
                      device=pm.device)
    saturated = torch.zeros((), dtype=torch.int64, device=pm.device)
    for x in range(M):
        z = (points[None, :] - mean[:, x:x + 1]) * inv[:, x:x + 1]
        saturated += ((z * _f32(SQRT2_INV, z)).abs() > SATURATED).sum()
        acc = acc + w[:, x:x + 1] * _phi(z)
    P = points.shape[0]
    q = torch.round(acc.clamp(0.0, 1.0) * float(2 ** 16 - (P - 1))).to(
        torch.int32)
    q = torch.cummax(q, dim=-1).values
    q = q + torch.arange(P, dtype=torch.int32, device=q.device)
    q[..., -1] = 1 << 16
    sym = (torch.round(y[:, sym_ch] * 255.0).to(torch.int32) - minv).clamp(
        0, P - 2).long()[:, None]
    lo = q.gather(1, sym)[:, 0]
    return q, lo, q.gather(1, sym + 1)[:, 0] - lo, saturated


def colour_spec(c: int, M: int, band: int, clr: int):
    """(M, std0, mean0, w0, ((coef0, y channel), ...), symbol channel) of
    one colour in a band's parameter map: the joint model's mean updates
    mu_Co += a Y, mu_Cg += b Y + d Co, from the pixel's own colours."""
    y0, y1 = c * (band + 1), c * (band + 1) + 1
    upd = {0: (), 1: ((9 * M, y0),), 2: ((10 * M, y0), (11 * M, y1))}[clr]
    return M, clr * M, (3 + clr) * M, (6 + clr) * M, upd, c * (band + 1) + clr


def bucket_range(lo: int, hi: int) -> Tuple[int, int]:
    return ((lo // RANGE_BUCKET) * RANGE_BUCKET,
            -((-(hi + 1)) // RANGE_BUCKET) * RANGE_BUCKET - 1)


def colour_ranges(minmax: Sequence[int]) -> List[Tuple[int, int]]:
    """Each colour's table range: its min and max over the images, out to
    multiples of 32; Y (coded as Y - 127) within [-127, 128]."""
    lo, hi = bucket_range(minmax[0] - 127, minmax[3] - 127)
    out = [(max(lo, -127), min(hi, 128))]
    for clr in (1, 2):
        out.append(bucket_range(minmax[clr], minmax[3 + clr]))
    return out


# ---- rANS --------------------------------------------------------------------

def rans_encode(chain: Sequence[Tuple[np.ndarray, np.ndarray]], N: int):
    """Encode K images' chains of slices, each slice's (start, freq) [K, n]
    in encode order; symbol i of a slice is lane i % N's at step i // N,
    steps run backward, lanes emit N-1 first.  -> (final states uint64
    [K, N], words of each image in emission order, cursor after each
    slice [K, slices])."""
    K = chain[0][0].shape[0]
    x = np.full((K, N), RANS_L, np.uint64)
    out: List[List[np.ndarray]] = [[] for _ in range(K)]
    count = np.zeros(K, np.int64)
    cursors = np.zeros((K, len(chain)), np.int64)
    for s, (starts, freqs) in enumerate(chain):
        n = starts.shape[1]
        for t in range(-(-n // N) - 1, -1, -1):
            i0 = t * N
            m = min(n, i0 + N) - i0
            start = np.zeros((K, N), np.uint64)
            freq = np.zeros((K, N), np.uint64)
            start[:, :m] = starts[:, i0:i0 + m]
            freq[:, :m] = freqs[:, i0:i0 + m]
            val = freq > 0
            fs = np.maximum(freq, 1)
            emit = val & (x >= ((fs << np.uint64(16)) & np.uint64(MASK32)))
            word = x & np.uint64(0xFFFF)
            xs = np.where(emit, x >> np.uint64(16), x)
            x = np.where(val, (((xs // fs) << np.uint64(16)) + xs % fs + start)
                         & np.uint64(MASK32), xs)
            for k in range(K):
                e = word[k][emit[k]][::-1]
                if e.size:
                    out[k].append(e)
                count[k] += e.size
        cursors[:, s] = count
    words = [np.concatenate(o).astype(np.uint16) if o
             else np.zeros(0, np.uint16) for o in out]
    return x, words, cursors


def stream(states: np.ndarray, words_emitted: np.ndarray) -> bytes:
    """N states as uint32, then the words in decode order (the reverse of
    emission), uint16."""
    return (np.asarray(states, np.uint32).tobytes()
            + np.ascontiguousarray(words_emitted[::-1]).tobytes())


# ---- the containers ------------------------------------------------------------

def _group(header: bytes, minmax, pad_int: int, raw: np.ndarray):
    return [header, np.array(minmax, np.int16).tobytes(),
            np.array([pad_int], np.int16).tobytes(), raw.tobytes(),
            b"", b"", b"", b"", b""]


def serialize(streams: List[List[bytes]]) -> bytes:
    """A container as one blob: u32 counts and lengths before each list
    and each stream."""
    out = [np.array([len(streams)], np.uint32).tobytes()]
    for group in streams:
        out.append(np.array([len(group)], np.uint32).tobytes())
        for s in group:
            out += [np.array([len(s)], np.uint32).tobytes(), s]
    return b"".join(out)


class Encoder:
    """Codes images with a reference :class:`Model` on ``device``."""

    def __init__(self, model: Model, lanes: int, device, tf32: bool = False):
        self.model = model
        self.cfg = model.cfg
        self.N = lanes
        self.device = torch.device(device)
        self.tf32 = tf32

    def _slices(self, rgb: np.ndarray, ranges, flags_out: list):
        """(start, freq) numpy [K, n] of every slice in decode order, and
        each slice's (rows, P, spec, saturated terms)."""
        cfg, c, M = self.cfg, self.cfg.c, self.cfg.M
        K = rgb.shape[0]
        dev = torch.from_numpy(np.ascontiguousarray(rgb)).to(self.device)
        shift = torch.tensor((127, 0, 0), dtype=torch.int32,
                             device=self.device)
        x = (rgb_int_to_ycocg_r_int(dev) - shift).float() * INV255
        y_list, flags = lazy_dwt(x, cfg.dwtlevels, pad=True)
        flags_out.extend(flags)
        pts = [sampling_points(*r).to(self.device) for r in ranges]
        sf, work = [], []
        for scl in range(cfg.num_scales - 1, -1, -1):
            y_lev = y_list[scl]
            padH, padW = flags[scl]
            for b in range(3):
                ch, cw = band_coded_shape(y_lev.shape[1], y_lev.shape[2], b,
                                          padH, padW)
                n = ch * cw

                def rows(t):
                    return t[:, :ch, :cw].reshape(K * n, -1).contiguous()

                pm = rows(self.model.band(scl, b).params(
                    y_lev[..., :c * (b + 1)].contiguous()))
                y2 = rows(y_lev)
                for clr in range(3):
                    Mx, s0, m0, w0, upd, sch = colour_spec(c, M, b, clr)
                    _, start, freq, sat = cdf_tables(
                        pts[clr], pm, y2, Mx, s0, m0, w0, upd, sch,
                        ranges[clr][0])
                    sf.append((start.view(K, n), freq.view(K, n)))
                    work.append((K * n, pts[clr].shape[0],
                                 (Mx, s0, m0, w0, upd), sch, sat))
        host = [(s.cpu().numpy(), f.cpu().numpy()) for s, f in sf]
        return host, [(r, P, spec, sch, int(sat))
                      for r, P, spec, sch, sat in work]

    def encode(self, imgs: Sequence[np.ndarray]) -> Dict:
        """K uint8 [H, W, 3] images of one shape -> {"streams": the
        container (a single one for K = 1 unless ``batch``), "slices":
        each slice's (rows, P, spec, symbol channel, saturated terms) in
        decode order, "words": each slice's words in decode order [K,
        slices]}."""
        return self._encode(imgs, batch=False)

    def encode_batch(self, imgs: Sequence[np.ndarray]) -> Dict:
        return self._encode(imgs, batch=True)

    def _encode(self, imgs, batch: bool) -> Dict:
        cfg = self.cfg
        rgb = np.stack([np.asarray(im, np.uint8) for im in imgs])
        K, H, W, _ = rgb.shape
        ycocg = rgb_int_to_ycocg_r_int_np(rgb)
        minmax = ([int(ycocg[..., i].min()) for i in range(3)]
                  + [int(ycocg[..., i].max()) for i in range(3)])
        ranges = colour_ranges(minmax)
        flags: list = []
        with torch.no_grad(), float32_math(self.tf32):
            sf, work = self._slices(rgb, ranges, flags)
        states, words, cursors = rans_encode(list(reversed(sf)), self.N)
        per_slice = np.diff(np.concatenate(
            [np.zeros((K, 1), np.int64), cursors], axis=1), axis=1)[:, ::-1]
        stride = 2 ** (max(cfg.dwtlevels) + 1)
        last_h, last_w = -(-H // stride), -(-W // stride)
        raw = np.ascontiguousarray(rgb[:, ::stride, ::stride, :])
        pad_int = 0
        for padH, padW in flags:
            pad_int = 4 * pad_int + 2 * int(padH) + int(padW)
        blobs = [stream(states[k], words[k]) for k in range(K)]
        if batch:
            header = (np.array([255, K, cfg.num_scales], np.uint8).tobytes()
                      + np.array([last_h, last_w], np.uint16).tobytes()
                      + np.array([[H, W]] * K, np.uint32).tobytes())
            streams = [_group(header, minmax, pad_int, raw)] + [
                [b] for b in blobs]
        else:
            if K != 1:
                raise ValueError("a single container holds one image")
            head_words = int(per_slice[0, :-9].sum())
            header = (np.array([cfg.num_scales], np.uint8).tobytes()
                      + np.array([last_h, last_w], np.uint16).tobytes()
                      + np.array([H, W], np.uint32).tobytes()
                      + np.array([head_words], np.uint32).tobytes())
            streams = [_group(header, minmax, pad_int, raw), [blobs[0]]]
        return {"streams": streams, "slices": work, "words": per_slice}
