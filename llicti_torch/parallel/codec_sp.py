"""Row-sharded codec: G row shards, one rANS stream each.

Port of ``llicti_tpu/parallel/codec_sp.py``.  The image is replicate-
padded so that H is a multiple of G * 2**(Lmax+1) and W of 2**(Lmax+1)
(its size before padding goes in the header; the decoder crops), so no
band carries pad flags.  Shard g is rows [g * H/G, (g+1) * H/G) of every
band; it is entropy-coded into its own stream with its own N lanes.

The G shards lie on the ranks of a process group, G / world consecutive
shards a rank (``make_sp_mesh``); one process alone holds all G.  A rank
runs the single-image codec's pipeline (``Codec._band``) on its block of
rows: the interpolator convs run once on the block, their layer-0 pads
reading the neighbouring ranks' boundary rows through
``halo.halo_rows`` (GSPMD inserts these exchanges in JAX), and the
wavelet and its inverse stay local because a block's height is a multiple
of 2**(Lmax+1).  The CDF tables are the float mixture CDF quantised to
int32, as the JAX sharded codec builds them (``Codec(use_kernel_cdf=
False)``; no Kernel 1 launch).  Per slice, the rank's tables ``[g_local,
n_loc, P]`` decode in one launch of Kernel 2 with K = g_local; an encode
is one ``rans_encode_chain`` call (Kernel 3, two launches) of the rank's
g_local chains of all 9*S slices, where JAX runs S grouped programs: the
chain is integer-only, so the words are the same.

Across ranks: ``compress`` reduces the image's YCoCg min/max over the
ranks (``prepare_encode`` takes them from the host's integer twin, as
JAX's does), every rank returns the same container (its blobs gathered)
and every decoder the same image (its rows gathered).  Both directions
run every pass under ``codec.exact_math()`` on the same (G, world)
layout with the same halo exchanges, so a container decodes at the G and
world it was encoded at.

Container (byte for byte the JAX package's):
  streams[0] = [hdr, minmax int16 x6, raw x00 RGB [1, last_h, last_w, 3]]
      hdr = S u8 | G u8 | last_h, last_w u16 | orig_h, orig_w u32
  streams[1] = [blob_0, ..., blob_{G-1}]   (pack_stream_packed each)
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..codec import (Codec, Header, _DecodeInputs, _pass, _Staged,
                     clr_range, exact_math, host_header, num_bytes)
from ..coder.rans import RANS_L, pack_stream_packed, rans_encode_chain
from ..config import ModelConfig
from ..models.interpolator import seq_colours
from ..ops.color import rgb_int_to_ycocg_r_int
from .distributed import (all_gather_bytes, all_gather_rows,
                          all_reduce_minmax, all_reduce_sum, comm_device,
                          rank, world_size)
from .halo import halo_rows


class ShardMesh(NamedTuple):
    """G row shards over the ranks of ``group`` (None: the world)."""
    G: int
    world: int
    rank: int
    local: int            # shards on this rank: G // world
    group: Optional[object]


def make_sp_mesh(shards: Optional[int] = None, group=None) -> ShardMesh:
    """``shards`` row shards (default: one a rank) over the process group
    (one process alone holds them all).  ValueError unless the ranks
    divide them evenly, or outside 1..255 (the header's u8)."""
    world = world_size(group)
    G = world if shards is None else shards
    if not 1 <= G <= 255:
        raise ValueError(f"shards={G}: the header holds 1..255")
    if G % world:
        raise ValueError(f"{G} shards do not split evenly over {world} "
                         "ranks")
    return ShardMesh(G, world, rank(group), G // world, group)


def _refusals(cfg: ModelConfig) -> List[str]:
    """What the sharded codec does not code (JAX ``codec_sp.py:92-101``)."""
    return [why for bad, why in (
        (cfg.clrchs != 3, "clrchs < 3"),
        (cfg.clr_joint_mode not in (0, 1, 2),
         f"clr_joint_mode={cfg.clr_joint_mode}"),
        (cfg.distribution not in ("normal", "logistic"),
         f"distribution={cfg.distribution!r}"),
        (cfg.num_mixtures < 2, "num_mixtures < 2"),
        (not cfg.ycocg, "ycocg=False"),
        (cfg.subtract_mean, "subtract_mean"),
        (seq_colours(cfg) and cfg.activfun == "GDN1",
         "clrjnt0seqmd with GDN1")) if bad]


class ShardedCodec:
    """Encoder/decoder of row-sharded containers, one rANS stream a shard.

    ``params``: Flax parameters as numpy arrays (as :class:`Codec` takes
    them).  ``mesh``: a :class:`ShardMesh` (default: one shard a rank of
    the process group, or one shard in a single process).  ``num_lanes``
    (JAX's default 128) lanes a shard, matched between encoder and
    decoder.  ``device`` is the card unless the caller asks for "cpu".

    Accounting, as JAX's: ``last_slice_bits`` / ``last_ideal_bits`` are
    [scale][b*3+clr] tables of stream bits and ideal bits
    (sum of 16 - log2 freq) summed over the G shards, coarsest scale
    first; the ``*_batch`` forms hold one table per image of a call and
    the flat ones their sums.  ``dispatch_counts`` counts, per direction,
    the scale passes a call ran (a decode: S, each nine Kernel 2
    launches) plus, per encode, its one chain call (S + 1); JAX counts
    its S decode and 2S encode programs.
    """

    serialize = staticmethod(Codec.serialize)
    deserialize = staticmethod(Codec.deserialize)
    num_bytes = staticmethod(num_bytes)

    @staticmethod
    def _check_cfg(cfg: ModelConfig) -> None:
        refused = _refusals(cfg)
        if refused:
            raise ValueError(f"the sharded codec does not code "
                             f"{', '.join(refused)}")

    @classmethod
    def supports(cls, cfg: ModelConfig) -> bool:
        """True if this codec can entropy-code models with this config."""
        return not _refusals(cfg)

    def __init__(self, cfg: ModelConfig, params, mesh: Optional[ShardMesh]
                 = None, num_lanes: int = 128, device="cuda"):
        self._check_cfg(cfg)
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_sp_mesh()
        self.G = self.mesh.G
        self.N = num_lanes
        self._codec = Codec(cfg, params, device=device, num_lanes=num_lanes,
                            use_kernel_cdf=False)
        if self.mesh.world > 1:
            self._codec._halo = functools.partial(halo_rows,
                                                  group=self.mesh.group)
        self.device = self._codec.device
        self.dispatch_counts = {"decode": 0, "encode": 0}
        self.last_slice_bits: Optional[List[List[int]]] = None
        self.last_ideal_bits: Optional[List[List[float]]] = None
        self.last_slice_bits_batch: Optional[List] = None
        self.last_ideal_bits_batch: Optional[List] = None
        self.last_ycocg_err: Optional[int] = None

    # ---- shapes ----------------------------------------------------------
    def _stride(self) -> int:
        return 2 ** (max(self.cfg.dwtlevels) + 1)

    def _pad_multiple(self) -> Tuple[int, int]:
        return self.G * self._stride(), self._stride()

    def _rows(self, H: int) -> slice:
        """This rank's rows of a (padded) height H."""
        h = H // self.mesh.world
        return slice(self.mesh.rank * h, (self.mesh.rank + 1) * h)

    def _padded(self, rgb: np.ndarray) -> Tuple[np.ndarray, int, int]:
        """[H, W, 3] / [1, H, W, 3] uint8 -> (replicate-padded [1, H', W',
        3], orig_h, orig_w)."""
        rgb = np.asarray(rgb)
        if rgb.ndim == 3:
            rgb = rgb[None]
        if rgb.dtype != np.uint8 or rgb.ndim != 4 or rgb.shape[0] != 1 \
                or rgb.shape[-1] != 3:
            raise ValueError(f"expected [H, W, 3] uint8, got {rgb.dtype} "
                             f"{rgb.shape}")
        mh, mw = self._pad_multiple()
        oh, ow = rgb.shape[1], rgb.shape[2]
        return np.pad(rgb, ((0, 0), (0, -(-oh // mh) * mh - oh),
                            (0, -(-ow // mw) * mw - ow), (0, 0)),
                      mode="edge"), oh, ow

    def _cap(self, last_h: int, last_w: int) -> int:
        """Words of a shard's stream buffer: one at most a symbol."""
        h, w, n = last_h, last_w, 0
        for _ in range(self.cfg.num_scales):
            n += 9 * (h // self.G) * w
            h, w = 2 * h, 2 * w
        return -(-(n + self.N) // 4096) * 4096

    def _stage(self, padded: np.ndarray, origs, minmax) -> _Staged:
        """The host's part of an encode of a padded image whose YCoCg
        min/max are ``minmax``: this rank's rows, the header's raw band."""
        S = self.cfg.num_scales
        st = self._stride()
        last_h, last_w = padded.shape[1] // st, padded.shape[2] // st
        raw = np.ascontiguousarray(padded[:, ::st, ::st])
        return _Staged(np.ascontiguousarray(padded[:, self._rows(
            padded.shape[1])]), [origs], list(minmax), raw,
            [(False, False)] * S, 0, last_h, last_w,
            self._cap(last_h, last_w),
            [clr_range(clr, minmax) for clr in range(3)])

    def _header(self, st: _Staged) -> List[bytes]:
        hdr = (np.array([self.cfg.num_scales, self.G], np.uint8).tobytes()
               + np.array([st.last_h, st.last_w], np.uint16).tobytes()
               + np.array(st.origs[0], np.uint32).tobytes())
        return [hdr, np.array(st.minmax, np.int16).tobytes(),
                st.raw.tobytes()]

    # ---- encode ----------------------------------------------------------
    def _chain(self, rgb_dev: torch.Tensor, st: _Staged):
        """Queue the convs and tables of an encode of this rank's rows:
        (starts, freqs) int32 [g_local, n_total] of its shards' chains in
        encode order, the slices' offsets (host int64), and every slice's
        freqs [rows] in decode order."""
        L = self.mesh.local
        sf = self._codec._encode_slices(rgb_dev, st)
        self.dispatch_counts["encode"] += self.cfg.num_scales + 1
        starts = torch.cat([s.reshape(L, -1) for s, _ in reversed(sf)], 1)
        freqs = torch.cat([f.reshape(L, -1) for _, f in reversed(sf)], 1)
        offsets = torch.from_numpy(np.cumsum(
            [0] + [f.numel() // L for _, f in reversed(sf)]))
        return starts, freqs, offsets, [f for _, f in sf]

    def _encode_queue(self, rgb_dev: torch.Tensor, st: _Staged):
        """Queue a whole encode of this rank's shards: -> (cursors int32
        [g_local, 9S] in encode order, states int64 [g_local, N], buf int32
        [g_local, cap], this rank's ideal bits float32 [9S] in decode
        order), on the device; nothing synchronises."""
        L, dev = self.mesh.local, self.device
        starts, freqs, offsets, per_slice = self._chain(rgb_dev, st)
        states = torch.full((L, self.N), RANS_L, dtype=torch.int64,
                            device=dev)
        cursor = torch.zeros((L,), dtype=torch.int32, device=dev)
        buf = torch.zeros((L, st.cap), dtype=torch.int32, device=dev)
        cursors = rans_encode_chain(starts, freqs, offsets, states, cursor,
                                    buf)
        ideal = torch.stack([torch.where(f > 0, 16.0 - torch.log2(
            f.clamp(min=1).float()), 0.0).sum() for f in per_slice])
        return cursors, states, buf, ideal

    def _finish(self, st: _Staged, cursors, states, words, ideal):
        """One image's container from this rank's fetched encode: blobs
        gathered from every rank, stream and ideal bits summed over the
        G shards.  -> (streams, slice bits table, ideal bits table)."""
        S = self.cfg.num_scales
        blobs = all_gather_bytes(
            [pack_stream_packed(w, s) for w, s in zip(words, states)],
            self.mesh.group)
        counts = np.diff(np.concatenate(
            [np.zeros((cursors.shape[0], 1), np.int64),
             cursors.astype(np.int64)], axis=1), axis=1).sum(axis=0)
        # one reduction of both: exact in float64
        both = torch.from_numpy(np.concatenate(
            [counts[::-1].astype(np.float64), ideal.astype(np.float64)])
        ).to(comm_device(self.mesh.group))
        both = all_reduce_sum(both, self.mesh.group).cpu().numpy()
        bits = [[int(v) * 16 for v in both[s * 9:s * 9 + 9]]
                for s in range(S)]
        ideals = [[float(v) for v in both[9 * S + s * 9:9 * S + s * 9 + 9]]
                  for s in range(S)]
        return [self._header(st), blobs], bits, ideals

    def _encode(self, staged, devs) -> List[List[List[bytes]]]:
        """Encode staged images: all device work queued, then one
        synchronisation for cursors, states and ideal bits and one for the
        payloads, then each image's gathers."""
        outs = [self._encode_queue(d, st) for d, st in zip(devs, staged)]
        small = self._codec._fetch([t for c, s, _, i in outs
                                    for t in (c, s, i)])
        payloads = []
        for st, (_, _, buf, _), cursors in zip(staged, outs, small[0::3]):
            if int(cursors[:, -1].max()) > st.cap:
                raise RuntimeError(f"a shard's rANS stream overran its "
                                   f"{st.cap}-word buffer")
            payloads += [buf[k, :int(t)] for k, t in
                         enumerate(cursors[:, -1])]
        words = self._codec._fetch(payloads)
        L = self.mesh.local
        done = [self._finish(st, c, s, words[i * L:(i + 1) * L], ideal)
                for i, (st, c, s, ideal) in enumerate(zip(
                    staged, small[0::3], small[1::3], small[2::3]))]
        Codec._account(self, done)  # the single codec's tables and sums
        return [streams for streams, _, _ in done]

    @_pass("llicti.compress")
    def compress(self, rgb: np.ndarray) -> List[List[bytes]]:
        """Encode one image (``[H, W, 3]`` or ``[1, H, W, 3]`` uint8); every
        rank of the mesh calls it with the same image."""
        return self.compress_many([rgb])[0]

    @_pass("llicti.compress")
    def compress_many(self, imgs: Sequence[np.ndarray]
                      ) -> List[List[List[bytes]]]:
        """Pipelined encode of several images, each into the container
        :meth:`compress` gives: every image's rows uploaded and its YCoCg
        min/max reduced first (one synchronisation, then the ranks'
        reduction), then every encode queued."""
        pads = [self._padded(im) for im in imgs]
        devs = [self._codec._upload(np.ascontiguousarray(
            p[:, self._rows(p.shape[1])])) for p, _, _ in pads]
        mms = []
        for d in devs:
            ycocg = rgb_int_to_ycocg_r_int(d).reshape(-1, 3)
            mms.append(torch.cat((ycocg.amin(0), ycocg.amax(0))))
        staged = []
        for (p, oh, ow), mm in zip(pads, self._codec._fetch(mms)):
            lo, hi = all_reduce_minmax(mm[:3].tolist(), mm[3:].tolist(),
                                       self.mesh.group)
            staged.append(self._stage(p, (oh, ow), lo + hi))
        return self._encode(staged, devs)

    @_pass("llicti.compress")
    def encode_inputs(self, rgb: np.ndarray):
        """The encoder's rANS chain of one image before it is encoded:
        (starts, freqs) int32 [g_local, n_total] of this rank's shards in
        encode order, the slices' offsets (host int64) and the word cap
        of a shard's buffer; Kernel 3's inputs."""
        p, oh, ow = self._padded(rgb)
        minmax, _ = host_header(p, self.cfg.dwtlevels)
        st = self._stage(p, (oh, ow), minmax)
        starts, freqs, offsets, _ = self._chain(
            self._codec._upload(st.rgb), st)
        return starts, freqs, offsets, st.cap

    def prepare_encode(self, rgb: np.ndarray):
        """Stage one image's rows on the device; returns a closure whose
        call queues the whole encode and returns its device tensors
        (cursors, states, buf, ideal bits, as :meth:`_encode_queue`).  The
        min/max come from the host's integer twin, so the call copies
        nothing and never synchronises (the payload stays on the device,
        as in JAX's)."""
        p, oh, ow = self._padded(rgb)
        minmax, _ = host_header(p, self.cfg.dwtlevels)
        st = self._stage(p, (oh, ow), minmax)
        dev = self._codec._upload(st.rgb)
        self._codec._pts3(st.ranges)
        self._codec._settle()

        def encode():
            with torch.inference_mode(), exact_math():
                return self._encode_queue(dev, st)

        return encode

    # ---- decode ----------------------------------------------------------
    def _parse(self, streams: List[List[bytes]]) -> Header:
        """The Header of this rank's rows; ValueError on a container of
        another S or G, or an inconsistent one."""
        hdr = streams[0][0] if streams and streams[0] else b""
        if len(hdr) != 14 or len(streams) != 2 or len(streams[0]) != 3:
            raise ValueError("not a row-sharded container")
        S, G = hdr[0], hdr[1]
        if S != self.cfg.num_scales or G != self.G:
            raise ValueError(f"a container of {S} scales and {G} shards; "
                             f"this codec codes {self.cfg.num_scales} and "
                             f"{self.G}")
        last_h, last_w = (int(v) for v in np.frombuffer(hdr[2:6], np.uint16))
        oh, ow = (int(v) for v in np.frombuffer(hdr[6:14], np.uint32))
        st = self._stride()
        mh, mw = self._pad_multiple()
        if ((last_h * st) % mh or (last_w * st) % mw or len(streams[1]) != G
                or len(streams[0][1]) != 12
                or len(streams[0][2]) != last_h * last_w * 3
                or not (1 <= oh <= last_h * st and 1 <= ow <= last_w * st)):
            raise ValueError("inconsistent row-sharded container")
        minmax = [int(v) for v in np.frombuffer(streams[0][1], np.int16)]
        raw = np.frombuffer(streams[0][2], np.uint8).reshape(
            1, last_h, last_w, 3)[:, self._rows(last_h)]
        return Header(minmax, [(False, False)] * S, raw, [(oh, ow)], None)

    def _decode_inputs(self, streams) -> _DecodeInputs:
        hdr = self._parse(streams)
        L, r = self.mesh.local, self.mesh.rank
        staged, = self._codec._decode_stage([streams[1][r * L:(r + 1) * L]])
        return self._codec._decode_upload(hdr, staged, split=False)

    def _decode_queue(self, d: _DecodeInputs):
        """Queue a decode of this rank's shards: -> (YCoCg int32 of its
        rows, RGB uint8 of the whole padded image gathered from the
        ranks), on the device."""
        self.dispatch_counts["decode"] += self.cfg.num_scales
        ycocg, rgb = self._codec._decode_queue(d)
        return ycocg, all_gather_rows(rgb, 1, self.mesh.group)

    @_pass("llicti.decompress")
    def decompress_dispatch(self, streams: List[List[bytes]]):
        """Queue one image's decode; -> (device RGB uint8 [1, H, W, 3] at
        the padded size, orig_h, orig_w)."""
        d = self._decode_inputs(streams)
        return (self._decode_queue(d)[1],) + d.hdr.origs[0]

    @_pass("llicti.decompress")
    def decompress(self, streams: List[List[bytes]],
                   xorg: Optional[np.ndarray] = None) -> np.ndarray:
        """Decode -> ``[1, H, W, 3]`` uint8.  With ``xorg`` (the original
        image), the largest error of the decoded YCoCg integers against
        its transform, over every rank, goes in ``last_ycocg_err``."""
        d = self._decode_inputs(streams)
        ycocg, rgb = self._decode_queue(d)
        out = self._codec._fetch([rgb])[0]
        oh, ow = d.hdr.origs[0]
        if xorg is not None:
            xpad, _, _ = self._padded(np.asarray(xorg).reshape(
                (-1,) + np.shape(xorg)[-3:]))
            org = rgb_int_to_ycocg_r_int(self._codec._upload(
                np.ascontiguousarray(xpad[:, self._rows(xpad.shape[1])])))
            err = int((ycocg - org).abs().max())
            self.last_ycocg_err = all_reduce_minmax([], [err],
                                                    self.mesh.group)[1][0]
        return out[:, :oh, :ow]

    @_pass("llicti.decompress")
    def decompress_many(self, streams_list) -> List[np.ndarray]:
        """Pipelined decode: every container staged and every decode
        queued, then one synchronisation."""
        inputs = [self._decode_inputs(s) for s in streams_list]
        outs = self._codec._fetch([self._decode_queue(d)[1]
                                   for d in inputs])
        return [o[:, :d.hdr.origs[0][0], :d.hdr.origs[0][1]]
                for o, d in zip(outs, inputs)]

    def prepare_decode(self, streams: List[List[bytes]]):
        """Stage a container's buffers once; returns a closure whose call
        queues its decode and returns the device RGB [1, H, W, 3] (padded
        size; gathered from the ranks), copying nothing from the host."""
        d = self._decode_inputs(streams)
        self._codec._pts3([clr_range(clr, d.hdr.minmax) for clr in range(3)])
        self._codec._settle()

        def decode():
            with torch.inference_mode(), exact_math():
                # the decode updates the lane states in place
                return self._decode_queue(
                    d._replace(states=d.states.clone()))[1]

        return decode
