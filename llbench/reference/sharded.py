"""The reference encoder of the row-sharded container: one image split by
rows into G shards, each entropy-coded into its own N-lane rANS stream.
Plain PyTorch and numpy, on the joint-colour model
(:class:`model.Model`).

The image's height must be a multiple of G times the coarsest stride and
its width a multiple of the stride, so no band is padded.  Per scale,
coarse to fine, and per band, the interpolator's parameter map of the
whole image; per colour the float mixture CDF (the erfc normal CDF of
every term at every sampling point, the weights normalised by 1e-9 plus
their sum, the terms summed one by one), quantised to int32 tables
(2^16 total, a running maximum, one count a symbol at least) and each
pixel's (start, freq).  Shard g's symbols of a slice are its rows of the
band, row-major; its chain is its 9 S slices in reverse decode order,
coded by :func:`codec.rans_encode` with one chain a shard.  The
container (``parallel/codec_sp.py``'s layout, the published codec's):

  [[S u8 | G u8 | last_h, last_w u16 | orig_h, orig_w u32,
    minmax int16 x6, coarsest x00 RGB [1, last_h, last_w, 3]],
   [shard 0's stream, ..., shard G-1's stream]]

``blocks``: the number of row blocks the maps are computed in, each from
its block of the replicate-padded bands with the neighbouring rows its
layer-0 kernels read: the program's layout over that many ranks, whose
convs run at a block's size (cuDNN may pick another algorithm for
another size, and the containers must match byte for byte).  Every
block's map equals the whole image's in exact arithmetic.

Departures from the published description: float32 with TF32 off
(``codec.float32_math``), the precision the codec states.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .codec import (INV255, colour_ranges, float32_math, rans_encode,
                    sampling_points, stream)
from .model import (SCALE_BOUND, WEIGHT_BOUND, BandNet, Model, lazy_dwt,
                    rgb_int_to_ycocg_r_int, rgb_int_to_ycocg_r_int_np)

SQRT2_INV = 2 ** -0.5


def block_params(net: BandNet, y_cond: torch.Tensor, r: int,
                 blocks: int) -> torch.Tensor:
    """Block ``r`` of ``blocks`` (rows) of ``net.params(y_cond)``, computed
    from that block's rows of the replicate-padded conditioning bands:
    [1, h / blocks, w, Co], contiguous."""
    x = y_cond.permute(0, 3, 1, 2)
    h = x.shape[2] // blocks
    out = None
    for unit, name, _, pad in net.specs:
        xb = F.pad(x[:, unit * net.c:(unit + 1) * net.c].contiguous(), pad,
                   mode="replicate")
        xb = xb[:, :, r * h:(r + 1) * h + pad[2] + pad[3]].contiguous()
        o = getattr(net, name)(xb)
        out = o if out is None else out + o
    return net.trunk(net.act0(out)).permute(0, 2, 3, 1).contiguous()


def _sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim``, one by one, left to right."""
    acc = t.select(dim, 0)
    for i in range(1, t.shape[dim]):
        acc = acc + t.select(dim, i)
    return acc


def float_tables(points, pm, y, M: int, clr: int, y0: int, sym_ch: int,
                 minv: int):
    """One colour's int32 table [n, P] and (start, freq) [n] from the
    float mixture CDF: parameter rows ``pm`` [n, 12 M] (the joint model's
    layout, mu_Co += a Y, mu_Cg += b Y + d Co), the pixels' channels ``y``
    [n, YC], Y at channel ``y0`` and Co after it."""
    std = torch.clamp_min(pm[:, clr * M:(clr + 1) * M], SCALE_BOUND)
    mean = pm[:, (3 + clr) * M:(4 + clr) * M]
    Y, Co = y[:, y0:y0 + 1], y[:, y0 + 1:y0 + 2]
    if clr == 1:
        mean = mean + pm[:, 9 * M:10 * M] * Y
    elif clr == 2:
        mean = mean + (pm[:, 10 * M:11 * M] * Y + pm[:, 11 * M:12 * M] * Co)
    w = torch.clamp_min(pm[:, (6 + clr) * M:(7 + clr) * M], WEIGHT_BOUND)
    w = w / (1e-9 + _sum(w, -1)[:, None])
    z = (points - mean[..., None]) / std[..., None]  # [n, M, P]
    cdf = _sum(w[..., None] * (0.5 * torch.special.erfc(-SQRT2_INV * z)),
               -2)
    P = points.shape[0]
    q = torch.round(cdf.clamp(0.0, 1.0) * float(2 ** 16 - (P - 1))).to(
        torch.int32)
    q = torch.cummax(q, dim=-1).values
    q = q + torch.arange(P, dtype=torch.int32, device=q.device)
    q[..., -1] = 1 << 16
    sym = (torch.round(y[:, sym_ch] * 255.0).to(torch.int32) - minv).clamp(
        0, P - 2).long()[:, None]
    lo = q.gather(1, sym)[:, 0]
    return q, lo, q.gather(1, sym + 1)[:, 0] - lo


def encode(model: Model, rgb: np.ndarray, shards: int, lanes: int,
           device, blocks: int = 1, tf32: bool = False) -> Dict:
    """A uint8 [H, W, 3] image -> {"streams": its row-sharded container,
    "words": each shard's words of each slice in decode order [G,
    slices]}; ``tf32`` computes in TF32, the control of the
    comparison."""
    cfg, c, M = model.cfg, model.cfg.c, model.cfg.M
    rgb = np.asarray(rgb, np.uint8)[None]
    _, H, W, _ = rgb.shape
    st = 2 ** (max(cfg.dwtlevels) + 1)
    if H % (shards * st) or W % st or shards % blocks:
        raise ValueError(f"{H}x{W} in {shards} shards of {blocks} blocks: "
                         f"the height must be a multiple of {shards * st} "
                         f"and the width of {st}, the blocks divide the "
                         "shards")
    ycocg = rgb_int_to_ycocg_r_int_np(rgb)
    minmax = ([int(ycocg[..., i].min()) for i in range(3)]
              + [int(ycocg[..., i].max()) for i in range(3)])
    ranges = colour_ranges(minmax)
    chain = []
    with torch.no_grad(), float32_math(tf32):
        dev = torch.from_numpy(rgb).to(device)
        shift = torch.tensor((127, 0, 0), dtype=torch.int32, device=device)
        x = (rgb_int_to_ycocg_r_int(dev) - shift).float() * INV255
        y_list = lazy_dwt(x, cfg.dwtlevels)
        pts = [sampling_points(*r).to(device) for r in ranges]
        for scl in range(cfg.num_scales - 1, -1, -1):
            y_lev = y_list[scl]
            h = y_lev.shape[1] // blocks
            for b in range(3):
                net = model.band(scl, b)
                y_cond = y_lev[..., :c * (b + 1)].contiguous()
                sf = [[], [], []]
                for r in range(blocks):
                    pm = block_params(net, y_cond, r, blocks)
                    pm = pm.reshape(-1, pm.shape[-1])
                    y2 = y_lev[:, r * h:(r + 1) * h].reshape(
                        pm.shape[0], -1).contiguous()
                    for clr in range(3):
                        _, start, freq = float_tables(
                            pts[clr], pm, y2, M, clr, c * (b + 1),
                            c * (b + 1) + clr, ranges[clr][0])
                        sf[clr].append((start, freq))
                for clr in range(3):
                    start = torch.cat([s for s, _ in sf[clr]])
                    freq = torch.cat([f for _, f in sf[clr]])
                    chain.append((start.view(shards, -1).cpu().numpy(),
                                  freq.view(shards, -1).cpu().numpy()))
    states, words, cursors = rans_encode(list(reversed(chain)), lanes)
    per_slice = np.diff(np.concatenate(
        [np.zeros((shards, 1), np.int64), cursors], axis=1), axis=1)[:, ::-1]
    raw = np.ascontiguousarray(rgb[:, ::st, ::st, :])
    hdr = (np.array([cfg.num_scales, shards], np.uint8).tobytes()
           + np.array([H // st, W // st], np.uint16).tobytes()
           + np.array([H, W], np.uint32).tobytes())
    streams: List[List[bytes]] = [
        [hdr, np.array(minmax, np.int16).tobytes(), raw.tobytes()],
        [stream(states[g], words[g]) for g in range(shards)]]
    return {"streams": streams, "words": per_slice}
