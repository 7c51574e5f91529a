"""Interpolator network: the conditional-GMM parameter CNN of one
(scale, band), and its self-information head.

Port of ``llicti_tpu/models/interpolator.py``.  Layer 0 is band-geometry
specific: small Ev/Od kernels with asymmetric replicate padding that
align receptive fields with the polyphase sample positions; the trunk is
grouped 1x1 convs.  ``band=-1`` (combine_layers1toL) holds every band's
layer-0 convs and picks them by the conditioning channel count.  With
clrjnt0seqmd, the current pixel's earlier colours feed the later colours'
channel groups through ``seq_toCo`` / ``seq_toCg``
(:meth:`Interpolator.params_from_base`).  The codec path calls
:meth:`Interpolator.get_params` (a batch of K > 1 images on the card
:meth:`Interpolator.get_params_batched`); the rate forward
(:meth:`Interpolator.forward`) turns the parameter map into the
self-information of the band to predict, for every configuration the
JAX package trains (clrjnt 0 / 1 / 2, clrchs < 3, subtract_mean).  Public
tensors are NHWC like the JAX package's; inside, the convs run in the
memory format of the layer-0 kernels: NCHW as loaded (the codec's), or
channels-last (the training step's), in which the NHWC bands need no
transpose.
Where no gradient is recorded and the convs run NCHW (every codec pass),
layer 0's unit sum, a ReLU, the parameter map's NHWC layout and, on the
card, each conv's bias are done in one pass after the conv
(:func:`band_epilogue`), with the additions PyTorch's own passes make, in
their order.  A codec holds (:meth:`Interpolator.hold`) the kernel of a
layer-0 conv of 1 < groups < input channels (clr_joint_mode 1's groups 2
over four channels) as one ungrouped conv's, its groups' kernels on the
diagonal and zeros elsewhere: on the card cuDNN runs such a grouped conv
as a conv a group between ``genericTranspose`` kernels, some 18x the time
of the ungrouped conv, whose sums gain only exact zero products.
The conditioning and predicted bands are data: no gradient flows into
them, only into the parameters.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops.band_epilogue import band_epilogue
from ..ops.color import ieee_div
from ..ops.gdn import GDN1
from ..ops.gmm import gmm_self_information


def interpolator_dims(cfg: ModelConfig, scale: int):
    """(grps, Ch, Co, c, grp0) of the interpolator owning ``scale``."""
    M = cfg.num_mixtures
    ch = cfg.chs[scale]
    if cfg.clrchs == 3:
        if cfg.clr_joint_mode == 2:
            grps = 1 if cfg.mwsa_joint else 4
            Ch = grps * ch
            Co = 3 * M * 3 + 3 * M  # sigma/mu/w for 3 colours + (a,b,d)*M
        elif cfg.clr_joint_mode == 1:
            grps = 8
            Ch = grps * ch
            Co = M * 16
        elif cfg.clr_joint_mode == 0:
            grps = 3 if cfg.mwsa_joint else 9
            Ch = grps * ch
            Co = M * grps
        else:
            raise ValueError(cfg.clr_joint_mode)
    else:
        chs = [48, 32, 24, 24]
        if cfg.clrchs in (1, 2):
            chs = [int(i * 0.75) for i in chs]
        Ch = 3 * chs[scale]
        grps = 3
        Co = M * 3
    c = cfg.cond_channels
    grp0 = 1 if (cfg.clrchs < 3 or cfg.clr_joint_mode == 2) else (
        3 if cfg.clr_joint_mode == 0 else 2)
    return grps, Ch, Co, c, grp0


def seq_colours(cfg: ModelConfig) -> bool:
    """Whether the config conditions later colours on earlier ones of the
    same pixel (clrjnt0seqmd)."""
    return cfg.clrchs == 3 and cfg.clr_joint_mode == 0 and cfg.clrjnt0seqmd


def _activation(kind: str, channels: int) -> nn.Module:
    if kind == "ReLU":
        return nn.ReLU()
    if kind == "LeakyReLU":
        return nn.LeakyReLU(0.01)
    if kind == "PReLU":
        return nn.PReLU(num_parameters=channels, init=0.25)
    if kind == "GDN1":
        return GDN1(channels)
    return nn.Identity()  # any other name, as the JAX _Activation


def _layer0_specs(Ev: int, Od: int):
    """band -> [(input band unit, conv name, kernel (kh, kw), replicate
    pad (left, right, top, bottom))] of layer 0."""
    e0, e1, o = Ev // 2 - 1, Ev // 2, Od // 2
    return {
        0: [(0, "conv_00_11", (Ev, Ev), (e0, e1, e0, e1))],
        1: [(0, "conv_00_01", (Od, Ev), (e0, e1, o, o)),
            (1, "conv_11_01", (Ev, Od), (o, o, e1, e0))],
        2: [(0, "conv_00_10", (Ev, Od), (o, o, e0, e1)),
            (1, "conv_11_10", (Od, Ev), (e1, e0, o, o)),
            (2, "conv_01_10", (Ev, Ev), (e1, e0, e0, e1))],
    }


class Interpolator(nn.Module):
    """One conditional-GMM parameter network for a (scale, band); band -1
    serves all three bands."""

    def __init__(self, cfg: ModelConfig, scale: int, band: int):
        super().__init__()
        if band not in (0, 1, 2, -1):
            raise ValueError(f"band={band}")
        grps, Ch, Co, c, grp0 = interpolator_dims(cfg, scale)
        self.c = c
        self.clrchs, self.clr_joint_mode = cfg.clrchs, cfg.clr_joint_mode
        self.num_mixtures = cfg.num_mixtures
        self.logistic = cfg.distribution == "logistic"
        self.subtract_mean, self.rndfactor = cfg.subtract_mean, cfg.rndfactor
        self.seq = seq_colours(cfg)
        specs = _layer0_specs(cfg.evens[scale], cfg.odds[scale])
        self._specs = {b: s for b, s in specs.items() if band in (b, -1)}
        for spec in self._specs.values():
            for _, name, kernel, _ in spec:
                self.add_module(name, nn.Conv2d(c, Ch, kernel, groups=grp0))
        if self.seq:
            self.seq_toCo = nn.Conv2d(1, Ch // 3, 1)
            self.seq_toCg = nn.Conv2d(2, Ch // 3, 1)
        self.act0 = _activation(cfg.activfun, Ch)
        trunk = []
        for _ in range(cfg.conv_layers - 2):
            trunk.append(nn.Conv2d(Ch, Ch, 1, groups=grps))
            trunk.append(_activation(cfg.activfun, Ch))
        trunk.append(nn.Conv2d(Ch, Co, 1, groups=grps))
        self.trunk = nn.Sequential(*trunk)

    def hold(self) -> None:
        """Hold each layer-0 conv of 1 < groups < input channels as one
        ungrouped conv (:func:`block_diagonal`), for the codec's passes
        (:func:`_unbiased` on the card); its weights are not trained
        after this.  A depthwise or ungrouped layer 0 holds nothing."""
        for spec in self._specs.values():
            for _, name, _, _ in spec:
                conv = getattr(self, name)
                if 1 < conv.groups < conv.in_channels:
                    with torch.no_grad():
                        conv.held_dense = block_diagonal(conv)

    def _band_specs(self, y_cond: torch.Tensor):
        """The layer-0 specs of the band ``y_cond`` conditions."""
        band = y_cond.shape[-1] // self.c - 1
        if band not in self._specs:
            raise ValueError(f"{y_cond.shape[-1]} conditioning channels fit "
                             f"no band of this interpolator")
        return self._specs[band]

    def _units(self, y_cond: torch.Tensor, halo=None):
        """The conditioning bands as NCHW, this band's layer-0 specs and
        the halo rows the bands carry a side: none without ``halo``; with
        it, the rows its widest pad needs, from the neighbouring ranks."""
        specs = self._band_specs(y_cond)
        if halo is None:
            return y_cond.permute(0, 3, 1, 2), specs, 0
        m = max(max(pad[2], pad[3]) for _, _, _, pad in specs)
        return halo(y_cond, m, m).permute(0, 3, 1, 2), specs, m

    def _format(self, specs) -> torch.memory_format:
        """The memory format of the layer-0 kernels: channels-last when a
        kernel's channel stride is 1, which in NCHW it is not: no layer-0
        kernel is 1x1 (Ev is even)."""
        w = getattr(self, specs[0][1]).weight
        return (torch.channels_last if w.stride(1) == 1
                else torch.contiguous_format)

    def _fused(self, x: torch.Tensor) -> bool:
        """Whether the convs that read the NCHW map ``x`` finish in the
        band epilogue: where no gradient is recorded (the epilogue has no
        backward), the layer-0 kernels run NCHW (a training model's run
        channels-last) and ``x`` is NCHW contiguous, the layouts the
        epilogue takes.  On the CPU the epilogue is its plain version,
        and each conv keeps its bias (:func:`_unbiased`): that run is
        where the CPU's tests hold the fused path's wiring."""
        specs = next(iter(self._specs.values()))
        return (not torch.is_grad_enabled() and x.is_contiguous()
                and self._format(specs) == torch.contiguous_format)

    def _unit_inputs(self, y_cond: torch.Tensor, halo=None):
        """(layer-0 conv, its padded NCHW input in the kernels' memory
        format) of each conditioning band unit in turn."""
        x, specs, m = self._units(y_cond, halo)
        c, fmt = self.c, self._format(specs)
        for unit, name, _, pad in specs:
            xb = x[:, unit * c:(unit + 1) * c].contiguous(memory_format=fmt)
            yield getattr(self, name), _replicate(xb, pad, m)

    def _base(self, y_cond: torch.Tensor, halo=None,
              act: bool = False) -> torch.Tensor:
        """Layer-0 sum, NCHW in the kernels' memory format: pre-activation,
        or with ``act`` after ``act0`` (a ReLU folded into the band
        epilogue on the fused path, :meth:`_fused`)."""
        units = self._unit_inputs(y_cond, halo)
        conv, x = next(units)
        if not self._fused(x):
            out = conv(x)
            for conv, x in units:
                out = out + conv(x)
            return self.act0(out) if act else out
        maps, biases = zip(_unbiased(conv, x), *(_unbiased(*u) for u in units))
        relu = act and type(self.act0) is nn.ReLU
        out = band_epilogue(maps, biases, relu=relu, out=maps[0])
        return self.act0(out) if act and not relu else out

    def _quant(self, x: torch.Tensor) -> torch.Tensor:
        return ieee_div(torch.round(x * self.rndfactor), self.rndfactor)

    def _base_submean(self, y_cond: torch.Tensor, halo=None):
        """subtract_mean layer 0: each conditioning band minus its quantised
        local box mean (over the conv's kernel window of the
        replicate-padded band) before its conv.  -> (pre-activation sum
        NCHW, quantised mean of the band means NHWC), the mean to subtract
        from the predicted band.  With ``halo`` the differences' own halo
        rows come from a second exchange."""
        x, specs, m = self._units(y_cond, halo)
        c = self.c
        out = mean_sum = None
        for unit, name, (kh, kw), pad in specs:
            xb = x[:, unit * c:(unit + 1) * c]
            mn = _box_mean(_replicate(xb, pad, m), kh, kw)
            d = xb[:, :, m:xb.shape[2] - m] - self._quant(mn)
            if halo is None:
                d = F.pad(d, pad, mode="replicate")
            else:
                d = F.pad(halo(d.permute(0, 2, 3, 1), pad[2], pad[3])
                          .permute(0, 3, 1, 2), pad[:2] + (0, 0),
                          mode="replicate")
            o = getattr(self, name)(d)
            out = o if out is None else out + o
            mean_sum = mn if mean_sum is None else mean_sum + mn
        mean = self._quant(ieee_div(mean_sum, len(specs)))
        return out, mean.permute(0, 2, 3, 1)

    def _head(self, base: torch.Tensor) -> torch.Tensor:
        """Activation + trunk of an NCHW base -> NHWC contiguous pmap."""
        return self._trunk(self.act0(base))

    def _trunk(self, h: torch.Tensor) -> torch.Tensor:
        """Trunk of an activated NCHW map -> NHWC contiguous pmap (a view,
        without a copy, of a channels-last trunk's output).  On the fused
        path (:meth:`_fused`) each conv's bias (and a middle conv's ReLU)
        is added in place in one pass, and the last conv's output written
        NHWC in the pass that adds its bias."""
        if not self._fused(h):
            return self.trunk(h).permute(0, 2, 3, 1).contiguous()
        layers = list(self.trunk)
        for conv, act in zip(layers[:-1:2], layers[1::2]):
            y, b = _unbiased(conv, h)
            relu = type(act) is nn.ReLU
            h = band_epilogue([y], [b], relu=relu, out=y)
            if not relu:
                h = act(h)
        y, b = _unbiased(layers[-1], h)
        return band_epilogue([y], [b], nhwc=True)

    def get_params(self, y_cond: torch.Tensor, halo=None) -> torch.Tensor:
        """Conditioning bands ``[B, H, W, c*(band+1)]`` -> GMM parameter map
        ``[B, H, W, Co]`` (contiguous).  ``halo``: for a rank's block of
        rows, the exchange that gives it its neighbours' boundary rows
        (``parallel.halo.halo_rows``); None for a whole image."""
        return self._trunk(self._base(y_cond, halo, act=True))

    def get_params_batched(self, y_cond: torch.Tensor) -> torch.Tensor:
        """:meth:`get_params` of a batch of K whole images, with the
        activation and the trunk at batch 1: layer 0's sum is written
        channel-major, ``[Ch, K, h, w]``, and the trunk runs on it as one
        image of the K stacked along the height, ``[1, Ch, K*h, w]``.  A
        1x1 conv sums over one pixel's channels, so every pixel gets the
        sum it gets in a batch of K; at N > 1 cuDNN runs the trunk's last
        grouped conv (Ch -> Co) between ``genericTranspose`` kernels, at
        N = 1 the same conv kernels without them.  The unit sums keep
        their order, ``(o0 + o1) + o2``, summed with their biases (and a
        ReLU) by the band epilogue.  The fused path only (:meth:`_fused`):
        no gradient, NCHW convs."""
        units = self._unit_inputs(y_cond)
        conv, x = next(units)
        if not self._fused(x):
            raise ValueError("the batch-1 trunk takes NCHW convs and "
                             "records no gradient")
        maps, biases = zip(_unbiased(conv, x), *(_unbiased(*u) for u in units))
        K, Ch, h, w = maps[0].shape
        relu = type(self.act0) is nn.ReLU
        base = maps[0].new_empty((Ch, K, h, w))
        band_epilogue(maps, biases, relu=relu, out=base.transpose(0, 1))
        del maps, x  # the unit maps, before the trunk's
        base = base.view(1, Ch, K * h, w)
        return self._trunk(base if relu else self.act0(base)).view(
            K, h, w, -1)

    def band_base(self, y_cond: torch.Tensor, halo=None) -> torch.Tensor:
        """clrjnt0seqmd codec path: the pre-activation layer-0 map
        ``[B, H, W, Ch]`` (an NHWC view of an NCHW tensor)."""
        return self._base(y_cond, halo).permute(0, 2, 3, 1)

    def params_from_base(self, base: torch.Tensor, y_seq: torch.Tensor,
                         clr: int) -> torch.Tensor:
        """clrjnt0seqmd codec path: add the current pixel's colours below
        ``clr`` (``y_seq`` ``[B, H, W, 2]``, Y and Co) to the later colours'
        channel groups of ``base``, then activation + trunk.  The groups of
        colour ``clr`` depend on colours < ``clr`` only, so a decoder that
        holds just those computes the same map."""
        b = base.permute(0, 3, 1, 2)
        ys = y_seq.permute(0, 3, 1, 2)
        K = b.shape[1] // 9
        parts = [b[:, :3 * K], b[:, 3 * K:6 * K], b[:, 6 * K:]]
        if clr >= 1:
            parts[1] = parts[1] + self.seq_toCo(ys[:, 0:1].contiguous())
        if clr >= 2:
            parts[2] = parts[2] + self.seq_toCg(ys[:, 0:2].contiguous())
        return self._head(torch.cat(parts, dim=1) if clr >= 1 else b)

    def forward(self, y_cond: torch.Tensor, y_topred: torch.Tensor,
                halo=None) -> torch.Tensor:
        """Rate forward: conditioning bands and the band to predict
        ``[B, H, W, c]`` -> its self-information map (bits), ``[B, H, W,
        3]`` for three colours, ``[B, H, W, 1]`` for one.  clrjnt0seqmd
        conditions each colour on the pixel's earlier colours of
        ``y_topred``; subtract_mean predicts ``y_topred`` minus the
        conditioning bands' local mean (and, as in the JAX package, skips
        the seqmd terms)."""
        if self.subtract_mean:
            base, mean = self._base_submean(y_cond, halo)
            return self.self_informations(self._head(base), y_topred - mean)
        if self.seq:
            params = self.params_from_base(self.band_base(y_cond, halo),
                                           y_topred, 2)
        else:
            params = self.get_params(y_cond, halo)
        return self.self_informations(params, y_topred)

    def self_informations(self, params: torch.Tensor,
                          y: torch.Tensor) -> torch.Tensor:
        """-log2 p of every pixel and colour of ``y`` under the parameter
        map's mixtures.  Layouts per clr_joint_mode (JAX
        ``interpolator.py:320-372``):
          2: [3M sigma | 3M mu | 3M w | M a | M b | M d];
             mu_Co += a*Y, mu_Cg += b*Y + d*Co;
          0: colour i's [M sigma | M mu | M w] at 3iM;
          1: Y with 2M mixtures, Co and Cg with M; mu_Cg += a*Co
             (``y`` is (0, Y, Co, Cg));
          clrchs < 3: one colour [M sigma | M mu | M w]."""
        M = self.num_mixtures
        lg = self.logistic
        if self.clrchs == 3 and self.clr_joint_mode == 2:
            mean = params[..., 3 * M:6 * M]
            a = params[..., 9 * M:10 * M]
            b = params[..., 10 * M:11 * M]
            d = params[..., 11 * M:12 * M]
            mean = torch.cat([
                mean[..., :M], mean[..., M:2 * M] + a * y[..., 0:1],
                mean[..., 2 * M:] + (b * y[..., 0:1] + d * y[..., 1:2])], -1)
            return gmm_self_information(y[..., 0:3], params[..., 0:3 * M],
                                        mean, params[..., 6 * M:9 * M], M,
                                        logistic=lg)
        if self.clrchs == 3 and self.clr_joint_mode == 0:
            def cols(k):  # colour i's k-th block: sigma 0, mu 1, w 2
                return torch.cat([params[..., (3 * i + k) * M:
                                         (3 * i + k + 1) * M]
                                  for i in range(3)], -1)
            return gmm_self_information(y[..., 0:3], cols(0), cols(1),
                                        cols(2), M, logistic=lg)
        if self.clrchs == 3 and self.clr_joint_mode == 1:
            mean_c = params[..., 10 * M:12 * M]
            mean_c = torch.cat([
                mean_c[..., :M],
                mean_c[..., M:] + params[..., 14 * M:15 * M] * y[..., 2:3]],
                -1)
            si_y = gmm_self_information(
                y[..., 1:2], params[..., 2 * M:4 * M],
                params[..., 4 * M:6 * M], params[..., 6 * M:8 * M], 2 * M,
                logistic=lg)
            si_c = gmm_self_information(
                y[..., 2:4], params[..., 8 * M:10 * M], mean_c,
                params[..., 12 * M:14 * M], M, logistic=lg)
            return torch.cat([si_y, si_c], -1)
        return gmm_self_information(y[..., 0:1], params[..., 0:M],
                                    params[..., M:2 * M],
                                    params[..., 2 * M:3 * M], M, logistic=lg)


def block_diagonal(conv: nn.Conv2d) -> torch.Tensor:
    """The kernel of a grouped ``conv`` as an ungrouped conv's ``[out, in,
    kh, kw]``: group g's kernel in output rows and input columns g, zeros
    elsewhere.  Each output sums the grouped conv's products and exact
    zero products; on the card cuDNN sums them in the grouped conv's
    order, so the map keeps its bits (``chip_smoke.py`` holds it against
    the benchmark's reference, whose layer 0 is the grouped conv)."""
    w, G = conv.weight, conv.groups
    o, i = w.shape[0] // G, w.shape[1]
    out = w.new_zeros((w.shape[0], i * G) + tuple(w.shape[2:]))
    for g in range(G):
        out[g * o:(g + 1) * o, g * i:(g + 1) * i] = w[g * o:(g + 1) * o]
    return out


def _unbiased(conv: nn.Conv2d, x: torch.Tensor):
    """-> (``conv(x)`` without its bias, the bias still to add, or None).
    On the card PyTorch runs a float32 conv through cuDNN, where cuDNN is
    on, and adds the bias after it, in a pass of its own, which the band
    epilogue does instead, with the same rounding.  Elsewhere the conv
    keeps its bias, as PyTorch takes it into the conv's own sums: in its
    depthwise kernel on the card (groups = input channels > 1), which
    starts each sum from the bias, in its GEMM conv where cuDNN is off,
    and in the CPU's convs.  That the maps keep their bits rests on this
    choice of PyTorch's backends; ``chip_smoke.py`` holds it, by the
    flagship's and a K = 8 batch container's sha256.  A conv the codec
    holds ungrouped (:meth:`Interpolator.hold`) runs so there."""
    if (conv.bias is None or x.device.type != "cuda"
            or x.dtype != torch.float32
            or not torch.backends.cudnn.enabled
            or 1 < conv.groups == conv.in_channels):
        return conv(x), None
    dense = getattr(conv, "held_dense", None)
    weight, groups = ((conv.weight, conv.groups) if dense is None
                      else (dense, 1))
    return F.conv2d(x, weight, None, conv.stride, conv.padding,
                    conv.dilation, groups), conv.bias


def _replicate(x: torch.Tensor, pad, m: int) -> torch.Tensor:
    """``F.pad(x, pad, mode="replicate")`` of an NCHW band; with ``m`` > 0,
    ``x`` carries ``m`` halo rows a side, which take the place of the row
    pads."""
    if not m:
        return F.pad(x, pad, mode="replicate")
    h = x.shape[2] - 2 * m
    return F.pad(x[:, :, m - pad[2]:m + h + pad[3]], pad[:2] + (0, 0),
                 mode="replicate")


def _box_mean(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Mean over every kh x kw window of an NCHW tensor (a fixed average
    pool, no padding): the window's values summed one by one in row-major
    order, as the JAX package's ``reduce_window`` sums them, then divided,
    so that the mean, which ``_quant`` rounds at its ties, equals the JAX
    package's bit for bit."""
    H, W = x.shape[2] - kh + 1, x.shape[3] - kw + 1
    s = None
    for i in range(kh):
        for j in range(kw):
            v = x[:, :, i:i + H, j:j + W]
            s = v if s is None else s + v
    return ieee_div(s, kh * kw)
