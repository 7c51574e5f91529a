"""The band epilogue: one pass that finishes an interpolator conv.

``csrc/band_epilogue.cu`` replaces no TPU kernel.  XLA fuses a conv's
bias add, the sum of layer 0's unit convs, the activation and the
parameter map's layout into the conv; PyTorch runs each as a pass of its
own over the whole map after cuDNN, to which it never gives the bias.
The kernel is bound by bytes and reads each map once: per element

    y = act(((x0 + b0) + (x1 + b1)) + (x2 + b2))

over 1-3 maps, each ``+`` its own float32 rounding in this order (the
order of PyTorch's passes, so the result is bit-equal to theirs), a map
without a bias taken as it is, ``act`` none or ReLU (``torch.clamp_min(y,
0)``, NaN kept).  :func:`band_epilogue` launches it on CUDA tensors;
:func:`band_epilogue_plain`, PyTorch's own passes (:func:`unfused_passes`),
runs on CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .. import _kernels


def unfused_passes(maps: Sequence[torch.Tensor],
                   biases: Sequence[Optional[torch.Tensor]],
                   relu: bool = False, layout: str = "k1") -> torch.Tensor:
    """The passes the band epilogue replaces, as the interpolator ran them
    before it: the bias add after each cuDNN conv (a map without a bias
    taken as it is), layer 0's sums, the clamp of ReLU, the last conv's
    NHWC copy.  ``layout``: "k1" (the maps summed as they are), or
    "channel_major" (K > 1: summed into a ``[C, N, h, w]`` buffer through
    transposed views), -> ``[N, C, h, w]``; or "nhwc", -> ``[N, h, w, C]``
    contiguous.  The reference the plain version and the kernel are held
    to, bit for bit."""
    outs = [x if b is None else x + b[:, None, None]
            for x, b in zip(maps, biases)]
    if layout == "channel_major":
        first = outs[0].transpose(0, 1)
        base = first.new_empty(first.shape)
        if len(outs) == 1 and relu:  # one clamp writes it channel-major
            return torch.clamp_min(first, 0, out=base).transpose(0, 1)
        if len(outs) == 1:
            base.copy_(first)
        else:
            torch.add(first, outs[1].transpose(0, 1), out=base)
        for o in outs[2:]:
            base.add_(o.transpose(0, 1))
        s = base.transpose(0, 1)
    else:
        s = outs[0]
        for o in outs[1:]:
            s = s + o
    if relu:
        s = torch.clamp_min(s, 0)
    return s.permute(0, 2, 3, 1).contiguous() if layout == "nhwc" else s


def band_epilogue_plain(maps: Sequence[torch.Tensor],
                        biases: Sequence[Optional[torch.Tensor]],
                        relu: bool = False,
                        out: Optional[torch.Tensor] = None,
                        nhwc: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`band_epilogue`: its passes
    (:func:`unfused_passes`), written to ``out``."""
    s = unfused_passes(maps, biases, relu, "nhwc" if nhwc else "k1")
    return s if out is None or nhwc else out.copy_(s)


def _pixels_contiguous(t: torch.Tensor) -> bool:
    """Whether each (image, channel) plane of ``[N, C, h, w]`` is one run
    of h * w values."""
    _, _, h, w = t.shape
    _, _, sh, sw = t.stride()
    if w == 1:
        return h == 1 or sh == 1
    return sw == 1 and (h == 1 or sh == w)


def _check(maps, biases, out, nhwc):
    if not 1 <= len(maps) <= 3 or len(biases) != len(maps):
        raise ValueError(f"1 to 3 maps, each with a bias or None; got "
                         f"{len(maps)} maps and {len(biases)} biases")
    x0 = maps[0]
    shape, dev, dt = x0.shape, x0.device, x0.dtype
    if len(shape) != 4:
        raise ValueError(f"maps are [N, C, h, w], got {tuple(shape)}")
    for x in maps:
        if x.shape != shape:
            raise ValueError(f"maps of shapes {tuple(shape)} and "
                             f"{tuple(x.shape)}")
    for b in biases:
        if b is not None and b.shape != shape[1:2]:
            raise ValueError(f"a bias of shape {tuple(b.shape)} for "
                             f"{shape[1]} channels")
    if out is not None:
        if nhwc:
            raise ValueError("the NHWC epilogue writes a new tensor")
        if out.shape != shape:
            raise ValueError(f"out {tuple(out.shape)} for maps "
                             f"{tuple(shape)}")
    for t in (*maps, *biases, out):
        if t is not None and (t.device != dev or t.dtype != dt):
            raise ValueError(f"a {t.dtype} tensor on {t.device} beside "
                             f"{dt} maps on {dev}")


_Strides = ctypes.c_longlong * 8


def band_epilogue(maps: Sequence[torch.Tensor],
                  biases: Sequence[Optional[torch.Tensor]],
                  relu: bool = False, out: Optional[torch.Tensor] = None,
                  nhwc: bool = False) -> torch.Tensor:
    """Each map plus its bias, summed in order, then ReLU with ``relu``.

    ``maps``: 1-3 tensors ``[N, C, h, w]`` of one shape, float32 on a
    card, each (image, channel) plane's pixels contiguous; ``biases``: one
    ``[C]`` tensor or None a map.  The result is written to ``out`` (an
    ``[N, C, h, w]`` view of the same form: NCHW, a channel-major ``[C,
    N, h, w]`` buffer transposed, or ``maps[0]`` itself), to a new NCHW
    tensor, or with ``nhwc`` to a new ``[N, h, w, C]`` contiguous tensor;
    it is returned.  CPU tensors take the plain version; CUDA tensors
    launch the kernel, and any other dtype or layout raises.  One map
    written onto itself with no bias and no ReLU is left as it is.
    """
    _check(maps, biases, out, nhwc)
    x0 = maps[0]
    if len(maps) == 1 and biases[0] is None and not relu and out is x0:
        return out
    if x0.device.type == "cpu":
        return band_epilogue_plain(maps, biases, relu, out, nhwc)
    if x0.dtype != torch.float32:
        raise ValueError(f"the band epilogue takes float32, not {x0.dtype}")
    N, C, h, w = x0.shape
    if nhwc:
        out = torch.empty((N, h, w, C), dtype=x0.dtype, device=x0.device)
    elif out is None:
        out = torch.empty_like(x0, memory_format=torch.contiguous_format)
    ptrs = [None] * 6  # the maps', then the biases'
    strides = _Strides()  # each map's image and channel strides, out's
    for u, (x, b) in enumerate(zip(maps, biases)):
        if not _pixels_contiguous(x):
            raise ValueError(f"a map of strides {x.stride()}: each plane's "
                             "pixels must be contiguous")
        if b is not None and not b.is_contiguous():
            raise ValueError("biases must be contiguous")
        ptrs[u] = x.data_ptr()
        ptrs[3 + u] = None if b is None else b.data_ptr()
        strides[2 * u], strides[2 * u + 1] = x.stride()[:2]
    if not nhwc:
        if not _pixels_contiguous(out):
            raise ValueError(f"out of strides {out.stride()}: each plane's "
                             "pixels must be contiguous")
        strides[6], strides[7] = out.stride()[:2]
    err = _kernels.lib().llicti_band_epilogue(
        *ptrs, out.data_ptr(), strides, len(maps), N, C, h * w, int(relu),
        int(nhwc), _kernels.stream_ptr(x0.device))
    _kernels.check(err, "llicti_band_epilogue")
    if x0.numel():
        band_epilogue.launches += 1
    return out


band_epilogue.launches = 0  # every launch of the band epilogue
