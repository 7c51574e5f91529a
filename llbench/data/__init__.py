"""The benchmark's inputs: images, training patches and weights made from
a seed, and a frozen copy of the trained flagship weights
(``bench_params.npz``, a copy of ``llicti_torch/weights/bench_params.npz``
at the commit that added this benchmark)."""
from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def synthetic_images(count: int, h: int, w: int, seed: int,
                     device) -> torch.Tensor:
    """``count`` uint8 [h, w, 3] RGB images on ``device``: smooth
    sinusoidal fields, a texture and Gaussian noise, each image with its
    own frequencies and phases.  The generator of the port's
    ``synthetic_image`` (``llicti_torch/data/dataset.py:67`` at the
    commit that added this benchmark), drawn in bulk from a
    ``torch.Generator`` on ``device``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    u = torch.rand((count, 7, 1, 1), generator=g, device=dev)
    f = 9 + 22 * u[:, 0:3]
    ph = 6.28 * u[:, 3:7]
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    base = (120 + 70 * torch.sin(yy / f[:, 0] + ph[:, 0])
            * torch.cos(xx / f[:, 1] + ph[:, 1])
            + 45 * torch.sin((xx + yy) / f[:, 2] + ph[:, 2]))
    tex = 10 * torch.sin(xx * 1.3 + ph[:, 3]) * torch.sin(yy * 1.7)
    img = torch.stack([base + tex, 0.85 * base + 25 + tex, 0.7 * base + 45],
                      dim=-1)
    img = img + 5 * torch.randn(img.shape, generator=g, device=dev)
    return img.clamp(0, 255).to(torch.uint8)


def training_batches(count: int, acc: int, batch: int, patch: int,
                     seed: int, device) -> torch.Tensor:
    """``count`` distinct training batches [acc, batch, patch, patch, 3],
    float32 in [0, 1] on ``device``: each patch a synthetic image of the
    patch's size (as the port's synthetic data set makes one), half of
    them flipped left to right, as the Trainer's loader crops."""
    n = count * acc * batch
    imgs = synthetic_images(n, patch, patch, seed, device)
    g = torch.Generator(device=imgs.device)
    g.manual_seed((int(seed) + 1) % (1 << 63))
    flip = torch.rand((n,), generator=g, device=imgs.device) < 0.5
    imgs = torch.where(flip[:, None, None, None], imgs.flip(2), imgs)
    return (imgs.float() / 255.0).reshape(count, acc, batch, patch, patch, 3)


def trained_weights(name: str) -> Dict[str, np.ndarray]:
    """{Flax name: float32 array} of a weights file in this folder."""
    with np.load(os.path.join(HERE, name), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def random_weights(leaves: Sequence[Tuple[str, Tuple[int, ...], int]],
                   seed: int, device) -> Dict[str, torch.Tensor]:
    """Fresh float32 weights {name: tensor} on ``device``, every leaf
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as the published model initialises
    its convs, drawn in one call."""
    dev = torch.device(device)
    counts = [int(np.prod(shape)) for _, shape, _ in leaves]
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    u = torch.rand((sum(counts),), generator=g, device=dev)
    scale = torch.repeat_interleave(
        torch.tensor([fan ** -0.5 for _, _, fan in leaves], device=dev),
        torch.tensor(counts, device=dev))
    flat = (2 * u - 1) * scale
    return {name: part.view(shape) for (name, shape, _), part
            in zip(leaves, flat.split(counts))}
