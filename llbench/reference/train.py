"""The reference training step: the rate of each microbatch, its
gradients summed and divided by the microbatches, clipped element-wise,
then Adam (Kingma & Ba, Algorithm 1; eps after the bias-corrected root),
all in float32 with TF32 off.  ``precision="bf16"`` runs the model under
bfloat16 autocast instead: the control of the comparison.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import torch

from .codec import float32_math
from .model import Config, build, rate

BETAS = (0.9, 0.999)
EPS = 1e-8


def run_steps(cfg: Config, state: Dict[str, torch.Tensor],
              batches: Sequence[torch.Tensor], lr: float, clip: float,
              device, precision: str = "float32", share: float = 1.0) -> Dict:
    """Steps from ``state`` on each of ``batches`` [acc, B, H, W, 3] in
    turn.  -> {"losses": each step's mean rate, "grads": the first step's
    clipped gradients by name, "delta": each parameter's change over all
    the steps}.  ``share`` < 1 scales each microbatch's rate, as when
    ``batches`` are one rank's ``share`` of a global batch whose rate is
    taken over the global subpixels and never summed over the ranks."""
    if precision not in ("float32", "bf16"):
        raise ValueError(f"precision={precision!r}")
    model = build(cfg, state, device).train()
    params = dict(model.named_parameters())
    first = {n: p.detach().clone() for n, p in params.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    dev = torch.device(device)
    cast = (torch.autocast(dev.type, dtype=torch.bfloat16)
            if precision == "bf16" else contextlib.nullcontext())
    losses, grads1 = [], None
    b1, b2 = BETAS
    with float32_math():
        for t, batch in enumerate(batches, 1):
            model.zero_grad(set_to_none=True)
            total = 0.0
            for xb in batch:
                with cast:
                    loss = share * rate(xb, model(xb))
                loss.float().backward()
                total += float(loss.detach())
            losses.append(total / batch.shape[0])
            with torch.no_grad():
                g = {n: (p.grad / batch.shape[0]).clamp(-clip, clip)
                     for n, p in params.items()}
                if grads1 is None:
                    grads1 = {n: x.clone() for n, x in g.items()}
                for n, p in params.items():
                    m[n].mul_(b1).add_(g[n], alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g[n], g[n], value=1 - b2)
                    mhat = m[n] / (1 - b1 ** t)
                    vhat = v[n] / (1 - b2 ** t)
                    p.sub_(lr * mhat / (vhat.sqrt() + EPS))
    delta = {n: (p.detach() - first[n]) for n, p in params.items()}
    return {"losses": losses, "grads": grads1, "delta": delta}
