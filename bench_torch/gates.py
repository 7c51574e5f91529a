"""The benchmark's correctness gates.  A failed gate raises
:class:`GateFailed` naming what failed; the command does not catch it."""
from __future__ import annotations

import copy
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from llicti_torch.training.loss import rate_loss_list

# the coder closure: stream bits against the ideal bits of the coder's own
# tables, the JAX bench's rule (bench.py's coder closure gate)
CLOSURE = 0.01
# a training step's loss against the same step in float64
LOSS_REL = 1e-4
# a float32 gradient's relative L2 distance from the float64 one: the
# trained weights sit near a minimum, where a gradient is a small sum of
# large cancelling terms; on an NVIDIA H100 (700 W) the band-2 gradients
# came 7.98e-4 from float64 (the CPU's 1.28e-4); a wrong one is O(1).
# It stays at 1e-2: tools/grad_drift_probe.py found the drift already in
# the gradient reaching the pmap (1.67e-4 against the CPU's 3.36e-5),
# ahead of any conv backward (band 2's layer-0 wgrad alone, cuDNN's
# wgrad_alg1_engine and implicit-GEMM kernels: 6.9e-7), and no
# deterministic setting brought it within 2x the CPU's (cuDNN off
# 1.17e-3, channels-last 5.33e-4)
GRAD_L2_BOUND = 1e-2
# the step's parameter change (relative L2, the worst parameter) against
# a plain Adam's update from the optimiser's state before the step: on the
# float64 gradients, where TF32's gradient noise passes into the update
# (on an NVIDIA H100 (700 W) 2.0e-3-8.1e-3 over 16 first steps, <= 1.5e-4
# under exact_math), and on the step's own clipped gradients, where only
# the parameters' float32 rounding remains.  A dropped update is 1 from
# either, one mis-scaled by s |s - 1|.
UPDATE_L2_BOUND = 3e-2
ADAM_L2_BOUND = 1e-3


class GateFailed(AssertionError):
    """A benchmark output is wrong."""


def gate(cond: bool, msg: str) -> None:
    if not cond:
        raise GateFailed(msg)


def lossless(img: np.ndarray, out: np.ndarray, label: str) -> None:
    """The decoded image ``out`` ([H, W, 3], or [1, H, W, 3] as
    ``decompress`` gives it) byte-equal to ``img``."""
    out = np.asarray(out)
    if out.ndim == 4 and out.shape[0] == 1:
        out = out[0]
    gate(out.shape == img.shape and out.dtype == img.dtype
         and np.array_equal(out, img),
         f"{label}: the decoded image differs from its input "
         f"({out.dtype} {out.shape} against {img.dtype} {img.shape})")


def coder_closure(slice_bits: Sequence[Sequence[int]],
                  ideal_bits: Sequence[Sequence[float]], label: str) -> float:
    """(stream bits - ideal bits) / ideal bits of one encode's tables
    (``Codec.last_slice_bits`` / ``last_ideal_bits``), within
    +-``CLOSURE``."""
    act = sum(sum(row) for row in slice_bits)
    ideal = sum(sum(row) for row in ideal_bits)
    gap = (act - ideal) / max(ideal, 1.0)
    gate(abs(gap) <= CLOSURE, f"{label}: coder closure {100 * gap:+.3f} % "
         f"(stream {act} bits, ideal {ideal:.1f}) is outside +-"
         f"{100 * CLOSURE:g} %")
    return gap


def float64_step(model: torch.nn.Module, batch: torch.Tensor,
                 clip_value: float) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The loss and the clipped gradients that ``make_train_step`` takes on
    ``batch`` [acc, B, H, W, 3], computed in float64 on the model's device
    from a copy of ``model``.  The bands come from the float32 model, so
    that the function is the float32 step's (YCoCg-R's rounding ties fall
    differently in float64)."""
    m64 = copy.deepcopy(model).double()
    m64.zero_grad(set_to_none=True)
    total = 0.0
    for xb in batch:
        with torch.no_grad():
            bands = [y.double() for y in model.transform(xb)]
        loss, _ = rate_loss_list(xb.numel(), m64.entropy_forward(bands))
        loss.backward()
        total += float(loss.detach())
    acc = batch.shape[0]
    grads = {n: (p.grad / acc).clamp(-clip_value, clip_value)
             for n, p in m64.named_parameters()}
    return total / acc, grads


def adam_snapshot(model: torch.nn.Module, opt: torch.optim.Adam) -> Dict:
    """A float64 copy of ``opt``'s state for each of ``model``'s parameters
    by name (step count, first and second moments; zeros before the first
    step), with its learning rate, betas and eps."""
    group = opt.param_groups[0]
    state = {}
    for name, p in model.named_parameters():
        s = opt.state.get(p, {})
        if s:
            state[name] = (float(s["step"]), s["exp_avg"].double().clone(),
                           s["exp_avg_sq"].double().clone())
        else:
            zero = torch.zeros_like(p, dtype=torch.float64)
            state[name] = (0.0, zero, zero)
    return {"lr": float(group["lr"]), "betas": tuple(group["betas"]),
            "eps": float(group["eps"]), "state": state}


def adam_update(snapshot: Dict, grads: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """Each parameter's change in one Adam step (Kingma & Ba, Algorithm 1;
    optax's and torch's eps after the bias-corrected root) on ``grads``
    from the optimiser state ``snapshot`` (:func:`adam_snapshot`)."""
    lr, eps = snapshot["lr"], snapshot["eps"]
    b1, b2 = snapshot["betas"]
    out = {}
    for name, g in grads.items():
        t, m, v = snapshot["state"][name]
        t += 1
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        out[name] = -lr * (m / (1 - b1 ** t)) / (
            (v / (1 - b2 ** t)).sqrt() + eps)
    return out


def _worst_rel_l2(got: Dict[str, torch.Tensor],
                  want: Dict[str, torch.Tensor]) -> Tuple[float, str]:
    """The largest relative L2 distance of ``got[name]`` from
    ``want[name]`` over the names (the absolute norm where ``want`` is
    zero), and its name."""
    worst, worst_name = 0.0, ""
    for name, w in want.items():
        g = got[name].double()
        rel = float((g - w).norm() / w.norm()) if w.norm() > 0 \
            else float(g.norm())
        if rel >= worst:
            worst, worst_name = rel, name
    return worst, worst_name


def update_matches(before: Dict[str, torch.Tensor],
                   after: Dict[str, torch.Tensor],
                   update: Dict[str, torch.Tensor], bound: float,
                   label: str) -> Tuple[float, str]:
    """Every parameter's change ``after - before`` within ``bound``
    relative L2 of the reference ``update`` (:func:`adam_update`).  ->
    (the largest distance, its parameter)."""
    change = {n: after[n].double() - before[n].double() for n in update}
    worst, name = _worst_rel_l2(change, update)
    gate(worst <= bound, f"{label}: the update of {name} is {worst:.3g} "
         f"(relative L2) from Adam's (bound {bound:g})")
    return worst, name


def step_matches_float64(loss: float, grads: Dict[str, torch.Tensor],
                         loss64: float, grads64: Dict[str, torch.Tensor],
                         label: str) -> Tuple[float, float, str]:
    """A float32 step's loss within ``LOSS_REL`` of the float64 one and
    every gradient within ``GRAD_L2_BOUND`` relative L2 of its float64
    one.  -> (the loss's relative distance, the largest gradient distance,
    its parameter)."""
    gate(np.isfinite(loss), f"{label}: the loss is {loss}")
    loss_rel = abs(loss - loss64) / abs(loss64)
    gate(loss_rel <= LOSS_REL, f"{label}: loss {loss!r} is {loss_rel:.3g} "
         f"from the float64 step's {loss64!r} (bound {LOSS_REL:g})")
    worst, worst_name = _worst_rel_l2(grads, grads64)
    gate(worst <= GRAD_L2_BOUND, f"{label}: the gradient of {worst_name} is "
         f"{worst:.3g} (relative L2) from the float64 one (bound "
         f"{GRAD_L2_BOUND:g})")
    return loss_rel, worst, worst_name
