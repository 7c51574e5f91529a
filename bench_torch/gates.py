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
# The training gate, in two halves (bench_torch.train_cell.train_steps);
# each bound at least 3x the worst of 64 first steps on an NVIDIA H100
# (700 W; tools/train_gate_probe.py: 4 seeds x 8 pinned batches, NCHW and
# the model in channels-last).
# (i) The function: the first timed step's code path run again under
# exact_math() (TF32 off, float32) from the same state and batch, against
# the same step in float64 and a plain Adam on its gradients.  It catches
# the faults: a dropped or mis-scaled update, lost moments, a lost
# gradient.  Its gradients read <= 1.34e-4 from float64, its update
# <= 7.29e-4 from Adam's, its loss <= 9.7e-8.  chip_smoke.py's phase 11
# (a) holds its trained flagship (near a minimum, where a gradient is a
# small sum of large cancelling terms: 7.98e-4 on the card, 5.33e-4 in
# channels-last) to the same GRAD_L2_BOUND: it runs under exact_math() too.
LOSS_REL = 1e-4  # the loss, relative
GRAD_L2_BOUND = 3e-3  # each gradient, relative L2
UPDATE_L2_BOUND = 3e-3  # the update (worst parameter), relative L2
# (ii) The timed step itself (PyTorch's default flags: TF32 convs) against
# (i)'s step: that it is the same computation.  TF32 puts up to 6e-2 of
# noise into a small gradient (band 0's models.0.0.conv_00_11.bias, in
# channels-last; 1.1e-2 in NCHW), which passes into Adam's update (up to
# 2.72e-2) and its loss (2.27e-5), so these bounds cannot see a 1 %
# fault.  ADAM_L2_BOUND, the step's update against a plain Adam's on its
# own clipped gradients (only the parameters' float32 rounding, <= 3.02e-5),
# catches a 1.01 x lr there.
TIMED_LOSS_REL = 1e-4
TIMED_GRAD_L2_BOUND = 2e-1
TIMED_UPDATE_L2_BOUND = 1e-1
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


def step_matches(loss: float, grads: Dict[str, torch.Tensor],
                 loss_ref: float, grads_ref: Dict[str, torch.Tensor],
                 loss_bound: float, grad_bound: float, label: str,
                 ref: str) -> Tuple[float, float, str]:
    """A step's loss within ``loss_bound`` (relative) of the reference
    step's and every gradient within ``grad_bound`` relative L2 of its
    reference (``ref`` names it).  -> (the loss's relative distance, the
    largest gradient distance, its parameter)."""
    gate(np.isfinite(loss), f"{label}: the loss is {loss}")
    loss_rel = abs(loss - loss_ref) / abs(loss_ref)
    gate(loss_rel <= loss_bound, f"{label}: loss {loss!r} is {loss_rel:.3g} "
         f"from {ref}'s {loss_ref!r} (bound {loss_bound:g})")
    worst, worst_name = _worst_rel_l2(grads, grads_ref)
    gate(worst <= grad_bound, f"{label}: the gradient of {worst_name} is "
         f"{worst:.3g} (relative L2) from {ref}'s (bound {grad_bound:g})")
    return loss_rel, worst, worst_name
