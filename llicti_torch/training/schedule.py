"""ReduceLROnPlateau scheduler (torch-semantics, checkpointable).

The port's own copy of ``llicti_tpu/training/schedule.py`` (pure Python):
the trainer sets the optimiser's learning rate from it.

Reference: torch.optim.lr_scheduler.ReduceLROnPlateau configured at
agents/llicti_agent.py:30-32 (factor=0.5, patience=16, cooldown=15,
min_lr=2.5e-5, threshold=1e-4 relative, mode=min).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass
class ReduceLROnPlateau:
    lr: float
    factor: float = 0.5
    patience: int = 16
    cooldown: int = 15
    min_lr: float = 2.5e-5
    threshold: float = 1e-4  # relative
    best: float = float("inf")
    num_bad: int = 0
    cooldown_counter: int = 0

    def step(self, metric: float) -> float:
        """Update with a new validation metric; returns the current lr."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return asdict(self)

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)
