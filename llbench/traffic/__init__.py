"""Traffic generators: one module for each kind of traffic, each with
``run(ctx) -> Outcome``.  A workload file names its generator and gives its
parameters; a new cell of an existing kind adds data files only."""
from __future__ import annotations

import torch


def port_config(config: dict):
    """The program's ModelConfig of a configuration file's model keys."""
    from llicti_torch.config import ModelConfig
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in config["model"].items()})


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def permutation(n: int, seed: int, salt: int) -> list:
    """A permutation of range(n) drawn from the run's seed."""
    g = torch.Generator()
    g.manual_seed((int(seed) * 1_000_003 + salt) % (1 << 63))
    return torch.randperm(n, generator=g).tolist()
