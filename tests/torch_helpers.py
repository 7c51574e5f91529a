"""Shared set-up of the port's CPU tests: every ``tests/test_torch_*.py``
imports this module first.

Under pytest-xdist each worker is a process of its own, and torch's
default of one intra-op thread a core makes the workers' OpenMP teams
fight over the cores (their threads spin at each parallel region's
barrier): a port test that takes ~5 s alone took minutes in a run of six
workers.  So a worker caps torch's intra-op threads at its share of the
cores.  Run alone (no xdist), a test keeps torch's default.  Subprocesses
a test starts get the same cap through ``OMP_NUM_THREADS`` (``env``).

It also builds the JAX references that several files compare against
(the tiny configuration's weights and codecs), once a worker: a file
that xdist sends to a worker where another has built them reuses them.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch


def worker_threads() -> int:
    """torch's intra-op threads for this process: the cores over the
    xdist workers, at least 1; torch's current count outside xdist."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers < 2:
        return torch.get_num_threads()
    return max(1, (os.cpu_count() or 1) // workers)


def env(**extra) -> dict:
    """os.environ for a subprocess of a test, its threads capped alike."""
    return dict(os.environ, OMP_NUM_THREADS=str(worker_threads()), **extra)


torch.set_num_threads(worker_threads())


# ---- JAX references shared by several files --------------------------------

# the tiny two-scale configuration the port's container tests code
TINY = dict(chs=(8, 8), evens=(4, 4), odds=(3, 3), dwtlevels=(0, 1),
            useprevlevNN=(False, True))


@functools.lru_cache(maxsize=None)
def tiny_jax_params():
    """JAX's init of TINY at PRNGKey(0), once a worker: (the JAX params,
    the same as numpy arrays)."""
    import jax
    import jax.numpy as jnp
    from llicti_tpu.config import ModelConfig
    from llicti_tpu.models.llicti import LLICTIModel
    params = LLICTIModel(cfg=ModelConfig(**TINY)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    return params, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def tiny_jax_codec():
    """JAX's ``Codec(use_pallas_cdf=True)`` of tiny_jax_params() at 32
    lanes, once a worker, so every test that codes through it reuses its
    compiled passes."""
    from llicti_tpu.codec import Codec
    from llicti_tpu.config import ModelConfig
    return Codec(ModelConfig(**TINY), tiny_jax_params()[0], num_lanes=32,
                 use_pallas_cdf=True)
