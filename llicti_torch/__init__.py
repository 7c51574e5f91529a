"""LLICTI on PyTorch + CUDA: the lossless codec round trip on an NVIDIA H100.

A port of ``llicti_tpu`` (the JAX reference, which stays beside it).  The
model, the integer colour/wavelet stages and the container format are
PyTorch and numpy; the three hot loops of the codec are CUDA kernels
written by hand under ``csrc/`` (the CDF table and the rANS decode and
encode lane scans), each with a plain PyTorch version that runs on CPU
tensors.  This package imports no JAX.
"""
from llicti_tpu.config import ModelConfig
from llicti_tpu.data.dataset import synthetic_image

from .codec import Codec
from .weights import load_npz, params_from_flax

__all__ = ["Codec", "ModelConfig", "load_npz", "params_from_flax",
           "synthetic_image"]
