"""LLICTI on PyTorch + CUDA: the lossless codec, its rate estimate and its
training on an NVIDIA H100.

A port of ``llicti_tpu`` (the JAX reference, which stays beside it).  The
model and its rate forward, the colour/wavelet stages and the container
format are PyTorch and numpy; the three hot loops of the device backend
are CUDA kernels written by hand under ``csrc/`` (the CDF table and the
rANS decode and encode lane scans), each with a plain PyTorch version that
runs on CPU tensors; the host backend's range coder is C++
(``csrc/rangecoder.cpp``, built with g++).  Training
(``llicti_torch.training``) is plain PyTorch and launches none of the
kernels.  This package imports no JAX and nothing of ``llicti_tpu``: it
keeps its own copies of the configuration and the data pipeline.
``Codec`` and ``Trainer`` run on the CUDA card unless they are given
``device="cpu"``.
"""
from .codec import Codec
from .config import ModelConfig
from .data import synthetic_image
from .weights import load_npz, params_from_flax

__all__ = ["Codec", "ModelConfig", "load_npz", "params_from_flax",
           "synthetic_image"]
