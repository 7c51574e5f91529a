"""Interleaved rANS coder: CUDA lane-scan kernels and their plain versions."""
