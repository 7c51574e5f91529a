"""Entropy coders: the interleaved rANS coder (CUDA lane-scan kernels and
their plain versions) and the host range coder of the host backend."""
