"""The benchmark of ``llicti_torch``, the PyTorch and CUDA port of LLICTI.

``python3 -m llbench --workload CELL --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once (:mod:`llbench.run`).  The
benchmark takes from the program only the system under test; its
inputs, work counts, reference and comparison live here.  It imports
neither JAX nor the JAX package.
"""
