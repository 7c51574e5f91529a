"""The benchmark of the PyTorch + CUDA port (``llicti_torch``) on one card.

Run it as ``python3 -m bench_torch [--cell NAME ...] [--seed S]
[--trace]`` from the repository's root, on a CUDA card (it raises without
one).  Two cells (``metrics.CELLS``): ``flagship_codec_512x768``, the
codec as its users run it, and ``paper_a_train_step``, one optimiser step
as a trainer runs it.  Each prints its end-to-end metrics by name and
unit, with sample counts, after its correctness gates; ``--trace`` runs
the cells' traced windows instead and prints the per-layer metrics.
``work`` holds the hand kernels' work counts and bounds, which
``chip_smoke.py`` imports too.  Imports torch, numpy and
``llicti_torch``; no JAX and nothing of ``llicti_tpu``.
"""
