"""The window's milliseconds over the data-parallel optimiser steps it
completed, every rank taking each step (rank 0's clock): read as
``train_step_ms`` is."""
from llbench.end_to_end.train_step_ms import read  # noqa: F401
