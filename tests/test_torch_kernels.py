"""The kernel build's bookkeeping, on the CPU: ptxas's -v report parsed
into one row per kernel (the numbers chip_smoke.py prints and checks)."""
import torch_helpers  # noqa: F401  (first: caps torch's threads)
from llicti_torch import _kernels

REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN6llicti15cdf_pmap_kernelILb0ELi8EEEvNS_8PmapArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN6llicti15cdf_pmap_kernelILb0ELi8EEEvNS_8PmapArgsE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers, 8 bytes cumulative stack size
ptxas info    : Function properties for __internal_helper
    24 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z18rans_encode_kernelPKiS0_PxPiS2_ii' for 'sm_90a'
ptxas info    : Function properties for _Z18rans_encode_kernelPKiS0_PxPiS2_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers
"""


def test_ptxas_table_rows():
    rows = _kernels.ptxas_table(REPORT)
    assert [(r["registers"], r["stack"], r["spill_stores"],
             r["spill_loads"]) for r in rows] == [(48, 8, 4, 4),
                                                  (30, 0, 0, 0)]
    # demangled where c++filt exists, the mangled name otherwise
    assert "cdf_pmap_kernel" in rows[0]["kernel"]
    assert "rans_encode_kernel" in rows[1]["kernel"]


def test_ptxas_table_ignores_non_entry_functions():
    rows = _kernels.ptxas_table(REPORT.split("ptxas info    : Compiling "
                                             "entry function '_Z18")[0])
    assert len(rows) == 1 and rows[0]["stack"] == 8
