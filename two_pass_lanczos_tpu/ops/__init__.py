"""Compute kernels: deterministic SpMV and tridiagonal utilities."""

from two_pass_lanczos_tpu.ops.spmv import (
    RowSums,
    build_row_sums,
    coo_spmv,
    csr_from_triplets,
    incidence_sums,
    kkt_matvec,
    row_sums,
    SortedCOO,
)
from two_pass_lanczos_tpu.ops.tridiag import (
    assemble_tridiagonal,
    eigh_tridiagonal,
    tridiagonal_solve_e1,
)

__all__ = [
    "RowSums",
    "build_row_sums",
    "coo_spmv",
    "csr_from_triplets",
    "incidence_sums",
    "kkt_matvec",
    "row_sums",
    "SortedCOO",
    "assemble_tridiagonal",
    "eigh_tridiagonal",
    "tridiagonal_solve_e1",
]
