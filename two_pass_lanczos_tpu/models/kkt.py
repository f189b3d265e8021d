"""KKT system construction: files → operators.

The reference assembles an explicit sparse ``A = [[D, Eᵀ], [E, 0]]``
(``src/utils/data_loader.rs:211-258``). Here the structure stays implicit:
:class:`~two_pass_lanczos_tpu.operators.KKTOperator` applies A from the
diagonal of D and the arc endpoint arrays directly (2 gathers + 2
fixed-order row reductions per matvec). An explicit :class:`SortedCOO` form is also
provided for the generic-SpMV path and for dense cross-checks in tests.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from two_pass_lanczos_tpu.operators import KKTOperator, make_kkt_operator
from two_pass_lanczos_tpu.ops.spmv import SortedCOO, csr_from_triplets
from two_pass_lanczos_tpu.utils.data_loader import KKTArrays, load_kkt_arrays

__all__ = ["KKTSystem", "kkt_operator_from_files", "kkt_operator_from_arrays", "kkt_sorted_coo"]


class KKTSystem(NamedTuple):
    """A loaded KKT problem (reference ``KKTSystem``, ``data_loader.rs:51-58``)."""

    operator: KKTOperator
    num_nodes: int
    num_arcs: int

    @property
    def n(self) -> int:
        return self.num_arcs + self.num_nodes


def kkt_operator_from_arrays(arrays: KKTArrays, dtype=jnp.float64) -> KKTSystem:
    # single construction path: delegate to the operator factory so fixes
    # there (validation, index dtypes) propagate to file-loaded systems
    return KKTSystem(
        operator=make_kkt_operator(
            arrays.quad_costs, arrays.arc_u, arrays.arc_v, arrays.num_nodes,
            dtype=dtype,
        ),
        num_nodes=arrays.num_nodes,
        num_arcs=arrays.num_arcs,
    )


def kkt_operator_from_files(dmx_path, qfc_path, dtype=jnp.float64) -> KKTSystem:
    """Load a (``.dmx``, ``.qfc``) pair into a matrix-free KKT operator."""
    return kkt_operator_from_arrays(load_kkt_arrays(dmx_path, qfc_path), dtype=dtype)


def kkt_sorted_coo(arrays: KKTArrays, dtype=np.float64) -> SortedCOO:
    """Explicit sparse assembly of ``A = [[D, Eᵀ], [E, 0]]`` (generic path).

    Triplet layout mirrors the reference assembly
    (``src/utils/data_loader.rs:222-249``): D at (j, j); E entries shifted to
    rows ``num_arcs + node``; Eᵀ mirrored. Duplicate (u == v self-loop arcs)
    collapse by summation, identical to faer's triplet semantics.
    """
    m = arrays.num_arcs
    p = arrays.num_nodes
    n = m + p
    j = np.arange(m, dtype=np.int64)
    rows = np.concatenate(
        [j, arrays.arc_u.astype(np.int64) + m, arrays.arc_v.astype(np.int64) + m, j, j]
    )
    cols = np.concatenate(
        [j, j, j, arrays.arc_u.astype(np.int64) + m, arrays.arc_v.astype(np.int64) + m]
    )
    ones = np.ones(m, dtype=dtype)
    vals = np.concatenate([arrays.quad_costs.astype(dtype), ones, -ones, ones, -ones])
    return csr_from_triplets(n, n, rows, cols, vals, dtype=dtype)
