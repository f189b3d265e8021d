"""Standard one-pass Lanczos: full basis stored, O(nk) memory.

Reference parity: ``lanczos_standard`` (``src/algorithms/lanczos.rs:55-156``).
Differences:

* The basis lives as the stacked scan output ``V`` of shape ``(k, n)`` —
  row-major over iterations, so the final reconstruction ``x = Vᵀ·y`` is a
  single (n×k)·(k,) GEMV, the analogue of the reference's one
  ``matmul`` with α-scaling (``src/solvers.rs:96-104``).
* Early termination (breakdown) pads trailing rows with zeros rather than
  reallocating; ``decomposition.steps_taken`` delimits the valid prefix.
* The per-iteration callback hook of the reference
  (``src/algorithms/mod.rs:69-86``, invoked at ``lanczos.rs:93-106``) is not
  compatible with a single compiled scan; equivalent observability is
  provided two ways: post-hoc by
  :func:`two_pass_lanczos_tpu.observability.replay_iterations` (replays
  (k, V_k, T_k) views from the scan outputs at zero extra compute), and
  in-run by the chunked drivers in
  :mod:`two_pass_lanczos_tpu.algorithms.chunked`, where a stop decision
  actually skips the remaining matvecs like the reference's early stop.
"""

from __future__ import annotations

from typing import Tuple

import jax

from two_pass_lanczos_tpu.algorithms.core import LanczosDecomposition, pass_one_scan
from two_pass_lanczos_tpu.operators import LinearOperator

__all__ = ["lanczos_standard"]


def lanczos_standard(
    operator: LinearOperator, b: jax.Array, k: int
) -> Tuple[LanczosDecomposition, jax.Array]:
    """Run k Lanczos steps storing the basis.

    Returns ``(decomposition, v_k)`` where ``v_k`` has shape ``(k, n)`` and
    row ``i`` is the basis vector v_{i+1} (zero rows beyond ``steps_taken``).
    Fully jittable; all shapes static.
    """
    decomp, basis = pass_one_scan(operator.matvec, b, k, emit_basis=True)
    return decomp, basis
