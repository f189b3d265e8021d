"""two_pass_lanczos_tpu — a sparse Krylov library for f(A)·b in JAX.

A from-scratch JAX/XLA library with the capabilities of the Rust
reference ``lukefleed/two-pass-lanczos``: computing the action of a matrix
function on a vector, x = f(A)·b, for large sparse Hermitian A via the
symmetric Lanczos process, in two variants with an explicit memory/compute
trade-off (reference ``src/lib.rs:11-22``):

* **one-pass** (``lanczos``): stores the Krylov basis, O(nk) memory, k matvecs;
* **two-pass** (``lanczos_two_pass``): O(n) memory, 2k matvecs — pass one keeps
  only the tridiagonal coefficients, pass two regenerates the basis on the fly.

Beyond the reference, the library is distributed by construction: operators
row-partition over a ``jax.sharding.Mesh`` and the same scan loops run under
``shard_map`` with ``psum``-fused reductions (see ``parallel/``).

Quick example (the analogue of the reference's crate doctest,
``src/lib.rs:35-84``)::

    import jax.numpy as jnp
    import two_pass_lanczos_tpu as tpl

    a = jnp.array([[2.0, 1, 0, 0], [1, 3, 1, 0], [0, 1, 4, 1], [0, 0, 1, 5]])
    b = jnp.array([1.0, 2.0, 3.0, 4.0])
    op = tpl.as_operator(a)
    solver = tpl.make_inv_solver()
    x1 = tpl.lanczos(op, b, 4, solver)          # one-pass
    x2 = tpl.lanczos_two_pass(op, b, 4, solver) # two-pass
    assert jnp.linalg.norm(x1 - x2) < 1e-12 * jnp.linalg.norm(x1)
"""

from two_pass_lanczos_tpu.utils.determinism import pin_fusion_emitters

pin_fusion_emitters()  # before any backend starts: see utils/determinism.py

from two_pass_lanczos_tpu.algorithms import (  # noqa: E402
    LanczosDecomposition,
    breakdown_tolerance,
    lanczos_pass_one,
    lanczos_pass_one_chunked,
    lanczos_pass_two,
    lanczos_pass_two_with_basis,
    lanczos_standard,
    lanczos_standard_chunked,
)
from two_pass_lanczos_tpu.errors import (
    BreakdownError,
    DimensionMismatchError,
    EvdError,
    InputError,
    LanczosError,
    ParameterMismatchError,
    SolverError,
)
from two_pass_lanczos_tpu.functions import (
    make_exp_solver,
    make_function_solver,
    make_inv_solver,
    make_poly_solver,
    padded_f_e1,
)
from two_pass_lanczos_tpu.operators import (
    CallableOperator,
    DenseOperator,
    DiagonalOperator,
    KKTOperator,
    LinearOperator,
    SparseOperator,
    as_operator,
    make_kkt_operator,
)
from two_pass_lanczos_tpu.algorithms.df import (
    DFDiagonalOperator,
    DFKKTOperator,
    lanczos_pass_one_df,
    solve_fAb_df,
)
from two_pass_lanczos_tpu.convergence import (
    convergence_history,
    make_convergence_callback,
    make_radau_error_callback,
    radau_error_bound,
    update_norm,
)
from two_pass_lanczos_tpu.spectrum import (
    a_norm_error_history,
    gauss_radau_bracket,
    quadratic_form,
    quadrature_bracket,
    ritz_pairs,
    ritz_residual_bounds,
    ritz_values,
)
from two_pass_lanczos_tpu.algorithms.block import (
    BlockDecomposition,
    block_padded_f_e1,
    block_pass_one,
    block_pass_two,
    solve_fAb_block,
    solve_fAb_block_jit,
)
from two_pass_lanczos_tpu.algorithms.chebyshev import (
    chebyshev_coefficients,
    chebyshev_fAb,
    estimate_interval,
)
from two_pass_lanczos_tpu.eigen import EigshResult, eigsh
from two_pass_lanczos_tpu.slq import (
    SLQResult,
    batched_quadratic_form,
    batched_ritz_weights,
    lanczos_pass_one_batched,
    slq_logdet,
    slq_spectral_density,
    slq_trace,
    slq_trace_adaptive,
)
from two_pass_lanczos_tpu.solvers import lanczos, lanczos_two_pass, solve_fAb

__version__ = "0.1.0"

__all__ = [
    # solvers (the reference's crate-root re-exports, src/lib.rs:101)
    "lanczos",
    "lanczos_two_pass",
    "solve_fAb",
    # algorithms
    "lanczos_standard",
    "lanczos_standard_chunked",
    "lanczos_pass_one",
    "lanczos_pass_one_chunked",
    "lanczos_pass_two",
    "lanczos_pass_two_with_basis",
    "LanczosDecomposition",
    "breakdown_tolerance",
    # operators
    "LinearOperator",
    "DenseOperator",
    "DiagonalOperator",
    "SparseOperator",
    "KKTOperator",
    "make_kkt_operator",
    "CallableOperator",
    "as_operator",
    # matrix functions
    "make_inv_solver",
    "make_exp_solver",
    "make_function_solver",
    "make_poly_solver",
    "padded_f_e1",
    # convergence estimation / ready-made stopping callbacks
    "update_norm",
    "convergence_history",
    "make_convergence_callback",
    "radau_error_bound",
    "make_radau_error_callback",
    # spectral analysis from the decomposition (beyond the reference)
    "ritz_values",
    "ritz_pairs",
    "ritz_residual_bounds",
    "quadratic_form",
    "gauss_radau_bracket",
    "quadrature_bracket",
    "a_norm_error_history",
    # thick-restart Lanczos eigensolver (beyond the reference)
    "eigsh",
    "EigshResult",
    # Chebyshev-expansion f(A)b: storage-free alternative (beyond the reference)
    "chebyshev_fAb",
    "chebyshev_coefficients",
    "estimate_interval",
    # block Lanczos: f(A)B on one shared block Krylov space (beyond the reference)
    "BlockDecomposition",
    "block_pass_one",
    "block_pass_two",
    "block_padded_f_e1",
    "solve_fAb_block",
    "solve_fAb_block_jit",
    # stochastic Lanczos quadrature: tr f(A) (beyond the reference)
    "SLQResult",
    "lanczos_pass_one_batched",
    "batched_quadratic_form",
    "batched_ritz_weights",
    "slq_trace",
    "slq_trace_adaptive",
    "slq_logdet",
    "slq_spectral_density",
    # compensated-precision (double-float) path
    "DFDiagonalOperator",
    "DFKKTOperator",
    "lanczos_pass_one_df",
    "solve_fAb_df",
    # errors
    "LanczosError",
    "BreakdownError",
    "DimensionMismatchError",
    "InputError",
    "ParameterMismatchError",
    "EvdError",
    "SolverError",
]
