"""High-level f(A)·b solvers — the primary user API.

Reference parity: ``solvers::lanczos`` and ``solvers::lanczos_two_pass``
(``src/solvers.rs:46,133``), re-exported at the package root like the
reference's crate root (``src/lib.rs:101``).

Two API flavors:

* :func:`lanczos` / :func:`lanczos_two_pass` — host-orchestrated, exact
  reference semantics: a user ``f_tk_solver(alphas, betas) -> y'`` closure is
  called with the *valid* coefficient prefix (dynamic length), its result is
  dimension-validated, and errors map onto the reference taxonomy. The heavy
  passes are individually jit-compiled; only the tiny (α, β) arrays cross the
  host boundary between them.
* :func:`solve_fAb` — a single fully-jittable pipeline for the built-in
  matrix functions, with fixed shapes end-to-end (breakdown handled by
  block-diagonal padding). This is the production fast path and the form
  that distributes over a device mesh unchanged.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from two_pass_lanczos_tpu.algorithms.core import (
    LanczosDecomposition,
    pass_one_scan,
    zero_tolerance,
)
from two_pass_lanczos_tpu.algorithms.two_pass import (
    lanczos_pass_two,
    lanczos_pass_two_with_basis,
)
from two_pass_lanczos_tpu.errors import (
    BreakdownError,
    DimensionMismatchError,
    InputError,
    ParameterMismatchError,
    SolverError,
)
from two_pass_lanczos_tpu.functions import padded_f_e1
from two_pass_lanczos_tpu.operators import LinearOperator

__all__ = ["lanczos", "lanczos_two_pass", "solve_fAb"]


def _validate_inputs(operator: LinearOperator, b, k: int):
    n = operator.shape[0]
    if operator.shape[0] != operator.shape[1]:
        raise DimensionMismatchError(operator.shape[0], operator.shape[1], "operator")
    if b.shape != (n,):
        raise DimensionMismatchError(n, b.shape[0] if b.ndim else 0, "vector b")
    if k < 1:
        raise InputError(f"k must be >= 1, got {k}")


@partial(jax.jit, static_argnums=(2, 3))
def _pass_one_jit(matvec_op, b, k: int, emit_basis: bool):
    return pass_one_scan(matvec_op.matvec, b, k, emit_basis=emit_basis)


@partial(jax.jit, static_argnums=(2, 3, 4))
def _pass_one_reorth_jit(matvec_op, b, k: int, sweeps: int, mode: str):
    from two_pass_lanczos_tpu.algorithms.reorth import (
        pass_one_scan_reorth,
        pass_one_scan_selective,
    )

    if mode == "selective":
        decomp, basis, _ = pass_one_scan_selective(
            matvec_op.matvec, b, k, sweeps=sweeps)
        return decomp, basis
    return pass_one_scan_reorth(matvec_op.matvec, b, k, sweeps=sweeps)


def reorth_mode(reorth):
    """Normalize the ``reorth`` argument: False/None → None, True → "full",
    or one of {"full", "selective"}."""
    if reorth is False or reorth is None:
        return None
    if reorth is True:
        return "full"
    if reorth in ("full", "selective"):
        return reorth
    raise ValueError(
        f"reorth must be a bool, 'full' or 'selective', got {reorth!r}")


def _run_f_solver(f_tk_solver, decomp: LanczosDecomposition):
    """Call the user closure(s) on the valid (α, β) prefix and validate.

    ``f_tk_solver`` may be a single closure (returns a ``(steps,)`` vector)
    or a sequence of closures — several matrix functions evaluated from the
    same decomposition (returns a stacked ``(nf, steps)`` array; the solvers
    then share the expensive basis work across all of them)."""
    steps = decomp.steps()
    alphas = decomp.alphas_valid()
    betas = decomp.betas_valid()
    multi = isinstance(f_tk_solver, (list, tuple))
    solvers = list(f_tk_solver) if multi else [f_tk_solver]
    ys = []
    for solver in solvers:
        try:
            y = solver(alphas, betas)
        except Exception as e:  # noqa: BLE001 — reference wraps any solver error
            raise SolverError(str(e)) from e
        y = np.asarray(y).reshape(-1)
        if y.shape[0] != steps:
            raise ParameterMismatchError("y_k_prime", steps, y.shape[0])
        ys.append(y)
    return np.stack(ys) if multi else ys[0]


def _check_zero_b(decomp: LanczosDecomposition, b):
    if float(decomp.b_norm) <= zero_tolerance(b.dtype):
        raise InputError("Input vector `b` must not be a zero vector.")


def _check_strict_breakdown(decomp: LanczosDecomposition, k: int, strict: bool):
    """Opt-in fatal-breakdown mode: raise if the subspace became invariant
    before k steps. Reference parity: ``LanczosErrorKind::Breakdown { k }``
    (``src/error.rs:26``) — the reference defines the kind; this is the API
    that actually raises it. A callback-requested early stop is NOT a
    breakdown (its residual β stays positive; true breakdown records
    β == 0 at the final step)."""
    if strict and decomp.steps() < k and decomp.beta_last() == 0.0:
        raise BreakdownError(decomp.steps())


def lanczos(
    operator: LinearOperator,
    b,
    k: int,
    f_tk_solver: Callable,
    *,
    callback: Callable = None,
    callback_chunk: int = 16,
    strict_breakdown: bool = False,
    reorth: bool = False,
    reorth_sweeps: int = 2,
) -> jax.Array:
    """One-pass f(A)·b: run ``lanczos_standard``, solve the projected problem,
    reconstruct ``x_k = V_k · y'_k · ‖b‖`` with a single GEMV.

    Reference parity: ``solvers::lanczos`` (``src/solvers.rs:46-105``).
    ``f_tk_solver`` may also be a sequence of closures — several matrix
    functions from the same basis (k matvecs total, result ``(nf, n)``).

    ``callback(steps, V_view, (alphas, betas)) -> bool`` enables the
    reference's per-iteration hook with true in-run early stopping (the
    remaining matvecs are skipped — see ``algorithms/chunked.py``);
    ``callback_chunk`` sets the compiled block size between host checks.
    ``strict_breakdown=True`` raises :class:`BreakdownError` instead of
    truncating gracefully when the Krylov subspace becomes invariant
    before ``k`` steps.

    ``reorth=True`` / ``"full"`` (beyond the reference) fully
    reorthogonalizes each new vector against the stored basis
    (``reorth_sweeps`` CGS sweeps, default 2 = CGS2) — the fix for the
    large-k forward instability the plain recurrence is documented to
    suffer on indefinite spectra, at O(k²n) extra matmul work
    (``algorithms/reorth.py``). ``reorth="selective"`` monitors the Simon
    ω-recurrence and sweeps only when semi-orthogonality (√ε) is about to
    be lost — plain-recurrence cost on benign spectra (a never-triggered
    run is bit-identical to ``reorth=False``), a small fraction of the
    full-reorth sweeps on hard ones. One-pass only: the basis these need
    is the one this variant already stores.
    """
    b = jnp.asarray(b)
    _validate_inputs(operator, b, k)
    mode = reorth_mode(reorth)
    if mode is not None:
        if callback is not None:
            raise InputError(
                "reorth= is not supported together with callback= (the "
                "chunked early-stop driver runs the plain recurrence); use "
                "a plain run to locate the stopping step, or reorth without "
                "a callback.")
        decomp, v_k = _pass_one_reorth_jit(operator, b, k, reorth_sweeps,
                                           mode)
    elif callback is not None:
        from two_pass_lanczos_tpu.algorithms.chunked import lanczos_standard_chunked

        decomp, v_k = lanczos_standard_chunked(
            operator, b, k, callback, chunk=callback_chunk
        )
    else:
        decomp, v_k = _pass_one_jit(operator, b, k, True)
    _check_zero_b(decomp, b)
    _check_strict_breakdown(decomp, k, strict_breakdown)
    steps = decomp.steps()
    if steps == 0:  # defensive; unreachable after _check_zero_b
        return jnp.zeros_like(b)  # reference parity: solvers.rs:64-66
    y = _run_f_solver(f_tk_solver, decomp)
    # Pad y to the static length k; rows of v_k beyond `steps` are zero.
    y_full = np.zeros(y.shape[:-1] + (k,), dtype=y.dtype)
    y_full[..., :steps] = y
    y_dev = jnp.asarray(y_full).astype(b.dtype) * decomp.b_norm.astype(b.dtype)
    return _gemv_reconstruct(v_k, y_dev)


@jax.jit
def _gemv_reconstruct(v_k, y):
    # x = V_kᵀ · y  with V stored (k, n): one GEMV (or GEMM for a
    # (nf, k) multi-function y stack — nf solutions from one basis).
    # HIGHEST: a GPU runs a DEFAULT f32 product in TF32, which would inject
    # ~1e-3 relative error into x at the very last step; the contraction
    # is one matvec-equivalent of work, so full precision costs nothing.
    return jnp.einsum("kn,...k->...n", v_k, y,
                      precision=jax.lax.Precision.HIGHEST)


def lanczos_two_pass(
    operator: LinearOperator,
    b,
    k: int,
    f_tk_solver: Callable,
    *,
    return_basis: bool = False,
    callback: Callable = None,
    callback_chunk: int = 16,
    strict_breakdown: bool = False,
):
    """Two-pass f(A)·b with O(n) memory.

    Reference parity: ``solvers::lanczos_two_pass`` (``src/solvers.rs:133-175``):
    pass one → user ``f_tk_solver`` → scale by ‖b‖ → reconstruction pass.
    ``f_tk_solver`` may be a sequence of closures: several matrix functions
    evaluated from one decomposition — the reconstruction pass fans the
    per-step accumulate out over all of them, so nf functions cost 2k
    matvecs instead of 2k·nf (result stacked ``(nf, n)``, each slice
    bit-identical to its single-function run).
    ``return_basis=True`` exposes the regenerated basis for the
    orthogonality/reconstruction-stability studies (reference
    ``lanczos_pass_two_with_basis``). ``callback`` enables live in-run early
    stopping of pass one (scalars-only view — pass one stores no basis);
    a stop at step s also shortens pass two to s steps.
    ``strict_breakdown=True`` raises :class:`BreakdownError` on invariant
    subspaces instead of truncating.
    """
    b = jnp.asarray(b)
    _validate_inputs(operator, b, k)
    if callback is not None:
        from two_pass_lanczos_tpu.algorithms.chunked import lanczos_pass_one_chunked

        decomp = lanczos_pass_one_chunked(
            operator, b, k, callback, chunk=callback_chunk
        )
    else:
        decomp, _ = _pass_one_jit(operator, b, k, False)
    _check_zero_b(decomp, b)
    _check_strict_breakdown(decomp, k, strict_breakdown)
    steps = decomp.steps()
    if steps == 0:
        z = jnp.zeros_like(b)
        return (z, jnp.zeros((0, b.shape[0]), b.dtype)) if return_basis else z
    y = _run_f_solver(f_tk_solver, decomp)
    # Truncate pass two to the executed prefix: the masked scan would
    # otherwise still run k matvecs on frozen state after an early stop or
    # breakdown. The reference's pass two runs exactly steps-1 matvecs
    # (``src/algorithms/lanczos_two_pass.rs:266``).
    if steps < k:
        decomp = LanczosDecomposition(
            alphas=decomp.alphas[:steps],
            betas=decomp.betas[:steps],
            steps_taken=decomp.steps_taken,
            b_norm=decomp.b_norm,
        )
    k_eff = decomp.k_max
    y_full = np.zeros(y.shape[:-1] + (k_eff,), dtype=y.dtype)
    y_full[..., :steps] = y
    y_dev = jnp.asarray(y_full).astype(b.dtype) * decomp.b_norm.astype(b.dtype)
    if return_basis:
        x, basis = _pass_two_basis_jit(operator, b, decomp, y_dev)
        if k_eff < k:  # restore the static (k, n) shape contract
            basis = jnp.pad(basis, ((0, k - k_eff), (0, 0)))
        return x, basis
    return _pass_two_jit(operator, b, decomp, y_dev)


@jax.jit
def _pass_two_jit(operator, b, decomp, y):
    return lanczos_pass_two(operator, b, decomp, y)


@jax.jit
def _pass_two_basis_jit(operator, b, decomp, y):
    return lanczos_pass_two_with_basis(operator, b, decomp, y)


# ---------------------------------------------------------------------------
# Fully-jittable fast path
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("k", "f", "method", "reorth"))
def solve_fAb(
    operator: LinearOperator,
    b: jax.Array,
    *,
    k: int,
    f="exp",
    method: str = "two_pass",
    reorth: bool = False,
) -> jax.Array:
    """Single-jit f(A)·b for built-in matrix functions.

    ``f`` ∈ {"exp", "inv"} or any scalar jnp-callable applied to the
    spectrum — or a TUPLE of those, evaluating several matrix functions
    from one decomposition: the Krylov work (all the matvecs) is paid once
    and the result is stacked ``(nf, n)``. ``method`` ∈ {"one_pass",
    "two_pass"}. Fixed shapes throughout; breakdown and zero-b degrade
    gracefully (zero output), making this safe inside larger jitted
    programs and over sharded meshes.

    ``reorth=True``/``"full"`` (one-pass only, beyond the reference) runs
    the fully reorthogonalized recurrence of ``algorithms/reorth.py`` —
    accurate at large k on the spectra where the plain recurrence's
    orthogonality collapses, for O(k²n) extra matmul work;
    ``reorth="selective"`` sweeps only when the ω-recurrence predicts
    semi-orthogonality loss (plain cost on benign spectra).
    """
    multi = isinstance(f, tuple)
    mode = reorth_mode(reorth)
    if mode is not None and method != "one_pass":
        raise ValueError(
            "reorth= requires method='one_pass' (reorthogonalization "
            "needs the stored basis; two-pass exists precisely to avoid "
            "storing it)")
    if method == "one_pass":
        if mode == "selective":
            from two_pass_lanczos_tpu.algorithms.reorth import (
                pass_one_scan_selective,
            )

            decomp, v_k, _ = pass_one_scan_selective(operator.matvec, b, k)
        elif mode == "full":
            from two_pass_lanczos_tpu.algorithms.reorth import pass_one_scan_reorth

            decomp, v_k = pass_one_scan_reorth(operator.matvec, b, k)
        else:
            decomp, v_k = pass_one_scan(operator.matvec, b, k, emit_basis=True)
    elif method == "two_pass":
        decomp, _ = pass_one_scan(operator.matvec, b, k, emit_basis=False)
    else:
        raise ValueError(f"unknown method {method!r}")
    fs = f if multi else (f,)
    y = jnp.stack([padded_f_e1(decomp, fi) for fi in fs])
    if not multi:
        y = y[0]
    y = (y * decomp.b_norm).astype(b.dtype)
    if method == "one_pass":
        # HIGHEST — same rationale as _gemv_reconstruct
        return jnp.einsum("kn,...k->...n", v_k, y,
                          precision=jax.lax.Precision.HIGHEST)
    return lanczos_pass_two(operator, b, decomp, y)
