"""Built-in ``f(T_k) e₁`` solvers for the projected tridiagonal problem.

The reference keeps ``f`` pluggable as a closure over ``(alphas, betas)``
returning ``f(T_k)·e₁`` (``src/solvers.rs:40-43``) and ships concrete solvers
in the experiment binaries: ``inv`` via sparse LU (``src/bin/stability.rs:161-170``)
and ``exp`` via self-adjoint EVD (``:175-193``). We provide the same closures
plus a generic scalar-function route, in two flavors:

* **host closures** (:func:`make_inv_solver` etc.) — exact reference
  semantics: called with the *valid* (α, β) prefix, return a length-``steps``
  vector; usable with any user code, not necessarily jittable.
* **padded jittable solvers** (:func:`padded_f_e1`) — operate on the full
  fixed-shape ``(k,)`` decomposition arrays with masking, so the entire
  f(A)·b pipeline can live inside a single ``jax.jit``. Padding the diagonal
  with 1.0 beyond ``steps_taken`` makes T block-diagonal ``[T_s, I]``, hence
  ``f(T_pad)·e₁ = [f(T_s)·e₁ ; 0]`` *exactly* — breakdown costs no accuracy.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from two_pass_lanczos_tpu.algorithms.core import LanczosDecomposition
from two_pass_lanczos_tpu.ops.tridiag import assemble_tridiagonal, eigh_qr

__all__ = [
    "host_f_tk_solve",
    "make_inv_solver",
    "make_exp_solver",
    "make_function_solver",
    "make_poly_solver",
    "padded_f_e1",
    "FUNC_EXP",
    "FUNC_INV",
]


# ---------------------------------------------------------------------------
# Host-closure flavor (exact reference-shaped API)
# ---------------------------------------------------------------------------

def host_f_tk_solve(alphas, betas, f) -> np.ndarray:
    """NumPy f64 ``y' = f(T_k)·e1`` on the host (the tiny projected solve
    shared by the double-float paths): ``f`` is "inv" (LU solve), "exp",
    or any callable applied to the spectrum."""
    alphas = np.asarray(alphas, np.float64)
    betas = np.asarray(betas, np.float64)
    steps = len(alphas)
    t = np.diag(alphas)
    if steps > 1:
        t += np.diag(betas, 1) + np.diag(betas, -1)
    e1 = np.zeros(steps)
    e1[0] = 1.0
    if f == "inv":
        return np.linalg.solve(t, e1)
    if f == "exp":
        fn = np.exp
    elif callable(f):
        fn = f
    else:
        raise ValueError(f"unknown matrix function {f!r}")
    lam, q = np.linalg.eigh(t)
    return q @ (fn(lam) * q[0, :])



def make_inv_solver() -> Callable:
    """``f(z) = 1/z``: solve ``T_k y = e₁`` with a pivoted dense LU.

    The reference uses faer's sparse LU (``src/bin/stability.rs:161-170``);
    at k ≤ ~1000 a pivoted dense solve is equally stable and trivially
    jittable, including for the indefinite ill-conditioned spectra.
    """

    from two_pass_lanczos_tpu.ops.tridiag import tridiagonal_solve_e1

    def solver(alphas, betas):
        return tridiagonal_solve_e1(jnp.asarray(alphas), jnp.asarray(betas))

    return solver


def make_exp_solver() -> Callable:
    """``f(z) = exp(z)`` via self-adjoint EVD: ``Q·exp(Λ)·Qᵀ·e₁``.

    Reference parity: ``exp_tk_solver`` (``src/bin/stability.rs:175-193``).
    """
    return make_function_solver(jnp.exp)


def make_function_solver(f: Callable) -> Callable:
    """Generic ``f(T_k)e₁`` for any scalar function ``f`` applied to the
    spectrum, via the symmetric eigendecomposition of T_k."""

    from two_pass_lanczos_tpu.ops.tridiag import eigh_tridiagonal

    def solver(alphas, betas):
        lam, q = eigh_tridiagonal(jnp.asarray(alphas), jnp.asarray(betas))
        # f(T) e1 = Q f(Λ) Qᵀ e1 — only the first row of Q is needed.
        # HIGHEST: a GPU runs a DEFAULT-precision f32 product in TF32.
        return jnp.matmul(q, f(lam) * q[0, :],
                          precision=jax.lax.Precision.HIGHEST)

    return solver


def make_poly_solver(coeffs) -> Callable:
    """``f(z) = Σ c_i z^i`` (ascending coefficients), exact when
    ``k > deg f`` — the sharp correctness oracle used by the reference's
    ``z²`` integration test (``tests/correctness.rs:42-51``)."""
    coeffs = list(coeffs)

    def f(lam):
        acc = jnp.zeros_like(lam)
        for c in reversed(coeffs):
            acc = acc * lam + c
        return acc

    return make_function_solver(f)


# ---------------------------------------------------------------------------
# Padded jittable flavor (fixed shapes, usable inside jit/scan/shard_map)
# ---------------------------------------------------------------------------

FUNC_EXP = "exp"
FUNC_INV = "inv"


def _padded_tridiagonal(decomp: LanczosDecomposition):
    """Assemble the k×k padded T: identity beyond ``steps_taken``.

    diag[i]    = alphas[i]  if i < steps else 1.0
    offdiag[i] = betas[i]   if i < steps-1 else 0.0   (drops the residual β_k)
    """
    k = decomp.k_max
    rdt = decomp.alphas.dtype
    i = jnp.arange(k)
    diag = jnp.where(i < decomp.steps_taken, decomp.alphas, jnp.ones((), rdt))
    j = jnp.arange(k - 1) if k > 1 else jnp.arange(0)
    off = jnp.where(j < decomp.steps_taken - 1, decomp.betas[: k - 1], jnp.zeros((), rdt))
    return assemble_tridiagonal(diag, off)


def padded_f_e1(decomp: LanczosDecomposition, f) -> jax.Array:
    """Fully-jittable ``y' = f(T_k)·e₁`` on the padded decomposition.

    ``f`` is either a scalar callable applied to the spectrum (EVD route) or
    the string ``"inv"`` (pivoted dense solve route). Returns shape ``(k,)``
    with exact zeros beyond ``steps_taken`` (block-diagonal padding).
    """
    t = _padded_tridiagonal(decomp)
    k = t.shape[0]
    e1 = jnp.zeros((k,), t.dtype).at[0].set(1.0)
    if f == FUNC_INV:
        y = jnp.linalg.solve(t, e1)
    else:
        fn = jnp.exp if f == FUNC_EXP else f
        lam, q = eigh_qr(t)
        # HIGHEST: a GPU runs a DEFAULT-precision f32 product in TF32.
        y = jnp.matmul(q, fn(lam) * q[0, :],
                       precision=jax.lax.Precision.HIGHEST)
    # Explicitly mask the padding block (guards against eigensolver noise in
    # degenerate spectra).
    return jnp.where(jnp.arange(k) < decomp.steps_taken, y, jnp.zeros((), y.dtype))
