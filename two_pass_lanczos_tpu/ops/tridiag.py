"""Tridiagonal utilities for the projected system T_k.

The reference assembles T_k as a sparse matrix and applies either a sparse LU
(``f = inv``, reference ``src/bin/stability.rs:161-170``) or a self-adjoint
eigendecomposition (``f = exp``, ``src/bin/stability.rs:175-193``). Here T_k is
tiny (k ≤ ~1000) relative to the device, so we use dense, jittable kernels:

* :func:`assemble_tridiagonal` — dense symmetric tridiagonal from (α, β);
* :func:`tridiagonal_solve_e1` — pivoted dense solve of ``T_k y = e₁`` (the
  O(k³) cost is negligible at these sizes and, unlike the Thomas algorithm,
  is stable for the indefinite ill-conditioned spectra in the reference's
  stability experiments);
* :func:`eigh_tridiagonal` — symmetric eigendecomposition, the backbone for
  arbitrary matrix functions ``f(T_k) = Q f(Λ) Qᵀ``.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.lax import linalg as lax_linalg

__all__ = ["assemble_tridiagonal", "tridiagonal_solve_e1", "eigh_tridiagonal",
           "eigh_qr"]


def assemble_tridiagonal(alphas, betas):
    """Dense symmetric tridiagonal matrix from diagonal ``alphas`` (length k)
    and off-diagonal ``betas`` (length k-1).

    Reference parity: ``assemble_tridiagonal`` in ``tests/correctness.rs:55-76``
    and ``assemble_tridiagonal_sparse`` in ``src/bin/tradeoff.rs:97``.
    """
    alphas = jnp.asarray(alphas)
    betas = jnp.asarray(betas)
    k = alphas.shape[0]
    t = jnp.zeros((k, k), dtype=alphas.dtype)
    t = t + jnp.diag(alphas)
    if k > 1:
        t = t + jnp.diag(betas, 1) + jnp.diag(betas, -1)
    return t


def tridiagonal_solve_e1(alphas, betas):
    """Solve ``T_k y = e₁`` with a pivoted dense LU (``jnp.linalg.solve``)."""
    t = assemble_tridiagonal(alphas, betas)
    k = t.shape[0]
    e1 = jnp.zeros((k,), dtype=t.dtype).at[0].set(1.0)
    return jnp.linalg.solve(t, e1)


def eigh_tridiagonal(alphas, betas):
    """Eigendecomposition ``T_k = Q Λ Qᵀ`` of the symmetric tridiagonal system.

    Returns ``(eigenvalues, eigenvectors)`` like ``jnp.linalg.eigh``.
    """
    return eigh_qr(assemble_tridiagonal(alphas, betas))


def eigh_qr(t):
    """``(eigenvalues, eigenvectors)`` of a symmetric matrix by the QR
    algorithm (``syevd``), on every backend. For matrices up to 32×32 the
    GPU default is Jacobi, whose f32 ``exp(T)e₁`` read 1e-4 from the f64
    value on an H100 where the CPU's ``syevd`` read 6e-6 (k=30)."""
    vecs, vals = lax_linalg.eigh(t, implementation=lax_linalg.EighImplementation.QR)
    return vals, vecs
