"""Thick-restart Lanczos eigensolver: extreme eigenpairs in bounded memory.

The reference library stops at f(A)·b; the other thing every Lanczos user
asks of the same machinery is extreme eigenpairs (`scipy.sparse.linalg
.eigsh`-class capability). This module provides it with the
thick-restart method (Wu & Simon, "Thick-restart Lanczos method for large
symmetric eigenvalue problems", SIAM J. Matrix Anal. 2000), formulated the
way that maps best onto the hardware:

* the expansion phase keeps the **full basis resident** and orthogonalizes
  every new vector against all of it with CGS2 — two (ncv+1, n) GEMV
  sweeps per step, matmul work, no modified-Gram-Schmidt serialization
  (the same design as :mod:`algorithms.reorth`);
* the projected matrix H is maintained **dense** (ncv is small); its
  eigendecomposition runs on-device inside the same jit;
* one restart cycle = ONE jitted launch (`lax.fori_loop` over the
  expansion with a dynamic start index, so the first cycle and every
  restart share a single compilation);
* the restart contraction ``V_new = S_keepᵀ·V`` is one (ℓ, ncv)×(ncv, n)
  matmul.

Residual bounds come for free from the Arnoldi relation
``A·V_k = V_k·H + β·v_{k+1}·e_kᵀ``: ‖A·u_i − θ_i·u_i‖ = β·|S_{k,i}| —
the same identity :func:`spectrum.ritz_residual_bounds` exposes for the
plain decomposition.

Happy breakdown (invariant subspace) is handled the standard way: the
exhausted direction is replaced by a random vector orthogonalized against
the basis, so the method keeps hunting for further eigenpairs instead of
stalling — a single-vector Krylov space alone can never leave an
invariant subspace. (Eigenvalue *multiplicities* still surface only
through these injections; for reliably resolving high-multiplicity
clusters use a block method.)

Works with any pytree :class:`LinearOperator`, in f32 or f64.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from two_pass_lanczos_tpu.algorithms.core import (
    _real_dtype,
    breakdown_tolerance,
    f32_matmul_precision,
    l2_norm,
)
from two_pass_lanczos_tpu.operators import LinearOperator

__all__ = ["EigshResult", "eigsh"]

_WHICH = ("LA", "SA", "LM", "SM")


class EigshResult(NamedTuple):
    """Converged (or best-effort) extreme eigenpairs.

    * ``eigenvalues`` — shape ``(nev,)``, ascending.
    * ``eigenvectors`` — shape ``(nev, n)``, **rows** are unit Ritz vectors
      matching ``eigenvalues`` (the library's basis-rows convention).
    * ``residual_norms`` — rigorous ‖A·u_i − θ_i·u_i‖₂ per pair.
    * ``restarts`` — number of restart cycles executed.
    * ``converged`` — True iff every returned pair met the tolerance.
    """

    eigenvalues: np.ndarray
    eigenvectors: np.ndarray
    residual_norms: np.ndarray
    restarts: int
    converged: bool


def _expand_and_ritz(matvec, v_basis, h_proj, start, key, *,
                     reduce_sum=None, inject_mask=None, inject_fold=None):
    """One restart cycle: grow the basis from ``start`` to ``ncv`` columns
    (CGS2 full orthogonalization), then Rayleigh–Ritz on the projected H.

    ``v_basis`` is (ncv+1, n) with rows [0, start] valid (row ``start`` is
    the next unit vector to expand with); ``h_proj`` is (ncv, ncv) with the
    leading (start, start) block valid. Returns the grown state plus the
    on-device eigendecomposition and residual bounds.

    Distribution hooks (the library's standard shard_map pattern, cf.
    ``algorithms/core.py``): under ``shard_map`` the basis is column-
    (n-)sharded, ``reduce_sum`` psums the (ncv+1,) projection partials and
    the norms, ``inject_mask`` confines random injections to the valid
    (non-padded) rows, and ``inject_fold`` decorrelates the per-device
    noise streams (e.g. fold in ``lax.axis_index``).
    """
    ncv = h_proj.shape[0]
    rdt = v_basis.dtype
    # norms/couplings/tolerances live in the REAL dtype (β is a norm);
    # keeping them real also keeps residual_norms real for complex A
    real = _real_dtype(rdt)
    brk = jnp.asarray(breakdown_tolerance(rdt), real)

    def project(v, w, mask):
        # ⟨v_i, w⟩ = Σ conj(v_i)·w — adjoint projection; conj folds away
        # on real dtypes, leaving the original real FP sequence.
        c = jnp.conj(v) @ w
        if reduce_sum is not None:
            c = reduce_sum(c)
        return c * mask

    def body(j, carry):
        v, h, key_j, _ = carry
        w = matvec(v[j])
        mask = (jnp.arange(ncv + 1) <= j).astype(rdt)
        # CGS2: two masked sweeps against the whole resident basis.
        c1 = project(v, w, mask)
        w = w - v.T @ c1
        c2 = project(v, w, mask)
        w = w - v.T @ c2
        h_col = (c1 + c2)[:ncv]
        h = h.at[:, j].set(h_col)
        # keep H Hermitian (j-th row = conj of j-th col; = for real)
        h = h.at[j, :].set(jnp.conj(h_col))

        beta = l2_norm(w, reduce_sum)

        def continue_direction(op_):
            w_, key_in = op_
            return w_ / beta.astype(rdt), key_in

        def random_restart_direction(op_):
            # invariant subspace: inject a fresh random direction, CGS2 it
            # against the basis (Wu–Simon §4.2 practice)
            _, key_in = op_
            key_out, sub = jax.random.split(key_in)
            if inject_fold is not None:
                sub = inject_fold(sub)
            r = jax.random.normal(sub, w.shape, rdt)
            if inject_mask is not None:
                r = r * inject_mask
            r = r - v.T @ project(v, r, mask)
            r = r - v.T @ project(v, r, mask)
            nrm = l2_norm(r, reduce_sum)
            safe = jnp.where(nrm > brk, nrm, jnp.ones((), rdt))
            return r / safe.astype(rdt), key_out

        v_next, key_j = jax.lax.cond(
            beta > brk, continue_direction, random_restart_direction, (w, key_j)
        )
        v = v.at[j + 1].set(v_next)
        # the sub-diagonal coupling: zero if we had to inject randomness
        # (the invariant block decouples exactly)
        coupled = jnp.where(beta > brk, beta, jnp.zeros((), real))
        h = jnp.where(j + 1 < ncv, h.at[j + 1, j].set(coupled)
                      .at[j, j + 1].set(coupled), h)
        return v, h, key_j, coupled

    v_basis, h_proj, _, beta_last = jax.lax.fori_loop(
        start, ncv, body, (v_basis, h_proj, key, jnp.zeros((), real))
    )
    # beta_last = the j = ncv-1 coupling: ‖remainder‖ of the final column,
    # i.e. A·V[:ncv] = V[:ncv]·H + β_last·v_ncv·e_lastᵀ
    theta, s_vecs = jnp.linalg.eigh(h_proj)
    resid = beta_last * jnp.abs(s_vecs[ncv - 1, :])
    return v_basis, h_proj, theta, s_vecs, resid, beta_last


@jax.jit
@f32_matmul_precision
def _cycle(operator, v_basis, h_proj, start, key):
    return _expand_and_ritz(operator.matvec, v_basis, h_proj, start, key)


@jax.jit
@f32_matmul_precision
def _thick_restart(v_basis, theta, s_vecs, keep_idx):
    """Contract the basis to the kept Ritz vectors + the residual direction.

    Returns (V', H') with V'[:ℓ] = S_keepᵀ·V[:ncv] (one matmul),
    V'[ℓ] = v_{ncv+1}, H' = diag(θ_keep) in the leading block. The
    couplings H'[i, ℓ] are NOT written — the next expansion's full
    orthogonalization recomputes them exactly as ⟨u_i, A·v_ℓ⟩.
    """
    ncv = v_basis.shape[0] - 1
    ell = keep_idx.shape[0]
    u = s_vecs[:, keep_idx].T @ v_basis[:ncv]  # (ell, n)
    v_new = jnp.zeros_like(v_basis)
    v_new = v_new.at[:ell].set(u)
    v_new = v_new.at[ell].set(v_basis[ncv])
    h_new = jnp.zeros((ncv, ncv), v_basis.dtype)
    h_new = h_new.at[jnp.arange(ell), jnp.arange(ell)].set(theta[keep_idx])
    return v_new, h_new


@jax.jit
@f32_matmul_precision
def _ritz_vectors(v_basis, s_vecs, sel_idx):
    ncv = v_basis.shape[0] - 1
    return s_vecs[:, sel_idx].T @ v_basis[:ncv]


def _select(theta: np.ndarray, count: int, which: str) -> np.ndarray:
    """Indices (into ascending θ) of the ``count`` wanted Ritz values,
    returned in ascending-θ order."""
    if which == "LA":
        idx = np.arange(theta.size - count, theta.size)
    elif which == "SA":
        idx = np.arange(count)
    elif which == "LM":
        idx = np.sort(np.argsort(np.abs(theta))[-count:])
    else:  # SM
        idx = np.sort(np.argsort(np.abs(theta))[:count])
    return idx


def eigsh(
    operator: LinearOperator,
    nev: int = 6,
    *,
    which: str = "LA",
    ncv: Optional[int] = None,
    tol: float = 1e-8,
    maxiter: int = 100,
    v0: Optional[jax.Array] = None,
    key: Optional[jax.Array] = None,
) -> EigshResult:
    """Compute ``nev`` extreme eigenpairs of a self-adjoint operator
    (real symmetric or complex Hermitian — the spectrum is real either
    way) by thick-restart Lanczos in O(ncv·n) memory.

    ``which`` ∈ {"LA", "SA", "LM", "SM"} (largest/smallest algebraic,
    largest/smallest magnitude; "SM" converges slowly without inversion —
    the classical Krylov caveat). ``ncv`` is the restart basis size
    (default ``min(n, max(2·nev + 1, 20))``); each cycle costs
    ``ncv − ℓ`` matvecs plus CGS2 GEMV sweeps. Convergence: every wanted
    pair's rigorous residual ``‖A·u − θ·u‖ ≤ tol·max(|θ|_max, 1)``.

    ``v0`` seeds the Krylov space (default: random from ``key``); ``key``
    also drives the random injections that let the method continue past an
    invariant subspace (default ``jax.random.key(0)`` — the solve is
    deterministic for fixed inputs).
    """
    n = operator.shape[0]
    ncv = validate_eigsh_params(n, nev, ncv, which, maxiter)
    # thickness: the standard Wu–Simon midpoint between nev and ncv
    ell = eigsh_thickness(nev, ncv)
    rdt = operator.dtype
    if key is None:
        key = jax.random.key(0)
    key, sub = jax.random.split(key)
    if v0 is None:
        v0 = jax.random.normal(sub, (n,), rdt)
    v0 = jnp.asarray(v0, rdt)
    nrm = float(l2_norm(v0))
    if nrm == 0.0:
        raise ValueError("v0 must be nonzero")

    v_basis = jnp.zeros((ncv + 1, n), rdt).at[0].set(v0 / nrm)
    h_proj = jnp.zeros((ncv, ncv), rdt)
    start = jnp.zeros((), jnp.int32)

    cycle = lambda v, h, s, k: _cycle(operator, v, h, s, k)
    theta, vectors_d, resid, restarts, converged = _eigsh_driver(
        cycle, _thick_restart, _ritz_vectors, v_basis, h_proj,
        nev=nev, ell=ell, which=which, tol=tol, maxiter=maxiter, key=key)
    return EigshResult(
        eigenvalues=theta,
        eigenvectors=np.asarray(vectors_d),
        residual_norms=resid,
        restarts=restarts,
        converged=converged,
    )


def _eigsh_driver(cycle, restart, ritzvec, v_basis, h_proj, *,
                  nev, ell, which, tol, maxiter, key):
    """The restart loop shared by the single-device and sharded drivers.

    ``cycle``/``restart``/``ritzvec`` are the compiled stage callables (the
    sharded variant passes shard_map-ped ones); everything host-side here
    is O(ncv) bookkeeping. Returns ``(theta[want], vectors_device,
    resid[want], restarts, converged)`` — vectors stay a device array so
    the caller controls layout restoration.
    """
    start = jnp.zeros((), jnp.int32)
    restarts = 0
    converged = False
    for it in range(maxiter):
        key, sub = jax.random.split(key)
        v_basis, h_proj, theta_d, s_d, resid_d, _ = cycle(
            v_basis, h_proj, start, sub)
        restarts = it + 1
        theta = np.asarray(theta_d)
        resid = np.asarray(resid_d)
        scale = max(float(np.max(np.abs(theta))), 1.0)
        want = _select(theta, nev, which)
        if np.all(resid[want] <= tol * scale):
            converged = True
            break
        if it < maxiter - 1:
            # want ⊆ keep by construction: both select extremes of the same
            # ordering and ell >= nev
            keep = _select(theta, ell, which)
            v_basis, h_proj = restart(
                v_basis, theta_d, s_d, jnp.asarray(keep, jnp.int32))
            start = jnp.asarray(ell, jnp.int32)

    vectors = ritzvec(v_basis, s_d, jnp.asarray(want, jnp.int32))
    return theta[want], vectors, resid[want], restarts, converged


def default_ncv(n: int, nev: int) -> int:
    """The default restart basis size (shared with the sharded driver)."""
    return min(n, max(2 * nev + 1, 20))


def eigsh_thickness(nev: int, ncv: int) -> int:
    """The Wu–Simon restart thickness ℓ (shared with the sharded driver)."""
    return min(nev + (ncv - nev) // 2, ncv - 1)


def validate_eigsh_params(n: int, nev: int, ncv: Optional[int],
                          which: str, maxiter: int) -> int:
    """Shared parameter validation; returns the resolved ``ncv``."""
    if which not in _WHICH:
        raise ValueError(f"which must be one of {_WHICH}, got {which!r}")
    if nev < 1:
        raise ValueError("nev must be >= 1")
    if maxiter < 1:
        raise ValueError("maxiter must be >= 1")
    if nev > n:
        raise ValueError(f"nev={nev} exceeds the operator dimension {n}")
    if ncv is None:
        ncv = default_ncv(n, nev)
    if ncv > n:
        raise ValueError(f"ncv={ncv} exceeds the operator dimension {n}")
    if ncv < nev + 1:
        raise ValueError(f"need ncv >= nev + 1 (got ncv={ncv}, nev={nev})")
    return ncv
