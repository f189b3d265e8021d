"""Spectral analysis from a Lanczos decomposition (beyond the reference).

The reference computes and stores (α, β) (``LanczosDecomposition``,
``src/algorithms/mod.rs:94-108``) but uses them only to evaluate f(T_k)e₁.
The same data answers the questions any Krylov-method user asks next, at
zero extra matvec cost — this module provides them host-side (NumPy/SciPy
f64; these are analysis utilities, not the device hot path):

* **Ritz values / pairs** — eigenvalues of T_s, the Rayleigh–Ritz
  approximations to A's spectrum (extreme eigenvalues converge first).
* **Ritz residual bounds** — the classical exact-arithmetic identity
  ‖A·u_j − θ_j·u_j‖₂ = β_s·|S_{s,j}| : a rigorous a-posteriori residual for
  every Ritz pair from the LAST ROW of T_s's eigenvectors alone (no basis,
  no matvec). In finite precision it holds to O(ε‖A‖) for the plain
  recurrence and to working precision under ``reorth=True``.
* **Lanczos quadrature** — ‖b‖²·e₁ᵀf(T_s)e₁, the s-point Gauss estimate of
  the quadratic form bᵀf(A)b (Golub–Meurant "Matrices, Moments and
  Quadrature" framework).
* **Gauss–Radau brackets** for bᵀA⁻¹b on SPD A: the plain Gauss rule is a
  LOWER bound (even derivatives of 1/x are positive on (0, ∞)); fixing a
  Radau node ζ ≤ λ_min yields an UPPER bound. Together: a computable
  enclosure that tightens with k.

All functions accept the decomposition from ANY pass-one implementation in
this package (XLA scan, chunked, sharded, df — they share the
pytree contract) and operate on the valid ``steps_taken`` prefix.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np

from two_pass_lanczos_tpu.algorithms.core import LanczosDecomposition

# scipy is an optional (test/plots) dependency; import lazily so the core
# package stays importable from a base install (pyproject deps: jax, numpy)


def _eigh_tridiagonal(*args, **kwargs):
    from scipy.linalg import eigh_tridiagonal

    return eigh_tridiagonal(*args, **kwargs)

__all__ = [
    "tridiagonal_valid",
    "ritz_values",
    "ritz_pairs",
    "ritz_residual_bounds",
    "quadratic_form",
    "gauss_radau_bracket",
    "quadrature_bracket",
    "a_norm_error_history",
]

FSpec = Union[str, Callable[[np.ndarray], np.ndarray]]


def _is_df(decomp) -> bool:
    # DFDecomposition (algorithms/df.py): coefficients are (hi, lo) pairs
    return hasattr(decomp, "alphas_f64")


def _fold_df_scalar(x, i=None) -> float:
    hi = np.asarray(x.hi, np.float64)
    lo = np.asarray(x.lo, np.float64)
    v = hi + lo
    return float(v if i is None else v[i])


def _beta_last(decomp) -> float:
    if _is_df(decomp):
        s = decomp.steps()
        return _fold_df_scalar(decomp.betas, s - 1) if s else 0.0
    return decomp.beta_last()


def _b_norm(decomp) -> float:
    if _is_df(decomp):
        return _fold_df_scalar(decomp.b_norm)
    return float(decomp.b_norm)


def tridiagonal_valid(decomp: LanczosDecomposition) -> Tuple[np.ndarray, np.ndarray]:
    """The valid (diagonal, off-diagonal) of T_s as host f64 arrays.

    Shapes ``(s,)`` and ``(s-1,)`` with ``s = steps_taken`` — the
    reference's unpadded storage convention (``src/algorithms/mod.rs:98``).
    Accepts the double-float path's decomposition too (hi+lo folded to
    f64, preserving its beyond-f32 accuracy).
    """
    if _is_df(decomp):
        return decomp.alphas_f64(), decomp.betas_f64()
    d = decomp.alphas_valid().astype(np.float64)
    e = decomp.betas_valid().astype(np.float64)
    return d, e


def _eig_ts(decomp, vectors: bool):
    d, e = tridiagonal_valid(decomp)
    if d.size == 0:
        empty = np.zeros(0)
        return (empty, np.zeros((0, 0))) if vectors else empty
    if d.size == 1:
        return (d.copy(), np.ones((1, 1))) if vectors else d.copy()
    if vectors:
        return _eigh_tridiagonal(d, e)
    return _eigh_tridiagonal(d, e, eigvals_only=True)


def ritz_values(decomp: LanczosDecomposition) -> np.ndarray:
    """Eigenvalues of T_s, ascending — the Ritz approximations to A's
    spectrum from the Krylov subspace. Empty for a zero-b run."""
    return _eig_ts(decomp, vectors=False)


def ritz_pairs(decomp: LanczosDecomposition) -> Tuple[np.ndarray, np.ndarray]:
    """``(theta, S)``: Ritz values (ascending) and T_s's orthonormal
    eigenvectors, columns ``S[:, j]``. The Ritz vector in R^n is
    ``u_j = Σ_i S[i, j]·v_{i+1}`` (contract with the one-pass basis)."""
    return _eig_ts(decomp, vectors=True)


def ritz_residual_bounds(decomp: LanczosDecomposition) -> np.ndarray:
    """Per-Ritz-pair residual ‖A·u_j − θ_j·u_j‖₂ = β_s·|S_{s,j}|.

    Exact-arithmetic identity from the Lanczos relation
    A·V_s = V_s·T_s + β_s·v_{s+1}·e_sᵀ; costs O(s²) host flops and needs
    neither the basis nor a matvec. After breakdown β_s = 0: every
    computed Ritz pair is exact (the subspace is invariant) and the
    bounds are identically zero.
    """
    theta, s_vecs = ritz_pairs(decomp)
    if theta.size == 0:
        return theta
    return _beta_last(decomp) * np.abs(s_vecs[-1, :])


def _f_of_theta(theta: np.ndarray, f: FSpec) -> np.ndarray:
    # same string set as slq._f_of_theta / chebyshev._f_host (host analogue)
    if f == "inv":
        return 1.0 / theta
    if f == "exp":
        return np.exp(theta)
    if f == "log":
        return np.log(theta)
    if callable(f):
        return np.asarray(f(theta), np.float64)
    raise ValueError(f"unknown function spec {f!r}")


def quadratic_form(decomp: LanczosDecomposition, f: FSpec = "inv") -> float:
    """The s-point Lanczos (Gauss) quadrature estimate of bᵀf(A)b:
    ‖b‖²·e₁ᵀf(T_s)e₁ = ‖b‖²·Σ_j f(θ_j)·S_{1,j}².

    Exact once the Krylov subspace is invariant (breakdown) or s reaches
    the number of distinct eigenvalues active in b. 0.0 for zero b.
    """
    theta, s_vecs = ritz_pairs(decomp)
    if theta.size == 0:
        return 0.0
    w = s_vecs[0, :] ** 2
    return _b_norm(decomp) ** 2 * float(np.dot(_f_of_theta(theta, f), w))


def gauss_radau_bracket(
    decomp: LanczosDecomposition, lambda_min: float
) -> Tuple[float, float]:
    """``(lower, upper)`` bounds on bᵀA⁻¹b for SPD A with λ_min(A) ≥
    ``lambda_min`` > 0.

    Lower: the plain s-point Gauss rule (``quadratic_form``; its error
    term has the sign of f^{(2s)} which is positive for 1/x on (0, ∞), so
    Gauss under-estimates). Upper: the (s+1)-point Gauss–Radau rule with
    the fixed node ζ = ``lambda_min`` at the left end of the spectrum —
    built by extending T_s with the standard Golub–Meurant boundary
    modification: solve (T_s − ζI)·δ = β_s²·e_s and append the diagonal
    entry α̂ = ζ + δ_s coupled by β_s.

    After breakdown the quadrature is exact and the bracket collapses to
    the exact value. Raises for ``lambda_min <= 0`` (the bound theory
    needs f smooth on [ζ, ∞) ⊂ (0, ∞)).
    """
    if lambda_min <= 0.0:
        raise ValueError("gauss_radau_bracket requires lambda_min > 0 (SPD A)")
    # lower = Gauss rule; upper = the shared Radau evaluator (which also
    # owns the empty-decomposition and breakdown-exactness edge cases)
    return (quadratic_form(decomp, "inv"),
            _radau_quadrature(decomp, "inv", lambda_min))


# ---------------------------------------------------------------------------
# Rigorous A-norm error certificates for the f = inv solve (Golub–Meurant)
# ---------------------------------------------------------------------------

def _tridiag_inv_e1_first(d, e):
    """``e₁ᵀT⁻¹e₁`` for symmetric tridiagonal T — one O(s) banded solve."""
    s = d.size
    if s == 1:
        return 1.0 / d[0]
    from scipy.linalg import solve_banded

    rhs = np.zeros(s)
    rhs[0] = 1.0
    ab = np.zeros((3, s))
    ab[0, 1:] = e
    ab[1, :] = d
    ab[2, :-1] = e
    return float(solve_banded((1, 1), ab, rhs)[0])


def _radau_extended(d, e, beta, zeta):
    """The Golub–Meurant Gauss–Radau extension of tridiagonal T (node
    fixed at ζ): append α̂ = ζ + δ_s with δ = (T − ζI)⁻¹·β²e_s (the
    boundary modification), coupled by β. Returns ``(d_hat, e_hat)`` —
    the ONE implementation shared by :func:`gauss_radau_bracket` and the
    error-certificate path. One O(s) banded solve."""
    s = d.size
    rhs = np.zeros(s)
    rhs[-1] = beta**2
    if s == 1:
        delta_last = rhs[0] / (d[0] - zeta)
    else:
        from scipy.linalg import solve_banded

        ab = np.zeros((3, s))
        ab[0, 1:] = e
        ab[1, :] = d - zeta
        ab[2, :-1] = e
        delta_last = solve_banded((1, 1), ab, rhs)[-1]
    return (np.concatenate([d, [zeta + delta_last]]),
            np.concatenate([e, [beta]]))


def _radau_inv_e1_first(d, e, beta_j, zeta):
    """``e₁ᵀT̂⁻¹e₁`` over the Radau extension — two O(s) banded solves."""
    d_hat, e_hat = _radau_extended(d, e, beta_j, zeta)
    return _tridiag_inv_e1_first(d_hat, e_hat)


def a_norm_error_history(
    decomp: LanczosDecomposition, lambda_min: float, *, stride: int = 1
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-step **rigorous bracket** on the A-norm solve error
    ``‖x − x_j‖_A`` of the f = inv Lanczos iterates, for SPD A with
    λ_min(A) ≥ ``lambda_min`` > 0 — from the stored (α, β) alone.

    The Golub–Meurant identity behind it: with x_j the step-j Lanczos
    (≡ CG) approximation to A⁻¹b from x₀ = 0,

        ‖x − x_j‖_A² = bᵀA⁻¹b − ‖b‖²·G_j ,

    where ``G_j = e₁ᵀT_j⁻¹e₁`` is the j-point Gauss quadrature. Gauss
    under-estimates bᵀA⁻¹b and Gauss–Radau (node ζ = ``lambda_min``)
    over-estimates it, so for every j < s (s = ``steps_taken``):

        ‖b‖·√(G_s − G_j)   ≤  ‖x − x_j‖_A  ≤  ‖b‖·√(U_j − G_j) ,

    with ``U_j`` the j-point Radau value — both sides computable, both
    rigorous in exact arithmetic (finite-precision caveat: past the
    orthogonality cliff the identities hold to the usual O(ε‖A‖·‖basis
    defect‖) slack; under ``reorth`` they are sharp). Returns
    ``(steps, lower, upper)`` arrays over ``j = 1, 1+stride, …, s−1``
    (``j = s`` is excluded: its lower bound is vacuously 0 and its Radau
    coupling β_s is the stored final residual). Cost: O(s²/stride) host
    flops — banded solves, no eigendecompositions.

    Reference frame: the reference stores exactly this (α, β) data
    (``src/algorithms/mod.rs:94-108``) but ships no error estimator; this
    is the standard certificate its users would build on top.
    """
    if lambda_min <= 0.0:
        raise ValueError(
            "a_norm_error_history requires lambda_min > 0 (SPD A)")
    if stride < 1:
        raise ValueError("stride must be >= 1")
    d, e = tridiagonal_valid(decomp)
    s = d.size
    b2 = _b_norm(decomp) ** 2
    if s < 2:
        return (np.zeros(0, np.int64), np.zeros(0), np.zeros(0))
    g_s = _tridiag_inv_e1_first(d, e)
    js, lows, ups = [], [], []
    for j in range(1, s, stride):
        g_j = _tridiag_inv_e1_first(d[:j], e[: j - 1])
        u_j = _radau_inv_e1_first(d[:j], e[: j - 1], e[j - 1], lambda_min)
        js.append(j)
        lows.append(np.sqrt(b2 * max(g_s - g_j, 0.0)))
        ups.append(np.sqrt(b2 * max(u_j - g_j, _cert_slack(u_j, g_j))))
    return np.asarray(js, np.int64), np.asarray(lows), np.asarray(ups)


def _cert_slack(u: float, g: float) -> float:
    """Resolution floor of the quadrature-difference certificate: once
    ``U − G`` shrinks to a few ulps of the quadrature values themselves,
    the f64 subtraction is noise and can even go ≤ 0 while the true error
    is still ~√ε·‖x‖_A. Flooring the difference at 4 ulps keeps the upper
    bound VALID (never smaller than what f64 can resolve) at the cost of
    saturating around √(4ε) ≈ 3e−8 relative — certifying below that needs
    higher-precision coefficients (the df path)."""
    return 4.0 * float(np.finfo(np.float64).eps) * max(abs(u), abs(g))


def _radau_quadrature(decomp, f: FSpec, zeta: float) -> float:
    """The (s+1)-point Gauss–Radau estimate of bᵀf(A)b with the fixed
    node ζ (host eigh of the extended tridiagonal)."""
    d, e = tridiagonal_valid(decomp)
    beta_s = _beta_last(decomp)
    if d.size == 0:
        return 0.0
    if beta_s == 0.0:
        return quadratic_form(decomp, f)  # invariant: Gauss already exact
    d_hat, e_hat = _radau_extended(d, e, beta_s, zeta)
    theta, s_vecs = _eigh_tridiagonal(d_hat, e_hat)
    return _b_norm(decomp) ** 2 * float(
        np.dot(_f_of_theta(theta, f), s_vecs[0, :] ** 2))


def quadrature_bracket(
    decomp: LanczosDecomposition, interval, f: FSpec = "exp"
) -> Tuple[float, float]:
    """``(lower, upper)`` enclosure of bᵀf(A)b for ``f`` with
    sign-definite high derivatives, from spectrum bounds alone.

    ``interval = (a, b)`` must satisfy spec(A) ⊆ [a, b] (an underestimate
    of λ_min and an overestimate of λ_max — e.g. Gershgorin, or
    :func:`~two_pass_lanczos_tpu.algorithms.chebyshev.estimate_interval`
    with its safety margin). The classical Golub–Meurant sign analysis
    picks the sides:

    * ``f = "exp"`` (all derivatives > 0): the left-node Radau rule
      under-estimates (error ∝ f^(2s+1)(ξ)·(x−a) ≥ 0 on [a, b]) and the
      right-node rule over-estimates — bracket = (Radau(a), Radau(b)).
      Valid for ANY symmetric A.
    * ``f = "inv"`` (derivatives alternate): on SPD A with a > 0 the
      Gauss rule under-estimates and the left-node Radau rule
      over-estimates — bracket = (Gauss, Radau(a)), i.e. exactly
      :func:`gauss_radau_bracket` (kept for API compatibility).

    Arbitrary callables are rejected — the enclosure property rests on
    the derivative signs, which a black-box f cannot promise.
    """
    a, b = float(interval[0]), float(interval[1])
    if not a < b:
        raise ValueError(f"interval must satisfy a < b, got ({a}, {b})")
    if f == "exp":
        return (_radau_quadrature(decomp, "exp", a),
                _radau_quadrature(decomp, "exp", b))
    if f == "inv":
        if a <= 0.0:
            raise ValueError(
                "quadrature_bracket(f='inv') requires a > 0 (SPD A)")
        return gauss_radau_bracket(decomp, a)
    raise ValueError(
        f"quadrature_bracket supports f in ('exp', 'inv'), got {f!r} "
        "(the enclosure needs sign-definite derivatives)")
