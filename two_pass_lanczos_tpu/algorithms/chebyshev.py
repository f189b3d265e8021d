"""Chebyshev expansion f(A)·b — the storage-free alternative to Lanczos.

The reference's answer to the O(nk) basis-memory problem is the two-pass
algorithm (``src/algorithms/lanczos_two_pass.rs``); the other classical
answer — which it does not ship — is to bypass the Krylov projection
entirely and evaluate a Chebyshev polynomial approximation of f on the
spectral interval:

    f(A)·b  ≈  Σ_{j=0}^{d} c_j · T_j(Ã)·b,      Ã = (2A − (a+b)I)/(b − a)

via the three-term recurrence T_{j+1} = 2Ã·T_j − T_{j-1}. Properties that
make it worth shipping alongside the Lanczos paths:

* **O(n) memory, ONE pass, d matvecs** (vs 2k for two-pass Lanczos) — no
  basis, no second pass, no (α, β) storage;
* **no orthogonality to lose**: the recurrence is forward-stable on
  [a, b] (|T_j| ≤ 1), so f32 behavior is benign where the Lanczos
  recurrence suffers forward instability at large k;
* **pure matvec chain** under one ``lax.scan`` — the simplest compiled
  control flow there is, and it works unchanged through any matvec
  (single-device or sharded).

The price: convergence depends on f's smoothness on [a, b] (not on the
spectrum's point distribution, which Lanczos adapts to), and the interval
[a, b] ⊇ spec(A) must be known — :func:`eigen.eigsh` estimates it
(``estimate_interval``) when not provided.

Coefficients come from Chebyshev interpolation at the d+1 Chebyshev nodes
(host-side f64 DCT; exact for polynomials of degree ≤ d).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from two_pass_lanczos_tpu.operators import LinearOperator

__all__ = [
    "chebyshev_coefficients",
    "chebyshev_fAb",
    "chebyshev_scan",
    "estimate_interval",
]

FSpec = Union[str, Callable[[np.ndarray], np.ndarray]]


def _f_host(x: np.ndarray, f: FSpec) -> np.ndarray:
    if f == "inv":
        return 1.0 / x
    if f == "exp":
        return np.exp(x)
    if f == "log":
        return np.log(x)
    if callable(f):
        return np.asarray(f(x), np.float64)
    raise ValueError(f"unknown function spec {f!r} (expected 'inv', 'exp', 'log' or a callable)")


def validate_interval_for_f(f: FSpec, a: float, bb: float) -> None:
    """Reject intervals on which the named function is singular: ``inv``
    must not straddle 0 (either sign-definite side is fine — 1/x is smooth
    there); ``log`` needs a strictly positive interval."""
    if f == "inv" and a <= 0.0 <= bb:
        raise ValueError(
            f"f='inv' needs a sign-definite spectral interval (not "
            f"containing 0), got ({a}, {bb})")
    if f == "log" and a <= 0.0:
        raise ValueError(
            f"f='log' needs a positive spectral interval, got ({a}, {bb})")


def chebyshev_coefficients(
    f: FSpec, interval: Tuple[float, float], degree: int
) -> np.ndarray:
    """Coefficients c_0..c_degree of the degree-``degree`` Chebyshev
    interpolant of ``f`` on ``interval`` (host f64, cosine-node DCT).

    Exact (to roundoff) for polynomials of degree ≤ ``degree``; for
    analytic f the coefficients decay geometrically — truncate where they
    hit the working epsilon.
    """
    a, b = float(interval[0]), float(interval[1])
    if not a < b:
        raise ValueError(f"interval must satisfy a < b, got ({a}, {b})")
    if degree < 0:
        raise ValueError("degree must be >= 0")
    n = degree + 1
    k = np.arange(n)
    x = np.cos(np.pi * (k + 0.5) / n)  # Chebyshev nodes on [-1, 1]
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        fx = _f_host(0.5 * (b - a) * x + 0.5 * (b + a), f)
    if not np.all(np.isfinite(fx)):
        raise ValueError(
            f"f is not finite everywhere on the interval ({a}, {b}) — the "
            "expansion would be NaN. Rescale the operator (e.g. A/‖A‖ for "
            "exp) or shrink the interval.")
    j = np.arange(n)[:, None]
    c = (2.0 / n) * (np.cos(j * np.pi * (k + 0.5) / n) @ fx)
    c[0] *= 0.5
    return c


def estimate_interval(
    operator: LinearOperator,
    *,
    margin: float = 0.05,
    tol: float = 1e-3,
    key: Optional[jax.Array] = None,
) -> Tuple[float, float]:
    """Spectral interval estimate [λ_min, λ_max] via two small
    :func:`eigen.eigsh` runs, widened by the residual norms plus a
    relative ``margin`` (Chebyshev needs spec(A) ⊆ [a, b]; Ritz values
    approach the spectrum from inside, so the padding matters).
    """
    from two_pass_lanczos_tpu.eigen import eigsh

    if key is None:
        key = jax.random.key(0)
    k_lo, k_hi = jax.random.split(key)
    hi = eigsh(operator, nev=1, which="LA", tol=tol, ncv=min(20, operator.shape[0]), key=k_hi)
    lo = eigsh(operator, nev=1, which="SA", tol=tol, ncv=min(20, operator.shape[0]), key=k_lo)
    return interval_from_extremes(hi, lo, margin)


def interval_from_extremes(hi, lo, margin: float) -> Tuple[float, float]:
    """Widen two extreme-eigenpair results into a Chebyshev interval —
    the residual-plus-margin padding shared by the single-device and
    sharded estimators (``hi``/``lo`` are LA/SA :class:`eigen.EigshResult`
    values from ANY driver)."""
    lam_hi = float(hi.eigenvalues[-1]) + float(hi.residual_norms[-1])
    lam_lo = float(lo.eigenvalues[0]) - float(lo.residual_norms[0])
    width = max(lam_hi - lam_lo, 1e-12 * max(abs(lam_hi), abs(lam_lo), 1.0))
    a = lam_lo - margin * width
    if lam_lo > 0.0 and a <= 0.0:
        # SPD spectrum: never let the additive margin cross 0 (it would
        # wrongly disqualify f='inv'/'log'); floor at margin·λ_min, which
        # stays below the (residual-widened) λ_min estimate
        a = margin * lam_lo
    return a, lam_hi + margin * width


def chebyshev_fAb(
    operator: LinearOperator,
    b: jax.Array,
    f: FSpec,
    *,
    degree: int = 100,
    interval: Optional[Tuple[float, float]] = None,
    key: Optional[jax.Array] = None,
) -> jax.Array:
    """Evaluate ``f(A)·b`` by a degree-``degree`` Chebyshev expansion:
    ``degree`` matvecs, O(n) memory, one ``lax.scan``.

    ``interval`` must contain spec(A); when omitted it is estimated with
    :func:`estimate_interval` (costing two small eigsh runs — pass the
    interval explicitly in production, it is a property of A you usually
    know or can cache). For f = "inv"/"log" the interval must stay
    positive. Accuracy ≈ the sup-norm error of the Chebyshev interpolant
    of f on the interval — geometric in ``degree`` for analytic f, with
    rate set by how far f's nearest singularity sits from [a, b] (for
    f=inv: q = (√κ−1)/(√κ+1) per degree, κ = b/a).
    """
    if interval is None:
        interval = estimate_interval(operator, key=key)
    a, bb = float(interval[0]), float(interval[1])
    validate_interval_for_f(f, a, bb)
    c_host = chebyshev_coefficients(f, interval, degree)
    rdt = jnp.real(jnp.zeros((), operator.dtype)).dtype
    coeffs = jnp.asarray(c_host, rdt)
    scale = jnp.asarray([2.0 / (bb - a), (bb + a) / (bb - a)], rdt)
    return _chebyshev_run(operator, jnp.asarray(b), coeffs, scale)


def chebyshev_scan(matvec, b_in, cs, scale):
    """``Σ c_j·T_j(Ã)·b`` as one scan over any ``matvec`` closure; degree
    is static via ``cs.shape``. The recurrence needs NO reductions — under
    ``shard_map`` it distributes with zero collectives beyond the matvec's
    own (see :meth:`parallel.sharded.ShardedSparseOperator.chebyshev_fAb`).

    Pytree-generic: ``b_in`` may be any pytree of arrays with ``matvec``
    mapping that pytree to a like pytree (every recurrence update is
    elementwise, so any pytree layout is preserved). On a plain array the
    tree_maps execute the identical elementwise ops as before.
    """
    alpha, beta = scale[0], scale[1]
    tmap = jax.tree_util.tree_map

    def a_tilde(v):
        av = matvec(v)
        return tmap(
            lambda a_, v_: alpha.astype(v_.dtype) * a_
            - beta.astype(v_.dtype) * v_, av, v)

    acc = tmap(lambda x: cs[0].astype(x.dtype) * x, b_in)
    if cs.shape[0] == 1:
        return acc
    t_curr = a_tilde(b_in)
    acc = tmap(lambda a_, t: a_ + cs[1].astype(t.dtype) * t, acc, t_curr)

    def step(carry, c_j):
        t_pm1, t_j, acc_j = carry
        t_next = tmap(lambda a_, p: 2.0 * a_ - p, a_tilde(t_j), t_pm1)
        acc_j = tmap(lambda a_, t: a_ + c_j.astype(t.dtype) * t,
                     acc_j, t_next)
        return (t_j, t_next, acc_j), None

    (_, _, acc), _ = jax.lax.scan(step, (b_in, t_curr, acc), cs[2:])
    return acc


@jax.jit
def _chebyshev_run(operator, b_in, cs, scale):
    return chebyshev_scan(operator.matvec, b_in, cs, scale)
