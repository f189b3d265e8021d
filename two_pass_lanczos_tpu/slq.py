"""Stochastic Lanczos quadrature (SLQ): tr f(A) estimation.

The reference evaluates f(A)·b for a single b (``src/solvers.rs``); the
identical pass-one machinery answers the other canonical matrix-function
question — ``tr f(A)`` (log-determinants, trace of the inverse, spectral
sums) — via Hutchinson probing + Gauss quadrature (Ubaru–Chen–Saad,
"Fast estimation of tr(f(A)) via stochastic Lanczos quadrature"):

    tr f(A) = E_z[ zᵀ f(A) z ]  ≈  (1/m) Σ_i ‖z_i‖²·e₁ᵀ f(T_k^{(i)}) e₁

with z_i Rademacher (or Gaussian) probes and T_k^{(i)} the Lanczos
tridiagonal of (A, z_i). This maps onto an accelerator better than any
other trace estimator:

* the m probe recurrences are **one vmapped ``lax.scan``** — every matvec
  becomes a batched matvec (a matmul for dense A; a shared-A
  batched SpMV for sparse A), so the m probes cost far less than m solo runs;
* the m quadratures are **one batched ``eigh``** of (m, k, k) tridiagonals —
  tiny device-side dense eigensolves, no host round-trip per probe.

Everything here reuses the scan from :mod:`algorithms.core` unchanged
(reference recurrence parity, ``src/algorithms/mod.rs:167-212``) so
breakdown handling, zero-probe handling and coefficient semantics are the
ones the rest of the library pins. Works with any pytree
:class:`LinearOperator` whose ``matvec`` is vmappable (every XLA-path
operator in :mod:`operators`).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from two_pass_lanczos_tpu.algorithms.core import (
    LanczosDecomposition,
    pass_one_scan,
)
from two_pass_lanczos_tpu.operators import LinearOperator

__all__ = [
    "SLQResult",
    "lanczos_pass_one_batched",
    "batched_quadratic_form",
    "batched_ritz_weights",
    "slq_trace",
    "slq_trace_adaptive",
    "slq_logdet",
    "slq_spectral_density",
]

FSpec = Union[str, Callable[[jax.Array], jax.Array]]

#: Diagonal value used to pad T beyond ``steps_taken``. The padded block is
#: exactly decoupled (its couplings are the zero-padded β entries), so its
#: eigenpairs carry zero e₁-weight; any finite positive value keeps
#: f ∈ {inv, log} NaN-free on the padding.
_PAD_DIAG = 1.0


def _f_of_theta(theta: jax.Array, f: FSpec) -> jax.Array:
    if f == "inv":
        return 1.0 / theta
    if f == "exp":
        return jnp.exp(theta)
    if f == "log":
        return jnp.log(theta)
    if callable(f):
        return f(theta)
    raise ValueError(f"unknown function spec {f!r} (expected 'inv', 'exp', 'log' or a callable)")


def lanczos_pass_one_batched(
    operator: LinearOperator, bs: jax.Array, k: int
) -> LanczosDecomposition:
    """Pass one over a batch of right-hand sides in a single vmapped scan.

    ``bs`` has shape ``(m, n)`` (row i = one RHS). Returns a
    :class:`LanczosDecomposition` whose leaves carry a leading batch axis:
    ``alphas``/``betas`` ``(m, k)``, ``steps_taken``/``b_norm`` ``(m,)``.
    Each row is bit-identical to a solo :func:`algorithms.core
    .pass_one_scan` on that RHS — vmap vectorizes the identical FP
    sequence, it does not reassociate the reductions.
    """
    if bs.ndim != 2:
        raise ValueError(f"bs must be (m, n), got shape {bs.shape}")

    def solo(b):
        return pass_one_scan(operator.matvec, b, k, emit_basis=False)[0]

    return jax.vmap(solo)(bs)


def batched_ritz_weights(decomp: LanczosDecomposition):
    """``(theta, w)`` per batch row: Ritz values (ascending, (m, k)) and
    the Gauss quadrature weights ``w_j = S[0, j]²`` (rows sum to 1 for a
    nonzero RHS).

    Rows that broke down early are padded with an exactly-decoupled
    diagonal block (its couplings are the zero-padded β entries), so the
    padded eigenpairs carry ZERO e₁-weight — they never contribute to any
    quadrature built from these weights.
    """
    alphas, betas = decomp.alphas, decomp.betas
    steps = jnp.atleast_1d(decomp.steps_taken)
    if alphas.ndim == 1:
        alphas, betas = alphas[None], betas[None]

    k = alphas.shape[-1]
    i = jnp.arange(k)
    diag = jnp.where(i[None, :] < steps[:, None], alphas,
                     jnp.asarray(_PAD_DIAG, alphas.dtype))
    # betas[j] = β_{j+1}; valid off-diagonals of T_s are j+1 < s.
    off = jnp.where((i[None, : k - 1] + 1) < steps[:, None], betas[:, : k - 1],
                    jnp.zeros((), betas.dtype))

    def build(d, e):
        t = jnp.diag(d)
        if k > 1:
            t = t + jnp.diag(e, 1) + jnp.diag(e, -1)
        return t

    t = jax.vmap(build)(diag, off)
    theta, s_vecs = jnp.linalg.eigh(t)
    return theta, s_vecs[:, 0, :] ** 2


def batched_quadratic_form(decomp: LanczosDecomposition, f: FSpec = "inv") -> jax.Array:
    """Device-side ``‖b‖²·e₁ᵀ f(T_s) e₁`` for every row of a batched
    decomposition — the s-point Gauss quadrature of ``bᵀ f(A) b``.

    Accepts the output of :func:`lanczos_pass_one_batched` (leading batch
    axis) or a solo decomposition (returns a scalar array). Early
    breakdown and zero-b rows are handled (see
    :func:`batched_ritz_weights`). Host-side single-decomposition
    analogue: :func:`spectrum.quadratic_form`.
    """
    solo = decomp.alphas.ndim == 1
    theta, w = batched_ritz_weights(decomp)
    b_norm = jnp.atleast_1d(decomp.b_norm)
    quad = (b_norm**2) * jnp.sum(_f_of_theta(theta, f) * w, axis=-1)
    return quad[0] if solo else quad


class SLQResult(NamedTuple):
    """Trace estimate with its sampling uncertainty.

    * ``estimate`` — mean of the per-probe quadratic forms (the tr f(A)
      estimator).
    * ``stderr`` — sample standard error across probes (0.0 when m == 1);
      the Hutchinson Monte-Carlo uncertainty, NOT the quadrature bias.
    * ``samples`` — the (m,) per-probe estimates ``‖z_i‖²·e₁ᵀf(T^{(i)})e₁``.
    """

    estimate: jax.Array
    stderr: jax.Array
    samples: jax.Array


def slq_stats(samples: jax.Array) -> "SLQResult":
    """Fold per-probe estimates into the Hutchinson mean ± standard error
    (shared by the single-device and sharded drivers)."""
    m = samples.shape[0]
    estimate = jnp.mean(samples)
    if m > 1:
        var = jnp.sum((samples - estimate) ** 2) / (m - 1)
        stderr = jnp.sqrt(var / m)
    else:
        stderr = jnp.zeros((), samples.dtype)
    return SLQResult(estimate=estimate, stderr=stderr, samples=samples)


@functools.partial(jax.jit, static_argnames=("k", "f"))
def _slq_run(operator, probes, k, f):
    decomp = lanczos_pass_one_batched(operator, probes, k)
    return slq_stats(batched_quadratic_form(decomp, f))


def _draw_probes(key, num_probes, n, dtype, probe):
    if probe == "rademacher":
        return jax.random.rademacher(key, (num_probes, n)).astype(dtype)
    if probe == "gaussian":
        return jax.random.normal(key, (num_probes, n), dtype)
    raise ValueError(f"unknown probe kind {probe!r} (expected 'rademacher' or 'gaussian')")


def slq_trace(
    operator: LinearOperator,
    f: FSpec = "inv",
    *,
    k: int = 50,
    num_probes: int = 16,
    key: jax.Array,
    probe: str = "rademacher",
) -> SLQResult:
    """Estimate ``tr f(A)`` by stochastic Lanczos quadrature.

    One jitted launch runs all ``num_probes`` recurrences as a single
    vmapped scan of ``k`` steps (≈ k batched matvecs total) and evaluates
    all quadratures with one batched ``eigh``. ``f`` ∈ {"inv", "exp",
    "log"} or any elementwise callable applied to Ritz values. Rademacher
    probes (default) have the lower variance for nearly-diagonal A;
    Gaussian probes are the classical alternative. The estimator is
    unbiased in the probes; the quadrature bias decays like the best
    degree-(2k-1) polynomial approximation of f on A's spectrum — for SPD
    A and f = inv/log, k of a few dozen is typically ample.

    The operator must be a pytree with a vmappable ``matvec`` (all XLA-path
    operators). Requires an explicit PRNG ``key`` — trace estimates are
    Monte-Carlo; reproducibility demands caller-owned randomness.

    A callable ``f`` is a static jit argument: pass the SAME function
    object across calls (module-level function, cached closure) — a fresh
    lambda per call retraces and recompiles the whole scan.
    """
    if num_probes < 1:
        raise ValueError("num_probes must be >= 1")
    n = operator.shape[0]
    probes = _draw_probes(key, num_probes, n, operator.dtype, probe)
    if not callable(f):
        _f_of_theta(jnp.ones(1), f)  # reject unknown strings before tracing
    return _slq_run(operator, probes, k, f)


def slq_trace_adaptive(
    operator: LinearOperator,
    f: FSpec = "inv",
    *,
    k: int = 50,
    key: jax.Array,
    probe: str = "rademacher",
    target_rel_stderr: float = 0.01,
    batch: int = 8,
    max_probes: int = 512,
) -> SLQResult:
    """:func:`slq_trace` with the probe count chosen adaptively: draw
    ``batch`` probes at a time (one compiled shape, reused every round)
    until the sample standard error falls below
    ``target_rel_stderr·|estimate|`` or ``max_probes`` is reached.

    Controls Monte-Carlo error only — the quadrature bias is set by ``k``
    (make k large enough that bias ≪ the stderr target). Zero-variance
    exactness cases (e.g. Rademacher probes on diagonal A) stop after the
    minimum two batches.
    """
    n = operator.shape[0]
    if not callable(f):
        _f_of_theta(jnp.ones(1), f)

    def run_batch(sub, take):
        probes = _draw_probes(sub, take, n, operator.dtype, probe)
        return _slq_run(operator, probes, k, f).samples

    return adaptive_probe_loop(
        run_batch, key, batch=batch, max_probes=max_probes,
        target_rel_stderr=target_rel_stderr)


def adaptive_probe_loop(run_batch, key, *, batch: int, max_probes: int,
                        target_rel_stderr: float) -> SLQResult:
    """The adaptive Hutchinson driver shared by every SLQ tier (single
    device, row-sharded): call ``run_batch(sub_key,
    take)`` → per-probe samples, accumulate until the sample standard
    error certifies ``target_rel_stderr`` (two-batch minimum — one
    batch's variance estimate is too noisy) or ``max_probes`` is hit."""
    if batch < 2:
        raise ValueError("batch must be >= 2 (variance needs >= 2 samples)")
    if not 0.0 < target_rel_stderr:
        raise ValueError("target_rel_stderr must be > 0")
    if max_probes < 2:
        raise ValueError("max_probes must be >= 2")
    samples = []
    m = 0
    while True:
        take = min(batch, max_probes - m)  # never overspend the cap
        key, sub = jax.random.split(key)
        samples.append(np.asarray(run_batch(sub, take)))
        all_s = np.concatenate(samples)
        m = all_s.shape[0]
        est = float(np.mean(all_s))
        stderr = float(np.std(all_s, ddof=1) / np.sqrt(m))
        if m >= min(2 * batch, max_probes) and (
                stderr <= target_rel_stderr * max(abs(est), 1e-300)):
            break
        if m >= max_probes:
            break
    dt = all_s.dtype
    return SLQResult(estimate=jnp.asarray(est, dt),
                     stderr=jnp.asarray(stderr, dt),
                     samples=jnp.asarray(all_s))


@jax.jit
def dos_from_decomposition(decomp, grid, sigma):
    """Smoothed DOS on ``grid`` from a batched (per-probe) decomposition:
    average of the Gaussian-KDE'd k-node spectral measures — the
    Lin–Saad–Yang estimator's second half, shared by the single-device and
    sharded tiers (the first half is any batched pass one over unit probes)."""
    theta, w = batched_ritz_weights(decomp)
    m = theta.shape[0]
    g = jnp.exp(-0.5 * ((grid[None, None, :] - theta[:, :, None]) / sigma) ** 2)
    g = g / (sigma * jnp.sqrt(2.0 * jnp.pi))
    return jnp.sum(w[:, :, None] * g, axis=(0, 1)) / m


def validate_dos_params(grid, sigma, num_probes):
    """Shared parameter validation for the DOS estimators; returns the
    device grid and the resolved ``sigma``."""
    if num_probes < 1:
        raise ValueError("num_probes must be >= 1")
    grid = jnp.asarray(grid)
    if grid.ndim != 1 or grid.shape[0] < 2:
        raise ValueError("grid must be a 1-D array with at least 2 points")
    if sigma is None:
        sigma = 2.0 * float(grid[1] - grid[0])
    if sigma <= 0.0:
        raise ValueError("sigma must be > 0")
    return grid, float(sigma)


@functools.partial(jax.jit, static_argnames=("k",))
def _dos_run(operator, probes, grid, sigma, k):
    decomp = lanczos_pass_one_batched(operator, probes, k)
    return dos_from_decomposition(decomp, grid, sigma)


def slq_spectral_density(
    operator: LinearOperator,
    grid,
    *,
    sigma: Optional[float] = None,
    k: int = 50,
    num_probes: int = 16,
    key: jax.Array,
    probe: str = "gaussian",
) -> jax.Array:
    """Smoothed spectral density (density of states) on ``grid``:
    φ_σ(t) ≈ (1/n)·Σ_i N(t; λ_i, σ²), by SLQ with unit-norm probes
    (Lin–Saad–Yang, "Approximating spectral densities of large matrices",
    SIAM Review 2016).

    Each normalized probe's Lanczos quadrature yields a k-node spectral
    measure (θ_j, w_j); averaging the Gaussian-smoothed node measures over
    probes estimates the normalized eigenvalue distribution. Integrates to
    1 by construction (each probe's weights sum to 1). ``sigma`` defaults
    to twice the grid spacing — resolution is limited by both σ and k
    (k nodes can resolve at most k spectral clusters).

    Runs as ONE vmapped scan + ONE batched ``eigh`` + one broadcast
    kernel-density evaluation, all inside a single jit.
    """
    grid, sigma = validate_dos_params(grid, sigma, num_probes)
    n = operator.shape[0]
    probes = _draw_probes(key, num_probes, n, operator.dtype, probe)
    probes = probes / jnp.linalg.norm(probes, axis=1, keepdims=True)
    return _dos_run(operator, probes, grid.astype(probes.dtype),
                    jnp.asarray(sigma, probes.dtype), k)


def slq_logdet(
    operator: LinearOperator,
    *,
    k: int = 50,
    num_probes: int = 16,
    key: jax.Array,
    probe: str = "rademacher",
) -> SLQResult:
    """``log det A = tr log A`` for SPD ``A`` — the marquee SLQ application
    (Gaussian-process likelihoods, determinantal point processes)."""
    return slq_trace(operator, "log", k=k, num_probes=num_probes, key=key, probe=probe)
