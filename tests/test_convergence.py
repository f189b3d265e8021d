"""Coefficient-only convergence estimation (two_pass_lanczos_tpu.convergence).

The reference exposes the callback hook but no stopping criterion
(``src/algorithms/mod.rs:69-86``); this module supplies the lagged
difference-of-iterates estimate computed from (α, β) alone. Pinned here:
(1) the norm identity ‖x_s − x_{s−lag}‖ = ‖b‖·‖ŷ_s − ŷ_{s−lag}‖ against
explicitly reconstructed solutions; (2) the ready-made callback stops
in-run and the truncated solution meets the requested tolerance vs the
analytic truth; (3) the same callback object drives the distributed path.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import two_pass_lanczos_tpu as tpl
from two_pass_lanczos_tpu.convergence import (
    convergence_history,
    make_convergence_callback,
    update_norm,
)


def _diag_problem(n=200, lo=1.0, hi=10.0, seed=0, dtype=jnp.float64):
    d = np.linspace(lo, hi, n)
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(n)
    return tpl.DiagonalOperator(jnp.asarray(d, dtype)), jnp.asarray(b, dtype), d, b


@pytest.mark.parametrize("f", ["inv", "exp"])
@pytest.mark.parametrize("lag", [1, 5])
def test_update_norm_is_solution_update_norm(f, lag):
    """While V is orthonormal, the coefficient-only estimate equals the true
    relative update of the reconstructed solutions (docstring identity)."""
    op, b, _, _ = _diag_problem()
    s = 15
    solver = tpl.make_inv_solver() if f == "inv" else tpl.make_exp_solver()
    # exp on a positive spectrum up to 10: scale down to avoid overflow noise
    decomp = tpl.lanczos_pass_one(op, b, s)
    d_est = update_norm(decomp.alphas_valid(), decomp.betas_valid(), f, lag=lag)

    x_s = np.asarray(tpl.lanczos(op, b, s, solver))
    x_j = np.asarray(tpl.lanczos(op, b, s - lag, solver))
    d_true = np.linalg.norm(x_s - x_j) / np.linalg.norm(x_s)
    # f64, pre-orthogonality-loss regime: the identity is near-exact
    assert d_est == pytest.approx(d_true, rel=1e-8), (d_est, d_true)


def test_update_norm_inf_until_past_lag():
    op, b, _, _ = _diag_problem()
    decomp = tpl.lanczos_pass_one(op, b, 4)
    assert update_norm(decomp.alphas_valid(), decomp.betas_valid(), "inv",
                       lag=4) == float("inf")


def test_convergence_history_monotone_trend():
    op, b, _, _ = _diag_problem()
    decomp = tpl.lanczos_pass_one(op, b, 60)
    hist = convergence_history(decomp.alphas_valid(), decomp.betas_valid(),
                               "inv", lag=5, stride=5)
    assert [s for s, _ in hist][0] == 6
    ds = [d for _, d in hist]
    assert ds[-1] < 1e-10 < ds[0]  # converged by k=60 on kappa=10


def test_callback_stops_and_solution_is_accurate():
    """End-to-end: the ready-made callback stops pass one in-run and the
    truncated f(A)b still meets the analytic-truth tolerance it targeted."""
    op, b_dev, d, b = _diag_problem()
    tol = 1e-10
    cb = make_convergence_callback("inv", tol, lag=5, stride=1)
    x = tpl.lanczos_two_pass(op, b_dev, 150, tpl.make_inv_solver(),
                             callback=cb, callback_chunk=10)
    assert cb.stopped_at is not None and cb.stopped_at < 100
    assert len(cb.history) >= 1
    x_true = b / d
    rel = np.linalg.norm(np.asarray(x) - x_true) / np.linalg.norm(x_true)
    # the update norm under-estimates the error by at most a modest factor
    # on a kappa=10 SPD spectrum
    assert rel < 100 * tol, (rel, cb.stopped_at)


def test_callback_stride_thins_checks():
    op, b_dev, _, _ = _diag_problem()
    cb = make_convergence_callback("inv", tol=0.0, lag=5, stride=10)
    tpl.lanczos_two_pass(op, b_dev, 40, tpl.make_inv_solver(),
                         callback=cb, callback_chunk=8)
    checked = [s for s, _ in cb.history]
    assert checked == [6, 16, 26, 36]  # lag+1 then every `stride`
    assert cb.stopped_at is None  # tol=0 never fires


def test_min_steps_defers_first_check():
    op, b_dev, _, _ = _diag_problem()
    cb = make_convergence_callback("inv", tol=1.0, lag=5, stride=1,
                                   min_steps=20)
    tpl.lanczos_two_pass(op, b_dev, 40, tpl.make_inv_solver(),
                         callback=cb, callback_chunk=8)
    assert cb.stopped_at is not None and cb.stopped_at >= 20


def test_convergence_callback_on_kkt_operator():
    """Contract smoke on the KKT operator: the coefficient-only callback
    plugs into the chunked two-pass driver unchanged and stops it."""
    rng = np.random.default_rng(2)
    m, p = 300, 120
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    d = rng.uniform(1.0, 3.0, m)
    op = tpl.make_kkt_operator(d, u, v, p, dtype=jnp.float64)
    b = jnp.asarray(rng.standard_normal(m + p))
    # tol=inf: fires at the first evaluated step (lag+1) — pins the
    # mechanical integration; numerical stopping quality is covered on the
    # diagonal problems above.
    cb = make_convergence_callback("inv", tol=np.inf, lag=5, stride=1)
    x = tpl.lanczos_two_pass(op, b, 32, tpl.make_inv_solver(), callback=cb,
                             callback_chunk=8)
    assert cb.stopped_at == 6
    assert np.all(np.isfinite(np.asarray(x)))


def test_convergence_callback_on_distributed_path():
    """The identical callback object drives ShardedSparseOperator.solve_fAb
    (scalars-only view: the estimator never needs the basis)."""
    from two_pass_lanczos_tpu.parallel import ShardedSparseOperator, make_mesh

    n = 160
    d = np.linspace(1.0, 10.0, n)
    idx = np.arange(n, dtype=np.int64)
    sop = ShardedSparseOperator(n, idx, idx, d, make_mesh(4))
    rng = np.random.default_rng(1)
    b = rng.standard_normal(n)
    cb = make_convergence_callback("inv", 1e-10, lag=5, stride=1)
    x, dec = sop.solve_fAb(b, k=120, f="inv", callback=cb)
    assert cb.stopped_at is not None and cb.stopped_at < 100
    assert int(dec.steps()) == cb.stopped_at
    rel = np.linalg.norm(np.asarray(x) - b / d) / np.linalg.norm(b / d)
    assert rel < 1e-7


class TestRadauErrorCallback:
    """Certificate-grade stopping (Golub–Meurant Radau bound, SPD inv)."""

    def test_bound_is_rigorous_and_monotone_enough(self):
        n, k = 150, 60
        d = np.linspace(1.0, 30.0, n)
        rng = np.random.default_rng(23)
        b = rng.standard_normal(n)
        op = tpl.DiagonalOperator(jnp.asarray(d, jnp.float64))
        dec = tpl.lanczos_pass_one(op, jnp.asarray(b), k)
        a = np.asarray(dec.alphas_valid()); e = np.asarray(dec.betas_valid())
        x_true = b / d
        for s in (10, 20, 30):
            bound = tpl.radau_error_bound(a[:s], e[:s - 1], lambda_min=1.0)
            j = s - 1
            x_j = np.asarray(tpl.solve_fAb(op, jnp.asarray(b), k=j, f="inv",
                                           method="one_pass"))
            err = np.sqrt(np.sum(d * (x_true - x_j) ** 2))
            xnorm = np.sqrt(np.sum(d * x_j ** 2))
            assert err / xnorm <= bound * (1 + 1e-8) + 1e-12, (s, err/xnorm, bound)

    def test_callback_stops_with_certificate(self):
        n = 150
        d = np.linspace(1.0, 30.0, n)
        rng = np.random.default_rng(29)
        b = rng.standard_normal(n)
        op = tpl.DiagonalOperator(jnp.asarray(d, jnp.float64))
        tol = 1e-6  # above the certificate's f64 floor (~3e-8 relative)
        cb = tpl.make_radau_error_callback(1.0, tol, stride=1)
        x = tpl.lanczos_two_pass(op, jnp.asarray(b), 100,
                                 tpl.make_inv_solver(),
                                 callback=cb, callback_chunk=10)
        assert cb.stopped_at is not None and cb.stopped_at < 100
        assert cb.history[-1][1] <= tol
        x_true = b / d
        rel_a = (np.sqrt(np.sum(d * (np.asarray(x) - x_true) ** 2))
                 / np.sqrt(np.sum(d * x_true ** 2)))
        # the solve actually meets the certified tolerance class
        assert rel_a < 10 * tol

    def test_validation(self):
        with pytest.raises(ValueError, match="lambda_min > 0"):
            tpl.radau_error_bound([1.0], [], 0.0)
        with pytest.raises(ValueError, match="stride"):
            tpl.make_radau_error_callback(1.0, 1e-6, stride=0)
        assert tpl.radau_error_bound([1.0], [], 1.0) == float("inf")
