"""Chebyshev-expansion f(A)b (two_pass_lanczos_tpu.algorithms.chebyshev).

The storage-free alternative the reference does not ship. Oracles:
polynomial exactness (degree-d interpolation reproduces degree-≤d
polynomials to roundoff — mirrors the reference's z² test methodology,
``tests/correctness.rs:42-51``), analytic diagonal truths, and agreement
with the library's own Lanczos solvers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import two_pass_lanczos_tpu as tpl
from two_pass_lanczos_tpu.algorithms.chebyshev import (
    chebyshev_coefficients,
    chebyshev_fAb,
    estimate_interval,
)


def _problem(n=300, lo=1.0, hi=10.0, seed=0):
    d = np.linspace(lo, hi, n)
    b = np.random.default_rng(seed).standard_normal(n)
    op = tpl.DiagonalOperator(jnp.asarray(d, jnp.float64))
    return op, jnp.asarray(b, jnp.float64), d, b


def test_coefficients_polynomial_exact():
    """Interpolating x² on any interval with degree >= 2: c_j exact —
    x² = (T_0 + T_2)/2 on [-1,1]; on [0,2] (x = t+1): c = [1.5, 2, 0.5]."""
    c = chebyshev_coefficients(lambda x: x**2, (0.0, 2.0), 4)
    np.testing.assert_allclose(c, [1.5, 2.0, 0.5, 0.0, 0.0], atol=1e-13)


def test_polynomial_fAb_exact():
    op, b_dev, d, b = _problem()
    x = chebyshev_fAb(op, b_dev, lambda t: t**2, degree=2,
                      interval=(0.5, 11.0))
    np.testing.assert_allclose(np.asarray(x), d**2 * b, rtol=1e-12)


def test_exp_matches_analytic_and_lanczos():
    op, b_dev, d, b = _problem(lo=-1.0, hi=3.0)
    truth = np.exp(d) * b
    x = chebyshev_fAb(op, b_dev, "exp", degree=40, interval=(-1.0, 3.0))
    rel = np.linalg.norm(np.asarray(x) - truth) / np.linalg.norm(truth)
    assert rel < 1e-12
    x_lan = tpl.solve_fAb(op, b_dev, k=60, f="exp", method="two_pass")
    rel_vs = (np.linalg.norm(np.asarray(x) - np.asarray(x_lan))
              / np.linalg.norm(truth))
    assert rel_vs < 1e-10


def test_inv_geometric_convergence_in_degree():
    op, b_dev, d, b = _problem(lo=1.0, hi=16.0)  # kappa = 16, q = 3/5
    truth = b / d
    errs = []
    for deg in (20, 40, 80):
        x = chebyshev_fAb(op, b_dev, "inv", degree=deg, interval=(1.0, 16.0))
        errs.append(np.linalg.norm(np.asarray(x) - truth)
                    / np.linalg.norm(truth))
    assert errs[1] < 0.1 * errs[0] and errs[2] < 0.1 * errs[1]
    assert errs[2] < 1e-10


def test_auto_interval_via_eigsh():
    op, b_dev, d, b = _problem(lo=0.5, hi=8.0, n=200)
    x = chebyshev_fAb(op, b_dev, "inv", degree=120, key=jax.random.key(2))
    rel = np.linalg.norm(np.asarray(x) - b / d) / np.linalg.norm(b / d)
    assert rel < 1e-8


def test_auto_interval_inv_stays_positive_at_high_kappa():
    """Regression: at kappa ~ 100 the additive margin used to push the
    estimated lower endpoint below 0, wrongly disqualifying f='inv' on an
    ordinary SPD problem."""
    op, b_dev, d, b = _problem(lo=0.1, hi=10.0, n=200)  # kappa = 100
    a, hi = estimate_interval(op)
    assert 0.0 < a <= d.min() and hi >= d.max()
    x = chebyshev_fAb(op, b_dev, "inv", degree=400, key=jax.random.key(0))
    rel = np.linalg.norm(np.asarray(x) - b / d) / np.linalg.norm(b / d)
    assert rel < 1e-6


def test_inv_on_negative_definite_interval():
    """Regression: a strictly negative interval is sign-definite — 1/x is
    smooth there and must be accepted."""
    d = np.linspace(-10.5, -0.5, 200)
    op = tpl.DiagonalOperator(jnp.asarray(d, jnp.float64))
    b = np.random.default_rng(3).standard_normal(200)
    x = chebyshev_fAb(op, jnp.asarray(b, jnp.float64), "inv", degree=120,
                      interval=(-10.5, -0.5))
    np.testing.assert_allclose(np.asarray(x), b / d, rtol=1e-9, atol=1e-12)


def test_estimate_interval_encloses_spectrum():
    op, _, d, _ = _problem(lo=0.5, hi=8.0, n=200)
    a, b = estimate_interval(op)
    assert a <= d.min() and b >= d.max()
    assert a > 0.0  # margin must not push a positive spectrum negative


def test_validation_errors():
    op, b_dev, _, _ = _problem()
    with pytest.raises(ValueError, match="sign-definite"):
        chebyshev_fAb(op, b_dev, "inv", degree=10, interval=(-1.0, 10.0))
    with pytest.raises(ValueError, match="positive spectral interval"):
        chebyshev_fAb(op, b_dev, "log", degree=10, interval=(-1.0, 10.0))
    with pytest.raises(ValueError, match="a < b"):
        chebyshev_coefficients("exp", (2.0, 2.0), 5)
    with pytest.raises(ValueError, match="degree"):
        chebyshev_coefficients("exp", (0.0, 1.0), -1)
    with pytest.raises(ValueError, match="unknown function"):
        chebyshev_coefficients("sinh?", (0.0, 1.0), 5)
    with pytest.raises(ValueError, match="not finite"):
        chebyshev_coefficients("exp", (0.0, 1e6), 10)  # exp overflow
    with pytest.raises(ValueError, match="not finite"):
        chebyshev_coefficients("log", (-1.0, 1.0), 10)  # log of negatives


def test_degree_zero_and_one():
    op, b_dev, d, b = _problem()
    x0 = chebyshev_fAb(op, b_dev, lambda t: 0.0 * t + 3.0, degree=0,
                       interval=(1.0, 10.0))
    np.testing.assert_allclose(np.asarray(x0), 3.0 * b, rtol=1e-13)
    x1 = chebyshev_fAb(op, b_dev, lambda t: 2.0 * t, degree=1,
                       interval=(1.0, 10.0))
    np.testing.assert_allclose(np.asarray(x1), 2.0 * d * b, rtol=1e-12)


def test_sparse_kkt_exp_against_lanczos():
    """Indefinite sparse KKT operator: Chebyshev exp vs the Lanczos f64
    solver (both fully converged — independent algorithms agreeing)."""
    rng = np.random.default_rng(4)
    m, p = 800, 50
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    dq = rng.uniform(1.0, 3.0, m)
    op = tpl.make_kkt_operator(dq / 10.0, u, v, p,
                               dtype=jnp.float64)
    b = jnp.asarray(rng.standard_normal(m + p), jnp.float64)
    a_lo, a_hi = estimate_interval(op)
    x_ch = chebyshev_fAb(op, b, "exp", degree=80, interval=(a_lo, a_hi))
    x_ln = tpl.solve_fAb(op, b, k=150, f="exp", method="two_pass")
    rel = (np.linalg.norm(np.asarray(x_ch) - np.asarray(x_ln))
           / np.linalg.norm(np.asarray(x_ln)))
    assert rel < 1e-9


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_sharded_chebyshev_matches_host(ndev):
    """Distributed Chebyshev over the row partition == the host expansion
    (the recurrence is collective-free, so N-device results are
    bit-for-bit reduction-order independent up to the matvec's own)."""
    from two_pass_lanczos_tpu.models.generator import generate_mcf_instance
    from two_pass_lanczos_tpu.parallel import ShardedSparseOperator, make_mesh
    from two_pass_lanczos_tpu.utils.data_loader import KKTArrays

    inst = generate_mcf_instance(400, rho=3, instance_id=2)
    scale = float(np.max(inst.quad_costs))  # keep exp() in range
    arrays = KKTArrays(quad_costs=inst.quad_costs / scale, arc_u=inst.arc_u,
                       arc_v=inst.arc_v, num_nodes=inst.num_nodes,
                       num_arcs=inst.num_arcs)
    op = tpl.make_kkt_operator(arrays.quad_costs, arrays.arc_u,
                               arrays.arc_v, arrays.num_nodes, dtype=jnp.float64)
    interval = estimate_interval(op)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(arrays.n)
    x_host = np.asarray(chebyshev_fAb(op, jnp.asarray(b, jnp.float64),
                                      "exp", degree=60, interval=interval))
    assert np.all(np.isfinite(x_host)) and np.linalg.norm(x_host) > 0
    sop = ShardedSparseOperator.from_kkt_arrays(arrays, make_mesh(ndev))
    x_dist = sop.chebyshev_fAb(b, "exp", degree=60, interval=interval)
    np.testing.assert_allclose(x_dist, x_host, rtol=1e-11, atol=1e-13)


def test_sharded_chebyshev_validation():
    from two_pass_lanczos_tpu.models.generator import generate_mcf_instance
    from two_pass_lanczos_tpu.parallel import ShardedSparseOperator, make_mesh
    from two_pass_lanczos_tpu.utils.data_loader import KKTArrays

    inst = generate_mcf_instance(200, rho=3, instance_id=3)
    arrays = KKTArrays(quad_costs=inst.quad_costs, arc_u=inst.arc_u,
                       arc_v=inst.arc_v, num_nodes=inst.num_nodes,
                       num_arcs=inst.num_arcs)
    sop = ShardedSparseOperator.from_kkt_arrays(arrays, make_mesh(2))
    with pytest.raises(ValueError, match="sign-definite"):
        sop.chebyshev_fAb(np.ones(arrays.n), "inv", degree=10,
                          interval=(-2.0, 2.0))


def test_chebyshev_through_kkt_operator_f32():
    """The expansion is a pure matvec chain: in f32 through the KKT
    operator's fixed-order matvec it matches the f64 run to f32 rounding."""
    rng = np.random.default_rng(8)
    m, p = 300, 30
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    dq = rng.uniform(0.1, 0.5, m)
    op32 = tpl.make_kkt_operator(dq, u, v, p, dtype=jnp.float32)
    op64 = tpl.make_kkt_operator(dq, u, v, p, dtype=jnp.float64)
    b = rng.standard_normal(m + p)
    iv = (-3.0, 3.0)
    x32 = np.asarray(chebyshev_fAb(op32, jnp.asarray(b, jnp.float32), "exp",
                                   degree=30, interval=iv))
    x64 = np.asarray(chebyshev_fAb(op64, jnp.asarray(b), "exp", degree=30,
                                   interval=iv))
    np.testing.assert_allclose(x32, x64, rtol=2e-5,
                               atol=2e-5 * np.abs(x64).max())


def test_jit_composability():
    """chebyshev_fAb's runner nests inside an outer jit (operator is a
    pytree; coefficients are data)."""
    from two_pass_lanczos_tpu.algorithms.chebyshev import _chebyshev_run

    op, b_dev, d, b = _problem()
    cs = jnp.asarray(chebyshev_coefficients("inv", (1.0, 10.0), 60))
    scale = jnp.asarray([2.0 / 9.0, 11.0 / 9.0])

    @jax.jit
    def outer(o, bb):
        return _chebyshev_run(o, bb, cs, scale) * 2.0

    x = outer(op, b_dev)
    np.testing.assert_allclose(np.asarray(x), 2.0 * b / d, rtol=1e-9)


def test_sharded_interval_estimation_and_auto_chebyshev():
    """The mesh no longer needs a user interval: estimate_interval runs
    the DISTRIBUTED eigsh twice and matches the single-device estimator's
    semantics; chebyshev_fAb(interval=None) then solves correctly."""
    from two_pass_lanczos_tpu.parallel import (
        ShardedSparseOperator, make_mesh,
    )

    n = 222
    d = np.linspace(0.5, 8.0, n)
    idx = np.arange(n)
    sop = ShardedSparseOperator(n, idx, idx, np.asarray(d, np.float64),
                                make_mesh(2))
    a, b_hi = sop.estimate_interval()
    assert a <= 0.5 and b_hi >= 8.0       # contains the spectrum
    assert a > 0.0                         # SPD floor preserved (inv-safe)
    assert b_hi < 12.0                     # not absurdly wide
    rng = np.random.default_rng(3)
    vec = rng.standard_normal(n)
    x = sop.chebyshev_fAb(vec, "inv", degree=60)
    truth = vec / d
    rel = np.linalg.norm(np.asarray(x) - truth) / np.linalg.norm(truth)
    assert rel < 1e-6, rel
