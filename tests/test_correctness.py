"""Ground-truth correctness tests.

Reference parity: ``tests/correctness.rs`` — diagonal A so f(A)·b is analytic
(x_true_i = f(λ_i)·b_i); 6 tests = {inv, exp, z²} × {one-pass, two-pass} at
n=100, k=30, seeded b; tolerance tiering 1e-3 for analytic functions
(Gauss-quadrature-limited) and 1e-12 for the degree-2 polynomial where
k > deg(f) implies exactness (reference ``tests/correctness.rs:36-51,123-157``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import two_pass_lanczos_tpu as tpl

N = 100
K = 30
TOL_ANALYTIC = 1e-3
TOL_POLY = 1e-12


def _problem():
    eigs = np.arange(1.0, N + 1.0)
    rng = np.random.default_rng(12345)
    b = rng.standard_normal(N)
    op = tpl.DiagonalOperator(jnp.asarray(eigs))
    return op, jnp.asarray(b), eigs, b


CASES = [
    ("inv", tpl.make_inv_solver(), lambda lam: 1.0 / lam, TOL_ANALYTIC),
    ("exp", tpl.make_exp_solver(), np.exp, TOL_ANALYTIC),
    # f(z) = z^2 is exact once k > 2.
    ("poly2", tpl.make_poly_solver([0.0, 0.0, 1.0]), lambda lam: lam**2, TOL_POLY),
]


@pytest.mark.parametrize("name,solver,f_scalar,tol", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("method", ["one_pass", "two_pass"])
def test_correctness_vs_analytic(name, solver, f_scalar, tol, method):
    op, b, eigs, b_np = _problem()
    x_true = f_scalar(eigs) * b_np
    if method == "one_pass":
        x = tpl.lanczos(op, b, K, solver)
    else:
        x = tpl.lanczos_two_pass(op, b, K, solver)
    rel = np.linalg.norm(np.asarray(x) - x_true) / np.linalg.norm(x_true)
    assert rel < tol, f"{name}/{method}: relative error {rel:.3e} >= {tol}"


@pytest.mark.parametrize("f", ["exp", "inv"])
@pytest.mark.parametrize("method", ["one_pass", "two_pass"])
def test_jitted_fast_path_matches_host_path(f, method):
    op, b, eigs, b_np = _problem()
    solver = tpl.make_exp_solver() if f == "exp" else tpl.make_inv_solver()
    host = (
        tpl.lanczos(op, b, K, solver)
        if method == "one_pass"
        else tpl.lanczos_two_pass(op, b, K, solver)
    )
    fast = tpl.solve_fAb(op, b, k=K, f=f, method=method)
    host, fast = np.asarray(host), np.asarray(fast)
    rel = np.linalg.norm(fast - host) / np.linalg.norm(host)
    assert rel < 1e-12, f"fast path deviates from host path: {rel:.3e}"


def test_one_pass_vs_two_pass_deviation_machine_eps():
    # Reference observes ~1e-16 relative deviation at every k
    # (col 4 of all accuracy_*.csv).
    op, b, _, _ = _problem()
    solver = tpl.make_exp_solver()
    x1 = np.asarray(tpl.lanczos(op, b, K, solver))
    x2 = np.asarray(tpl.lanczos_two_pass(op, b, K, solver))
    dev = np.linalg.norm(x1 - x2) / np.linalg.norm(x1)
    assert dev < 1e-13


def test_doctest_example_4x4():
    # The analogue of the reference's crate-level doctest (src/lib.rs:35-84).
    a = jnp.array(
        [[2.0, 1, 0, 0], [1, 3, 1, 0], [0, 1, 4, 1], [0, 0, 1, 5]],
        dtype=jnp.float64,
    )
    b = jnp.array([1.0, 2.0, 3.0, 4.0], dtype=jnp.float64)
    op = tpl.as_operator(a)
    solver = tpl.make_inv_solver()
    x1 = np.asarray(tpl.lanczos(op, b, 4, solver))
    x2 = np.asarray(tpl.lanczos_two_pass(op, b, 4, solver))
    x_direct = np.linalg.solve(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(x1, x_direct, atol=1e-12)
    np.testing.assert_allclose(x1, x2, atol=1e-12)


def test_breakdown_truncates_solution_gracefully():
    # b lies in a 2-D invariant subspace: breakdown at step 2, but the
    # projected solution on that subspace is already exact for inv.
    diag = jnp.array([2.0, 2.0, 5.0, 5.0, 7.0], dtype=jnp.float64)
    b = jnp.array([1.0, 0.0, 1.0, 0.0, 0.0], dtype=jnp.float64)
    op = tpl.DiagonalOperator(diag)
    x = tpl.lanczos_two_pass(op, b, 5, tpl.make_inv_solver())
    x_true = np.asarray(b) / np.asarray(diag)
    np.testing.assert_allclose(np.asarray(x), x_true, atol=1e-12)
    decomp = tpl.lanczos_pass_one(op, b, 5)
    assert decomp.steps() == 2


def test_complex_hermitian_support():
    # Generic over complex fields like the reference (c64): build a random
    # Hermitian matrix and compare against a dense eigendecomposition.
    rng = np.random.default_rng(7)
    n, k = 40, 40
    m = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a_np = (m + m.conj().T) / 2
    b_np = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    lam, q = np.linalg.eigh(a_np)
    x_true = q @ (np.exp(lam) * (q.conj().T @ b_np))
    op = tpl.DenseOperator(jnp.asarray(a_np))
    x = tpl.lanczos_two_pass(op, jnp.asarray(b_np), k, tpl.make_exp_solver())
    rel = np.linalg.norm(np.asarray(x) - x_true) / np.linalg.norm(x_true)
    assert rel < 1e-10


def test_baseline_config1_exp_on_vendored_kkt():
    """BASELINE config 1: exp(A)b one-pass on a vendored netgen KKT pair
    (n ~ 1000 size class), k <= 100, f64 CPU — validated against a dense
    eigendecomposition oracle."""
    from pathlib import Path

    from two_pass_lanczos_tpu.utils.data_loader import load_kkt_arrays

    d = Path(__file__).resolve().parents[1] / "data" / "1000"
    dmx = sorted(d.glob("*.dmx"))
    if not dmx:
        pytest.skip("no vendored data/1000 instances")
    arrays = load_kkt_arrays(dmx[0], dmx[0].with_suffix(".qfc"))
    m, p = arrays.num_arcs, arrays.num_nodes
    n = arrays.n

    # scale the spectrum so exp() stays in range: A has quad costs up to
    # ~1e5; use A / ||d||_inf
    scale = float(np.max(arrays.quad_costs))
    dsc = arrays.quad_costs / scale
    op = tpl.make_kkt_operator(dsc, arrays.arc_u, arrays.arc_v, p, dtype=jnp.float64)
    rng = np.random.default_rng(7)
    b = rng.standard_normal(n)

    x = np.asarray(tpl.solve_fAb(op, jnp.asarray(b), k=100, f="exp",
                                 method="one_pass"))

    # dense oracle
    a = np.zeros((n, n))
    a[np.arange(m), np.arange(m)] = dsc
    a[arrays.arc_u + m, np.arange(m)] += 1.0
    a[arrays.arc_v + m, np.arange(m)] -= 1.0
    a[np.arange(m), arrays.arc_u + m] += 1.0
    a[np.arange(m), arrays.arc_v + m] -= 1.0
    lam, q = np.linalg.eigh(a)
    x_true = q @ (np.exp(lam) * (q.T @ b))
    rel = np.linalg.norm(x - x_true) / np.linalg.norm(x_true)
    assert rel < 1e-6, rel
