"""Thick-restart Lanczos eigensolver (two_pass_lanczos_tpu.eigen).

Beyond the reference (it ships no eigensolver); ground truths are analytic
diagonal spectra and dense eigendecompositions — the reference's own test
methodology (``tests/correctness.rs:1-23``). Residual norms returned by
``eigsh`` are rigorous (Arnoldi-relation identity), so every test also
cross-checks them against real matvecs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import two_pass_lanczos_tpu as tpl
from two_pass_lanczos_tpu.eigen import eigsh


def _diag_op(d):
    return tpl.DiagonalOperator(jnp.asarray(d, jnp.float64))


def _check_pairs(res, a_apply, tol=1e-7):
    """Verify returned residual norms against real matvecs and unit norms."""
    for theta, u, r in zip(res.eigenvalues, res.eigenvectors,
                           res.residual_norms):
        assert np.linalg.norm(u) == pytest.approx(1.0, abs=1e-10)
        true_resid = np.linalg.norm(a_apply(u) - theta * u)
        assert true_resid == pytest.approx(r, rel=1e-4, abs=1e-9)


def test_largest_algebraic_diagonal():
    n = 500
    d = np.linspace(0.1, 100.0, n)
    res = eigsh(_diag_op(d), nev=5, which="LA", tol=1e-10)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, np.sort(d)[-5:], rtol=1e-9)
    assert np.all(np.diff(res.eigenvalues) > 0)
    _check_pairs(res, lambda u: d * u)


def test_smallest_algebraic_diagonal():
    n = 400
    d = np.linspace(1.0, 50.0, n)
    res = eigsh(_diag_op(d), nev=4, which="SA", tol=1e-10, maxiter=300)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, np.sort(d)[:4], rtol=1e-8)
    _check_pairs(res, lambda u: d * u)


def test_largest_magnitude_indefinite():
    """LM on an indefinite spectrum must pick from both ends."""
    d = np.concatenate([np.linspace(-99.0, -1.0, 150),
                        np.linspace(1.0, 100.0, 150)])
    res = eigsh(_diag_op(d), nev=4, which="LM", tol=1e-10)
    assert res.converged
    truth = d[np.argsort(np.abs(d))[-4:]]
    np.testing.assert_allclose(res.eigenvalues, np.sort(truth), rtol=1e-9)
    assert res.eigenvalues[0] < 0 < res.eigenvalues[-1]
    _check_pairs(res, lambda u: d * u)


def test_eigenvectors_match_analytic():
    """On a diagonal operator every eigenvector is ±e_i: check alignment."""
    n = 300
    d = np.linspace(1.0, 30.0, n)
    res = eigsh(_diag_op(d), nev=3, which="LA", tol=1e-11)
    assert res.converged
    for j, u in enumerate(res.eigenvectors):
        i_true = n - 3 + j
        assert abs(u[i_true]) == pytest.approx(1.0, abs=1e-7)


def test_dense_spd_against_numpy():
    n = 200
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(0.5, 60.0, n)
    a = (q * lam) @ q.T
    op = tpl.DenseOperator(jnp.asarray(a, jnp.float64))
    res = eigsh(op, nev=6, which="LA", tol=1e-10)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, lam[-6:], rtol=1e-8)
    _check_pairs(res, lambda u: a @ u)
    # eigenvector quality: |<u_computed, q_true>| ~ 1 (distinct eigenvalues)
    for j, u in enumerate(res.eigenvectors):
        assert abs(u @ q[:, n - 6 + j]) == pytest.approx(1.0, abs=1e-6)


def test_kkt_operator_extreme_pairs():
    """Sparse indefinite KKT system vs a dense oracle."""
    rng = np.random.default_rng(3)
    m, p = 600, 40
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    dq = rng.uniform(1.0, 3.0, m)
    op = tpl.make_kkt_operator(dq, u, v, p, dtype=jnp.float64)
    n = m + p
    a = np.zeros((n, n))
    a[np.arange(m), np.arange(m)] = dq
    np.add.at(a, (u + m, np.arange(m)), 1.0)
    np.add.at(a, (v + m, np.arange(m)), -1.0)
    a[:m, m:] = a[m:, :m].T
    lam = np.linalg.eigvalsh(a)
    res = eigsh(op, nev=3, which="LA", tol=1e-9, maxiter=300)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, lam[-3:], rtol=1e-7)
    _check_pairs(res, lambda x: a @ x)


def test_invariant_subspace_random_injection():
    """v0 = an exact eigenvector: the Krylov space is 1-D invariant from
    step one. A plain single-vector method can never leave it; the random
    injection must discover the other wanted pairs."""
    d = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    v0 = jnp.zeros(6, jnp.float64).at[5].set(1.0)  # eigenvector of 6.0
    res = eigsh(_diag_op(d), nev=3, which="LA", ncv=5, v0=v0, tol=1e-10)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, [4.0, 5.0, 6.0], rtol=1e-9)
    _check_pairs(res, lambda u: d * u)


def test_degenerate_eigenvalue_copies_found():
    """Multiplicity > 1: one starting vector sees one copy per eigenvalue;
    the injections surface the degenerate copies, so LA with nev=3 on a
    spectrum whose top eigenvalue has multiplicity 40 correctly returns
    three (mutually orthogonal) copies of it."""
    d = np.array([1.0, 2.0, 3.0] * 40)
    res = eigsh(_diag_op(d), nev=3, which="LA", ncv=12, tol=1e-10)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, [3.0, 3.0, 3.0], rtol=1e-9)
    gram = res.eigenvectors @ res.eigenvectors.T
    np.testing.assert_allclose(gram, np.eye(3), atol=1e-8)
    _check_pairs(res, lambda u: d * u)


def test_full_dimension_ncv_equals_n():
    d = np.array([3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.3, 5.8])
    res = eigsh(_diag_op(d), nev=2, ncv=8, which="SA", tol=1e-12)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, np.sort(d)[:2], rtol=1e-10)


def test_deterministic_given_key():
    d = np.linspace(1.0, 20.0, 100)
    r1 = eigsh(_diag_op(d), nev=3, key=jax.random.key(5))
    r2 = eigsh(_diag_op(d), nev=3, key=jax.random.key(5))
    np.testing.assert_array_equal(r1.eigenvalues, r2.eigenvalues)
    np.testing.assert_array_equal(r1.eigenvectors, r2.eigenvectors)


def test_v0_seeding_and_validation():
    d = np.linspace(1.0, 10.0, 50)
    op = _diag_op(d)
    res = eigsh(op, nev=2, v0=jnp.ones(50, jnp.float64), tol=1e-10)
    assert res.converged
    with pytest.raises(ValueError, match="nonzero"):
        eigsh(op, nev=2, v0=jnp.zeros(50, jnp.float64))
    with pytest.raises(ValueError, match="which"):
        eigsh(op, nev=2, which="BE")
    with pytest.raises(ValueError, match="nev"):
        eigsh(op, nev=0)
    with pytest.raises(ValueError, match="ncv"):
        eigsh(op, nev=2, ncv=2)
    with pytest.raises(ValueError, match="exceeds"):
        eigsh(op, nev=51)
    with pytest.raises(ValueError, match="maxiter"):
        eigsh(op, nev=2, maxiter=0)


def test_unconverged_reports_honestly():
    """One restart on a hard spectrum: converged=False and the residuals
    are still rigorous (checked against real matvecs)."""
    n = 2000
    d = np.linspace(1.0, 2.0, n)  # flat spectrum: slow extreme convergence
    res = eigsh(_diag_op(d), nev=4, which="LA", ncv=12, maxiter=1, tol=1e-14)
    assert not res.converged
    assert res.restarts == 1
    _check_pairs(res, lambda u: d * u)


def test_complex_hermitian_eigsh():
    """Self-adjoint genericity: extreme eigenpairs of a complex Hermitian
    A = Q·diag(d)·Qᴴ (real spectrum, complex eigenvectors), rigorous
    residuals cross-checked against real complex matvecs."""
    n = 60
    d = np.concatenate([np.linspace(1.0, 8.0, n - 2), [11.0, 12.0]])
    rng = np.random.default_rng(77)
    m = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    q, _ = np.linalg.qr(m)
    a_np = (q * d) @ q.conj().T
    a_np = (a_np + a_np.conj().T) / 2
    op = tpl.DenseOperator(jnp.asarray(a_np))
    res = eigsh(op, nev=2, which="LA", tol=1e-10, maxiter=200)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, [11.0, 12.0], rtol=1e-8)
    assert np.iscomplexobj(res.eigenvectors)
    # norms stay REAL for complex A (the documented residual contract)
    assert not np.iscomplexobj(res.residual_norms)
    _check_pairs(res, lambda u: a_np @ u)
