"""Auxiliary subsystem tests: callbacks, checkpoint/resume, SoL accounting."""

import jax.numpy as jnp
import numpy as np
import pytest

import two_pass_lanczos_tpu as tpl
from two_pass_lanczos_tpu.checkpoint import load_decomposition, save_decomposition
from two_pass_lanczos_tpu.observability import (
    find_stopping_point,
    kkt_spmv_sol,
    peak_hbm_bandwidth,
    replay_iterations,
    truncate_decomposition,
)


def _problem(n=200, k=25):
    rng = np.random.default_rng(9)
    m = rng.standard_normal((n, n))
    op = tpl.as_operator(jnp.asarray((m + m.T) / 2))
    b = jnp.asarray(rng.standard_normal(n))
    return op, b, k


def test_callback_replay_views():
    op, b, k = _problem()
    decomp, basis = tpl.lanczos_standard(op, b, k)
    seen = []

    def cb(step, v_view, tk):
        alphas, betas = tk
        assert v_view.shape == (step, op.shape[0])
        assert alphas.shape == (step,)
        assert betas.shape == (max(step - 1, 0),)
        seen.append(step)
        return True

    visited = replay_iterations(decomp, cb, basis)
    assert visited == k
    assert seen == list(range(1, k + 1))


def test_callback_early_stop_and_truncation():
    op, b, k = _problem()
    decomp = tpl.lanczos_pass_one(op, b, k)

    # stop when the off-diagonal falls below a threshold — a convergence
    # monitor like the reference's callback contract supports.
    def cb(step, _v, tk):
        return step < 10

    stop = find_stopping_point(decomp, cb)
    assert stop == 10
    trunc = truncate_decomposition(decomp, stop)
    assert trunc.steps() == 10
    assert np.all(np.asarray(trunc.alphas)[10:] == 0)
    np.testing.assert_allclose(
        trunc.alphas_valid(), decomp.alphas_valid()[:10], rtol=0, atol=0
    )
    # the truncated decomposition drives a valid (shorter) second pass
    y = jnp.ones((trunc.k_max,), b.dtype)
    x = tpl.lanczos_pass_two(op, b, trunc, y)
    assert np.all(np.isfinite(np.asarray(x)))


def test_checkpoint_roundtrip(tmp_path):
    op, b, k = _problem()
    decomp = tpl.lanczos_pass_one(op, b, k)
    f = tmp_path / "pass_one.npz"
    save_decomposition(f, decomp)
    loaded = load_decomposition(f)
    np.testing.assert_array_equal(np.asarray(loaded.alphas), np.asarray(decomp.alphas))
    np.testing.assert_array_equal(np.asarray(loaded.betas), np.asarray(decomp.betas))
    assert loaded.steps() == decomp.steps()

    # resume: pass two from the loaded checkpoint equals a fresh two-pass run
    solver = tpl.make_exp_solver()
    y = solver(loaded.alphas_valid(), loaded.betas_valid())
    y_full = np.zeros(k)
    y_full[: loaded.steps()] = np.asarray(y)
    y_dev = jnp.asarray(y_full) * loaded.b_norm
    x_resumed = tpl.lanczos_pass_two(op, b, loaded, y_dev)
    x_fresh = tpl.lanczos_two_pass(op, b, k, solver)
    np.testing.assert_allclose(np.asarray(x_resumed), np.asarray(x_fresh), rtol=1e-12)


H100 = "NVIDIA H100 80GB HBM3"


def test_sol_report():
    rep = kkt_spmv_sol(500_000, 1155, achieved_seconds=2e-3, device_kind=H100)
    assert rep.nnz == 2_500_000
    assert 0 < rep.sol_fraction < 1
    assert "speed of light" in str(rep)
    # 500k arcs x (2 int32 + 3 f64) + 2 node vectors, over 3.35 TB/s
    rep64 = kkt_spmv_sol(500_000, 1155, achieved_seconds=2e-3,
                         device_kind=H100, dtype_bytes=8)
    assert rep64.bytes_per_matvec == 500_000 * 32 + 2 * 1155 * 8
    assert rep64.sol_seconds == rep64.bytes_per_matvec / 3.35e12


def test_peak_table_knows_the_h100():
    assert peak_hbm_bandwidth(H100) == 3.35e12


def test_peak_table_refuses_unknown_kinds():
    with pytest.raises(KeyError, match="no published memory bandwidth"):
        peak_hbm_bandwidth("cpu")
    with pytest.raises(KeyError):
        kkt_spmv_sol(10, 2, achieved_seconds=1.0, device_kind="NVIDIA A100-SXM4-40GB")


class TestErrorMessages:
    """Exact message-format tests, the reference's Display tier
    (``src/error.rs:69-129``)."""

    def test_breakdown(self):
        e = tpl.BreakdownError(7)
        assert str(e) == ("Numerical breakdown occurred at iteration 7: beta "
                          "is numerically zero (the Krylov subspace is "
                          "invariant).")
        assert e.k == 7

    def test_dimension_mismatch(self):
        e = tpl.DimensionMismatchError(10, 5, "vector b")
        assert str(e) == "Dimension mismatch for vector b: expected 10, got 5."

    def test_parameter_mismatch(self):
        e = tpl.ParameterMismatchError("y_k_prime", 30, 29)
        assert str(e) == ("Parameter 'y_k_prime' has mismatched size: "
                          "expected 30, got 29.")

    def test_hierarchy(self):
        for cls in (tpl.BreakdownError, tpl.DimensionMismatchError,
                    tpl.InputError, tpl.ParameterMismatchError,
                    tpl.EvdError, tpl.SolverError):
            assert issubclass(cls, tpl.LanczosError)


def test_readme_quickstart():
    """The crate-level doctest of the reference (``src/lib.rs:35-84``):
    a 4x4 runnable example where one-pass and two-pass agree to 1e-12."""
    import jax.numpy as jnp

    a = jnp.array([[2.0, 1, 0, 0], [1, 3, 1, 0], [0, 1, 4, 1], [0, 0, 1, 5]])
    b = jnp.array([1.0, 2.0, 3.0, 4.0])
    op = tpl.as_operator(a)
    x1 = tpl.lanczos(op, b, 4, tpl.make_inv_solver())
    x2 = tpl.lanczos_two_pass(op, b, 4, tpl.make_inv_solver())
    assert float(jnp.linalg.norm(x1 - x2)) < 1e-12
    # and against a dense solve
    x_true = jnp.linalg.solve(a, b)
    assert float(jnp.linalg.norm(x1 - x_true)) < 1e-10
