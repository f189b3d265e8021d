"""Multi-function evaluation from one decomposition.

The reference computes one f(A)b per Lanczos run (``src/solvers.rs:46,133``);
this library evaluates a stack of matrix functions from the SAME
decomposition — the Krylov work (all the matvecs) is shared, only the
per-step accumulate fans out. Pinned here: (1) each multi slice is
bit-identical to its single-f run on the two-pass paths (the replay
arithmetic is independent of y); (2) nf functions cost k (one-pass) /
2k (two-pass) matvecs, not nf times that; (3) the row-partitioned
distributed path produces the same stack.
"""

import numpy as np
import pytest

import two_pass_lanczos_tpu as tpl
from test_chunked import CountingOperator, _problem


def _solvers():
    return tpl.make_inv_solver(), tpl.make_exp_solver(), \
        tpl.make_poly_solver([0.0, 0.0, 1.0])


def test_two_pass_multi_bit_identical_to_singles():
    op, b = _problem(n=80, seed=11)
    k = 25
    solvers = _solvers()
    x_multi = tpl.lanczos_two_pass(op, b, k, list(solvers))
    assert x_multi.shape == (3, 80)
    for i, s in enumerate(solvers):
        x_single = tpl.lanczos_two_pass(op, b, k, s)
        np.testing.assert_array_equal(np.asarray(x_multi[i]),
                                      np.asarray(x_single))


def test_one_pass_multi_matches_singles():
    op, b = _problem(n=80, seed=12)
    k = 25
    solvers = _solvers()
    x_multi = tpl.lanczos(op, b, k, list(solvers))
    assert x_multi.shape == (3, 80)
    for i, s in enumerate(solvers):
        x_single = np.asarray(tpl.lanczos(op, b, k, s))
        # GEMV vs GEMM reassociation: allclose, not bit-equal
        np.testing.assert_allclose(np.asarray(x_multi[i]), x_single,
                                   rtol=0, atol=1e-12 * np.abs(x_single).max())


@pytest.mark.parametrize("method", ["one_pass", "two_pass"])
def test_solve_fAb_multi(method):
    op, b = _problem(n=60, seed=13)
    fs = ("inv", "exp")
    x_multi = tpl.solve_fAb(op, b, k=20, f=fs, method=method)
    assert x_multi.shape == (2, 60)
    for i, f in enumerate(fs):
        x_single = np.asarray(tpl.solve_fAb(op, b, k=20, f=f, method=method))
        np.testing.assert_allclose(np.asarray(x_multi[i]), x_single,
                                   rtol=0, atol=1e-12 * np.abs(x_single).max())


def test_multi_f_shares_matvecs():
    """3 functions, two-pass: exactly 2k matvecs total (not 6k)."""
    import jax

    op, b = _problem(n=50, seed=14)
    k = 12
    counting = CountingOperator(op)
    tpl.lanczos_two_pass(counting, b, k, list(_solvers()))
    jax.effects_barrier()
    assert counting.count == 2 * k - 1  # pass one: k, pass two: k-1


def test_multi_f_solver_validation():
    """Each closure in the stack is dimension-validated like a single one."""
    op, b = _problem(n=40, seed=15)
    bad = lambda a, b_: np.zeros(3)  # noqa: E731 — wrong length
    with pytest.raises(tpl.ParameterMismatchError):
        tpl.lanczos_two_pass(op, b, 10, [tpl.make_inv_solver(), bad])


class TestShardedMultiF:
    """Multi-f on both distributed designs (virtual mesh)."""

    def _kkt(self, seed=7, m=500, p=200):
        rng = np.random.default_rng(seed)
        u = rng.integers(0, p, m).astype(np.int32)
        v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
        d = rng.uniform(1.0, 3.0, m).astype(np.float32)
        b = rng.standard_normal(m + p).astype(np.float32)
        return d, u, v, p, b

    @pytest.mark.parametrize("method", ["one_pass", "two_pass"])
    def test_generic_row_partition(self, method):
        from two_pass_lanczos_tpu.parallel import (
            ShardedSparseOperator, make_mesh)

        n = 160
        diag = np.linspace(1.0, 10.0, n)
        idx = np.arange(n, dtype=np.int64)
        sop = ShardedSparseOperator(n, idx, idx, diag, make_mesh(4))
        b = np.random.default_rng(8).standard_normal(n)
        fs = ("inv", "exp")
        x_multi, dec = sop.solve_fAb(b, k=20, f=fs, method=method)
        assert x_multi.shape == (2, n)
        for i, f in enumerate(fs):
            x_single, _ = sop.solve_fAb(b, k=20, f=f, method=method)
            np.testing.assert_allclose(
                x_multi[i], x_single, rtol=0,
                atol=1e-12 * np.abs(x_single).max())
