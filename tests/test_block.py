"""Block Lanczos (two_pass_lanczos_tpu.algorithms.block).

Oracles: analytic diagonal truths, agreement with the single-vector
solvers per column (p=1 must coincide with the β>0-normalized standard
recurrence), and the capability single-vector Krylov provably lacks —
resolving eigenvalue multiplicities ≤ p (the reference methodology of
``tests/correctness.rs:1-23`` extended to blocks)."""

import jax.numpy as jnp
import numpy as np
import pytest

import two_pass_lanczos_tpu as tpl
from two_pass_lanczos_tpu.algorithms.block import (
    block_pass_one,
    solve_fAb_block,
)


def _diag_op(d):
    return tpl.DiagonalOperator(jnp.asarray(d, jnp.float64))


def test_p1_matches_single_vector_recurrence():
    """Width-1 blocks: the QR-with-positive-diagonal convention reduces to
    the β > 0 normalization — (α, β) match the core scan bit-for-bit up
    to the n-dependent reduction order (same dtype, rel 1e-13)."""
    n, k = 200, 30
    d = np.linspace(1.0, 9.0, n)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)
    op = _diag_op(d)
    dec1 = tpl.lanczos_pass_one(op, jnp.asarray(b), k)
    decb, _ = block_pass_one(op.matvec, jnp.asarray(b)[:, None], k)
    assert int(decb.steps_taken) == dec1.steps()
    np.testing.assert_allclose(np.asarray(decb.a_blocks)[:, 0, 0],
                               np.asarray(dec1.alphas), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(decb.b_blocks)[:k - 1, 0, 0],
                               np.asarray(dec1.betas)[:k - 1], rtol=1e-11)
    assert float(decb.r0[0, 0]) == pytest.approx(float(dec1.b_norm),
                                                 rel=1e-14)


def test_block_fAB_matches_analytic_exp_and_inv():
    n, p, k = 300, 4, 40
    d = np.linspace(0.5, 6.0, n)
    rng = np.random.default_rng(1)
    B = rng.standard_normal((n, p))
    op = _diag_op(d)
    for f, truth in (("exp", np.exp(d)[:, None] * B),
                     ("inv", B / d[:, None])):
        x = solve_fAb_block(op, jnp.asarray(B), k, f)
        rel = np.linalg.norm(np.asarray(x) - truth) / np.linalg.norm(truth)
        assert rel < 1e-10, (f, rel)


def test_block_matches_per_column_single_solves():
    n, p, k = 250, 3, 50
    d = np.linspace(1.0, 12.0, n)
    rng = np.random.default_rng(2)
    B = rng.standard_normal((n, p))
    op = _diag_op(d)
    x_blk = np.asarray(solve_fAb_block(op, jnp.asarray(B), k, "inv"))
    for j in range(p):
        x_col = np.asarray(tpl.solve_fAb(op, jnp.asarray(B[:, j]), k=k,
                                         f="inv", method="one_pass"))
        rel = np.linalg.norm(x_blk[:, j] - x_col) / np.linalg.norm(x_col)
        assert rel < 1e-9, (j, rel)


def test_block_resolves_multiplicity_in_few_steps():
    """3 distinct eigenvalues, each of multiplicity 2, block width 2:
    the block space is A-invariant after 3 block steps and the answer is
    exact — single-vector Krylov cannot even represent both copies."""
    d = np.array([1.0, 1.0, 2.0, 2.0, 5.0, 5.0] * 20)
    n = len(d)
    rng = np.random.default_rng(3)
    B = rng.standard_normal((n, 2))
    op = _diag_op(d)
    decomp, _ = block_pass_one(op.matvec, jnp.asarray(B), 10)
    # breakdown (invariant block subspace) strictly before 10 steps
    assert 3 <= int(decomp.steps_taken) <= 6
    x = solve_fAb_block(op, jnp.asarray(B), 10, "inv")
    np.testing.assert_allclose(np.asarray(x), B / d[:, None], rtol=1e-10)


def test_basis_block_orthonormality():
    n, p, k = 300, 3, 30
    d = np.linspace(0.1, 40.0, n)
    rng = np.random.default_rng(4)
    B = rng.standard_normal((n, p))
    decomp, basis = block_pass_one(_diag_op(d).matvec, jnp.asarray(B), k)
    s = int(decomp.steps_taken)
    v = np.asarray(basis)[:s].transpose(1, 0, 2).reshape(n, s * p)
    g = v.T @ v
    assert np.max(np.abs(g - np.eye(s * p))) < 1e-8


def test_zero_and_rank_deficient_b():
    op = _diag_op(np.linspace(1.0, 2.0, 16))
    x0 = solve_fAb_block(op, jnp.zeros((16, 2), jnp.float64), 4, "inv")
    np.testing.assert_array_equal(np.asarray(x0), np.zeros((16, 2)))
    # rank-1 block of width 2: initial QR is rank deficient -> zeros
    rng = np.random.default_rng(5)
    col = rng.standard_normal(16)
    b_def = np.stack([col, 2.0 * col], axis=1)
    decomp, _ = block_pass_one(op.matvec, jnp.asarray(b_def), 4)
    assert int(decomp.steps_taken) == 0


def test_validation():
    op = _diag_op(np.ones(8))
    with pytest.raises(ValueError, match="k must be"):
        block_pass_one(op.matvec, jnp.ones((8, 2), jnp.float64), 0)
    with pytest.raises(ValueError, match="must be \\(n, p\\)"):
        block_pass_one(op.matvec, jnp.ones(8, jnp.float64), 4)
    with pytest.raises(ValueError, match="unknown function"):
        solve_fAb_block(op, jnp.ones((8, 2), jnp.float64), 4, "huh")


def _hermitian_pair(n, d, seed):
    """A = Q·diag(d)·Qᴴ with a random unitary Q — known-spectrum complex
    Hermitian oracle (the ``test_correctness.py`` c64 pattern)."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    q, _ = np.linalg.qr(m)
    a_np = (q * d) @ q.conj().T
    a_np = (a_np + a_np.conj().T) / 2
    return a_np, q


def test_complex_hermitian_block():
    """Self-adjoint genericity, block edition: f(A)·B on a complex
    Hermitian A with an eigenvalue of multiplicity 2 — resolved within
    the width-2 block space, validated against the dense oracle."""
    n, p, k = 48, 2, 24
    d = np.concatenate([[1.0, 1.0, 2.5], np.linspace(3.0, 9.0, n - 3)])
    a_np, q = _hermitian_pair(n, d, 11)
    rng = np.random.default_rng(12)
    B = rng.standard_normal((n, p)) + 1j * rng.standard_normal((n, p))
    op = tpl.DenseOperator(jnp.asarray(a_np))
    truth = (q * (1.0 / d)) @ (q.conj().T @ B)
    for method in ("one_pass", "two_pass"):
        x = np.asarray(solve_fAb_block(op, jnp.asarray(B), k, "inv",
                                       method=method))
        rel = np.linalg.norm(x - truth) / np.linalg.norm(truth)
        assert rel < 1e-9, (method, rel)


def test_complex_block_breakdown_truncates():
    """Invariant-subspace truncation holds over ℂ: three distinct
    eigenvalues, width-2 complex block => steps_taken == 3."""
    d = np.array([1.0, 1.0, 2.0, 2.0, 5.0, 5.0] * 8)
    a_np, _ = _hermitian_pair(len(d), d, 13)
    rng = np.random.default_rng(14)
    B = rng.standard_normal((len(d), 2)) + 1j * rng.standard_normal(
        (len(d), 2))
    op = tpl.DenseOperator(jnp.asarray(a_np))
    decomp, _ = block_pass_one(op.matvec, jnp.asarray(B), 10)
    assert int(decomp.steps_taken) == 3
    # the stored blocks are a valid Hermitian T: the solve matches truth
    x = np.asarray(solve_fAb_block(op, jnp.asarray(B), 10, "inv"))
    lam, q = np.linalg.eigh(a_np)
    truth = (q * (1.0 / lam)) @ (q.conj().T @ B)
    assert np.linalg.norm(x - truth) / np.linalg.norm(truth) < 1e-9


def test_small_norm_f32_block_is_valid_input():
    """Regression: the rank tests are scale-relative — an f32 block with
    tiny (but well-conditioned) column norms must solve correctly, not be
    silently zeroed by an absolute ε cut (the zero_tolerance rationale)."""
    n, p = 64, 2
    d = np.linspace(1.0, 4.0, n)
    rng = np.random.default_rng(9)
    B = (1e-5 * rng.standard_normal((n, p))).astype(np.float32)
    op = tpl.DiagonalOperator(jnp.asarray(d, jnp.float32))
    decomp, _ = block_pass_one(op.matvec, jnp.asarray(B), 20)
    assert int(decomp.steps_taken) > 0
    x = np.asarray(solve_fAb_block(op, jnp.asarray(B), 20, "inv"),
                   np.float64)
    truth = B.astype(np.float64) / d[:, None]
    rel = np.linalg.norm(x - truth) / np.linalg.norm(truth)
    assert rel < 1e-4, rel


def test_pass_two_replay_matches_pass_one():
    """The two-pass replay regenerates pass one's basis to ≤ ~1 ulp/step
    (same op sequence, same stored-R normalization; bitwise equality is
    not guaranteed across separately compiled GEMM programs — see the
    block_pass_two docstring; the single-vector path's drift == 0
    guarantee is pinned elsewhere)."""
    from two_pass_lanczos_tpu.algorithms.block import block_pass_two

    n, p, k = 200, 3, 25
    d = np.linspace(0.5, 30.0, n)
    rng = np.random.default_rng(11)
    B = jnp.asarray(rng.standard_normal((n, p)))
    op = _diag_op(d)
    decomp, basis1 = block_pass_one(op.matvec, B, k)
    y_dummy = jnp.zeros((k, p, p), B.dtype)
    _, basis2 = block_pass_two(op.matvec, B, decomp, y_dummy,
                               emit_basis=True)
    drift = np.max(np.abs(np.asarray(basis1) - np.asarray(basis2)))
    assert drift < 1e-12, drift


def test_two_pass_matches_one_pass_solution():
    n, p, k = 260, 3, 40
    d = np.linspace(0.8, 9.0, n)
    rng = np.random.default_rng(12)
    B = rng.standard_normal((n, p))
    op = _diag_op(d)
    for f in ("inv", "exp"):
        x1 = np.asarray(solve_fAb_block(op, jnp.asarray(B), k, f,
                                        method="one_pass"))
        x2 = np.asarray(solve_fAb_block(op, jnp.asarray(B), k, f,
                                        method="two_pass"))
        rel = np.linalg.norm(x1 - x2) / np.linalg.norm(x1)
        assert rel < 1e-12, (f, rel)
    with pytest.raises(ValueError, match="unknown method"):
        solve_fAb_block(op, jnp.asarray(B), k, "inv", method="three_pass")


def test_two_pass_after_breakdown():
    """Breakdown (invariant block subspace): the replay honors
    steps_taken and the two-pass result is exact like the one-pass."""
    d = np.array([1.0, 1.0, 2.0, 2.0, 5.0, 5.0] * 20)
    rng = np.random.default_rng(13)
    B = rng.standard_normal((len(d), 2))
    op = _diag_op(d)
    x = np.asarray(solve_fAb_block(op, jnp.asarray(B), 10, "inv",
                                   method="two_pass"))
    np.testing.assert_allclose(x, B / d[:, None], rtol=1e-10)


def test_pass_one_no_basis_mode():
    op = _diag_op(np.linspace(1.0, 5.0, 50))
    B = jnp.asarray(np.random.default_rng(14).standard_normal((50, 2)))
    decomp, basis = block_pass_one(op.matvec, B, 8, emit_basis=False)
    assert basis is None
    assert int(decomp.steps_taken) == 8


class TestShardedBlock:
    """Distributed block Lanczos (CholeskyQR2 over the row partition)."""

    @staticmethod
    def _diag_sharded(d, ndev):
        from two_pass_lanczos_tpu.parallel import (
            ShardedSparseOperator, make_mesh,
        )

        n = len(d)
        idx = np.arange(n)
        return ShardedSparseOperator(n, idx, idx, np.asarray(d, np.float64),
                                     make_mesh(ndev))

    @pytest.mark.parametrize("ndev", [1, 2, 8])
    def test_matches_single_device_and_truth(self, ndev):
        n, p, k = 333, 3, 30  # non-multiple of ndev: real padding rows
        d = np.linspace(0.5, 12.0, n)
        rng = np.random.default_rng(21)
        B = rng.standard_normal((n, p))
        sop = self._diag_sharded(d, ndev)
        x = sop.solve_fAb_block(B, k=k, f="inv")
        truth = B / d[:, None]
        rel = np.linalg.norm(np.asarray(x) - truth) / np.linalg.norm(truth)
        assert rel < 1e-5, rel  # Krylov convergence at k=30, kappa=24
        op1 = tpl.DiagonalOperator(jnp.asarray(d, jnp.float64))
        x1 = np.asarray(solve_fAb_block(op1, jnp.asarray(B), k, "inv"))
        # CholeskyQR2 vs Householder QR: same math, different rounding —
        # the implementations agree far below the Krylov error
        rel_vs = np.linalg.norm(np.asarray(x) - x1) / np.linalg.norm(x1)
        assert rel_vs < 1e-10, rel_vs

    def test_breakdown_multiplicity(self):
        d = np.array([1.0, 1.0, 2.0, 2.0, 5.0, 5.0] * 20)
        rng = np.random.default_rng(22)
        B = rng.standard_normal((len(d), 2))
        sop = self._diag_sharded(d, 4)
        x = sop.solve_fAb_block(B, k=10, f="inv")
        np.testing.assert_allclose(np.asarray(x), B / d[:, None],
                                   rtol=1e-9)
        # Invariant-subspace breakdown must TRUNCATE (three distinct
        # eigenvalues, width-2 block => the space is exhausted at s=3);
        # the rank test needs the external max|diag(a_j)| scale to see it
        # (an eps*||A|| residual block's own diagonal ratio is O(1)).
        decomp, _ = block_pass_one(
            tpl.DiagonalOperator(jnp.asarray(d, jnp.float64)).matvec,
            jnp.asarray(B), 10)
        assert int(decomp.steps_taken) == 3
        assert sop._last_block_steps == int(decomp.steps_taken)

    def test_rank_deficient_b_zeros(self):
        d = np.linspace(1.0, 2.0, 64)
        col = np.random.default_rng(23).standard_normal(64)
        B = np.stack([col, 3.0 * col], axis=1)  # rank 1
        sop = self._diag_sharded(d, 2)
        x = sop.solve_fAb_block(B, k=5, f="inv")
        np.testing.assert_array_equal(np.asarray(x), np.zeros((64, 2)))

    def test_validation(self):
        sop = self._diag_sharded(np.ones(16), 2)
        with pytest.raises(ValueError, match="b_block must be"):
            sop.solve_fAb_block(np.ones(16), k=4)
        with pytest.raises(ValueError, match="rows"):
            sop.solve_fAb_block(np.ones((8, 2)), k=4)
        with pytest.raises(ValueError, match="unknown function"):
            sop.solve_fAb_block(np.ones((16, 2)), k=4, f="nope")
        # parity with the single-device block_pass_one validation
        with pytest.raises(ValueError, match="k must be >= 1"):
            sop.solve_fAb_block(np.ones((16, 2)), k=0)
        with pytest.raises(ValueError, match="block width"):
            sop.solve_fAb_block(np.ones((16, 0)), k=4)
        with pytest.raises(TypeError, match="complex b_block with a real"):
            sop.solve_fAb_block(np.ones((16, 2), np.complex128), k=4)


def test_complex_hermitian_sharded_block():
    """Distributed block Lanczos over ℂ: CholeskyQR2 with Hermitian Gram
    psums matches the dense oracle (2-device mesh, complex COO)."""
    from two_pass_lanczos_tpu.parallel import (
        ShardedSparseOperator, make_mesh,
    )

    n, p, k = 48, 2, 24
    d = np.concatenate([[1.0, 1.0, 2.5], np.linspace(3.0, 9.0, n - 3)])
    a_np, q = _hermitian_pair(n, d, 31)
    rows, cols = np.nonzero(np.ones((n, n), bool))
    sop = ShardedSparseOperator(n, rows, cols, a_np[rows, cols],
                                make_mesh(2))
    rng = np.random.default_rng(32)
    B = rng.standard_normal((n, p)) + 1j * rng.standard_normal((n, p))
    x = sop.solve_fAb_block(B, k=k, f="inv")
    truth = (q * (1.0 / d)) @ (q.conj().T @ B)
    rel = np.linalg.norm(np.asarray(x) - truth) / np.linalg.norm(truth)
    assert rel < 1e-9, rel


class TestJittableBlockSolve:
    """solve_fAb_block_jit: fixed shapes end-to-end — composes inside an
    outer jit and matches the host-orchestrated solver."""

    def test_matches_host_solver_under_jit(self):
        import jax

        n, p, k = 200, 3, 30
        d = np.linspace(0.5, 10.0, n)
        rng = np.random.default_rng(61)
        B = rng.standard_normal((n, p))
        op = _diag_op(d)
        for f in ("inv", "exp"):
            for method in ("one_pass", "two_pass"):
                jitted = jax.jit(lambda bb, f=f, m=method: tpl.
                                 solve_fAb_block_jit(op, bb, k=k, f=f,
                                                     method=m))
                x_j = np.asarray(jitted(jnp.asarray(B)))
                x_h = np.asarray(solve_fAb_block(op, jnp.asarray(B), k, f,
                                                 method=method))
                rel = (np.linalg.norm(x_j - x_h)
                       / np.linalg.norm(x_h))
                assert rel < 1e-10, (f, method, rel)

    def test_breakdown_inside_jit(self):
        """Identity padding: the multiplicity spectrum truncates at s=3
        and the jitted result is still exact."""
        import jax

        d = np.array([1.0, 1.0, 2.0, 2.0, 5.0, 5.0] * 20)
        rng = np.random.default_rng(62)
        B = rng.standard_normal((len(d), 2))
        op = _diag_op(d)
        x = jax.jit(lambda bb: tpl.solve_fAb_block_jit(op, bb, k=10,
                                                       f="inv"))(
            jnp.asarray(B))
        np.testing.assert_allclose(np.asarray(x), B / d[:, None],
                                   rtol=1e-9)

    def test_complex_hermitian_under_jit(self):
        import jax

        n, p, k = 40, 2, 20
        d = np.linspace(1.0, 6.0, n)
        a_np, q = _hermitian_pair(n, d, 63)
        rng = np.random.default_rng(64)
        B = rng.standard_normal((n, p)) + 1j * rng.standard_normal((n, p))
        op = tpl.DenseOperator(jnp.asarray(a_np))
        x = jax.jit(lambda bb: tpl.solve_fAb_block_jit(
            op, bb, k=k, f="inv", method="two_pass"))(jnp.asarray(B))
        truth = (q * (1.0 / d)) @ (q.conj().T @ B)
        rel = np.linalg.norm(np.asarray(x) - truth) / np.linalg.norm(truth)
        assert rel < 1e-9, rel

    def test_zero_b_inside_jit(self):
        import jax

        op = _diag_op(np.linspace(1.0, 2.0, 16))
        x = jax.jit(lambda bb: tpl.solve_fAb_block_jit(op, bb, k=4,
                                                       f="inv"))(
            jnp.zeros((16, 2), jnp.float64))
        np.testing.assert_array_equal(np.asarray(x), np.zeros((16, 2)))


class TestMatmulPrecision:
    """The GEMM-heavy device programs must trace at HIGHEST dot precision.

    An accelerator's DEFAULT f32 dot precision is reduced (TF32 on a GPU);
    CPU dots are exact-dtype, so only the traced program (not a CPU numeric
    result) can pin the fix."""

    @staticmethod
    def _dots_all_highest(jaxpr_str):
        """Every dot_general in the program carries an explicit HIGHEST
        precision tuple. Counting total dot_generals (not just the ones
        that print a tuple) is what makes a single regressed
        DEFAULT-precision dot — printed as ``precision=None`` — fail
        rather than slip past the tuple regex (ADVICE r4 low #3)."""
        import re

        total = len(re.findall(r"\bdot_general\b", jaxpr_str))
        assert total, "no dot_general found in the program"
        assert "precision=None" not in jaxpr_str, (
            "a dot_general regressed to DEFAULT precision")
        tuples = re.findall(r"precision=\(([^)]*)\)", jaxpr_str)
        return len(tuples) == total and all("HIGHEST" in d for d in tuples)

    def test_block_pass_one_traces_highest(self):
        import jax

        op = _diag_op(np.linspace(1.0, 2.0, 16))
        b = jnp.ones((16, 2), jnp.float64)
        txt = str(jax.make_jaxpr(
            lambda bb: block_pass_one(op.matvec, bb, 4))(b))
        assert self._dots_all_highest(txt)

    def test_block_solvers_trace_highest(self):
        import jax

        op = _diag_op(np.linspace(1.0, 2.0, 16))
        b = jnp.ones((16, 2), jnp.float64)
        txt = str(jax.make_jaxpr(lambda bb: tpl.solve_fAb_block_jit(
            op, bb, k=4, f="inv"))(b))
        assert self._dots_all_highest(txt)

    def test_reorth_sweeps_trace_highest(self):
        import jax

        from two_pass_lanczos_tpu.algorithms.reorth import (
            pass_one_scan_reorth,
            pass_one_scan_selective,
        )

        op = _diag_op(np.linspace(1.0, 2.0, 16))
        b = jnp.ones((16,), jnp.float64)
        for fn in (pass_one_scan_reorth, pass_one_scan_selective):
            txt = str(jax.make_jaxpr(
                lambda bb, f=fn: f(op.matvec, bb, 4))(b))
            # the CGS einsums are HIGHEST; the recurrence's vdot keeps the
            # plain path's default precision (bit-equality contract), so
            # only assert presence, not exclusivity
            assert "HIGHEST" in txt

    def test_gemv_reconstruct_traces_highest(self):
        import jax

        from two_pass_lanczos_tpu.solvers import _gemv_reconstruct

        v = jnp.ones((4, 16), jnp.float64)
        y = jnp.ones((4,), jnp.float64)
        txt = str(jax.make_jaxpr(lambda a, b: _gemv_reconstruct(a, b))(v, y))
        assert "HIGHEST" in txt

    def test_eigsh_cycle_traces_highest(self):
        import jax

        from two_pass_lanczos_tpu.eigen import _expand_and_ritz
        from two_pass_lanczos_tpu.algorithms.core import f32_matmul_precision

        op = _diag_op(np.linspace(1.0, 2.0, 16))
        v = jnp.zeros((5, 16), jnp.float64).at[0, 0].set(1.0)
        h = jnp.zeros((4, 4), jnp.float64)
        txt = str(jax.make_jaxpr(f32_matmul_precision(
            lambda vv: _expand_and_ritz(
                op.matvec, vv, h, jnp.zeros((), jnp.int32),
                jax.random.key(0))))(v))
        assert "HIGHEST" in txt
