"""Distributed-layer tests on a virtual 8-device CPU mesh.

The reference has nothing distributed; these tests implement the strategy
SURVEY §4 prescribes for the distributed build: mesh-size-parameterized equality
between 1-device and N-device runs, within rounding tolerance (reduction
orders differ across device counts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import two_pass_lanczos_tpu as tpl
from two_pass_lanczos_tpu.models.generator import generate_mcf_instance
from two_pass_lanczos_tpu.models.kkt import kkt_operator_from_arrays, kkt_sorted_coo
from two_pass_lanczos_tpu.parallel import ShardedSparseOperator, make_mesh, snake_partition
from two_pass_lanczos_tpu.utils.data_loader import KKTArrays


def _kkt_arrays(arcs=500, rho=3, iid=1):
    inst = generate_mcf_instance(arcs, rho=rho, instance_id=iid)
    return KKTArrays(
        quad_costs=inst.quad_costs,
        arc_u=inst.arc_u,
        arc_v=inst.arc_v,
        num_nodes=inst.num_nodes,
        num_arcs=inst.num_arcs,
    )


def test_virtual_device_count():
    assert len(jax.devices()) == 8


def test_snake_partition_balance():
    # KKT-like degree profile: many light rows, few heavy ones.
    nnz = np.concatenate([np.full(1000, 3), np.full(40, 50)])
    part = snake_partition(nnz, 8)
    assert part.n_pad % 8 == 0
    assert part.perm.shape == (part.n_pad,)
    np.testing.assert_array_equal(np.sort(part.perm), np.arange(part.n_pad))
    spread = part.nnz_per_dev.max() - part.nnz_per_dev.min()
    assert spread <= 60, f"nnz imbalance too large: {part.nnz_per_dev}"


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_distributed_spmv_matches_dense(ndev):
    arrays = _kkt_arrays()
    mesh = make_mesh(ndev)
    sop = ShardedSparseOperator.from_kkt_arrays(arrays, mesh)
    dense = np.asarray(kkt_sorted_coo(arrays).todense())
    rng = np.random.default_rng(0)
    x = rng.standard_normal(arrays.n)
    y = sop.matvec_distributed(x)
    np.testing.assert_allclose(y, dense @ x, atol=1e-12)


@pytest.mark.parametrize("method", ["one_pass", "two_pass"])
@pytest.mark.parametrize("f", ["exp", "inv"])
def test_distributed_solve_matches_single_device(method, f):
    # exp on a KKT spectrum (eigenvalues ~1e5) overflows f64 — use the
    # reference's controlled exp spectrum for exp, the KKT system for inv.
    # Tolerances reflect conditioning: reduction order differs per device
    # count, and inv on the indefinite KKT amplifies rounding (~1e-11 seen).
    k = 25
    rng = np.random.default_rng(42)
    if f == "inv":
        arrays = _kkt_arrays()
        op = kkt_operator_from_arrays(arrays).operator
        n = arrays.n
        sop = ShardedSparseOperator.from_kkt_arrays(arrays, make_mesh(8))
        tol = 1e-9
    else:
        from two_pass_lanczos_tpu.models.synthetic import create_diagonal_problem

        n = 700
        op, eigs = create_diagonal_problem(n, "well-conditioned", "exp")
        idx = np.arange(n)
        sop = ShardedSparseOperator(n, idx, idx, eigs, make_mesh(8))
        tol = 1e-13
    b = rng.standard_normal(n)

    x_single = np.asarray(tpl.solve_fAb(op, jnp.asarray(b), k=k, f=f, method=method))
    x_dist, decomp = sop.solve_fAb(b, k=k, f=f, method=method)

    rel = np.linalg.norm(x_dist - x_single) / np.linalg.norm(x_single)
    assert rel < tol, f"{method}/{f}: N-device vs 1-device deviation {rel:.3e}"
    assert decomp.steps() == k


def test_distributed_decomposition_matches_single_device():
    arrays = _kkt_arrays()
    sys = kkt_operator_from_arrays(arrays)
    rng = np.random.default_rng(42)
    b = rng.standard_normal(arrays.n)
    k = 25

    d_single = tpl.lanczos_pass_one(sys.operator, jnp.asarray(b), k)
    sop = ShardedSparseOperator.from_kkt_arrays(arrays, make_mesh(8))
    _, d_dist = sop.solve_fAb(b, k=k, f="inv", method="two_pass")

    # relative agreement: alphas/betas are ~1e5 here and psum order differs
    np.testing.assert_allclose(
        np.asarray(d_dist.alphas), np.asarray(d_single.alphas), rtol=1e-10, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(d_dist.betas), np.asarray(d_single.betas), rtol=1e-10, atol=1e-12
    )


def test_distributed_mesh_sizes_consistent():
    # The same problem over meshes of 1, 2, 4, 8 devices agrees to tolerance.
    arrays = _kkt_arrays(arcs=300)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(arrays.n)
    results = []
    for ndev in (1, 2, 4, 8):
        sop = ShardedSparseOperator.from_kkt_arrays(arrays, make_mesh(ndev))
        x, _ = sop.solve_fAb(b, k=20, f="inv", method="two_pass")
        results.append(x)
    for x in results[1:]:
        rel = np.linalg.norm(x - results[0]) / np.linalg.norm(results[0])
        assert rel < 1e-9  # inv on the indefinite KKT amplifies psum-order rounding


class TestGenericChunked:
    """In-run early stopping on the generic row partition
    (`ShardedSparseOperator.solve_fAb(callback=...)`): chunked
    coefficients bit-identical to the
    monolithic scan, a stop at s costs <= ceil(s/chunk)·chunk pass-one
    matvecs + s pass-two matvecs per device."""

    def _op(self, ndev=8, arcs=500):
        arrays = _kkt_arrays(arcs=arcs)
        sop = ShardedSparseOperator.from_kkt_arrays(arrays, make_mesh(ndev))
        rng = np.random.default_rng(7)
        return sop, rng.standard_normal(arrays.n)

    @pytest.mark.parametrize("ndev", [2, 8])
    def test_bit_identical_to_monolithic(self, ndev):
        sop, b = self._op(ndev)
        k = 23
        _, dec_ref = sop.solve_fAb(b, k=k, f="inv", method="two_pass")
        dec, stopped = sop.pass_one_chunked(b, k, chunk=8)
        assert not stopped
        np.testing.assert_array_equal(np.asarray(dec.alphas),
                                      np.asarray(dec_ref.alphas))
        np.testing.assert_array_equal(np.asarray(dec.betas),
                                      np.asarray(dec_ref.betas))
        assert int(dec.steps_taken) == k

    def test_callback_stop_cost_and_result(self):
        sop, b = self._op()
        k, stop_at, chunk = 30, 11, 4
        seen = []

        def cb(step, basis, scalars):
            alphas, betas = scalars
            assert basis is None
            assert len(alphas) == step and len(betas) == step - 1
            seen.append(step)
            return step < stop_at

        x_cb, dec = sop.solve_fAb(b, k=k, f="inv", callback=cb,
                                  callback_chunk=chunk)
        assert seen == list(range(1, stop_at + 1))
        assert int(dec.steps_taken) == stop_at
        assert sop._last_p1_launches <= -(-stop_at // chunk)
        assert sop._last_p2_len == stop_at
        x_ref, dec_ref = sop.solve_fAb(b, k=stop_at, f="inv")
        np.testing.assert_array_equal(np.asarray(dec.alphas)[:stop_at],
                                      np.asarray(dec_ref.alphas))
        np.testing.assert_allclose(x_cb, x_ref, rtol=0,
                                   atol=1e-12 * np.abs(x_ref).max())

    def test_zero_b(self):
        sop, _ = self._op(ndev=2)
        n = sop.shape[0]
        dec, stopped = sop.pass_one_chunked(np.zeros(sop.part.n_orig), 8,
                                            chunk=4)
        assert not stopped
        assert int(dec.steps_taken) == 0
        x, dec2 = sop.solve_fAb(np.zeros(sop.part.n_orig), k=8, f="inv",
                                callback=lambda *a: True, callback_chunk=4)
        assert int(dec2.steps_taken) == 0
        np.testing.assert_array_equal(x, 0.0)
