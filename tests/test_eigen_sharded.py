"""Distributed thick-restart eigensolver (ShardedSparseOperator.eigsh)
on the virtual CPU mesh: N-device == analytic truth == host eigsh, with
the basis column-sharded and projections psummed (SURVEY §4 mesh-equality
strategy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import two_pass_lanczos_tpu as tpl
from two_pass_lanczos_tpu.models.generator import generate_mcf_instance
from two_pass_lanczos_tpu.parallel import ShardedSparseOperator, make_mesh
from two_pass_lanczos_tpu.utils.data_loader import KKTArrays


def _diag_sharded(d, ndev):
    n = len(d)
    idx = np.arange(n)
    return ShardedSparseOperator(n, idx, idx, np.asarray(d, np.float64),
                                 make_mesh(ndev))


def _kkt_pair(arcs=400, iid=5):
    inst = generate_mcf_instance(arcs, rho=3, instance_id=iid)
    scale = float(np.max(inst.quad_costs))
    arrays = KKTArrays(quad_costs=inst.quad_costs / scale, arc_u=inst.arc_u,
                       arc_v=inst.arc_v, num_nodes=inst.num_nodes,
                       num_arcs=inst.num_arcs)
    host_op = tpl.make_kkt_operator(arrays.quad_costs, arrays.arc_u,
                                    arrays.arc_v, arrays.num_nodes, dtype=jnp.float64)
    return arrays, host_op


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_sharded_eigsh_diagonal_truth(ndev):
    d = np.linspace(0.5, 40.0, 333)  # non-multiple of ndev: real padding
    sop = _diag_sharded(d, ndev)
    res = sop.eigsh(nev=4, which="LA", tol=1e-10)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, np.sort(d)[-4:], rtol=1e-9)
    # eigenvectors restored to original order: diagonal op => +-e_i
    for j, u in enumerate(res.eigenvectors):
        assert np.linalg.norm(u) == pytest.approx(1.0, abs=1e-9)
        assert abs(u[333 - 4 + j]) == pytest.approx(1.0, abs=1e-7)


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_eigsh_matches_host_on_kkt(ndev):
    arrays, host_op = _kkt_pair()
    truth = tpl.eigsh(host_op, nev=3, which="LA", tol=1e-9, maxiter=300)
    assert truth.converged
    sop = ShardedSparseOperator.from_kkt_arrays(arrays, make_mesh(ndev))
    res = sop.eigsh(nev=3, which="LA", tol=1e-9, maxiter=300)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, truth.eigenvalues, rtol=1e-8)
    # eigenvectors agree up to sign (distinct extreme eigenvalues)
    for u_d, u_h in zip(res.eigenvectors, truth.eigenvectors):
        assert abs(float(u_d @ u_h)) == pytest.approx(1.0, abs=1e-6)


def test_sharded_eigsh_sa_padding_never_leaks():
    """which='SA' would be corrupted by the padding's spurious zero
    eigenvalues if injections or v0 ever touched padded rows: the true
    λ_min here is 0.5 > 0."""
    d = np.linspace(0.5, 40.0, 333)
    sop = _diag_sharded(d, 8)
    res = sop.eigsh(nev=3, which="SA", tol=1e-10, maxiter=300)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, np.sort(d)[:3], rtol=1e-9)
    assert res.eigenvalues[0] > 0.4  # no phantom zeros from padding


def test_sharded_eigsh_degenerate_injection_across_mesh():
    """Masked per-device random injections find degenerate copies."""
    d = np.array([1.0, 2.0, 3.0] * 40)
    sop = _diag_sharded(d, 8)
    res = sop.eigsh(nev=3, which="LA", ncv=12, tol=1e-10)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, [3.0, 3.0, 3.0], rtol=1e-9)
    gram = res.eigenvectors @ res.eigenvectors.T
    np.testing.assert_allclose(gram, np.eye(3), atol=1e-8)


def test_sharded_eigsh_validation():
    d = np.linspace(1.0, 5.0, 64)
    sop = _diag_sharded(d, 2)
    with pytest.raises(ValueError, match="which"):
        sop.eigsh(nev=2, which="XX")
    with pytest.raises(ValueError, match="nonzero"):
        sop.eigsh(nev=2, v0=np.zeros(64))


def test_sharded_eigsh_complex_hermitian():
    """Self-adjoint genericity on the mesh: complex Hermitian A in COO,
    complex basis columns sharded, conj-projections psummed."""
    n = 48
    d = np.concatenate([np.linspace(1.0, 6.0, n - 2), [9.0, 10.0]])
    rng = np.random.default_rng(55)
    m = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    q, _ = np.linalg.qr(m)
    a_np = (q * d) @ q.conj().T
    a_np = (a_np + a_np.conj().T) / 2
    rows, cols = np.nonzero(np.ones((n, n), bool))
    sop = ShardedSparseOperator(n, rows, cols, a_np[rows, cols],
                                make_mesh(2))
    res = sop.eigsh(nev=2, which="LA", tol=1e-9, maxiter=200)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, [9.0, 10.0], rtol=1e-8)
    assert np.iscomplexobj(res.eigenvectors)
    for theta, u in zip(res.eigenvalues, res.eigenvectors):
        assert np.linalg.norm(u) == pytest.approx(1.0, abs=1e-9)
        assert np.linalg.norm(a_np @ u - theta * u) < 1e-7
