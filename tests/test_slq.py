"""Stochastic Lanczos quadrature (two_pass_lanczos_tpu.slq).

The reference never estimates traces; these tests pin the SLQ layer built
on the shared pass-one scan: batched pass one is bit-identical to solo
runs, the device-side batched quadrature matches the host-side
spectrum.quadratic_form, and the trace estimators hit analytic ground
truths on diagonal operators (the reference's own test methodology,
``tests/correctness.rs:1-23``) — including the exactness cases where the
Monte-Carlo variance is identically zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import two_pass_lanczos_tpu as tpl
from two_pass_lanczos_tpu.slq import (
    batched_quadratic_form,
    lanczos_pass_one_batched,
    slq_logdet,
    slq_trace,
)
from two_pass_lanczos_tpu.spectrum import quadratic_form


def _diag_op(d):
    return tpl.DiagonalOperator(jnp.asarray(d, jnp.float64))


def test_batched_pass_one_bit_identical_to_solo():
    n, m, k = 150, 4, 25
    rng = np.random.default_rng(0)
    d = np.linspace(0.5, 50.0, n)
    op = _diag_op(d)
    bs = jnp.asarray(rng.standard_normal((m, n)), jnp.float64)
    batched = lanczos_pass_one_batched(op, bs, k)
    assert batched.alphas.shape == (m, k) and batched.steps_taken.shape == (m,)
    for i in range(m):
        solo = tpl.lanczos_pass_one(op, bs[i], k)
        np.testing.assert_array_equal(np.asarray(batched.alphas[i]),
                                      np.asarray(solo.alphas))
        np.testing.assert_array_equal(np.asarray(batched.betas[i]),
                                      np.asarray(solo.betas))
        assert int(batched.steps_taken[i]) == solo.steps()


def test_batched_quadratic_form_matches_host_spectrum():
    n, m, k = 120, 3, 30
    rng = np.random.default_rng(1)
    op = _diag_op(np.linspace(1.0, 10.0, n))
    bs = jnp.asarray(rng.standard_normal((m, n)), jnp.float64)
    batched = lanczos_pass_one_batched(op, bs, k)
    for f in ("inv", "exp"):
        dev = np.asarray(batched_quadratic_form(batched, f))
        for i in range(m):
            solo = tpl.lanczos_pass_one(op, bs[i], k)
            assert dev[i] == pytest.approx(quadratic_form(solo, f), rel=1e-11)


def test_batched_quadratic_form_solo_decomposition():
    op = _diag_op(np.linspace(1.0, 4.0, 40))
    b = jnp.asarray(np.random.default_rng(2).standard_normal(40), jnp.float64)
    decomp = tpl.lanczos_pass_one(op, b, 20)
    got = batched_quadratic_form(decomp, "inv")
    assert got.shape == ()
    assert float(got) == pytest.approx(quadratic_form(decomp, "inv"), rel=1e-11)


def test_breakdown_rows_padded_safely():
    """One RHS breaks down at step 1 (invariant e₁), another runs longer:
    the padded decoupled block must carry zero quadrature weight."""
    op = _diag_op([2.0, 3.0, 5.0, 7.0])
    bs = jnp.asarray([[1.0, 0.0, 0.0, 0.0],
                      [1.0, 1.0, 1.0, 1.0]], jnp.float64)
    batched = lanczos_pass_one_batched(op, bs, 4)
    assert int(batched.steps_taken[0]) == 1
    quad = np.asarray(batched_quadratic_form(batched, "inv"))
    assert quad[0] == pytest.approx(0.5, rel=1e-13)
    truth = sum(1.0 / v for v in (2.0, 3.0, 5.0, 7.0))
    assert quad[1] == pytest.approx(truth, rel=1e-12)


def test_zero_probe_row_yields_zero():
    op = _diag_op(np.ones(8))
    bs = jnp.zeros((2, 8), jnp.float64)
    quad = np.asarray(batched_quadratic_form(
        lanczos_pass_one_batched(op, bs, 3), "inv"))
    np.testing.assert_array_equal(quad, [0.0, 0.0])


def test_rademacher_diag_trace_is_exact():
    """Diagonal A + Rademacher probes: zᵀf(A)z = Σ f(d_i)·z_i² = tr f(A)
    exactly per probe (z_i² = 1), and the quadrature is exact once k ≥ the
    number of distinct eigenvalues — so estimate == truth and stderr == 0."""
    d = np.array([1.0, 1.0, 4.0, 4.0, 4.0, 9.0] * 20)
    op = _diag_op(d)
    res = slq_trace(op, "inv", k=8, num_probes=4, key=jax.random.key(0))
    assert float(res.estimate) == pytest.approx(float(np.sum(1.0 / d)), rel=1e-10)
    assert float(res.stderr) == pytest.approx(0.0, abs=1e-8)
    assert res.samples.shape == (4,)


def test_slq_logdet_converges_to_analytic():
    n = 400
    d = np.linspace(0.5, 20.0, n)
    truth = float(np.sum(np.log(d)))
    res = slq_logdet(_diag_op(d), k=40, num_probes=24, key=jax.random.key(3))
    # diagonal + Rademacher is exact per probe up to quadrature bias
    assert float(res.estimate) == pytest.approx(truth, rel=1e-6)


def test_slq_gaussian_probes_within_sampling_error():
    n = 300
    d = np.linspace(1.0, 10.0, n)
    truth = float(np.sum(1.0 / d))
    res = slq_trace(_diag_op(d), "inv", k=30, num_probes=48,
                    key=jax.random.key(7), probe="gaussian")
    err = abs(float(res.estimate) - truth)
    assert float(res.stderr) > 0.0
    assert err < 5.0 * float(res.stderr) + 1e-9


def test_slq_callable_f_and_determinism():
    d = np.linspace(0.1, 2.0, 64)
    op = _diag_op(d)
    kw = dict(k=16, num_probes=8, key=jax.random.key(11))
    a = slq_trace(op, lambda x: x**2, **kw)
    b = slq_trace(op, lambda x: x**2, **kw)
    np.testing.assert_array_equal(np.asarray(a.samples), np.asarray(b.samples))
    # f(x)=x² is a degree-2 polynomial: quadrature exact at k=16; Rademacher
    # on diagonal A: per-probe zᵀA²z = tr A² exactly.
    assert float(a.estimate) == pytest.approx(float(np.sum(d**2)), rel=1e-10)


def test_slq_dense_operator_mxu_path():
    """Dense SPD (non-diagonal) A: the vmapped matvec is a matmul; compare
    against the dense eigendecomposition ground truth."""
    n = 96
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.linspace(0.5, 8.0, n)
    a = (q * d) @ q.T
    truth = float(np.sum(np.log(d)))
    op = tpl.DenseOperator(jnp.asarray(a, jnp.float64))
    res = slq_logdet(op, k=48, num_probes=64, key=jax.random.key(9))
    err = abs(float(res.estimate) - truth)
    assert err < 5.0 * float(res.stderr) + 1e-6 * abs(truth)


def test_slq_on_vendored_kkt_operator():
    """The vmapped batched scan over a real sparse KKT matvec (indefinite
    saddle-point A): tr(A²) = ‖A‖²_F has an exact analytic oracle
    (Σ d_i² + 4m — each arc contributes four ±1 incidence entries), and the
    2-point Gauss quadrature is exact for the degree-2 polynomial — only
    Hutchinson sampling error remains."""
    from pathlib import Path

    d = Path(__file__).resolve().parents[1] / "data" / "1000"
    dmx = sorted(d.glob("*.dmx"))
    if not dmx:
        pytest.skip("no vendored data/1000 instances")
    from two_pass_lanczos_tpu.utils.data_loader import load_kkt_arrays

    arrays = load_kkt_arrays(dmx[0], dmx[0].with_suffix(".qfc"))
    scale = float(np.max(arrays.quad_costs))
    dsc = arrays.quad_costs / scale
    op = tpl.make_kkt_operator(dsc, arrays.arc_u, arrays.arc_v,
                               arrays.num_nodes,
                               dtype=jnp.float64)
    truth = float(np.sum(dsc**2)) + 4.0 * arrays.num_arcs
    res = slq_trace(op, lambda x: x**2, k=4, num_probes=64,
                    key=jax.random.key(13))
    err = abs(float(res.estimate) - truth)
    assert err < 5.0 * float(res.stderr) + 1e-9 * truth


def test_adaptive_slq_zero_variance_stops_at_minimum():
    from two_pass_lanczos_tpu.slq import slq_trace_adaptive

    d = np.array([1.0, 4.0, 9.0] * 50)
    res = slq_trace_adaptive(_diag_op(d), "inv", k=8, key=jax.random.key(0),
                             batch=4, target_rel_stderr=1e-6)
    assert res.samples.shape[0] == 8  # two batches, then certified
    assert float(res.estimate) == pytest.approx(float(np.sum(1.0 / d)),
                                                rel=1e-9)


def test_adaptive_slq_grows_probes_to_target():
    from two_pass_lanczos_tpu.slq import slq_trace_adaptive

    d = np.linspace(1.0, 10.0, 500)
    truth = float(np.sum(1.0 / d))
    res = slq_trace_adaptive(_diag_op(d), "inv", k=30,
                             key=jax.random.key(5), probe="gaussian",
                             target_rel_stderr=0.02, batch=8,
                             max_probes=512)
    m = res.samples.shape[0]
    assert m > 16  # gaussian on a spread spectrum needs more than 2 batches
    assert float(res.stderr) <= 0.02 * abs(float(res.estimate)) + 1e-12
    assert abs(float(res.estimate) - truth) < 5 * float(res.stderr) + 1e-9


def test_adaptive_slq_respects_max_probes():
    from two_pass_lanczos_tpu.slq import slq_trace_adaptive

    d = np.linspace(1.0, 10.0, 300)
    res = slq_trace_adaptive(_diag_op(d), "inv", k=20,
                             key=jax.random.key(1), probe="gaussian",
                             target_rel_stderr=1e-9, batch=8, max_probes=24)
    assert res.samples.shape[0] == 24  # capped, target unreachable
    assert float(res.stderr) > 0.0


def test_adaptive_slq_validation():
    from two_pass_lanczos_tpu.slq import slq_trace_adaptive

    op = _diag_op(np.ones(8))
    with pytest.raises(ValueError, match="batch"):
        slq_trace_adaptive(op, "inv", key=jax.random.key(0), batch=1)
    with pytest.raises(ValueError, match="target_rel_stderr"):
        slq_trace_adaptive(op, "inv", key=jax.random.key(0),
                           target_rel_stderr=0.0)


def test_spectral_density_integrates_to_one_and_locates_mass():
    """Three well-separated eigenvalue clusters: the DOS estimate must
    integrate to ~1, put ~equal mass near each cluster, and vanish in the
    gaps."""
    from two_pass_lanczos_tpu.slq import slq_spectral_density

    d = np.concatenate([np.full(100, 2.0), np.full(100, 5.0),
                        np.full(100, 8.0)])
    op = _diag_op(d)
    grid = np.linspace(0.0, 10.0, 401)
    phi = np.asarray(slq_spectral_density(op, grid, sigma=0.2, k=12,
                                          num_probes=16,
                                          key=jax.random.key(0)))
    dt = grid[1] - grid[0]
    assert float(np.sum(phi) * dt) == pytest.approx(1.0, rel=1e-3)
    # mass within +-0.6 of each cluster ~ 1/3 each
    for center in (2.0, 5.0, 8.0):
        sel = np.abs(grid - center) < 0.6
        assert float(np.sum(phi[sel]) * dt) == pytest.approx(1 / 3, rel=0.05)
    # the gaps are empty
    for gap in (3.5, 6.5):
        sel = np.abs(grid - gap) < 0.4
        assert float(np.sum(phi[sel]) * dt) < 0.01
    # first moment = mean eigenvalue
    assert float(np.sum(grid * phi) * dt) == pytest.approx(5.0, rel=0.02)


def test_spectral_density_validation():
    from two_pass_lanczos_tpu.slq import slq_spectral_density

    op = _diag_op(np.ones(8))
    with pytest.raises(ValueError, match="grid"):
        slq_spectral_density(op, np.ones((2, 2)), key=jax.random.key(0))
    with pytest.raises(ValueError, match="sigma"):
        slq_spectral_density(op, np.linspace(0, 1, 10), sigma=-1.0,
                             key=jax.random.key(0))
    with pytest.raises(ValueError, match="num_probes"):
        slq_spectral_density(op, np.linspace(0, 1, 10), num_probes=0,
                             key=jax.random.key(0))


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_sharded_slq_trace_diagonal_exact(ndev):
    """Distributed SLQ over the row partition: diagonal + Rademacher is
    exact per probe (k >= #distinct eigenvalues), so N-device estimates
    hit the analytic trace at rounding tolerance — and the padding rows
    contribute nothing."""
    from two_pass_lanczos_tpu.parallel import ShardedSparseOperator, make_mesh

    d = np.array([1.0, 4.0, 9.0] * 37)  # n=111: real padding on 2/8 devices
    n = len(d)
    idx = np.arange(n)
    sop = ShardedSparseOperator(n, idx, idx, d, make_mesh(ndev))
    res = sop.slq_trace("inv", k=8, num_probes=4, key=jax.random.key(0))
    truth = float(np.sum(1.0 / d))
    assert float(res.estimate) == pytest.approx(truth, rel=1e-9)
    assert float(res.stderr) == pytest.approx(0.0, abs=1e-8)


def test_sharded_slq_matches_single_device_estimator():
    """Same probes (same key) through the sharded KKT partition and the
    host operator: estimates agree to reduction-order rounding."""
    from two_pass_lanczos_tpu.models.generator import generate_mcf_instance
    from two_pass_lanczos_tpu.parallel import ShardedSparseOperator, make_mesh
    from two_pass_lanczos_tpu.utils.data_loader import KKTArrays

    inst = generate_mcf_instance(300, rho=3, instance_id=7)
    scale = float(np.max(inst.quad_costs))
    arrays = KKTArrays(quad_costs=inst.quad_costs / scale, arc_u=inst.arc_u,
                       arc_v=inst.arc_v, num_nodes=inst.num_nodes,
                       num_arcs=inst.num_arcs)
    host_op = tpl.make_kkt_operator(arrays.quad_costs, arrays.arc_u,
                                    arrays.arc_v, arrays.num_nodes, dtype=jnp.float64)
    key = jax.random.key(11)
    f = lambda x: x**2
    res_host = slq_trace(host_op, f, k=4, num_probes=8, key=key)
    sop = ShardedSparseOperator.from_kkt_arrays(arrays, make_mesh(8))
    res_dist = sop.slq_trace(f, k=4, num_probes=8, key=key)
    np.testing.assert_allclose(np.asarray(res_dist.samples),
                               np.asarray(res_host.samples), rtol=1e-10)
    assert float(res_dist.estimate) == pytest.approx(
        float(res_host.estimate), rel=1e-10)


def test_sharded_slq_validation():
    from two_pass_lanczos_tpu.parallel import ShardedSparseOperator, make_mesh

    idx = np.arange(16)
    sop = ShardedSparseOperator(16, idx, idx, np.ones(16), make_mesh(2))
    with pytest.raises(ValueError, match="num_probes"):
        sop.slq_trace("inv", k=4, num_probes=0, key=jax.random.key(0))
    with pytest.raises(ValueError, match="unknown function"):
        sop.slq_trace("nope", k=4, num_probes=2, key=jax.random.key(0))


def test_slq_input_validation():
    op = _diag_op(np.ones(8))
    with pytest.raises(ValueError, match="num_probes"):
        slq_trace(op, "inv", k=4, num_probes=0, key=jax.random.key(0))
    with pytest.raises(ValueError, match="probe kind"):
        slq_trace(op, "inv", k=4, num_probes=2, key=jax.random.key(0),
                  probe="uniform")
    with pytest.raises(ValueError, match="unknown function"):
        slq_trace(op, "sqrtish", k=4, num_probes=2, key=jax.random.key(0))
    with pytest.raises(ValueError, match="bs must be"):
        lanczos_pass_one_batched(op, jnp.ones(8, jnp.float64), 3)


def test_adaptive_slq_cap_is_exact():
    """Regression: the probe budget is a hard cap even when it is not a
    batch multiple (the last draw is clamped)."""
    from two_pass_lanczos_tpu.slq import slq_trace_adaptive

    d = np.linspace(1.0, 10.0, 200)
    res = slq_trace_adaptive(_diag_op(d), "inv", k=16,
                             key=jax.random.key(2), probe="gaussian",
                             target_rel_stderr=1e-12, batch=8,
                             max_probes=10)
    assert res.samples.shape[0] == 10


class TestAdaptiveOnProductionTiers:
    """slq_trace_adaptive on the KKT operator, single-device and
    row-partitioned: the shared adaptive driver draws batches through the
    operator's matvec and certifies the target standard error."""

    def _kkt(self, rng, m=300, p=120):
        u = rng.integers(0, p, m).astype(np.int32)
        v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
        d = rng.uniform(1.0, 3.0, m)
        return d, u, v, p

    def test_kkt_operator_adaptive(self, rng):
        d, u, v, p = self._kkt(rng)
        op = tpl.make_kkt_operator(d, u, v, p, dtype=jnp.float64)
        res = tpl.slq_trace_adaptive(op, lambda t: t * t, k=8, batch=4,
                                     target_rel_stderr=0.2, max_probes=24,
                                     key=jax.random.key(3))
        truth = float(np.sum(d ** 2) + 4 * len(d))
        assert res.samples.shape[0] >= 8  # two-batch minimum
        assert abs(float(res.estimate) - truth) < 0.3 * truth
        # certified or capped
        assert (float(res.stderr) <= 0.2 * abs(float(res.estimate))
                or res.samples.shape[0] == 24)

    def test_kkt_sharded_adaptive(self, rng):
        from two_pass_lanczos_tpu.parallel import (
            ShardedSparseOperator, make_mesh,
        )
        from two_pass_lanczos_tpu.utils.data_loader import KKTArrays

        d, u, v, p = self._kkt(rng)
        arrays = KKTArrays(quad_costs=d, arc_u=u, arc_v=v, num_nodes=p,
                           num_arcs=len(d))
        s = ShardedSparseOperator.from_kkt_arrays(arrays, make_mesh(2))
        res = s.slq_trace_adaptive(lambda t: t * t, k=8, batch=4,
                                   target_rel_stderr=0.2, max_probes=16,
                                   key=jax.random.key(4))
        truth = float(np.sum(d ** 2) + 4 * len(d))
        assert abs(float(res.estimate) - truth) < 0.3 * truth

    def test_generic_sharded_adaptive(self, rng):
        from two_pass_lanczos_tpu.parallel import (
            ShardedSparseOperator, make_mesh,
        )

        n = 200
        dvals = np.linspace(1.0, 4.0, n)
        idx = np.arange(n)
        sop = ShardedSparseOperator(n, idx, idx, dvals, make_mesh(2))
        res = sop.slq_trace_adaptive(lambda t: t * t, k=6, batch=4,
                                     target_rel_stderr=0.05,
                                     max_probes=32, key=jax.random.key(5))
        # diagonal + Rademacher: every sample exact => stderr 0, stops
        # at the two-batch minimum
        truth = float(np.sum(dvals ** 2))
        assert float(res.estimate) == pytest.approx(truth, rel=1e-5)
        assert res.samples.shape[0] == 8


def test_sharded_dos_matches_host(rng):
    """DOS on the generic distributed tier: same key => pointwise match
    with the host estimator, integral 1."""
    from two_pass_lanczos_tpu.parallel import (
        ShardedSparseOperator, make_mesh,
    )
    from two_pass_lanczos_tpu.slq import slq_spectral_density

    n = 222
    d = np.linspace(0.5, 9.0, n)
    idx = np.arange(n)
    sop = ShardedSparseOperator(n, idx, idx, d, make_mesh(2))
    grid = np.linspace(0.0, 10.0, 101)
    key = jax.random.key(12)
    phi_s = np.asarray(sop.slq_spectral_density(
        grid, sigma=0.3, k=16, num_probes=4, key=key))
    op = tpl.DiagonalOperator(jnp.asarray(d, jnp.float64))
    phi_h = np.asarray(slq_spectral_density(
        op, grid, sigma=0.3, k=16, num_probes=4, key=key))
    np.testing.assert_allclose(phi_s, phi_h, rtol=1e-8,
                               atol=1e-10 * phi_h.max())
    mass = np.trapezoid(phi_s, grid)
    assert abs(mass - 1.0) < 0.05
