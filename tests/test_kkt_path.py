"""The user path on the KKT system: ``make_kkt_operator`` → ``solve_fAb``.

Pins, on the CPU, what the GPU run relies on: (1) two-pass replay is
bitwise through the fixed-order matvec, for ``KKTOperator`` and
``SparseOperator``, every method, function and dtype; (2) the behaviours
users meet on this path — multi-f fan-out, an early-stop callback,
breakdown, zero b, nested jit, SLQ and Chebyshev, and the row-partitioned
distributed solve against one device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

import two_pass_lanczos_tpu as tpl
from two_pass_lanczos_tpu.functions import padded_f_e1
from two_pass_lanczos_tpu.models.generator import generate_mcf_instance
from two_pass_lanczos_tpu.models.kkt import kkt_sorted_coo
from two_pass_lanczos_tpu.utils.data_loader import KKTArrays

FUNCS = {"inv": "inv", "exp": "exp", "z2": lambda t: t * t}


def _arrays(arcs=2000, seed=1):
    inst = generate_mcf_instance(arcs, rho=3, instance_id=seed)
    # unit-scale costs keep exp(A) finite and the spectrum modest
    d = 1.0 + inst.quad_costs / inst.quad_costs.max()
    return KKTArrays(d, inst.arc_u, inst.arc_v, inst.num_nodes, inst.num_arcs)


def _op(kind, a, dtype=jnp.float64):
    if kind == "kkt":
        return tpl.make_kkt_operator(a.quad_costs, a.arc_u, a.arc_v,
                                     a.num_nodes, dtype=dtype)
    return tpl.SparseOperator(kkt_sorted_coo(a, dtype=np.dtype(dtype)))


def _b(a, dtype=jnp.float64, seed=0):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(
        a.num_arcs + a.num_nodes), dtype)


def _dense(a):
    m, p = a.num_arcs, a.num_nodes
    e = np.zeros((p, m))
    e[a.arc_u, np.arange(m)] += 1.0
    e[a.arc_v, np.arange(m)] -= 1.0
    return np.block([[np.diag(a.quad_costs), e.T], [e, np.zeros((p, p))]])


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("f", sorted(FUNCS))
@pytest.mark.parametrize("method", ["one_pass", "two_pass"])
@pytest.mark.parametrize("kind", ["kkt", "coo"])
def test_replay_bitwise(kind, method, f, dtype):
    """Pass two regenerates pass one's basis bit for bit, and a repeated
    solve returns the same bits."""
    a = _arrays()
    op, b, k = _op(kind, a, dtype), _b(a, dtype), 24
    decomp, v1 = jax.jit(tpl.lanczos_standard, static_argnums=2)(op, b, k)
    y = (padded_f_e1(decomp, FUNCS[f]) * decomp.b_norm).astype(dtype)
    _, v2 = jax.jit(tpl.lanczos_pass_two_with_basis)(op, b, decomp, y)
    assert np.asarray(v1).tobytes() == np.asarray(v2).tobytes()
    x1 = tpl.solve_fAb(op, b, k=k, f=FUNCS[f], method=method)
    x2 = tpl.solve_fAb(op, b, k=k, f=FUNCS[f], method=method)
    assert np.all(np.isfinite(np.asarray(x1)))
    assert np.asarray(x1).tobytes() == np.asarray(x2).tobytes()


@pytest.mark.parametrize("kind", ["kkt", "coo"])
def test_multi_f_fan_out_bit_identical(kind):
    """Pass two over a stack of functions' y: each slice of the result is
    bit-identical to the single-function pass (the regeneration does not
    depend on y)."""
    a = _arrays()
    op, b, k = _op(kind, a), _b(a), 20
    decomp = tpl.lanczos_pass_one(op, b, k)
    ys = [(padded_f_e1(decomp, f) * decomp.b_norm) for f in ("inv", "exp")]
    two = jax.jit(tpl.lanczos_pass_two)
    multi = np.asarray(two(op, b, decomp, jnp.stack(ys)))
    for i, y in enumerate(ys):
        assert multi[i].tobytes() == np.asarray(two(op, b, decomp, y)).tobytes()


@pytest.mark.parametrize("chunk", [4, 16])
def test_callback_stop_on_kkt(chunk):
    """A live callback stops the chunked pass one at the requested step,
    and pass two follows the shortened decomposition."""
    a = _arrays()
    op, b = _op("kkt", a), _b(a)
    stop = 9
    seen = []

    def cb(steps, v_view, coeffs):
        seen.append(steps)
        return steps < stop

    x = tpl.lanczos_two_pass(op, b, 32, tpl.make_inv_solver(), callback=cb,
                             callback_chunk=chunk)
    assert seen[-1] == stop
    x_ref = tpl.lanczos_two_pass(op, b, stop, tpl.make_inv_solver())
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref), rtol=1e-10)


@pytest.mark.parametrize("method", ["one_pass", "two_pass"])
def test_breakdown_on_kkt(method):
    """n = 3 (one arc, two nodes): the Krylov space is exhausted before
    k = 8 and the solve truncates gracefully to the exact inverse."""
    a = KKTArrays(np.array([2.0]), np.array([0], np.int32),
                  np.array([1], np.int32), 2, 1)
    op = _op("kkt", a)
    dense = _dense(a)  # rank 2: b is taken in its range
    b_np = dense @ np.array([1.0, 2.0, 3.0])
    b = jnp.asarray(b_np)
    x = tpl.solve_fAb(op, b, k=8, f="inv", method=method)
    decomp = tpl.lanczos_pass_one(op, b, 8)
    assert int(decomp.steps_taken) < 8
    np.testing.assert_allclose(dense @ np.asarray(x), b_np, atol=1e-10)


@pytest.mark.parametrize("api", ["solve_fAb", "lanczos_two_pass"])
def test_zero_b_on_kkt(api):
    a = _arrays()
    op = _op("kkt", a)
    b = jnp.zeros(a.num_arcs + a.num_nodes)
    if api == "solve_fAb":
        x = tpl.solve_fAb(op, b, k=10, f="inv", method="two_pass")
        assert not np.any(np.asarray(x))
    else:
        with pytest.raises(tpl.InputError):
            tpl.lanczos_two_pass(op, b, 10, tpl.make_inv_solver())


@pytest.mark.parametrize("built", ["outside", "inside", "with_costs"])
def test_nested_jit(built):
    """``solve_fAb`` nests in an outer jit, with the operator passed in
    (its plans travel as leaves), assembled inside from traced costs and
    concrete endpoints, or given traced costs through ``with_costs``."""
    a = _arrays()
    op, b = _op("kkt", a), _b(a)
    direct = tpl.solve_fAb(op, b, k=16, f="inv", method="two_pass")
    if built == "outside":
        outer = jax.jit(lambda o, bb: 2.0 * tpl.solve_fAb(
            o, bb, k=16, f="inv", method="two_pass"))
        got = outer(op, b)
    else:
        @jax.jit
        def outer(d, bb):
            if built == "inside":
                o = tpl.KKTOperator(d=d, arc_u=op.arc_u, arc_v=op.arc_v,
                                    num_nodes=a.num_nodes)
            else:
                o = op.with_costs(d)
            return 2.0 * tpl.solve_fAb(o, bb, k=16, f="inv",
                                       method="two_pass")

        got = outer(op.d, b)
    np.testing.assert_allclose(np.asarray(got), 2.0 * np.asarray(direct),
                               rtol=1e-9, atol=1e-12)


def test_slq_trace_on_kkt():
    """tr(A²) = ‖A‖_F² = Σd² + 4m, exact per probe for f(t)=t² at k ≥ 3."""
    a = _arrays(arcs=1000)
    op = _op("kkt", a)
    res = tpl.slq_trace(op, lambda t: t * t, k=4, num_probes=64,
                        key=jax.random.key(1))
    truth = float(np.sum(a.quad_costs ** 2) + 4 * a.num_arcs)
    assert abs(float(res.estimate) - truth) < 0.2 * truth


def test_chebyshev_on_kkt():
    a = _arrays(arcs=400)
    op = _op("kkt", a)
    b = _b(a)
    dense = _dense(a)
    ev = np.linalg.eigvalsh(dense)
    x = tpl.chebyshev_fAb(op, b, "exp", degree=40,
                          interval=(ev[0] - 0.1, ev[-1] + 0.1))
    x_ref = scipy.linalg.expm(dense) @ np.asarray(b)
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-8,
                               atol=1e-8 * np.abs(x_ref).max())


@pytest.mark.parametrize("method", ["one_pass", "two_pass"])
def test_sharded_matches_one_device(method):
    """``ShardedSparseOperator`` on a 4-device mesh against the one-device
    KKT solve of the same instance."""
    from two_pass_lanczos_tpu.parallel import ShardedSparseOperator, make_mesh

    a = _arrays()
    b = _b(a)
    sop = ShardedSparseOperator.from_kkt_arrays(a, make_mesh(4))
    x_sh, _ = sop.solve_fAb(np.asarray(b), k=30, f="inv", method=method)
    x_one = tpl.solve_fAb(_op("kkt", a), b, k=30, f="inv", method=method)
    rel = np.linalg.norm(x_sh - np.asarray(x_one)) / np.linalg.norm(x_one)
    assert rel < 1e-10, rel
