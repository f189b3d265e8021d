"""The fixed-order matvec (``ops/spmv.py``) against a host scipy reference.

Every row sum goes through a :class:`RowSums` plan: fixed-width chunks summed
by plain reductions, level by level. These tests pin (1) the KKT and COO
matvecs against ``scipy.sparse`` CSR in f64 and f32 on generated families,
skewed and degenerate degree patterns and the vendored ``data/`` instances;
(2) the planner on the shapes that stress it; (3) that the product is
bitwise the same on every call.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import two_pass_lanczos_tpu as tpl
from two_pass_lanczos_tpu.models.generator import generate_mcf_instance
from two_pass_lanczos_tpu.models.kkt import kkt_sorted_coo
from two_pass_lanczos_tpu.ops.spmv import (
    build_row_sums,
    incidence_sums,
    row_sums,
    stacked_row_sums,
)
from two_pass_lanczos_tpu.utils.data_loader import KKTArrays, load_kkt_arrays

DATA = Path(__file__).resolve().parents[1] / "data"

#: f64 product against scipy: same terms, another summation order.
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _generated(rho):
    inst = generate_mcf_instance(3000, rho=rho, instance_id=2)
    return KKTArrays(inst.quad_costs, inst.arc_u, inst.arc_v, inst.num_nodes,
                     inst.num_arcs)


def _skewed():
    """Power-law-ish degrees: node 0 is a hub on a third of the arcs."""
    rng = np.random.default_rng(3)
    m, p = 3000, 200
    u = np.where(rng.random(m) < 0.33, 0, rng.integers(0, p, m))
    v = (u + 1 + rng.zipf(1.5, m) % (p - 1)) % p
    return KKTArrays(rng.uniform(1, 5, m), u.astype(np.int32),
                     v.astype(np.int32), p, m)


def _isolated():
    """Nodes 40..99 touch no arc: their node-block rows are empty."""
    rng = np.random.default_rng(4)
    m, p = 500, 100
    u = rng.integers(0, 40, m)
    v = (u + 1 + rng.integers(0, 39, m)) % 40
    return KKTArrays(rng.uniform(1, 5, m), u.astype(np.int32),
                     v.astype(np.int32), p, m)


def _two_nodes():
    """The smallest network: every arc joins node 0 and node 1."""
    m = 7
    u = np.array([0, 1, 0, 1, 0, 0, 1], np.int32)
    return KKTArrays(np.linspace(1, 2, m), u, (1 - u).astype(np.int32), 2, m)


def _vendored(sub, idx):
    dmx = sorted((DATA / sub).glob("*.dmx"))[idx]
    return load_kkt_arrays(dmx, dmx.with_suffix(".qfc"))


INSTANCES = {
    "rho1": lambda: _generated(1),
    "rho2": lambda: _generated(2),
    "rho3": lambda: _generated(3),
    "skewed": _skewed,
    "isolated_nodes": _isolated,
    "two_nodes": _two_nodes,
    "data1000": lambda: _vendored("1000", 0),
    "data1000_b": lambda: _vendored("1000", 5),
    "data2000": lambda: _vendored("2000", 0),
    "data2000_b": lambda: _vendored("2000", 5),
    "data3000": lambda: _vendored("3000", 0),
    "data3000_b": lambda: _vendored("3000", 5),
}


def scipy_kkt(a: KKTArrays):
    m, p = a.num_arcs, a.num_nodes
    cols = np.arange(m)
    e = sp.csr_matrix(
        (np.r_[np.ones(m), -np.ones(m)],
         (np.r_[a.arc_u, a.arc_v], np.r_[cols, cols])), shape=(p, m))
    return sp.bmat([[sp.diags(a.quad_costs), e.T], [e, None]], format="csr")


def _operator(kind, a: KKTArrays, dtype):
    if kind == "kkt":
        return tpl.make_kkt_operator(a.quad_costs, a.arc_u, a.arc_v,
                                     a.num_nodes, dtype=dtype)
    return tpl.SparseOperator(kkt_sorted_coo(a, dtype=dtype))


@pytest.mark.parametrize("kind", ["kkt", "coo"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_matvec_matches_scipy(name, dtype, kind):
    a = INSTANCES[name]()
    ref = scipy_kkt(a)
    x = np.random.default_rng(0).standard_normal(ref.shape[0])
    op = _operator(kind, a, dtype)
    y = np.asarray(jax.jit(lambda o, v: o.matvec(v))(op, jnp.asarray(x, dtype)),
                   np.float64)
    y_ref = ref @ x
    rel = np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref)
    assert rel < TOL[dtype], rel


@pytest.mark.parametrize("kind", ["kkt", "coo"])
def test_matvec_bitwise_repeatable(kind):
    a = _skewed()
    op = _operator(kind, a, np.float64)
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        a.num_arcs + a.num_nodes))
    mv = jax.jit(lambda o, v: o.matvec(v))
    first = np.asarray(mv(op, x))
    for _ in range(3):
        assert np.asarray(mv(op, x)).tobytes() == first.tobytes()


def test_traced_endpoints_are_refused():
    """The node-block plans are built from the endpoints on the host, so an
    operator assembled inside jit from traced endpoints is refused."""
    a = _generated(3)

    @jax.jit
    def traced(d, u, v):
        return tpl.KKTOperator(d=d, arc_u=u, arc_v=v, num_nodes=a.num_nodes)

    with pytest.raises(tpl.InputError, match="concrete arc endpoints"):
        traced(jnp.asarray(a.quad_costs), jnp.asarray(a.arc_u),
               jnp.asarray(a.arc_v))


def test_with_costs_reuses_the_plans():
    """New costs keep the endpoint plans, inside jit too, and the product
    is bitwise that of an operator built from scratch with those costs."""
    a = _generated(3)
    op = _operator("kkt", a, np.float64)
    d2 = 1.0 + np.random.default_rng(6).random(a.num_arcs)
    x = jnp.asarray(np.random.default_rng(7).standard_normal(
        a.num_arcs + a.num_nodes))
    fresh = tpl.make_kkt_operator(d2, a.arc_u, a.arc_v, a.num_nodes,
                                  dtype=jnp.float64)
    mv = jax.jit(lambda o, v: o.matvec(v))
    want = np.asarray(mv(fresh, x))
    assert op.with_costs(d2).tails is op.tails
    assert np.asarray(mv(op.with_costs(d2), x)).tobytes() == want.tobytes()
    traced = jax.jit(lambda d, v: op.with_costs(d).matvec(v))
    np.testing.assert_allclose(np.asarray(traced(jnp.asarray(d2), x)), want,
                               rtol=1e-13, atol=1e-13)
    with pytest.raises(tpl.DimensionMismatchError):
        op.with_costs(d2[:-1])


COUNT_PATTERNS = {
    "empty_rows": [0, 3, 0, 1000, 5, 0],
    "all_empty": [0, 0, 0],
    "single_row": [17],
    "unit_rows": [1] * 50,
    "uniform_long": [300] * 5,
    "hub_and_leaves": [100_000, 1, 1, 1],
    "at_width_edges": [4, 5, 8, 9, 256, 257, 1024, 1025],
}


@pytest.mark.parametrize("name", sorted(COUNT_PATTERNS))
def test_row_sums_plan(name):
    counts = np.asarray(COUNT_PATTERNS[name])
    plan, pos = build_row_sums(counts)
    n = int(counts.sum())
    x = np.random.default_rng(5).standard_normal(n)
    chunks = np.where((pos >= 0) & (pos < n), np.append(x, 0.0)[np.clip(pos, 0, n)], 0.0)
    got = np.asarray(row_sums(plan, jnp.asarray(chunks)))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    want = np.array([x[s:s + c].sum() for s, c in zip(starts, counts)])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # every chunk width is a power of two
    for table in (pos,) + tuple(np.asarray(t) for t in plan.levels):
        w = table.shape[1]
        assert w & (w - 1) == 0, w


@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_stacked_plans_share_shapes(ndev):
    """Per-device plans padded to one shape give each device's own sums."""
    rng = np.random.default_rng(ndev)
    counts = [rng.integers(0, 40 * (d + 1), 30) for d in range(ndev)]
    plan, level0 = stacked_row_sums(counts)
    assert len({t.shape for t in level0}) == 1
    for d in range(ndev):
        n = int(counts[d].sum())
        x = rng.standard_normal(n)
        pos = level0[d]
        chunks = np.where((pos >= 0) & (pos < n), np.append(x, 0.0)[np.clip(pos, 0, n)], 0.0)
        dev_plan = type(plan)(levels=tuple(t[d] for t in plan.levels),
                              out=plan.out[d])
        got = np.asarray(row_sums(dev_plan, jnp.asarray(chunks)))
        starts = np.concatenate([[0], np.cumsum(counts[d])[:-1]])
        want = np.array([x[s:s + c].sum() for s, c in zip(starts, counts[d])])
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_incidence_padding_reads_zero():
    """Padding slots of the incidence table point one past the last arc,
    which the fill-mode gather reads as zero."""
    u = np.array([2, 0, 2, 2, 1], np.int64)
    plan, arcs = incidence_sums(u, 4)
    arcs = np.asarray(arcs)
    assert set(arcs[arcs >= len(u)].tolist()) <= {len(u)}
    x = jnp.asarray([1.0, 10.0, 100.0, 1000.0, 10000.0])
    y = row_sums(plan, x.at[jnp.asarray(arcs)].get(mode="fill", fill_value=0))
    np.testing.assert_array_equal(np.asarray(y), [10.0, 10000.0, 1101.0, 0.0])
