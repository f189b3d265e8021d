"""Data-layer tests: DIMACS/QFC parsing, KKT assembly, instance generation.

Covers the reference loader's validation rules (``src/utils/data_loader.rs``)
and the resolution of the qfc format ambiguity (SURVEY §2 caveat).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import two_pass_lanczos_tpu as tpl
from two_pass_lanczos_tpu.models.generator import generate_mcf_instance, nodes_for
from two_pass_lanczos_tpu.models.kkt import (
    kkt_operator_from_files,
    kkt_sorted_coo,
)
from two_pass_lanczos_tpu.utils.data_loader import (
    DataLoaderError,
    KKTArrays,
    load_kkt_arrays,
    parse_dmx,
    parse_qfc,
)

DMX = """c comment line
p min 4 5
n 1 10
n 4 -10
a 1 2 0 5 3
a 2 3 0 5 3
a 3 4 0 5 3
a 1 3 0 5 3
a 2 4 0 5 3
"""

QFC_LINEWISE = "5\n1\n1\n1\n1\n1\n2.0\n3.0\n4.0\n5.0\n6.0\n"
QFC_SPACESEP = "5\n1 1 1 1 1 \n2.0 3.0 4.0 5.0 6.0 \n"
QFC_QUADONLY = "5\n2.0 3.0 4.0 5.0 6.0\n"


def test_parse_dmx_basic(tmp_path):
    f = tmp_path / "t.dmx"
    f.write_text(DMX)
    nodes, arcs, u, v = parse_dmx(f)
    assert (nodes, arcs) == (4, 5)
    np.testing.assert_array_equal(u, [0, 1, 2, 0, 1])
    np.testing.assert_array_equal(v, [1, 2, 3, 2, 3])


def test_parse_dmx_missing_problem_line(tmp_path):
    f = tmp_path / "bad.dmx"
    f.write_text("c nothing here\na 1 2 0 5 3\n")
    with pytest.raises(DataLoaderError):
        parse_dmx(f)


def test_parse_dmx_zero_index_rejected(tmp_path):
    # 1-based validation: index 0 is illegal (``data_loader.rs:103-134``).
    f = tmp_path / "zero.dmx"
    f.write_text("p min 2 1\na 0 1 0 5 3\n")
    with pytest.raises(DataLoaderError):
        parse_dmx(f)


@pytest.mark.parametrize(
    "content", [QFC_LINEWISE, QFC_SPACESEP, QFC_QUADONLY], ids=["lines", "spaces", "quadonly"]
)
def test_parse_qfc_all_layouts(tmp_path, content):
    # Both the reference parser's expected layout and the layout the actual
    # qfcgen.c writes must parse to the same quadratic costs.
    f = tmp_path / "t.qfc"
    f.write_text(content)
    quad = parse_qfc(f, 5)
    np.testing.assert_allclose(quad, [2.0, 3.0, 4.0, 5.0, 6.0])


def test_parse_qfc_arc_count_mismatch(tmp_path):
    f = tmp_path / "t.qfc"
    f.write_text(QFC_SPACESEP)
    with pytest.raises(DataLoaderError):
        parse_qfc(f, 7)


def test_kkt_operator_matches_dense_assembly(tmp_path):
    (tmp_path / "t.dmx").write_text(DMX)
    (tmp_path / "t.qfc").write_text(QFC_SPACESEP)
    sys = kkt_operator_from_files(tmp_path / "t.dmx", tmp_path / "t.qfc")
    assert (sys.num_nodes, sys.num_arcs, sys.n) == (4, 5, 9)

    arrays = load_kkt_arrays(tmp_path / "t.dmx", tmp_path / "t.qfc")
    coo = kkt_sorted_coo(arrays)
    dense = np.asarray(coo.todense())
    # structure: D block, E block, symmetry, zero bottom-right block
    np.testing.assert_allclose(np.diag(dense)[:5], [2, 3, 4, 5, 6])
    np.testing.assert_allclose(dense, dense.T)
    assert np.all(dense[5:, 5:] == 0)

    # operator action == dense action
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal(9))
    np.testing.assert_allclose(
        np.asarray(sys.operator.matvec(x)), dense @ np.asarray(x), atol=1e-14
    )


def test_generator_roundtrip(tmp_path):
    inst = generate_mcf_instance(200, rho=3, instance_id=7, output_dir=tmp_path)
    n_expected = nodes_for(200, 3)
    assert inst.num_nodes == n_expected
    base = f"netgen-200-3-7-a-a-ns"
    arrays = load_kkt_arrays(tmp_path / f"{base}.dmx", tmp_path / f"{base}.qfc")
    assert arrays.num_arcs == 200
    assert arrays.num_nodes == n_expected
    np.testing.assert_allclose(arrays.quad_costs, inst.quad_costs, rtol=1e-6)
    np.testing.assert_array_equal(arrays.arc_u, inst.arc_u)
    # deterministic in the instance id
    inst2 = generate_mcf_instance(200, rho=3, instance_id=7)
    np.testing.assert_array_equal(inst.arc_v, inst2.arc_v)
    np.testing.assert_allclose(inst.quad_costs, inst2.quad_costs)
    # different id ⇒ different instance
    inst3 = generate_mcf_instance(200, rho=3, instance_id=8)
    assert not np.array_equal(inst.arc_u, inst3.arc_u)


def test_generator_connectivity():
    inst = generate_mcf_instance(150, rho=2, instance_id=1)
    # undirected reachability over the arc set must span all nodes
    n = inst.num_nodes
    adj = [[] for _ in range(n)]
    for a, b in zip(inst.arc_u, inst.arc_v):
        adj[a].append(b)
        adj[b].append(a)
    seen = {0}
    stack = [0]
    while stack:
        cur = stack.pop()
        for nb in adj[cur]:
            if nb not in seen:
                seen.add(nb)
                stack.append(nb)
    assert len(seen) == n
    # supplies balance
    assert inst.supplies.sum() == 0


def test_synthetic_scenarios_exact_constants():
    from two_pass_lanczos_tpu.models.synthetic import create_diagonal_problem

    _, eigs = create_diagonal_problem(100, "well-conditioned", "exp")
    assert eigs[0] == -10.0 and np.isclose(eigs[-1], -0.1)
    _, eigs = create_diagonal_problem(100, "ill-conditioned", "exp")
    assert eigs[0] == -1000.0 and np.isclose(eigs[-1], -0.1)
    _, eigs = create_diagonal_problem(100, "well-conditioned", "inv")
    assert eigs[0] == 0.1 and np.isclose(eigs[-1], 100.0)
    _, eigs = create_diagonal_problem(100, "ill-conditioned", "inv")
    assert eigs[50] == 1e-8
    # second-half start -1.0 is overwritten by the critical eigenvalue at mid,
    # exactly like the reference (stability.rs:144); allow float rounding at 1.0
    assert eigs.min() >= -1.0 and eigs.max() <= 1.0 + 1e-12


def test_stability_accuracy_on_reference_scenarios():
    # Small-scale version of the reference's accuracy result: exp/well reaches
    # machine precision in <30 iterations (``tex/report.tex:512``).
    from two_pass_lanczos_tpu.models.synthetic import create_diagonal_problem

    n, k = 2000, 30
    op, eigs = create_diagonal_problem(n, "well-conditioned", "exp")
    rng = np.random.default_rng(42)
    b = rng.standard_normal(n)
    x_true = np.exp(eigs) * b
    x = tpl.lanczos_two_pass(op, jnp.asarray(b), k, tpl.make_exp_solver())
    rel = np.linalg.norm(np.asarray(x) - x_true) / np.linalg.norm(x_true)
    assert rel < 1e-13
