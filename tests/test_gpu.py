"""Card-only checks: the behaviours the two-pass contract rests on, run on
a GPU at a size where its reductions and atomics would show. They skip
without a card; on one, run ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import two_pass_lanczos_tpu as tpl
from two_pass_lanczos_tpu.models.generator import generate_mcf_instance
from two_pass_lanczos_tpu.models.kkt import kkt_sorted_coo
from two_pass_lanczos_tpu.utils.data_loader import KKTArrays

pytestmark = pytest.mark.gpu


def _problem(kind="kkt", arcs=50_000):
    inst = generate_mcf_instance(arcs, rho=3, instance_id=1)
    a = KKTArrays(inst.quad_costs, inst.arc_u, inst.arc_v, inst.num_nodes,
                  inst.num_arcs)
    if kind == "kkt":
        op = tpl.make_kkt_operator(a.quad_costs, a.arc_u, a.arc_v,
                                   a.num_nodes, dtype=jnp.float64)
    else:
        op = tpl.SparseOperator(kkt_sorted_coo(a))
    b = jnp.asarray(np.random.default_rng(0).standard_normal(a.n))
    return op, b


@pytest.mark.parametrize("kind", ["kkt", "coo"])
def test_replay_bitwise_on_card(gpu, kind):
    from two_pass_lanczos_tpu.functions import padded_f_e1

    op, b = _problem(kind)
    k = 200
    decomp, v1 = jax.jit(tpl.lanczos_standard, static_argnums=2)(op, b, k)
    y = padded_f_e1(decomp, "inv") * decomp.b_norm
    _, v2 = jax.jit(tpl.lanczos_pass_two_with_basis)(op, b, decomp, y)
    assert np.asarray(v1).tobytes() == np.asarray(v2).tobytes()


def test_breakdown_on_card(gpu):
    op = tpl.DiagonalOperator(jnp.asarray([2.0, 3.0]))
    decomp = tpl.lanczos_pass_one(op, jnp.asarray([1.0, 0.0]), 5)
    assert int(decomp.steps_taken) == 1


def test_zero_b_on_card(gpu):
    op, b = _problem()
    x = tpl.solve_fAb(op, jnp.zeros_like(b), k=20, f="inv", method="two_pass")
    assert not np.any(np.asarray(x))
    with pytest.raises(tpl.InputError):
        tpl.lanczos_two_pass(op, jnp.zeros_like(b), 20, tpl.make_inv_solver())


def test_chunked_resume_on_card(gpu):
    """The chunked pass one (a compiled launch per chunk, state carried
    between them) gives the monolithic scan's coefficients bit for bit."""
    op, b = _problem()
    k = 64
    whole = tpl.lanczos_pass_one(op, b, k)
    chunked = tpl.lanczos_pass_one_chunked(op, b, k, lambda s, v, t: True,
                                           chunk=16)
    assert np.asarray(whole.alphas).tobytes() == \
        np.asarray(chunked.alphas).tobytes()
    assert np.asarray(whole.betas).tobytes() == \
        np.asarray(chunked.betas).tobytes()


def test_with_costs_under_jit_on_card(gpu):
    """New costs passed through jit (``with_costs``) keep the fixed-order
    node sums: two solves of the same costs give the same bits."""
    op, b = _problem()
    solve = jax.jit(lambda d, bb: tpl.solve_fAb(
        op.with_costs(d), bb, k=100, f="inv", method="two_pass"))
    d = 2.0 * op.d
    x1, x2 = solve(d, b), solve(d, b)
    assert np.all(np.isfinite(np.asarray(x1)))
    assert np.asarray(x1).tobytes() == np.asarray(x2).tobytes()
